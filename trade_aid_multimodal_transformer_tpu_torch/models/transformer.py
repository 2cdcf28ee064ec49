"""The multimodal transformer's forward over a parameter tree, for inference
and training (port of the JAX package's ``models/transformer.py``).

Architecture as there (reference model, SURVEY Quirk Q6):

- factored QKV: Linear(C, hs/2) -> tanh -> Linear(hs/2, hs, no bias) per
  projection; attention q.k^T * hs**-0.5, causal mask, softmax, then .v
- output projection: Linear(H*hs, C/2) -> tanh -> Linear(C/2, C)
- cross-attention: per head a no-bias query Linear; per KV modality a no-bias
  Linear(C, 2hs) split into k, v; per-modality outputs SUMMED across the KV
  modalities; the KV inputs are the post-SA/FF activations of the other
  modalities in the same block
- block order: x += SA(LN1(x)); x += FF(LN2(x)); then cross-attention
- post block: LN -> Linear(C, V/2) -> tanh -> Linear(V/2, V), all heads
  batched over a vocabulary padded to a multiple of 128

Self-attention, feed-forward and LayerNorm are stacked over a leading
modality axis M; embeddings, vocab heads and cross-attention unroll per
modality. On a CUDA device in the whole-row band (T <= 512), self-attention
is one call of the fused projection + attention kernel and the cross core one
call of the whole-row cross kernel; in the flash band (T >= 256, T % 128 == 0,
so above 512) both cores are the flash kernels (ops/kernels.py; their
backward kernels run in training); elsewhere the dense cores run. Outside the
whole-row band cross-attention projects in the JAX package's (B, H, T, hs)
order, so that the flash kernels' and the dense core's dropout rows are
JAX's. Inside a context-parallel scope (ops/attention.py) the whole-row
kernels are off, as in the JAX package: self-attention projects q, k, v and
cross-attention projects in JAX's (B, H, T, hs) order, and both cores go
through ring attention, whose chunk rows are then JAX's.

Training (``train=True`` with a raw uint32[2] ``rng``) applies hash dropout
at the JAX package's sites in its order: ``KeyGen(rng)`` gives one key per
block; inside a block self-attention takes two sites (the attention site is
taken on the fused path even where its dropout is off), feed-forward one, and
each cross-attending modality two, so the masks are bit-identical to JAX's.
Every site names its batch axis, so that inside a data-parallel rank's
``batch_slice_scope`` (ops/layers.py) its mask is the global batch's rows.
With ``cfg.remat`` a training forward stores only each block's input and
recomputes the block in the backward (``torch.utils.checkpoint``, the JAX
package's ``jax.checkpoint`` with ``nothing_saveable``): memory changes, values
do not. The recompute runs inside the backward, which must therefore run in
the forward's scopes (context parallelism, ``batch_slice_scope``), as
train/steps.py runs it; the block's salt pair is an argument of the block, so
the recompute draws the forward's masks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import kernels
from ..ops.attention import (
    causal_attention,
    cross_causal_attention,
    cross_short_kernel_active,
    fused_qkv_attention_active,
)
from ..ops.layers import KeyGen, batch_slice, dropout, layernorm
from .config import ModelConfig


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with >= f32 accumulation, result in the activation dtype.

    bf16 activations multiply bf16 weights with f32 accumulation on the card.
    On the CPU the product runs in f32 on the f32 weights and rounds to bf16,
    as the JAX package does where the backend lacks mixed bf16 dots."""
    if a.dtype == torch.bfloat16 and a.device.type == "cpu":
        return torch.einsum(eq, a.float(), b.float()).to(torch.bfloat16)
    return torch.einsum(eq, a, b.to(a.dtype))


def _bias(b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(M, N) bias -> (M, 1, 1, N) in the activation dtype."""
    return b.to(dt)[:, None, None, :]


def _qkv_project(h: torch.Tensor, w1, b1, w2, H: int, hs2: int) -> torch.Tensor:
    """One factored tanh-MLP projection (q, k or v) for all modalities and
    heads: h (M, B, T, C) -> (M, B, H, T, hs). The KV-cached path projects
    q, k and v apart so that k and v can go into the cache."""
    M, B, T, _ = h.shape
    t = torch.tanh(_mm("mbtc,mcd->mbtd", h, w1) + _bias(b1, h.dtype)).reshape(M, B, T, H, hs2)
    return _mm("mbthd,mhde->mbhte", t, w2)


def _proj_mlp(out: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """tanh-MLP projection of one modality (2-D weights, any leading axes):
    the KV-cached path's vocab head."""
    dt = out.dtype
    t = torch.tanh(_mm("...d,de->...e", out, w1) + b1.to(dt))
    return _mm("...e,ec->...c", t, w2) + b2.to(dt)


def _qkv_project_fused(h: torch.Tensor, sa: Dict[str, torch.Tensor], H: int, hs2: int):
    """All three factored q/k/v projections in two einsums. h: (M, B, T, C).
    Returns q, k, v: (M, B, H, T, hs)."""
    M, B, T, _ = h.shape
    w1 = torch.cat([sa["w1_q"], sa["w1_k"], sa["w1_v"]], dim=-1)
    b1 = torch.cat([sa["b1_q"], sa["b1_k"], sa["b1_v"]], dim=-1)
    t = _mm("mbtc,mcd->mbtd", h, w1) + _bias(b1, h.dtype)
    t = torch.tanh(t).reshape(M, B, T, 3, H, hs2)
    w2 = torch.stack([sa["w2_q"], sa["w2_k"], sa["w2_v"]])  # (3, M, H, hs2, hs)
    out = _mm("mbtihd,imhde->imbhte", t, w2)
    return out[0], out[1], out[2]


def _proj_mlp_heads(
    att: torch.Tensor, w1, b1, w2, b2, H: int, hs: int, head_major: bool = False
) -> torch.Tensor:
    """tanh-MLP output projection taking attention output in (..., H, T, hs)
    layout; ``head_major=True`` takes (M, H, B, T, hs) / (H, B, T, hs).

    The heads are moved next to hs and flattened to (..., B, T, H*hs), one
    copy (none for T = 1, a decode step), so that both products are plain
    matmuls against the weights as stored: a contraction over (h, e) in one
    einsum copies the weight as well."""
    dt = att.dtype
    att = att.movedim(-4, -2) if head_major else att.transpose(-3, -2)
    out = att.reshape(*att.shape[:-2], H * hs)
    if w1.ndim == 3:  # stacked over modality
        t = torch.tanh(_mm("mbtd,mdc->mbtc", out, w1) + _bias(b1, dt))
        return _mm("mbtc,mcd->mbtd", t, w2) + _bias(b2, dt)
    t = torch.tanh(_mm("btd,dc->btc", out, w1) + b1.to(dt))
    return _mm("btc,cd->btd", t, w2) + b2.to(dt)


def self_attention(
    x_norm: torch.Tensor, sa: Dict[str, torch.Tensor], cfg: ModelConfig,
    keys: KeyGen, train: bool = False,
) -> torch.Tensor:
    """Multi-head self-attention for all modalities (x_norm: (M, B, T, C))."""
    _, _, T, _ = x_norm.shape
    H, hs = cfg.n_head, cfg.head_size
    if fused_qkv_attention_active(T, hs, cfg.attn_impl, x_norm.device):
        w1 = torch.cat([sa["w1_q"], sa["w1_k"], sa["w1_v"]], dim=-1)
        b1 = torch.cat([sa["b1_q"], sa["b1_k"], sa["b1_v"]], dim=-1)
        w2 = torch.cat([sa["w2_q"], sa["w2_k"], sa["w2_v"]], dim=1)
        use_dropout = train and cfg.dropout > 0.0
        k_att = keys()  # taken unconditionally, as in the JAX package
        att_hm = kernels.fused_qkv_attention(
            x_norm.contiguous(), w1.float(), b1.float(), w2.float(), H,
            cfg.dropout if use_dropout else 0.0, k_att if use_dropout else None,
            batch_slice(),
        )  # (M, H, B, T, hs)
        out = _proj_mlp_heads(
            att_hm, sa["proj_w1"], sa["proj_b1"], sa["proj_w2"], sa["proj_b2"],
            H, hs, head_major=True,
        )
        return dropout(out, cfg.dropout, keys(), train, batch_axis=1)
    q, k, v = _qkv_project_fused(x_norm, sa, H, hs // 2)
    att = causal_attention(q, k, v, cfg.attn_impl, cfg.dropout, keys(), train,
                           batch_axis=1)  # (M, B, H, T, hs)
    out = _proj_mlp_heads(
        att, sa["proj_w1"], sa["proj_b1"], sa["proj_w2"], sa["proj_b2"], H, hs
    )
    return dropout(out, cfg.dropout, keys(), train, batch_axis=1)


def cross_attention(
    query_x: torch.Tensor, kv_x: torch.Tensor, cp: Dict[str, torch.Tensor], cfg: ModelConfig,
    keys: KeyGen, train: bool = False,
) -> torch.Tensor:
    """Cross-attention for one modality.

    query_x: (B, T, C), the LN_cross output of the querying modality;
    kv_x: (J, B, T, C), the post-SA/FF activations of the other modalities.
    Where the whole-row cross kernel runs, q and k/v are emitted head-major,
    (H, B, T, hs) and (J, H, B, T, hs), as the JAX package emits them for its
    kernel; elsewhere in its (B, H, T, hs) order. The collapsed rows key the
    attention dropout as the JAX package's do."""
    T = query_x.shape[1]
    H, hs = cfg.n_head, cfg.head_size
    hs_q = cp["q_w"].shape[-1]
    head_major = cross_short_kernel_active(T, hs_q, cfg.attn_impl, query_x.device)
    lead = "hb" if head_major else "bh"
    q = _mm(f"btc,hce->{lead}te", query_x, cp["q_w"])
    k = _mm(f"jbtc,jhcf->j{lead}tf", kv_x, cp["kv_w"][..., :hs_q])
    v = _mm(f"jbtc,jhcf->j{lead}tf", kv_x, cp["kv_w"][..., hs_q:])
    att = cross_causal_attention(q, k, v, cfg.attn_impl, cfg.dropout, keys(), train,
                                 batch_axis=1 if head_major else 0)
    out = _proj_mlp_heads(
        att, cp["proj_w1"], cp["proj_b1"], cp["proj_w2"], cp["proj_b2"],
        H, hs, head_major=head_major,
    )
    return dropout(out, cfg.dropout, keys(), train, batch_axis=0)


def feed_forward(
    x_norm: torch.Tensor, ff: Dict[str, torch.Tensor], cfg: ModelConfig, keys: KeyGen,
    train: bool = False,
) -> torch.Tensor:
    """C -> 4C -> ReLU -> C -> dropout."""
    dt = x_norm.dtype
    h = torch.relu(_mm("mbtc,mcd->mbtd", x_norm, ff["w1"]) + _bias(ff["b1"], dt))
    h = _mm("mbtd,mdc->mbtc", h, ff["w2"]) + _bias(ff["b2"], dt)
    return dropout(h, cfg.dropout, keys(), train, batch_axis=1)


def block_forward(
    x: torch.Tensor, block: Dict[str, Any], key, cfg: ModelConfig, train: bool = False
) -> torch.Tensor:
    """One MultimodalBlock. x: (M, B, T, C); key: the block's salt pair."""
    keys = KeyGen(key)
    x = x + self_attention(
        layernorm(x, block["ln1"]["scale"], block["ln1"]["bias"]), block["sa"], cfg, keys, train
    )
    x = x + feed_forward(
        layernorm(x, block["ln2"]["scale"], block["ln2"]["bias"]), block["ffwd"], cfg, keys, train
    )
    if block["cross"]:
        # the KV inputs are x after SA/FF, frozen for every querying modality
        # before any cross update applies; modalities in the JAX tree's
        # (sorted) key order, which fixes their dropout sites
        updates = {}
        for i_str, cp in sorted(block["cross"].items()):
            i = int(i_str)
            kv_idx = cfg.kv_modalities(i)
            if not kv_idx:
                continue
            kv_x = x[list(kv_idx)]
            y = layernorm(x[i], cp["ln_scale"], cp["ln_bias"])
            updates[i] = x[i] + cross_attention(y, kv_x, cp, cfg, keys, train)
        if updates:
            x = torch.stack([updates.get(i, x[i]) for i in range(cfg.num_modalities)])
    return x


def _round128(n: int) -> int:
    return ((n + 127) // 128) * 128


def embed(params: Dict[str, Any], cfg: ModelConfig, idx: torch.Tensor) -> torch.Tensor:
    """Token + shared positional embedding. idx: (M, B, T) -> (M, B, T, C)."""
    T = idx.shape[-1]
    pos = params["pre"]["pos_emb"][:T]
    Vp = _round128(max(cfg.vocab_sizes))
    tab = torch.stack([F.pad(t, (0, 0, 0, Vp - t.shape[0])) for t in params["pre"]["tok_emb"]])
    if cfg.compute_dtype == "bfloat16":
        tab = tab.to(torch.bfloat16)
        pos = pos.to(torch.bfloat16)
    mods = torch.arange(tab.shape[0], device=idx.device)[:, None, None]
    return tab[mods, idx.long()] + pos


_HEAD_PAD_NEG = -1e30  # padded-class logit; exp underflows to exactly 0.0


def logits_heads_padded(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """All vocab heads in one batched matmul chain over a padded vocab.
    Padded classes get a -1e30 bias through zeroed weight columns, so softmax
    and sampling over the real classes equal the unpadded computation.
    Returns (M, B, T, Vp) logits in f32 (f64 under f64)."""
    post = params["post"]
    Vs = list(cfg.vocab_sizes)
    Vp = _round128(max(Vs))
    Hp = _round128(max(v // 2 for v in Vs))
    heads = post["heads"]
    w1 = torch.stack([F.pad(h["w1"], (0, Hp - h["w1"].shape[1])) for h in heads])
    b1 = torch.stack([F.pad(h["b1"], (0, Hp - h["b1"].shape[0])) for h in heads])
    w2 = torch.stack([
        F.pad(h["w2"], (0, Vp - h["w2"].shape[1], 0, Hp - h["w2"].shape[0])) for h in heads
    ])
    b2 = torch.stack([
        F.pad(h["b2"], (0, Vp - h["b2"].shape[0]), value=_HEAD_PAD_NEG) for h in heads
    ])
    h = layernorm(x, post["ln_scale"], post["ln_bias"])
    dt = h.dtype
    t = torch.tanh(_mm("mbtc,mch->mbth", h, w1) + _bias(b1, dt))
    logits = _mm("mbth,mhv->mbtv", t, w2)
    acc = torch.float64 if dt == torch.float64 else torch.float32
    return logits.to(acc) + b2.to(acc)[:, None, None, :]


def cross_entropy_padded(logits_pad: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-modality mean CE over padded batched logits (M, B, T, Vp), whose
    padded classes carry exactly zero probability; targets (M, B, T).
    Returns (M,)."""
    logp = torch.log_softmax(logits_pad, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return nll.mean(dim=(1, 2))


def forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    idx: torch.Tensor,
    targets: Optional[torch.Tensor] = None,
    rng=None,
    train: bool = False,
) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    """Full forward. idx: (M, B, T) stacked token ids; rng: a raw uint32[2]
    key (needed for dropout in training). Returns (per-modality logits
    (B, T, V_i), per-modality mean losses or None without targets), like the
    JAX ``forward``."""
    keys = KeyGen(rng)
    x = embed(params, cfg, idx)
    for block in params["blocks"]:
        if cfg.remat and train:
            # the non-reentrant form, which torch.autograd.grad can
            # differentiate; dropout is a hash of the salt pair, so the
            # recompute needs no generator state
            x = checkpoint(block_forward, x, block, keys(), cfg, train,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = block_forward(x, block, keys(), cfg, train)
    padded = logits_heads_padded(params, cfg, x)
    logits = [padded[m, ..., :v] for m, v in enumerate(cfg.vocab_sizes)]
    if targets is None:
        return logits, None
    losses = cross_entropy_padded(padded, targets)
    return logits, [losses[m] for m in range(cfg.num_modalities)]


def total_loss(
    params: Dict[str, Any],
    cfg: ModelConfig,
    idx: torch.Tensor,
    targets: torch.Tensor,
    rng=None,
    train: bool = True,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Summed multimodal loss and the per-modality losses."""
    _, losses = forward(params, cfg, idx, targets, rng, train)
    return torch.stack(losses).sum(), losses


def sample_last(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Multinomial draw from the softmax of (B, V) logits -> (B,) int64."""
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(
    params: Dict[str, Any],
    cfg: ModelConfig,
    idx_list: Sequence[torch.Tensor],
    generator: torch.Generator,
    max_new_tokens: int = 1,
    modality_to_generate: int = 0,
) -> List[torch.Tensor]:
    """Autoregressive sampling for one modality, one full forward per token.
    Other modalities stay length-consistent by repeating their last token."""
    seqs = list(idx_list)
    for _ in range(max_new_tokens):
        cond = [s[:, -cfg.block_size:] for s in seqs]
        t = max(c.shape[1] for c in cond)
        # pad shorter streams on the left by repeating their first token
        cond = [
            torch.cat([c[:, :1].expand(-1, t - c.shape[1]), c], dim=1) for c in cond
        ]
        logits_list, _ = forward(params, cfg, torch.stack(cond))
        nxt = sample_last(logits_list[modality_to_generate][:, -1, :], generator)
        seqs[modality_to_generate] = torch.cat(
            [seqs[modality_to_generate], nxt[:, None].to(seqs[modality_to_generate].dtype)],
            dim=1,
        )
        target_len = seqs[modality_to_generate].shape[1]
        for i in range(cfg.num_modalities):
            if i == modality_to_generate:
                continue
            if seqs[i].shape[1] < target_len:
                seqs[i] = torch.cat([seqs[i], seqs[i][:, -1:]], dim=1)
            elif seqs[i].shape[1] > target_len:
                seqs[i] = seqs[i][:, :target_len]
    return seqs
