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
Inside a tensor-parallel rank's ``head_slice_scope`` (ops/layers.py) the
parameters are the rank's parts (parallel/mesh.py ``param_pspecs``), and
each layer runs the Megatron form of its one-rank computation over the
scope's model axis: self- and cross-attention on the rank's heads (their
inputs through ``copy_to``; the output projection's first product split
by rows, its partial sums added in f32 by ``reduce_from`` before its bias
and tanh), the feed-forward split by hidden columns (the sum before its
second bias), the token tables by vocabulary rows (a lookup of the rank's
rows, zeros elsewhere, summed) and the vocabulary heads by hidden columns
(the f32 logits summed before their bias). A leaf the placement keeps
whole (a dimension the axis does not divide) runs as on one rank, with no
collective. Where the axis does not divide the heads (the JAX package's
placement then keeps the per-head leaves ``w2_*``, ``q_w`` and ``kv_w``
whole and splits ``w1_*``, ``b1_*`` and ``proj_w1`` by columns and rows
through the heads), each attention layer gathers its split leaves over the
axis (``ModelAxis.gather``) and runs whole on every rank of the axis, its
masks those of all the heads (h0 = 0), each rank keeping its slice of the
gathered leaves' gradients. Every attention core names its head axis, so
the masks are the global heads'.
Inside a modality-parallel rank's ``mod_slice_scope`` (ops/layers.py) the
batch, the M-stacked leaves (sa, ffwd, ln1, ln2, the post norm) and the
activations hold the rank's modalities [m0, m0 + M / P); the embedding and
the vocabulary heads run on them, every (M, B, ...) dropout site names its
modality axis, so its mask is the global modalities' rows. Before the
cross loop each block gathers x over the modality axis (``ModAxis.gather``,
whose backward sums each modality's gradient onto its owner); the owner of
a querying modality computes its cross update, and every rank advances the
block's ``KeyGen`` over every cross site, its own or not, so the salts of
the sites after it stay the global forward's.
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
from ..ops.layers import (KeyGen, batch_slice, dropout, head_slice, head_slice_scope,
                          layernorm, mod_slice)
from .config import ModelConfig


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with >= f32 accumulation, result in the activation dtype.

    bf16 activations multiply bf16 weights with f32 accumulation on the card.
    On the CPU the product runs in f32 on the f32 weights and rounds to bf16,
    as the JAX package does where the backend lacks mixed bf16 dots."""
    if a.dtype == torch.bfloat16 and a.device.type == "cpu":
        return torch.einsum(eq, a.float(), b.float()).to(torch.bfloat16)
    return torch.einsum(eq, a, b.to(a.dtype))


def _mm_partial(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_mm`` before its rounding: the product in f32 (f64 under f64) of
    the operands ``_mm`` multiplies, a row-split product's share, which the
    model axis sums before the one rounding to the activation dtype."""
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    if a.device.type != "cpu":
        b = b.to(a.dtype)
    return torch.einsum(eq, a.to(acc), b.to(acc))


def _tp_axis():
    """The model axis of an open ``head_slice_scope``, or None."""
    tp = head_slice()
    return None if tp is None else tp[3]


def _mods(M: int) -> Tuple[int, int]:
    """(m0, local count) of the modalities an open ``mod_slice_scope``
    holds, else (0, M)."""
    ms = mod_slice()
    return (0, M) if ms is None else (ms[0], ms[1])


def _whole_heads(leaves: Dict[str, torch.Tensor], whole: Dict[str, Tuple[int, int]], axis
                 ) -> Dict[str, torch.Tensor]:
    """``leaves`` with each one the model axis splits gathered whole:
    ``whole`` maps a leaf's name to (its split dimension, its whole size
    there); a leaf already whole as it is."""
    out = dict(leaves)
    for name, (dim, size) in whole.items():
        if out[name].shape[dim] != size:
            out[name] = axis.gather(out[name], dim)
    return out


# the sites (KeyGen draws) of one cross-attending modality: the core's and
# the output's dropout
CROSS_SITES = 2


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
    att: torch.Tensor, w1, b1, w2, b2, H: int, hs: int, head_major: bool = False, axis=None
) -> torch.Tensor:
    """tanh-MLP output projection taking attention output in (..., H, T, hs)
    layout; ``head_major=True`` takes (M, H, B, T, hs) / (H, B, T, hs).
    ``axis``: the model axis where att and w1 hold the rank's heads; the
    first product's partial sums are then added over it before b1.

    The heads are moved next to hs and flattened to (..., B, T, H*hs), one
    copy (none for T = 1, a decode step), so that both products are plain
    matmuls against the weights as stored: a contraction over (h, e) in one
    einsum copies the weight as well."""
    dt = att.dtype
    att = att.movedim(-4, -2) if head_major else att.transpose(-3, -2)
    out = att.reshape(*att.shape[:-2], H * hs)
    eq = "mbtd,mdc->mbtc" if w1.ndim == 3 else "btd,dc->btc"  # stacked over modality or not
    first = _mm(eq, out, w1) if axis is None else axis.reduce_from(_mm_partial(eq, out, w1)).to(dt)
    if w1.ndim == 3:
        t = torch.tanh(first + _bias(b1, dt))
        return _mm("mbtc,mcd->mbtd", t, w2) + _bias(b2, dt)
    t = torch.tanh(first + b1.to(dt))
    return _mm("btc,cd->btd", t, w2) + b2.to(dt)


def self_attention(
    x_norm: torch.Tensor, sa: Dict[str, torch.Tensor], cfg: ModelConfig,
    keys: KeyGen, train: bool = False,
) -> torch.Tensor:
    """Multi-head self-attention for all modalities (x_norm: (M, B, T, C));
    on a tensor-parallel rank its heads, or where the axis does not divide
    the heads all of them on every rank of the axis; on a
    modality-parallel rank its modalities."""
    _, _, T, _ = x_norm.shape
    H, hs = cfg.n_head, cfg.head_size
    tp, axis = head_slice(), _tp_axis()
    if axis is not None and sa["w2_q"].shape[1] == H:  # the axis does not divide the heads
        # every rank computes the layer whole, proj_w1 gathered as well: its
        # row-split partial sums would leave each rank a share of the whole
        # attention output's gradient, and summing that over the axis (M B T C
        # in f32 a layer) moves about ten times the bytes of the gather
        names =[f"{w}_{g}" for w in ("w1", "b1") for g in "qkv"]
        whole = {n: (sa[n].ndim - 1, H * (hs // 2)) for n in names}
        whole["proj_w1"] = (1, H * hs)
        with head_slice_scope(0, H, H):
            return self_attention(x_norm, _whole_heads(sa, whole, axis), cfg, keys, train)
    if axis is not None:
        H = tp[1]
        x_norm = axis.copy_to(x_norm)
    ms = mod_slice()
    mods = None if ms is None else (ms[0], ms[2])
    if fused_qkv_attention_active(T, hs, cfg.attn_impl, x_norm.device):
        w1 = torch.cat([sa["w1_q"], sa["w1_k"], sa["w1_v"]], dim=-1)
        b1 = torch.cat([sa["b1_q"], sa["b1_k"], sa["b1_v"]], dim=-1)
        w2 = torch.cat([sa["w2_q"], sa["w2_k"], sa["w2_v"]], dim=1)
        use_dropout = train and cfg.dropout > 0.0
        k_att = keys()  # taken unconditionally, as in the JAX package
        att_hm = kernels.fused_qkv_attention(
            x_norm.contiguous(), w1.float(), b1.float(), w2.float(), H,
            cfg.dropout if use_dropout else 0.0, k_att if use_dropout else None,
            batch_slice(), None if tp is None else (tp[0], tp[2]), mods,
        )  # (M, H, B, T, hs)
        out = _proj_mlp_heads(
            att_hm, sa["proj_w1"], sa["proj_b1"], sa["proj_w2"], sa["proj_b2"],
            H, hs, head_major=True, axis=axis,
        )
        return dropout(out, cfg.dropout, keys(), train, batch_axis=1, mod_axis=0)
    q, k, v = _qkv_project_fused(x_norm, sa, H, hs // 2)
    att = causal_attention(q, k, v, cfg.attn_impl, cfg.dropout, keys(), train,
                           batch_axis=1, head_axis=2, mod_axis=0)  # (M, B, H, T, hs)
    out = _proj_mlp_heads(
        att, sa["proj_w1"], sa["proj_b1"], sa["proj_w2"], sa["proj_b2"], H, hs, axis=axis
    )
    return dropout(out, cfg.dropout, keys(), train, batch_axis=1, mod_axis=0)


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
    attention dropout as the JAX package's do. On a tensor-parallel rank its
    heads, or where the axis does not divide the heads all of them on every
    rank of the axis."""
    T = query_x.shape[1]
    H, hs = cfg.n_head, cfg.head_size
    axis = _tp_axis()
    if axis is not None and cp["q_w"].shape[0] == H:  # the axis does not divide the heads
        with head_slice_scope(0, H, H):
            return cross_attention(query_x, kv_x, _whole_heads(cp, {"proj_w1": (0, H * hs)},
                                                               axis), cfg, keys, train)
    if axis is not None:
        H = head_slice()[1]
        query_x, kv_x = axis.copy_to(query_x), axis.copy_to(kv_x)
    hs_q = cp["q_w"].shape[-1]
    head_major = cross_short_kernel_active(T, hs_q, cfg.attn_impl, query_x.device)
    lead = "hb" if head_major else "bh"
    q = _mm(f"btc,hce->{lead}te", query_x, cp["q_w"])
    k = _mm(f"jbtc,jhcf->j{lead}tf", kv_x, cp["kv_w"][..., :hs_q])
    v = _mm(f"jbtc,jhcf->j{lead}tf", kv_x, cp["kv_w"][..., hs_q:])
    att = cross_causal_attention(q, k, v, cfg.attn_impl, cfg.dropout, keys(), train,
                                 batch_axis=1 if head_major else 0,
                                 head_axis=0 if head_major else 1)
    out = _proj_mlp_heads(
        att, cp["proj_w1"], cp["proj_b1"], cp["proj_w2"], cp["proj_b2"],
        H, hs, head_major=head_major, axis=axis,
    )
    return dropout(out, cfg.dropout, keys(), train, batch_axis=0)


def feed_forward(
    x_norm: torch.Tensor, ff: Dict[str, torch.Tensor], cfg: ModelConfig, keys: KeyGen,
    train: bool = False,
) -> torch.Tensor:
    """C -> 4C -> ReLU -> C -> dropout; on a tensor-parallel rank whose
    placement splits the hidden 4C, its columns."""
    dt = x_norm.dtype
    axis = _tp_axis()
    if ff["w1"].shape[-1] == 4 * x_norm.shape[-1]:  # whole
        axis = None
    if axis is not None:
        x_norm = axis.copy_to(x_norm)
    h = torch.relu(_mm("mbtc,mcd->mbtd", x_norm, ff["w1"]) + _bias(ff["b1"], dt))
    if axis is None:
        h = _mm("mbtd,mdc->mbtc", h, ff["w2"]) + _bias(ff["b2"], dt)
    else:
        h = axis.reduce_from(_mm_partial("mbtd,mdc->mbtc", h, ff["w2"])).to(dt)
        h = h + _bias(ff["b2"], dt)
    return dropout(h, cfg.dropout, keys(), train, batch_axis=1, mod_axis=0)


def block_forward(
    x: torch.Tensor, block: Dict[str, Any], key, cfg: ModelConfig, train: bool = False
) -> torch.Tensor:
    """One MultimodalBlock. x: (M, B, T, C) (on a modality-parallel rank its
    modalities); key: the block's salt pair."""
    keys = KeyGen(key)
    x = x + self_attention(
        layernorm(x, block["ln1"]["scale"], block["ln1"]["bias"]), block["sa"], cfg, keys, train
    )
    x = x + feed_forward(
        layernorm(x, block["ln2"]["scale"], block["ln2"]["bias"]), block["ffwd"], cfg, keys, train
    )
    if block["cross"]:
        # the KV inputs are x after SA/FF, frozen for every querying modality
        # before any cross update applies (all modalities': gathered over a
        # modality axis); modalities in the JAX tree's (sorted) key order,
        # which fixes their dropout sites
        # (the block's output is taken from the gathered x, so that every
        # rank's backward runs the gather's reduce-scatter, cross-attending
        # modality or not)
        ms = mod_slice()
        m0, per = _mods(x.shape[0])
        full = x if ms is None else ms[3].gather(x)
        updates = {}
        for i_str, cp in sorted(block["cross"].items()):
            i = int(i_str)
            kv_idx = cfg.kv_modalities(i)
            if not kv_idx:
                continue
            if not m0 <= i < m0 + per:  # another rank's: its sites still drawn
                for _ in range(CROSS_SITES):
                    keys()
                continue
            kv_x = full[list(kv_idx)]
            y = layernorm(full[i], cp["ln_scale"], cp["ln_bias"])
            updates[i] = full[i] + cross_attention(y, kv_x, cp, cfg, keys, train)
        if updates or ms is not None:
            x = torch.stack([updates.get(i, full[i]) for i in range(m0, m0 + per)])
    return x


def _round128(n: int) -> int:
    return ((n + 127) // 128) * 128


def embed(params: Dict[str, Any], cfg: ModelConfig, idx: torch.Tensor) -> torch.Tensor:
    """Token + shared positional embedding. idx: (M, B, T) -> (M, B, T, C)
    (on a modality-parallel rank its modalities' rows and tables)."""
    T = idx.shape[-1]
    pos = params["pre"]["pos_emb"][:T]
    if cfg.compute_dtype == "bfloat16":
        pos = pos.to(torch.bfloat16)
    m0, per = _mods(idx.shape[0])
    tables = params["pre"]["tok_emb"][m0:m0 + per]
    axis = _tp_axis()
    if axis is not None:
        return _embed_tp(tables, cfg.vocab_sizes[m0:m0 + per], cfg, idx, axis) + pos
    Vp = _round128(max(cfg.vocab_sizes))
    tab = torch.stack([F.pad(t, (0, 0, 0, Vp - t.shape[0])) for t in tables])
    if cfg.compute_dtype == "bfloat16":
        tab = tab.to(torch.bfloat16)
    mods = torch.arange(tab.shape[0], device=idx.device)[:, None, None]
    return tab[mods, idx.long()] + pos


def _embed_tp(tables, vocab_sizes, cfg: ModelConfig, idx: torch.Tensor, axis) -> torch.Tensor:
    """The token rows on a tensor-parallel rank: of a table split by
    vocabulary rows, the lookup of the rank's rows (an index outside them
    reads an appended zero row), summed over the axis (one non-zero addend:
    exact); a whole table's lookup as on one rank. (M, B, T, C)."""
    rows, split = [], []
    for i, (t, V) in enumerate(zip(tables, vocab_sizes)):
        if cfg.compute_dtype == "bfloat16":
            t = t.to(torch.bfloat16)
        ids = idx[i].long()
        if t.shape[0] != V:
            per = t.shape[0]
            local = ids - axis.rank * per
            ids = torch.where((local >= 0) & (local < per), local, per)
            t = F.pad(t, (0, 0, 0, 1))
            split.append(i)
        rows.append(t[ids])
    if split:
        summed = iter(axis.reduce_from(torch.stack([rows[i] for i in split])).unbind(0))
        rows = [next(summed) if i in split else r for i, r in enumerate(rows)]
    return torch.stack(rows)


_HEAD_PAD_NEG = -1e30  # padded-class logit; exp underflows to exactly 0.0


def logits_heads_padded(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """All vocab heads in one batched matmul chain over a padded vocab.
    Padded classes get a -1e30 bias through zeroed weight columns, so softmax
    and sampling over the real classes equal the unpadded computation.
    On a tensor-parallel rank the heads its placement splits by hidden
    columns run as a second batch over their local columns (the LN output
    through ``copy_to``), whose f32 partial logits the axis sums, then
    rounded where the one-rank product rounds them, before b2. On a
    modality-parallel rank its modalities' heads (x and the post norm its
    modalities').
    Returns (M, B, T, Vp) logits in f32 (f64 under f64)."""
    post = params["post"]
    m0, per = _mods(x.shape[0])
    heads = post["heads"][m0:m0 + per]
    Vs = list(cfg.vocab_sizes[m0:m0 + per])
    Vp = _round128(max(cfg.vocab_sizes))
    h = layernorm(x, post["ln_scale"], post["ln_bias"])
    dt = h.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    axis = _tp_axis()
    split = [] if axis is None else [i for i, hd in enumerate(heads)
                                     if hd["w1"].shape[1] != Vs[i] // 2]
    whole = [i for i in range(len(heads)) if i not in split]
    outs = []
    for group, part in ((split, True), (whole, False)):
        if not group:
            continue
        Hp = _round128(max(heads[i]["w1"].shape[1] for i in group))
        w1 = torch.stack([F.pad(heads[i]["w1"], (0, Hp - heads[i]["w1"].shape[1])) for i in group])
        b1 = torch.stack([F.pad(heads[i]["b1"], (0, Hp - heads[i]["b1"].shape[0])) for i in group])
        w2 = torch.stack([F.pad(heads[i]["w2"], (0, Vp - heads[i]["w2"].shape[1],
                                                 0, Hp - heads[i]["w2"].shape[0])) for i in group])
        hx = h if len(group) == len(heads) else h[group]
        if part:
            hx = axis.copy_to(hx)
        t = torch.tanh(_mm("mbtc,mch->mbth", hx, w1) + _bias(b1, dt))
        if part:
            outs.append((group, axis.reduce_from(_mm_partial("mbth,mhv->mbtv", t, w2)).to(dt)))
        else:
            outs.append((group, _mm("mbth,mhv->mbtv", t, w2)))
    if len(outs) == 1:
        logits = outs[0][1]
    else:
        by_modality = {i: o for group, out in outs for i, o in zip(group, out.unbind(0))}
        logits = torch.stack([by_modality[i] for i in range(len(heads))])
    b2 = torch.stack([
        F.pad(hd["b2"], (0, Vp - hd["b2"].shape[0]), value=_HEAD_PAD_NEG) for hd in heads
    ])
    return logits.to(acc) + b2.to(acc)[:, None, None, :]


def logits_heads(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor) -> List[torch.Tensor]:
    """Per-modality logits (B, T, V_i): the list view of
    ``logits_heads_padded`` over each modality's real classes."""
    m0, per = _mods(x.shape[0])
    padded = logits_heads_padded(params, cfg, x)
    return [padded[m, ..., :v] for m, v in enumerate(cfg.vocab_sizes[m0:m0 + per])]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token-level CE of one modality's unpadded logits (B, T, V) over
    every position (the pipelined loss's form)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


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
    JAX ``forward``; on a modality-parallel rank its modalities' (idx and
    targets its rows)."""
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
    m0, per = _mods(idx.shape[0])
    logits = [padded[m, ..., :v] for m, v in enumerate(cfg.vocab_sizes[m0:m0 + per])]
    if targets is None:
        return logits, None
    losses = cross_entropy_padded(padded, targets)
    return logits, [losses[m] for m in range(per)]


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
