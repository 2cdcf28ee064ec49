"""KV-cached incremental decoding for serving (port of the JAX package's
``models/cache.py``).

``generate_fast`` recomputes the full context window for every new token.
This module caches each block's attention keys and values so that a new
token costs one single-position forward against the cache.

Exactness: the model embeds absolute positions 0..T-1 of a window cropped to
``block_size``. While the context grows toward ``block_size`` the window
start stays at 0 and cached decoding computes what the full forward computes
(``generate_cached``; past a full window it finishes with the full-window
sampler). ``generate_serve`` goes on past that point with a chunked refresh:
every ``refresh`` tokens it rebuilds the cache from the last ``block_size -
refresh`` tokens at positions 0..block_size-refresh-1 and decodes the next
``refresh`` tokens against it, a sliding-window approximation that is opt-in.

Cache layout per block, leaf for leaf the JAX package's (S = block_size,
pack = ``cache_pack(hs, S)``, 2 at the production config):
  sa_k / sa_v: (M, B, H, S/pack, pack*hs) self-attention keys / values;
  sa_k_tail / sa_v_tail: (M, B, H, pack, hs) the last ``pack`` written
  positions in the activation type (pack > 1);
  sa_k_scale / sa_v_scale: (M, B, H, S/pack) f32, one scale per packed row
  (int8 caches);
  cross[i]["k" / "v" / "k_tail" / "v_tail" / "k_scale" / "v_scale"]: the
  same for modality i's cross-attention over its J key/value modalities,
  with J in place of M.
Position c lies at row c // pack, lane block c % pack: the packed array is
the row-major (..., S, hs) array itself. Every append rebuilds its whole
packed row from the tail, as the JAX package does (an int8 row requantizes
from full-precision values), so the caches agree with JAX's bit for bit. The
port updates the cache tensors in place; ``forward_cached`` returns the same
list it was given.

Prefill (``prefill=True``, start 0, an empty cache) runs self-attention
through ``ops.attention.causal_attention`` and cross-attention through
``cross_causal_attention`` over the new tokens (on the card the K3f and K2f
kernels in the whole-row band, K5f and K6f in the flash band: a --serve chunk
at block_size 1024 prefills 896 tokens). A single-position decode step on the card runs one
of the three decode kernels per attention (ops/kernels.py: the packed, the
packed int8 or the plain layout), which read the position from a
one-element int32 tensor on the device; everywhere else the dense masked
expression runs. The cached path keeps the JAX package's own bf16 rounding
points, which differ from the full forward's: ``embed_at`` adds token and
position embeddings in f32 before rounding, and the head adds its output
bias in the activation type.

The JAX package fuses its steady chunks into one device program
(``_serve_chunks``) to save dispatches on the TPU; that changes no token. The
port runs one chunk loop.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops import kernels
from ..ops.attention import causal_attention, cross_causal_attention
from ..ops.layers import KeyGen, layernorm
from .config import ModelConfig
from .sampler import generate_fast
from .transformer import (
    _mm,
    _proj_mlp,
    _proj_mlp_heads,
    _qkv_project,
    feed_forward,
    logits_heads_padded,
    sample_last,
)


def cache_pack(hs: int, S: int) -> int:
    """Positions per packed row: 128 // hs when hs divides 128 and S packs
    into whole rows, a multiple of 8 of them; else 1 (plain layout)."""
    if hs >= 128 or 128 % hs != 0:
        return 1
    pack = 128 // hs
    if S % pack != 0 or (S // pack) % 8 != 0:
        return 1
    return pack


def init_cache(
    cfg: ModelConfig, batch: int, params: Dict[str, Any], kv_dtype: Optional[str] = None,
) -> List[Dict]:
    """Zero-filled cache, one dict per block, on the parameters' device.

    ``kv_dtype='int8'`` (packed layouts only) stores keys and values as int8
    with one f32 scale per packed row: an approximation for serving."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    M, H, S, hs = cfg.num_modalities, cfg.n_head, cfg.block_size, cfg.head_size
    dt, dev = cfg.cdtype, params["pre"]["pos_emb"].device
    pack = cache_pack(hs, S)
    q8 = kv_dtype == "int8"
    if q8 and pack == 1:
        raise ValueError(
            "kv_dtype='int8' requires the packed cache layout "
            f"(head_size {hs} / block_size {S} pack to {pack})"
        )
    store_dt = torch.int8 if q8 else dt

    def leaves(lead: int, names: Tuple[str, str, str]) -> Dict[str, torch.Tensor]:
        k, tail, scale = names
        out = {}
        for kv in ("k", "v"):
            out[k.format(kv)] = torch.zeros((lead, batch, H, S // pack, pack * hs),
                                            dtype=store_dt, device=dev)
            if pack > 1:
                out[tail.format(kv)] = torch.zeros((lead, batch, H, pack, hs), dtype=dt,
                                                   device=dev)
            if q8:
                out[scale.format(kv)] = torch.zeros((lead, batch, H, S // pack),
                                                    dtype=torch.float32, device=dev)
        return out

    caches = []
    for block in params["blocks"]:
        bc: Dict[str, Any] = leaves(M, ("sa_{}", "sa_{}_tail", "sa_{}_scale"))
        bc["cross"] = {}
        for i_str in block["cross"] or {}:
            kv_idx = cfg.kv_modalities(int(i_str))
            if kv_idx:
                bc["cross"][i_str] = leaves(len(kv_idx), ("{}", "{}_tail", "{}_scale"))
        caches.append(bc)
    return caches


def _quantize_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., r, pack*hs) -> (int8 rows, (..., r) f32 scales max|row| + 1e-12).
    127 / scale is one f32 division, as in the JAX package (Python's
    ``127.0 / tensor`` would multiply by a rounded reciprocal instead)."""
    a = rows.float()
    scale = a.abs().amax(dim=-1) + 1e-12
    inv = torch.full_like(scale, 127.0) / scale
    q = torch.clamp(torch.round(a * inv[..., None]), -127.0, 127.0).to(torch.int8)
    return q, scale


def _cache_append(c, tail, new, start: int, scale=None):
    """Write ``new`` (..., t, hs) at positions start..start+t-1 of cache ``c``
    in place; returns ``(c, tail, scale)`` with a new tail.

    Plain layout (pack == 1): one slice write (``tail`` is returned as is).
    Packed layout: whole packed rows are written. A position that starts or
    ends a partial row rebuilds that row from the tail of the last ``pack``
    positions (lane blocks past pos % pack hold the tail's older values,
    which the pos mask hides; an int8 row zeroes them so that its scale
    covers live lanes only); whole rows of a prefill are written in bulk.
    int8 rows quantize with one scale each (``scale`` is updated in place)."""
    hs, t = new.shape[-1], new.shape[-2]
    pack = c.shape[-1] // hs
    q8 = c.dtype == torch.int8
    if not q8:
        new = new.to(c.dtype)
    if pack == 1:
        c[..., start:start + t, :] = new
        return c, tail, scale

    def store_rows(rows, row0):
        if q8:
            rows, rscale = _quantize_rows(rows)
            scale[..., row0:row0 + rows.shape[-2]] = rscale
        c[..., row0:row0 + rows.shape[-2], :] = rows

    def write_one(tail, tok, pos):
        tail = torch.cat([tail[..., 1:, :], tok.to(tail.dtype)], dim=-2)
        # tail[k] holds position pos - (pack - 1) + k; lane block j of the
        # row holds position pos - pos % pack + j: roll by pos % pack + 1
        row = torch.roll(tail, pos % pack + 1, dims=-2)
        if q8:
            row[..., pos % pack + 1:, :] = 0
        store_rows(row.reshape(*row.shape[:-2], 1, pack * hs), pos // pack)
        return tail

    lead = min((-start) % pack, t)  # a leading partial row
    for i in range(lead):
        tail = write_one(tail, new[..., i:i + 1, :], start + i)
    rest = new[..., lead:, :]
    start, t = start + lead, t - lead
    bulk = (t // pack) * pack
    if bulk:
        store_rows(rest[..., :bulk, :].reshape(*rest.shape[:-2], bulk // pack, pack * hs),
                   start // pack)
        tail = torch.cat([tail, rest[..., :bulk, :].to(tail.dtype)], dim=-2)[..., -pack:, :]
    for i in range(bulk, t):  # a trailing partial row
        tail = write_one(tail, rest[..., i:i + 1, :], start + i)
    return c, tail, scale


def _decode_packed_eligible(hs: int, kc: torch.Tensor) -> bool:
    """The JAX package's ``decode_attention_packed_eligible``: 128-wide packed
    rows, hs < 128 dividing 128, a multiple of 8 rows."""
    return kc.shape[-1] == 128 and hs < 128 and 128 % hs == 0 and kc.shape[-2] % 8 == 0


def _decode_eligible(hs: int, kc: torch.Tensor) -> bool:
    """The JAX package's ``decode_attention_eligible`` for a plain cache."""
    return hs <= 256 and kc.shape[-2] % 8 == 0


def _decode_kernel_active(kc: torch.Tensor, t_new: int, impl: str) -> bool:
    """True when a cached attention runs a decode kernel: one new position,
    a cache on the card, ``attn_impl`` not 'jnp'."""
    return t_new == 1 and kc.device.type == "cuda" and impl != "jnp"


def _attn_cached(q, kc, vc, start: int, t_new: int, k_scale=None, v_scale=None,
                 impl: str = "auto", pos=None):
    """Masked attention of ``t_new`` new queries (..., t_new, hs) at positions
    start..start+t_new-1 against a packed or plain cache: column c visible
    iff c <= the row's position. ``pos`` is ``start`` as a one-element int32
    tensor on the card, for the decode kernels.

    A single-position step on the card (``attn_impl`` not 'jnp') runs one
    decode kernel where the JAX package's eligibility holds; else the dense
    expression: f32 scores and softmax, probabilities rounded to the
    activation type before P.V, f32 accumulation, the result in q's type."""
    hs = q.shape[-1]
    q8 = kc.dtype == torch.int8
    if _decode_kernel_active(kc, t_new, impl):
        qb = q.expand(*kc.shape[:-2], *q.shape[-2:]).contiguous()
        pos = start if pos is None else pos
        if q8 and _decode_packed_eligible(hs, kc):
            return kernels.decode_attention_packed_q8(qb, kc, vc, k_scale, v_scale, pos)
        if not q8 and kc.shape[-1] != hs and _decode_packed_eligible(hs, kc):
            return kernels.decode_attention_packed(qb, kc, vc, pos)
        if not q8 and kc.shape[-1] == hs and _decode_eligible(hs, kc):
            return kernels.decode_attention(qb, kc, vc, pos)
    if q8:
        kc = (kc.float() * (k_scale[..., None] * kernels.INV127)).to(q.dtype)
        vc = (vc.float() * (v_scale[..., None] * kernels.INV127)).to(q.dtype)
    kc, vc = kernels.unpack_cache(kc, hs), kernels.unpack_cache(vc, hs)
    dt = q.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    s = torch.matmul(q.to(acc), kc.to(acc).transpose(-1, -2)) * hs ** -0.5
    rows = start + torch.arange(t_new, device=q.device)
    cols = torch.arange(kc.shape[-2], device=q.device)
    p = torch.softmax(s.masked_fill(cols[None, :] > rows[:, None], float("-inf")), dim=-1)
    return torch.matmul(p.to(dt).to(acc), vc.to(acc)).to(dt)


def _sa_cached(x_norm, sa, cfg: ModelConfig, entry, start: int, prefill: bool = False,
               pos=None):
    """Self-attention with cache append. x_norm: (M, B, t, C).

    ``prefill=True`` (start 0, an empty cache) runs the attention over the
    new tokens through ``causal_attention``: with an empty cache the
    visibility mask is plain causal over them."""
    t = x_norm.shape[2]
    H, hs = cfg.n_head, cfg.head_size
    hs2 = hs // 2
    k_new = _qkv_project(x_norm, sa["w1_k"], sa["b1_k"], sa["w2_k"], H, hs2)
    q = _qkv_project(x_norm, sa["w1_q"], sa["b1_q"], sa["w2_q"], H, hs2)
    v_new = _qkv_project(x_norm, sa["w1_v"], sa["b1_v"], sa["w2_v"], H, hs2)
    kc, ktl, ksc = _cache_append(entry["sa_k"], entry.get("sa_k_tail"), k_new, start,
                                 entry.get("sa_k_scale"))
    vc, vtl, vsc = _cache_append(entry["sa_v"], entry.get("sa_v_tail"), v_new, start,
                                 entry.get("sa_v_scale"))
    if ktl is not None:
        entry["sa_k_tail"], entry["sa_v_tail"] = ktl, vtl
    if prefill:
        att = causal_attention(q, k_new, v_new, cfg.attn_impl)
    else:
        att = _attn_cached(q, kc, vc, start, t, ksc, vsc, cfg.attn_impl, pos)  # (M, B, H, t, hs)
    return _proj_mlp_heads(att, sa["proj_w1"], sa["proj_b1"], sa["proj_w2"], sa["proj_b2"], H, hs)


def _cross_cached(y, kv_x_new, cp, cfg: ModelConfig, entry, start: int,
                  prefill: bool = False, pos=None):
    """Cross-attention with cache append. y: (B, t, C), the LN_cross output
    of the querying modality; kv_x_new: (J, B, t, C), the new positions'
    post-SA/FF activations of its key/value modalities. Each stream's
    attention is rounded to the activation type, then the streams are
    summed."""
    t = y.shape[1]
    hs = cp["q_w"].shape[-1]
    q = _mm("btc,hce->bhte", y, cp["q_w"])  # (B, H, t, hs)
    k_new = _mm("jbtc,jhcf->jbhtf", kv_x_new, cp["kv_w"][..., :hs])
    v_new = _mm("jbtc,jhcf->jbhtf", kv_x_new, cp["kv_w"][..., hs:])
    kc, ktl, ksc = _cache_append(entry["k"], entry.get("k_tail"), k_new, start,
                                 entry.get("k_scale"))
    vc, vtl, vsc = _cache_append(entry["v"], entry.get("v_tail"), v_new, start,
                                 entry.get("v_scale"))
    if ktl is not None:
        entry["k_tail"], entry["v_tail"] = ktl, vtl
    if prefill:
        att = cross_causal_attention(q, k_new, v_new, cfg.attn_impl)
    else:
        att = _attn_cached(q[None], kc, vc, start, t, ksc, vsc, cfg.attn_impl, pos).sum(dim=0)
    return _proj_mlp_heads(att, cp["proj_w1"], cp["proj_b1"], cp["proj_w2"], cp["proj_b2"],
                           cfg.n_head, hs)  # att: (B, H, t, hs)


def block_forward_cached(x, block, cache, start: int, cfg: ModelConfig,
                         prefill: bool = False, pos=None):
    """One MultimodalBlock over the new positions only, reading and writing
    the block's cache. Same update order as ``block_forward``: x += SA(LN1(x));
    x += FF(LN2(x)); cross-attention reads the post-SA/FF x. Inference only."""
    keys = KeyGen(None)
    x = x + _sa_cached(layernorm(x, block["ln1"]["scale"], block["ln1"]["bias"]),
                       block["sa"], cfg, cache, start, prefill, pos)
    x = x + feed_forward(layernorm(x, block["ln2"]["scale"], block["ln2"]["bias"]),
                         block["ffwd"], cfg, keys, False)
    if block["cross"]:
        updates = {}
        for i_str, cp in block["cross"].items():
            i = int(i_str)
            kv_idx = cfg.kv_modalities(i)
            if not kv_idx:
                continue
            y = layernorm(x[i], cp["ln_scale"], cp["ln_bias"])
            updates[i] = x[i] + _cross_cached(y, x[list(kv_idx)], cp, cfg, cache["cross"][i_str],
                                              start, prefill, pos)
        if updates:
            x = torch.stack([updates.get(i, x[i]) for i in range(cfg.num_modalities)])
    return x


def embed_at(params: Dict[str, Any], cfg: ModelConfig, idx: torch.Tensor, start: int):
    """Token + position embedding of positions start..start+t-1, added in the
    parameters' type and then rounded to the activation type. idx: (M, B, t)."""
    t = idx.shape[-1]
    pos = params["pre"]["pos_emb"][start:start + t]
    x = torch.stack([params["pre"]["tok_emb"][m][idx[m].long()] + pos
                     for m in range(cfg.num_modalities)])
    if cfg.compute_dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    return x


def forward_cached(
    params: Dict[str, Any],
    cfg: ModelConfig,
    idx: torch.Tensor,
    cache: List[Dict],
    start: int,
    head_modality: Optional[int] = None,
    prefill: bool = False,
) -> Tuple[Any, List[Dict]]:
    """Forward over the new positions start..start+t-1 only. idx: (M, B, t).

    Returns (logits, cache): the last position's logits of ``head_modality``
    (B, V) in f32 when it is given, else the per-modality list of (B, t, V)
    logits; the cache is updated in place. ``prefill=True`` needs start 0 and
    an empty cache."""
    x = embed_at(params, cfg, idx, start)
    pos = None
    if idx.shape[-1] == 1 and x.device.type == "cuda":
        pos = torch.full((1,), start, dtype=torch.int32, device=x.device)
    for block, bc in zip(params["blocks"], cache):
        x = block_forward_cached(x, block, bc, start, cfg, prefill, pos)
    if head_modality is None:
        padded = logits_heads_padded(params, cfg, x)
        return [padded[m, ..., :v] for m, v in enumerate(cfg.vocab_sizes)], cache
    post, m = params["post"], head_modality
    h = layernorm(x[m][:, -1:, :], post["ln_scale"][m], post["ln_bias"][m])
    head = post["heads"][m]
    logits = _proj_mlp(h, head["w1"], head["b1"], head["w2"], head["b2"])[:, 0, :]
    if logits.dtype == torch.bfloat16:
        logits = logits.float()
    return logits, cache


def _prefill(params, cfg: ModelConfig, idx: torch.Tensor, modality_to_generate: int,
            kv_dtype: Optional[str] = None):
    """A fresh cache filled from the prompt idx (M, B, t); returns the last
    position's logits of the generated modality and the cache."""
    cache = init_cache(cfg, idx.shape[1], params, kv_dtype)
    return forward_cached(params, cfg, idx, cache, 0, modality_to_generate, prefill=True)


def _decode_steps(params, cfg: ModelConfig, cache, start: int, logits, last_col: torch.Tensor,
                 generator: torch.Generator, modality_to_generate: int, n_steps: int):
    """``n_steps`` cached decode steps from position ``start``: each samples
    the next token from the carried logits (one ``torch.multinomial`` draw,
    as ``generate_fast`` draws), builds the new column (the other modalities
    repeat their last token) and runs one forward at that position for the
    next logits. Returns (the columns (M, B, n_steps), the last logits)."""
    cols, col = [], last_col
    for pos in range(start, start + n_steps):
        col = col.clone()
        col[modality_to_generate] = sample_last(logits, generator).to(col.dtype)
        logits, cache = forward_cached(params, cfg, col[:, :, None], cache, pos,
                                       modality_to_generate)
        cols.append(col)
    return torch.stack(cols, dim=-1), logits


def _check_ids(idx: torch.Tensor) -> None:
    if idx.ndim != 3:
        raise ValueError("idx must be (num_modalities, B, T) stacked ids")


@torch.inference_mode()
def generate_cached(
    params: Dict[str, Any],
    cfg: ModelConfig,
    idx: torch.Tensor,
    generator: torch.Generator,
    max_new_tokens: int = 1,
    modality_to_generate: int = 0,
) -> torch.Tensor:
    """Token-exact generation: one cached forward per token while the window
    grows toward ``block_size``, then the full-window sampler for the rest.
    idx: (M, B, T0). Returns (M, B, T0 + max_new_tokens), the tokens of
    ``generate_fast`` for the same generator state."""
    _check_ids(idx)
    seq, t0, S = idx, idx.shape[-1], cfg.block_size
    n_cached = max(0, min(max_new_tokens, S - t0))
    if n_cached > 0:
        logits, cache = _prefill(params, cfg, seq, modality_to_generate)
        cols, _ = _decode_steps(params, cfg, cache, t0, logits, seq[:, :, -1], generator,
                               modality_to_generate, n_cached)
        seq = torch.cat([seq, cols], dim=-1)
    remaining = max_new_tokens - n_cached
    if remaining > 0:
        window = seq[:, :, -S:]
        if window.shape[-1] < S:
            return seq
        out = generate_fast(params, cfg, window, generator, remaining, modality_to_generate)
        seq = torch.cat([seq, out[:, :, S:]], dim=-1)
    return seq


@torch.inference_mode()
def generate_serve(
    params: Dict[str, Any],
    cfg: ModelConfig,
    idx: torch.Tensor,
    generator: torch.Generator,
    max_new_tokens: int,
    modality_to_generate: int = 0,
    refresh: Optional[int] = None,
    kv_dtype: Optional[str] = None,
) -> torch.Tensor:
    """Serving-mode generation: cached decode everywhere, a chunked refresh
    once the window is full (not token-exact past that point, see the module
    docstring). ``refresh`` defaults to block_size // 8 (at least 1) and must
    be below block_size. ``kv_dtype='int8'`` quantizes the cache.

    The phases: exact cached steps while the window grows; then chunks, each
    a prefill over the last S - refresh tokens at positions 0..S-refresh-1
    and ``refresh`` cached steps; a shorter last chunk where the tokens run
    out. idx: (M, B, T0); returns (M, B, T0 + max_new_tokens)."""
    _check_ids(idx)
    S = cfg.block_size
    refresh = max(1, refresh if refresh is not None else S // 8)
    if refresh >= S:
        raise ValueError("refresh must be < block_size")
    seq, t0, mod = idx, idx.shape[-1], modality_to_generate
    n_exact = max(0, min(max_new_tokens, S - t0))
    if n_exact > 0:
        logits, cache = _prefill(params, cfg, seq, mod, kv_dtype)
        cols, _ = _decode_steps(params, cfg, cache, t0, logits, seq[:, :, -1], generator, mod,
                               n_exact)
        seq = torch.cat([seq, cols], dim=-1)
    produced, W = n_exact, S - refresh
    while produced < max_new_tokens:
        n = min(refresh, max_new_tokens - produced)
        logits, cache = _prefill(params, cfg, seq[:, :, -W:], mod, kv_dtype)
        cols, _ = _decode_steps(params, cfg, cache, W, logits, seq[:, :, -1], generator, mod, n)
        seq = torch.cat([seq, cols], dim=-1)
        produced += n
    return seq
