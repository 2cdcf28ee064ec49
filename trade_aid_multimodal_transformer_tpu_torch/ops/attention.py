"""Causal attention cores and their dispatch (port of the JAX package's
``ops/attention.py``).

    aff = q @ k^T * head_size**-0.5 ; causal mask ; softmax ; dropout ; aff @ v

The dense cores are the counterparts of ``causal_attention_jnp`` and of the
dense cross core ``causal_attention_jnp(q[None], k, v).sum(0)``: f32 scores
and softmax (f64 for f64 inputs), hash dropout on the normalised affinity,
probabilities cast to the value dtype before P.V. On the CPU bf16 inputs run
the whole core in f32, as the JAX package does where the backend lacks mixed
bf16 dots. The dispatch keeps the JAX package's order for CUDA tensors: the
whole-row kernels (ops/kernels.py, with in-kernel dropout) for 8 <= T <= 512,
T % 8 == 0 and hs <= 256 (hs even for the fused self-attention; over one
packed q|k|v operand in ``causal_attention_packed``); then the flash kernels
for T >= 256, T % 128 == 0 and hs <= 256 (so above 512); the dense cores
everywhere else, as the JAX package leaves shapes outside both to XLA.
``attn_impl: jnp`` keeps the dense cores on the card too. Cached decode
attention (one query position against the KV cache) dispatches in
models/cache.py. A core given its batch axis (``batch_axis``) keys its
dropout by global batch rows inside a data-parallel rank's
``layers.batch_slice_scope``, given its head axis (``head_axis``) by
global heads inside a tensor-parallel rank's ``layers.head_slice_scope``,
and given its modality axis (``mod_axis``, self-attention's leading M) by
global modalities inside a modality-parallel rank's
``layers.mod_slice_scope``, in the dense cores and the kernels alike.

Inside ``context_parallel_scope`` (opened by the context-parallel trainer,
``tpu_options.context_parallel``) both cores route through ring attention
(parallel/ring_attention.py) over the scope's sequence group, as the JAX
package's scope does, and the whole-row kernels are off. With a data axis
(data x sequence) the ring keys its masks by local rows and the dropout key
folded with the data rank, as the JAX package's ``shard_map`` body does;
with a model axis (model x sequence) by local heads too, the key folded
with the data rank and then the model rank, as that body does wherever
the axis is larger than 1 (where it does not divide the heads every rank
rings every head, the key folded with place 0: parallel/trainer.py). The
global-row and global-head maps of the scopes never reach the ring. With
a modality axis (modality x sequence)
the JAX body sees every modality and folds no modality place, so a
modality-parallel rank's self-attention ring keys its rows by their index
in the whole M: the chunk kernels' row base m0 B H (B and H the ring's
local sizes), the modality level of ``layers.mod_slice_scope``; the cross
rings run per querying modality and need none. The ring's chunk
core is ``chunk_fwd`` / ``chunk_bwd``: the chunk kernels K7f / K7b where the
chunk is at least 256 long and eligible on the card (``attn_impl: pallas``:
wherever eligible; on the CPU that is their plain version), the dense mirror
``chunk_fwd_dense`` / ``chunk_bwd_dense`` elsewhere or under ``attn_impl:
jnp``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch

from . import kernels
from .layers import batch_row_map, dropout, mix32_const, mod_slice


def causal_attention_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_key: Optional[Sequence[int]] = None,
    train: bool = False,
    batch_axis: Optional[int] = None,
    head_axis: Optional[int] = None,
    mod_axis: Optional[int] = None,
) -> torch.Tensor:
    """Dense causal attention over trailing (T, head_size) axes. Leading axes
    broadcast (q may have fewer leading dims than k/v); ``batch_axis``,
    ``head_axis`` and ``mod_axis`` are q's batch, head and modality axes
    (counted from the left of q's shape)."""
    dt = q.dtype
    if dt == torch.bfloat16 and q.device.type == "cpu":
        return causal_attention_dense(
            q.float(), k.float(), v.float(), dropout_rate, dropout_key, train, batch_axis,
            head_axis, mod_axis,
        ).to(dt)
    acc = torch.float64 if dt == torch.float64 else torch.float32
    t_q, t_k = q.shape[-2], k.shape[-2]
    scale = k.shape[-1] ** -0.5
    aff = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
    aff = torch.softmax(aff.masked_fill(~mask, float("-inf")), dim=-1)
    shift = aff.ndim - q.ndim
    aff = dropout(aff, dropout_rate, dropout_key, train,
                  None if batch_axis is None else batch_axis + shift,
                  None if head_axis is None else head_axis + shift,
                  None if mod_axis is None else mod_axis + shift)
    return torch.matmul(aff.to(v.dtype).to(acc), v.to(acc)).to(dt)


def _kernel_device(device: torch.device, impl: str) -> bool:
    if impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"Unknown attention impl: {impl}")
    return impl != "jnp" and device.type == "cuda"


# ------------------------------------------------- context-parallel dispatch

_CP_SCOPE = None  # (sequence group (parallel.mesh.SeqMesh), data rank, model rank) of an open scope


@contextlib.contextmanager
def context_parallel_scope(mesh, data_rank: Optional[int] = None,
                           model_rank: Optional[int] = None):
    """Route causal and cross attention through ring attention over
    ``mesh`` (a ``parallel.mesh.SeqMesh``) while the scope is open.
    ``data_rank`` and ``model_rank``: this rank's places on a data and a
    model axis of more than one rank (data x sequence, model x sequence),
    whose indices the rings' dropout keys are folded with, in that order."""
    global _CP_SCOPE
    prev = _CP_SCOPE
    _CP_SCOPE = (mesh, data_rank, model_rank)
    try:
        yield
    finally:
        _CP_SCOPE = prev


def _cp_active(q: torch.Tensor):
    """The scope's (mesh, data rank, model rank) where it shards q's
    sequence axis, else None."""
    if _CP_SCOPE is None:
        return None
    mesh = _CP_SCOPE[0]
    if mesh.size <= 1 or q.shape[-2] % mesh.size != 0:
        return None
    return _CP_SCOPE


def _ring_key(key, places: Sequence[Optional[int]], use_drop: bool):
    """The rings' dropout key: folded with the data rank under a data axis,
    then with the model rank under a model axis (JAX's ``shard_map`` body
    decorrelates its data and model shards so)."""
    if not use_drop:
        return key
    for place in places:
        if place is not None:
            key = fold_key(key, place)
    return key


def fold_key(key, i: int):
    """The JAX package's ``fold_key`` on a raw uint32[2] salt pair: the
    murmur-mixed index xored into the trailing salt word."""
    s0, s1 = (int(v) for v in key)
    return (s0, s1 ^ mix32_const(int(i)))


def _ring_base(q, mod_axis: Optional[int]) -> int:
    """The first mask row of a self-attention ring on q (M, ..., T, hs):
    inside a ``mod_slice_scope`` its first modality m0 times the rows of
    one modality (the JAX ring keys the whole M), else 0."""
    ms = mod_slice()
    if ms is None or mod_axis is None:
        return 0
    if mod_axis != 0:
        raise ValueError(f"the modality axis must lead, got axis {mod_axis}")
    return ms[0] * math.prod(q.shape[1:-2])


def _cp_self_attention(q, k, v, scope, dropout_rate, dropout_key, train, impl, mod_axis=None):
    """Ring attention over the sequence group, every leading axis local
    (JAX's ``_cp_self_attention``): this rank's batch rows and heads keyed
    by their local index, the key folded with the data rank under a data
    axis and the model rank under a model axis; a modality-parallel rank's
    modalities (``mod_axis``) keyed by their global index."""
    from ..parallel.ring_attention import ring_causal_attention

    mesh, places = scope[0], scope[1:]
    use_drop = train and dropout_rate > 0.0
    key = _ring_key(dropout_key, places, use_drop)
    base = _ring_base(q, mod_axis) if use_drop else 0
    return ring_causal_attention(q, k, v, mesh, impl, dropout_rate, key, train, base)


def _cp_cross_attention(q, k, v, scope, dropout_rate, dropout_key, train, impl):
    """Ring attention per key/value stream j with ``fold_key(key, j)`` (the
    key first folded with the data rank and the model rank where those axes
    exist), summed over the streams in q's type (JAX's
    ``_cp_cross_attention``); q (..., T, hs), k, v (J, ..., T, hs)."""
    from ..parallel.ring_attention import ring_cross_attention

    mesh, places = scope[0], scope[1:]
    key = _ring_key(dropout_key, places, train and dropout_rate > 0.0)
    return ring_cross_attention(q, k, v, mesh, impl, dropout_rate, key, train)


def fused_qkv_attention_active(t: int, hs: int, impl: str, device: torch.device) -> bool:
    """True when self-attention runs the fused projection + attention kernel
    (the JAX package's ``fused_qkv_attention_active``, with CUDA in place of
    the TPU); never inside a context-parallel scope."""
    return (_CP_SCOPE is None and _kernel_device(device, impl) and kernels.in_band(t, hs)
            and hs % 2 == 0)


def cross_short_kernel_active(t: int, hs: int, impl: str, device: torch.device) -> bool:
    """True when cross-attention runs the whole-row cross kernel (the JAX
    package's ``cross_t_attention_active``): the model then projects q and
    k/v head-major, (H, B, T, hs), whose collapsed rows key that kernel's
    dropout as the JAX kernel's; everywhere else it projects in JAX's
    (B, H, T, hs) order, whose rows key the flash kernels' and the dense
    core's masks. Never inside a context-parallel scope."""
    return _CP_SCOPE is None and _kernel_device(device, impl) and kernels.in_band(t, hs)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    dropout_key: Optional[Sequence[int]] = None,
    train: bool = False,
    batch_axis: Optional[int] = None,
    head_axis: Optional[int] = None,
    mod_axis: Optional[int] = None,
) -> torch.Tensor:
    """Causal self-attention over separate q, k, v (..., T, hs), the JAX
    package's ``causal_attention``. On the card: in the band the
    differentiable whole-row kernels (K3f forward, K3b backward; the
    KV-cache prefill runs K3f alone, and the model's training forward takes
    the fused kernel there), in the flash band the differentiable flash
    kernels (K5f forward, K5b backward), the collapsed leading axes keying
    the dropout as the JAX kernels key it; the dense core elsewhere.
    ``batch_axis``: q's batch axis, whose rows key the dropout by their
    global rows in a data-parallel rank's batch slice scope; ``head_axis``
    its head axis, by global heads in a tensor-parallel rank's head slice
    scope; ``mod_axis`` its modality axis (0), by global modalities in a
    modality-parallel rank's modality slice scope."""
    scope = _cp_active(q)
    if scope is not None and q.shape == k.shape:
        return _cp_self_attention(q, k, v, scope, dropout_rate, dropout_key, train, impl,
                                  mod_axis)
    t, hs = q.shape[-2], q.shape[-1]
    use_dropout = train and dropout_rate > 0.0
    rate, key = (dropout_rate, dropout_key) if use_dropout else (0.0, None)
    rows = batch_row_map(q.shape[:-2], batch_axis, head_axis, mod_axis) if use_dropout else None
    if _kernel_device(q.device, impl) and q.shape == k.shape == v.shape:
        if kernels.in_band(t, hs):
            if rows is not None:
                raise NotImplementedError(
                    "the whole-row self-attention kernel (K3) takes no global batch rows: "
                    "data-parallel dropout there needs the fused kernel (an even head size)")
            return kernels.short_causal_attention(q.contiguous(), k.contiguous(),
                                                  v.contiguous(), rate, key)
        if kernels.flash_eligible(t, hs) and q.ndim >= 3:
            return kernels.flash_causal_attention(q, k, v, rate, key, rows)
    return causal_attention_dense(q, k, v, dropout_rate, dropout_key, train, batch_axis,
                                  head_axis, mod_axis)


def packed_attention_active(t: int, hs: int, impl: str, device: torch.device) -> bool:
    """True when ``causal_attention_packed`` runs the packed whole-row
    kernels (the JAX package's ``packed_attention_active``, with CUDA in
    place of the TPU); never inside a context-parallel scope."""
    return (_CP_SCOPE is None and _kernel_device(device, impl)
            and kernels.short_packed_eligible(t, hs))


def causal_attention_packed(
    qkv: torch.Tensor,
    n_head: int,
    dropout_rate: float = 0.0,
    dropout_key: Optional[Sequence[int]] = None,
    train: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Causal self-attention over packed (..., 3H, T, hs) q/k/v head groups,
    the JAX package's ``causal_attention_packed``: on the card in the band one
    kernel operand in and one packed gradient out (K4f / K4b, mask rows
    b * H + h of the collapsed (..., H) axes); elsewhere the packed axis is
    split and ``causal_attention`` runs. Returns (..., H, T, hs). (The JAX
    model's packed branch is never taken, the fused kernel covers the same
    band first, so the port's model does not call this.)"""
    H = n_head
    t, hs = qkv.shape[-2], qkv.shape[-1]
    if packed_attention_active(t, hs, impl, qkv.device):
        use_dropout = train and dropout_rate > 0.0
        return kernels.short_causal_attention_packed(
            qkv, H, dropout_rate if use_dropout else 0.0, dropout_key if use_dropout else None)
    q, k, v = qkv[..., :H, :, :], qkv[..., H:2 * H, :, :], qkv[..., 2 * H:, :, :]
    return causal_attention(q, k, v, impl, dropout_rate, dropout_key, train)


def cross_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    dropout_key: Optional[Sequence[int]] = None,
    train: bool = False,
    batch_axis: Optional[int] = None,
    head_axis: Optional[int] = None,
) -> torch.Tensor:
    """Causal attention of one query stream q (..., T, hs) against J
    key/value streams (J, ..., T, hs), summed over the streams. The collapsed
    leading axes of q are the rows that key the dropout: head-major
    (H, B, T, hs) where the whole-row kernel runs (``cross_short_kernel_active``),
    JAX's (B, H, T, hs) elsewhere.

    On the card: in the band the whole-row cross kernel (K2f / K2b), in the
    flash band the flash cross kernels (K6f, or K6f-r forward and K5b per
    stream backward), dropout keyed per stream as the JAX kernels key it.
    Elsewhere the dense core, whose mask is drawn over the (J, B, H, T, T)
    affinity, as the JAX package's dense core draws it. Inside a
    context-parallel scope: ring attention per stream, summed.
    ``batch_axis``: q's batch axis (0 in JAX's order, 1 head-major), whose
    rows key the dropout by their global rows in a data-parallel rank's
    batch slice scope; ``head_axis`` its head axis (1 in JAX's order, 0
    head-major), by global heads in a tensor-parallel rank's head slice
    scope."""
    scope = _cp_active(q)
    if scope is not None:
        return _cp_cross_attention(q, k, v, scope, dropout_rate, dropout_key, train, impl)
    t, hs = q.shape[-2], q.shape[-1]
    use_dropout = train and dropout_rate > 0.0
    rate, key = (dropout_rate, dropout_key) if use_dropout else (0.0, None)
    rows = batch_row_map(q.shape[:-2], batch_axis, head_axis) if use_dropout else None
    if _kernel_device(q.device, impl):
        if kernels.in_band(t, hs):
            return kernels.short_cross_attention(q.contiguous(), k.contiguous(),
                                                 v.contiguous(), rate, key, rows)
        if kernels.flash_eligible(t, hs):
            return kernels.flash_cross_attention(q, k, v, rate, key, rows)
    return causal_attention_dense(q[None], k, v, dropout_rate, dropout_key, train,
                                  None if batch_axis is None else batch_axis + 1,
                                  None if head_axis is None else head_axis + 1).sum(dim=0)


# ------------------------------------------------- chunk core (ring/CP shared)
#
# Ring attention needs per (query chunk, key chunk) pair the output with its
# logsumexp, so that partial results merge exactly, and the backward from the
# merged logsumexp. Two implementations of the same math: the chunk kernels
# (K7f / K7b, ops/kernels.py) and the dense mirror below (the JAX package's
# ``chunk_fwd_jnp`` / ``chunk_bwd_jnp``). Both keep the dropout mask on the
# unnormalised exp-scores with the softmax denominator unmasked. The dense
# mirror keys its mask per chunk (``_chunk_keep_mask``: block indices
# iq = jk = 0, rows and columns over the whole chunk), the kernels on JAX's
# blocks of at most 512: the two masks are the same bits where each chunk
# is one block (t_q, t_k <= 512, multiples of 128) and differ beyond.


def _chunk_scores(q, k, causal: bool):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        t_q, t_k = q.shape[-2], k.shape[-2]
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return s


def _chunk_keep_mask(shape, seed, rate: float, device, base: int = 0):
    """The JAX package's ``_chunk_keep_mask``: every leading slice its
    linearised index (plus ``base``) as the hash's row index, iq = jk = 0."""
    lead = tuple(shape[:-2])
    n_idx = torch.arange(max(1, int(torch.Size(lead).numel())), device=device) + base
    return kernels.hash_keep_mask(seed, n_idx.reshape(*lead, 1, 1), 0, 0, shape, rate, device)


def chunk_fwd_dense(q, k, v, causal: bool, seed=None, rate: float = 0.0, base: int = 0):
    """Dense chunk forward: (out (..., t_q, hs) in q's type, lse (..., t_q));
    ``base``: the mask row of the first leading slice."""
    s = _chunk_scores(q, k, causal)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    if rate > 0.0:
        keep = _chunk_keep_mask(s.shape, seed, rate, q.device, base)
        p = torch.where(keep, p, torch.zeros((), device=q.device))
        l = l * (1.0 - rate)
    out = torch.matmul(p, v.float()) / l
    return out.to(q.dtype), lse


def chunk_bwd_dense(q, k, v, out, lse, g, causal: bool, seed=None, rate: float = 0.0,
                    base: int = 0):
    """Dense chunk backward given the merged lse: P = exp(S - lse),
    D = rowsum(g * out), dS = P * (keep * (g V^T) / (1 - rate) - D).
    Returns (dq, dk, dv) in q's, k's and v's types."""
    zero = torch.zeros((), device=q.device)
    s = _chunk_scores(q, k, causal)
    p = torch.exp(s - lse[..., :, None])
    g32 = g.float()
    delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(g32, v.float().transpose(-1, -2))
    if rate > 0.0:
        keep = _chunk_keep_mask(s.shape, seed, rate, q.device, base)
        pd = torch.where(keep, p / (1.0 - rate), zero)
        dp = torch.where(keep, dp / (1.0 - rate), zero)
    else:
        pd = p
    dv = torch.matmul(pd.transpose(-1, -2), g32)
    ds = p * (dp - delta)
    scale = q.shape[-1] ** -0.5
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _chunk_use_kernel(q, k, impl: str) -> bool:
    """The JAX package's ``_chunk_use_pallas`` with the card in place of the
    TPU: ``jnp`` never, ``pallas`` wherever eligible, ``auto`` on the card
    where eligible and the query chunk is at least 256 long."""
    on_card = _kernel_device(q.device, impl)  # raises on an unknown impl
    if impl == "jnp" or not kernels.flash_chunk_eligible(q.shape[-2], k.shape[-2], q.shape[-1]):
        return False
    return impl == "pallas" or (on_card and q.shape[-2] >= kernels.FLASH_MIN_SEQ_LEN)


def chunk_fwd(q, k, v, causal: bool, seed=None, rate: float = 0.0, impl: str = "auto",
              base: int = 0):
    """Chunk forward with dispatch: K7f, or the dense mirror; ``base``: the
    mask row of the first collapsed row."""
    if _chunk_use_kernel(q, k, impl):
        return kernels.flash_chunk_fwd(q, k, v, causal, seed, rate, base)
    return chunk_fwd_dense(q, k, v, causal, seed, rate, base)


def chunk_bwd(q, k, v, out, lse, g, causal: bool, seed=None, rate: float = 0.0,
              impl: str = "auto", base: int = 0):
    """Chunk backward with dispatch: K7b, or the dense mirror."""
    if _chunk_use_kernel(q, k, impl):
        return kernels.flash_chunk_bwd(q, k, v, out, lse, g, causal, seed, rate, base)
    return chunk_bwd_dense(q, k, v, out, lse, g, causal, seed, rate, base)
