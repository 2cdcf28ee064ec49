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
T % 8 == 0 and hs <= 256 (hs even for the fused self-attention); then the
flash kernels for T >= 256, T % 128 == 0 and hs <= 256 (so above 512); the
dense cores everywhere else, as the JAX package leaves shapes outside both
to XLA. ``attn_impl: jnp`` keeps the dense cores on the card too. Cached
decode attention (one query position against the KV cache) dispatches in
models/cache.py.

Inside ``context_parallel_scope`` (opened by the context-parallel trainer,
``tpu_options.context_parallel``) both cores route through ring attention
(parallel/ring_attention.py) over the scope's sequence group, as the JAX
package's scope does, and the whole-row kernels are off. The ring's chunk
core is ``chunk_fwd`` / ``chunk_bwd``: the chunk kernels K7f / K7b where the
chunk is at least 256 long and eligible on the card (``attn_impl: pallas``:
wherever eligible; on the CPU that is their plain version), the dense mirror
``chunk_fwd_dense`` / ``chunk_bwd_dense`` elsewhere or under ``attn_impl:
jnp``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from . import kernels
from .layers import dropout, mix32_const


def causal_attention_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_key: Optional[Sequence[int]] = None,
    train: bool = False,
) -> torch.Tensor:
    """Dense causal attention over trailing (T, head_size) axes. Leading axes
    broadcast (q may have fewer leading dims than k/v)."""
    dt = q.dtype
    if dt == torch.bfloat16 and q.device.type == "cpu":
        return causal_attention_dense(
            q.float(), k.float(), v.float(), dropout_rate, dropout_key, train
        ).to(dt)
    acc = torch.float64 if dt == torch.float64 else torch.float32
    t_q, t_k = q.shape[-2], k.shape[-2]
    scale = k.shape[-1] ** -0.5
    aff = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
    aff = torch.softmax(aff.masked_fill(~mask, float("-inf")), dim=-1)
    aff = dropout(aff, dropout_rate, dropout_key, train)
    return torch.matmul(aff.to(v.dtype).to(acc), v.to(acc)).to(dt)


def _kernel_device(device: torch.device, impl: str) -> bool:
    if impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"Unknown attention impl: {impl}")
    return impl != "jnp" and device.type == "cuda"


# ------------------------------------------------- context-parallel dispatch

_CP_SCOPE = None  # the sequence group (parallel.mesh.SeqMesh) of an open scope


@contextlib.contextmanager
def context_parallel_scope(mesh):
    """Route causal and cross attention through ring attention over
    ``mesh`` (a ``parallel.mesh.SeqMesh``) while the scope is open."""
    global _CP_SCOPE
    prev = _CP_SCOPE
    _CP_SCOPE = mesh
    try:
        yield
    finally:
        _CP_SCOPE = prev


def _cp_active(q: torch.Tensor):
    """The scope's mesh where it shards q's sequence axis, else None."""
    mesh = _CP_SCOPE
    if mesh is None or mesh.size <= 1 or q.shape[-2] % mesh.size != 0:
        return None
    return mesh


def fold_key(key, i: int):
    """The JAX package's ``fold_key`` on a raw uint32[2] salt pair: the
    murmur-mixed index xored into the trailing salt word."""
    s0, s1 = (int(v) for v in key)
    return (s0, s1 ^ mix32_const(int(i)))


def _cp_self_attention(q, k, v, mesh, dropout_rate, dropout_key, train, impl):
    """Ring attention over the sequence group, every leading axis local
    (a sequence-only mesh: JAX's ``_cp_self_attention`` with data and model
    of size 1)."""
    from ..parallel.ring_attention import ring_causal_attention

    return ring_causal_attention(q, k, v, mesh, impl, dropout_rate, dropout_key, train)


def _cp_cross_attention(q, k, v, mesh, dropout_rate, dropout_key, train, impl):
    """Ring attention per key/value stream j with ``fold_key(key, j)``,
    summed over the streams in q's type (JAX's ``_cp_cross_attention``);
    q (..., T, hs), k, v (J, ..., T, hs)."""
    from ..parallel.ring_attention import ring_cross_attention

    return ring_cross_attention(q, k, v, mesh, impl, dropout_rate, dropout_key, train)


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
) -> torch.Tensor:
    """Causal self-attention over separate q, k, v (..., T, hs), the JAX
    package's ``causal_attention``. On the card: in the band the
    self-attention kernel (K3f, forward only: the KV-cache prefill; the
    model's training forward takes the fused kernel there), in the flash band
    the differentiable flash kernels (K5f forward, K5b backward), the
    collapsed leading axes keying the dropout as the JAX kernels key it; the
    dense core elsewhere."""
    mesh = _cp_active(q)
    if mesh is not None and q.shape == k.shape:
        return _cp_self_attention(q, k, v, mesh, dropout_rate, dropout_key, train, impl)
    t, hs = q.shape[-2], q.shape[-1]
    use_dropout = train and dropout_rate > 0.0
    rate, key = (dropout_rate, dropout_key) if use_dropout else (0.0, None)
    if _kernel_device(q.device, impl) and q.shape == k.shape == v.shape:
        if kernels.in_band(t, hs):
            return kernels.short_causal_attention(q.contiguous(), k.contiguous(),
                                                  v.contiguous(), rate, key)
        if kernels.flash_eligible(t, hs) and q.ndim >= 3:
            return kernels.flash_causal_attention(q, k, v, rate, key)
    return causal_attention_dense(q, k, v, dropout_rate, dropout_key, train)


def cross_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    dropout_key: Optional[Sequence[int]] = None,
    train: bool = False,
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
    context-parallel scope: ring attention per stream, summed."""
    mesh = _cp_active(q)
    if mesh is not None:
        return _cp_cross_attention(q, k, v, mesh, dropout_rate, dropout_key, train, impl)
    t, hs = q.shape[-2], q.shape[-1]
    use_dropout = train and dropout_rate > 0.0
    rate, key = (dropout_rate, dropout_key) if use_dropout else (0.0, None)
    if _kernel_device(q.device, impl):
        if kernels.in_band(t, hs):
            return kernels.short_cross_attention(q.contiguous(), k.contiguous(),
                                                 v.contiguous(), rate, key)
        if kernels.flash_eligible(t, hs):
            return kernels.flash_cross_attention(q, k, v, rate, key)
    return causal_attention_dense(q[None], k, v, dropout_rate, dropout_key, train).sum(dim=0)


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


def _chunk_keep_mask(shape, seed, rate: float, device):
    """The JAX package's ``_chunk_keep_mask``: every leading slice its
    linearised index as the hash's row index, iq = jk = 0."""
    lead = tuple(shape[:-2])
    n_idx = torch.arange(max(1, int(torch.Size(lead).numel())), device=device)
    return kernels.hash_keep_mask(seed, n_idx.reshape(*lead, 1, 1), 0, 0, shape, rate, device)


def chunk_fwd_dense(q, k, v, causal: bool, seed=None, rate: float = 0.0):
    """Dense chunk forward: (out (..., t_q, hs) in q's type, lse (..., t_q))."""
    s = _chunk_scores(q, k, causal)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    if rate > 0.0:
        keep = _chunk_keep_mask(s.shape, seed, rate, q.device)
        p = torch.where(keep, p, torch.zeros((), device=q.device))
        l = l * (1.0 - rate)
    out = torch.matmul(p, v.float()) / l
    return out.to(q.dtype), lse


def chunk_bwd_dense(q, k, v, out, lse, g, causal: bool, seed=None, rate: float = 0.0):
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
        keep = _chunk_keep_mask(s.shape, seed, rate, q.device)
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


def chunk_fwd(q, k, v, causal: bool, seed=None, rate: float = 0.0, impl: str = "auto"):
    """Chunk forward with dispatch: K7f, or the dense mirror."""
    if _chunk_use_kernel(q, k, impl):
        return kernels.flash_chunk_fwd(q, k, v, causal, seed, rate)
    return chunk_fwd_dense(q, k, v, causal, seed, rate)


def chunk_bwd(q, k, v, out, lse, g, causal: bool, seed=None, rate: float = 0.0,
              impl: str = "auto"):
    """Chunk backward with dispatch: K7b, or the dense mirror."""
    if _chunk_use_kernel(q, k, impl):
        return kernels.flash_chunk_bwd(q, k, v, out, lse, g, causal, seed, rate)
    return chunk_bwd_dense(q, k, v, out, lse, g, causal, seed, rate)
