"""Ring (context-parallel) causal attention over the sequence axis,
differentiable (port of the JAX package's ``parallel/ring_attention.py``).

Rank r of P holds the sequence chunk [r c, (r + 1) c) of q, k and v
(c = T / P). Forward: the local chunk attends with the causal mask (K7f
causal), then P - 1 hops pass (k, v) to rank + 1; after s hops rank r holds
the chunk of rank (r - s) mod P, which it attends with no mask (K7f full)
where that rank is earlier than r. Partial results carry their logsumexp
and merge exactly in f32: out <- out e^(lse - lse') + out_s e^(lse_s - lse'),
lse' = logaddexp(lse, lse_s); the output is cast to q's type.

Backward, the exact ring gradient: with the merged lse, P = exp(S - lse)
splits the global softmax per chunk pair, so each pair contributes through
the flash backward identities (K7b from the merged out and lse). dq
accumulates locally in f32; (k, v, dk, dv) travel the ring together, each
rank adding its contribution to the visiting chunk's dk, dv where the
chunk's rank is earlier than its own, and one last hop brings them home.

The JAX package computes the chunk pairs of later ranks (src > rank, wholly
in the causal future) and drops them with a select, to keep its SPMD program
uniform. The port skips those launches, which gives the same values: per
ring, rank r launches one causal chunk and r full-mask chunks forward, and
as many backward. Dropout is keyed per (rank, source) pair, seed +
rank * P + src in int32, as the JAX package's ``_pair_seed``.

The model's attention runs on the full sequence on every rank (the JAX
package's sequence-only mesh: everything but the attention cores is
replicated), so each core takes this rank's chunk of q, k, v, and gathers
the output along the sequence after the ring; the backward takes this rank's
chunk of the output gradient and gathers dq, dk, dv. Parameters and their
gradients are then the same on every rank with no all-reduce.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops import kernels
from ..ops.attention import chunk_bwd, chunk_fwd, fold_key
from .mesh import SeqMesh


def _pair_seed(seed: Optional[int], rank: int, src: int, p_size: int) -> Optional[int]:
    """Distinct dropout stream per (query rank, key/value source) chunk pair."""
    return None if seed is None else kernels._int32(seed + rank * p_size + src)


def _ring_fwd(q, k, v, seed, mesh: SeqMesh, impl: str, rate: float):
    P, r = mesh.size, mesh.rank
    out, lse = chunk_fwd(q, k, v, True, _pair_seed(seed, r, r, P), rate, impl)
    out = out.float()
    kv = (k, v)
    for s in range(1, P):
        kv = mesh.hop(kv)
        src = (r - s) % P
        if src >= r:
            continue  # a later rank: wholly in the causal future
        o_s, lse_s = chunk_fwd(q, kv[0], kv[1], False, _pair_seed(seed, r, src, P), rate, impl)
        lse_new = torch.logaddexp(lse, lse_s)
        out = (out * torch.exp(lse - lse_new)[..., None]
               + o_s.float() * torch.exp(lse_s - lse_new)[..., None])
        lse = lse_new
    return out.to(q.dtype), lse


def _ring_bwd(q, k, v, out, lse, g, seed, mesh: SeqMesh, impl: str, rate: float):
    P, r = mesh.size, mesh.rank
    dq, dk, dv = (x.float() for x in chunk_bwd(q, k, v, out, lse, g, True,
                                               _pair_seed(seed, r, r, P), rate, impl))
    travel = (k, v, dk, dv)
    for s in range(1, P):
        k_c, v_c, dk_c, dv_c = mesh.hop(travel)
        src = (r - s) % P
        if src < r:
            dq_s, dk_s, dv_s = chunk_bwd(q, k_c, v_c, out, lse, g, False,
                                         _pair_seed(seed, r, src, P), rate, impl)
            dq = dq + dq_s.float()
            dk_c = dk_c + dk_s.float()
            dv_c = dv_c + dv_s.float()
        travel = (k_c, v_c, dk_c, dv_c)
    if P > 1:
        # one last hop returns each chunk's accumulated gradient to its owner
        _, _, dk, dv = mesh.hop(travel)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Ring(torch.autograd.Function):
    """Ring attention on this rank's chunks: q, k, v (..., c, hs) -> out."""

    @staticmethod
    def forward(ctx, q, k, v, seed, mesh, impl, rate):
        out, lse = _ring_fwd(q, k, v, seed, mesh, impl, rate)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (seed, mesh, impl, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_ring_bwd(q, k, v, out, lse, g.contiguous(), *ctx.args), None, None, None, None)


class _SeqChunk(torch.autograd.Function):
    """This rank's chunk of a tensor that every rank holds whole; the
    gradient of the whole is every rank's chunk gradient, gathered."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.chunk(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather_seq(g), None


class _SeqGather(torch.autograd.Function):
    """Every rank's chunk gathered along the sequence; the gradient of this
    rank's chunk is its chunk of the whole's gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather_seq(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.chunk(g), None


def _seed(rate: float, dropout_key) -> Optional[int]:
    if rate == 0.0:
        return None
    if dropout_key is None:
        raise ValueError("dropout_rate > 0 requires dropout_key")
    return kernels.seed_from_salts(dropout_key)


def ring_causal_attention_local(q, k, v, mesh: SeqMesh, impl: str = "auto",
                                dropout_rate: float = 0.0,
                                dropout_key: Optional[Sequence[int]] = None,
                                train: bool = False) -> torch.Tensor:
    """Causal attention of this rank's chunks q, k, v (..., c, hs) with the
    ring's key/value exchange, the JAX package's
    ``ring_causal_attention_local``; returns this rank's output chunk."""
    rate = float(dropout_rate) if train else 0.0
    return _Ring.apply(q, k, v, _seed(rate, dropout_key), mesh, impl, rate)


def ring_causal_attention(q, k, v, mesh: SeqMesh, impl: str = "auto",
                          dropout_rate: float = 0.0,
                          dropout_key: Optional[Sequence[int]] = None,
                          train: bool = False) -> torch.Tensor:
    """Causal self-attention of whole q, k, v (..., T, hs), the same on every
    rank, through the ring: this rank's chunks in, the whole output out."""
    chunks = [_SeqChunk.apply(x, mesh) for x in (q, k, v)]
    out = ring_causal_attention_local(*chunks, mesh, impl, dropout_rate, dropout_key, train)
    return _SeqGather.apply(out, mesh)


def ring_cross_attention(q, k, v, mesh: SeqMesh, impl: str = "auto",
                         dropout_rate: float = 0.0,
                         dropout_key: Optional[Sequence[int]] = None,
                         train: bool = False) -> torch.Tensor:
    """One query stream q (..., T, hs) against J key/value streams
    (J, ..., T, hs), each through the ring with the stream's key
    ``fold_key(key, j)``, summed over the streams in q's type."""
    use_drop = train and dropout_rate > 0.0
    ql, kl, vl = (_SeqChunk.apply(x, mesh) for x in (q, k, v))
    out = None
    for j in range(k.shape[0]):
        kj = fold_key(dropout_key, j) if use_drop else None
        o = ring_causal_attention_local(ql, kl[j], vl[j], mesh, impl, dropout_rate, kj, train)
        out = o if out is None else out + o
    return _SeqGather.apply(out, mesh)
