"""Normalisation and hash dropout (port of the JAX package's ``ops/layers.py``).

LayerNorm uses eps 1e-5 with biased variance and computes its statistics in
f32 (f64 for f64 inputs), returning the activation dtype.

Dropout is inverted dropout whose keep-mask is an integer hash of the
element coordinates salted by two u32 scalars (``hash_keep_mask_nd``), as in
the JAX package; every u32 operation runs here in int64 masked to 32 bits, so
the masks are bit-identical to JAX's. ``KeyGen`` derives each site's salt
pair from a raw uint32[2] key (the port never holds a JAX key); ``dropout``
regenerates the mask in its backward from the two salts and stores no mask.

Under data parallelism a rank holds rows [start, start + B) of a global
batch, and every mask must be the global call's rows. The data-parallel
trainer opens ``batch_slice_scope(start, total)``; a site that names its
batch axis (``dropout(..., batch_axis=...)``, the attention cores and their
kernels) then hashes each collapsed row at its global index
(``batch_row_map``). Under tensor parallelism a rank holds heads
[h0, h0 + H / N) of the model's H, and the tensor-parallel trainer opens
``head_slice_scope``, which also carries the model axis whose collectives
the model calls (parallel/mesh.py ``ModelAxis``); an attention core that
names its head axis then hashes each row at its global head as well: a row
map of two affine levels where both a batch and a head axis are split.
Under modality parallelism a rank holds modalities [m0, m0 + M / P) of the
model's M, and the modality-parallel trainer opens ``mod_slice_scope``,
which also carries the modality axis (parallel/mesh.py ``ModAxis``); a site
on an (M, B, ...) tensor that names its modality axis (always the leading
one) then hashes modality m's rows at m0 + m: a third level, the outermost,
which adds to the map's base alone. Outside the scopes the masks are the
one-rank masks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch

LN_EPS = 1e-5
_U32 = 0xFFFFFFFF


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the trailing feature axis; scale/bias broadcast from the
    left, so per-modality stacked (M, C) params apply to (M, B, T, C)."""
    dt = x.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    xf = x.to(acc)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + LN_EPS)
    scale = scale.to(acc)
    bias = bias.to(acc)
    if 1 < scale.ndim < x.ndim:
        shape = (scale.shape[0],) + (1,) * (x.ndim - scale.ndim) + (scale.shape[-1],)
        scale = scale.reshape(shape)
        bias = bias.reshape(shape)
    return (normed * scale + bias).to(dt)


# ------------------------------------------------------------------ hashing


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 tensors of u32 values, without int64
    overflow: the low and high 16 bits multiply apart."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over int64 tensors of u32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 2246822519)
    h = h ^ (h >> 13)
    h = _mul32(h, 3266489917)
    return h ^ (h >> 16)


def mix32_const(i: int) -> int:
    """murmur3 finalizer of a Python int: the per-site salt constant."""
    h = i & _U32
    h ^= h >> 16
    h = (h * 2246822519) & _U32
    h ^= h >> 13
    h = (h * 3266489917) & _U32
    h ^= h >> 16
    return h


# ------------------------------------------------------- global batch rows

_BATCH_SLICE: Optional[Tuple[int, int]] = None  # (start, total) of an open scope


@contextlib.contextmanager
def batch_slice_scope(start: int, total: int):
    """While open, the batch axes that dropout sites name hold rows
    [start, start + B) of a global batch of ``total`` rows (one data-parallel
    rank's share), so their masks are keyed by global rows."""
    global _BATCH_SLICE
    prev = _BATCH_SLICE
    _BATCH_SLICE = (int(start), int(total))
    try:
        yield
    finally:
        _BATCH_SLICE = prev


def batch_slice() -> Optional[Tuple[int, int]]:
    """(start, total) of the open ``batch_slice_scope``, or None."""
    return _BATCH_SLICE


_HEAD_SLICE = None  # (h0, local heads, global heads, model axis) of an open scope


@contextlib.contextmanager
def head_slice_scope(h0: int, n_local: int, n_head: int, axis=None):
    """While open, the head axes that attention cores name hold heads
    [h0, h0 + n_local) of the model's ``n_head`` (one tensor-parallel
    rank's share), so their masks are keyed by global heads; ``axis`` is
    the model axis (``parallel.mesh.ModelAxis``) whose ``copy_to`` and
    ``reduce_from`` the model's layers call around their head-split and
    column-split products."""
    global _HEAD_SLICE
    prev = _HEAD_SLICE
    _HEAD_SLICE = (int(h0), int(n_local), int(n_head), axis)
    try:
        yield
    finally:
        _HEAD_SLICE = prev


def head_slice():
    """(h0, local heads, global heads, model axis) of the open
    ``head_slice_scope``, or None."""
    return _HEAD_SLICE


_MOD_SLICE = None  # (m0, local modalities, global modalities, modality axis) of an open scope


@contextlib.contextmanager
def mod_slice_scope(m0: int, n_local: int, n_mod: int, axis=None):
    """While open, the modality axes that dropout sites name hold
    modalities [m0, m0 + n_local) of the model's ``n_mod`` (one
    modality-parallel rank's share), so their masks are keyed by global
    modalities; ``axis`` is the modality axis (``parallel.mesh.ModAxis``)
    whose gather the model's blocks call before cross-attention."""
    global _MOD_SLICE
    prev = _MOD_SLICE
    _MOD_SLICE = (int(m0), int(n_local), int(n_mod), axis)
    try:
        yield
    finally:
        _MOD_SLICE = prev


def mod_slice():
    """(m0, local modalities, global modalities, modality axis) of the open
    ``mod_slice_scope``, or None."""
    return _MOD_SLICE


def _level(lead: Tuple[int, ...], axis: int, offset: int, total: int):
    """One affine level of a row map: the collapsed rows of ``lead`` whose
    axis ``axis`` holds [offset, offset + lead[axis]) of ``total``, as
    (span, skip, base) over that axis's inner rows."""
    inner = math.prod(lead[axis + 1:])
    return lead[axis] * inner, (total - lead[axis]) * inner, offset * inner


def batch_row_map(lead: Sequence[int], batch_axis: Optional[int],
                  head_axis: Optional[int] = None,
                  mod_axis: Optional[int] = None) -> Optional[Tuple[int, ...]]:
    """Under a ``batch_slice_scope``, the global row of each collapsed row of
    the leading axes ``lead`` whose axis ``batch_axis`` is the batch axis, as
    (span, skip, base): row n = (o B + b) I + i (I the rows inside a batch
    row) is global row n + (n // span) skip + base = (o Bg + start + b) I + i.
    Under a ``head_slice_scope`` too, with ``head_axis`` the head axis: the
    head level the same way. Where both are split the inner axis's level
    comes first: (span, skip, base, ispan, iskip) maps n to n1 = n +
    (n // ispan) iskip, then n1 + (n1 // span) skip + base (``map_rows``);
    two levels that one expresses are merged into one. Under a
    ``mod_slice_scope`` too, with ``mod_axis`` (0: the modality axis leads)
    the modality level: modality m's rows start at global modality m0 + m,
    the product of the other axes' global sizes past it, added to the base
    (the outermost level never skips). None (the identity) outside the
    scopes or without the named axes."""
    lead = tuple(int(d) for d in lead)
    mod_base = 0
    if _MOD_SLICE is not None and mod_axis is not None:
        if mod_axis != 0:
            raise ValueError(f"the modality axis must lead, got axis {mod_axis}")
        glob = list(lead)
        if _BATCH_SLICE is not None and batch_axis is not None:
            glob[batch_axis] = _BATCH_SLICE[1]
        if _HEAD_SLICE is not None and head_axis is not None:
            glob[head_axis] = _HEAD_SLICE[2]
        mod_base = _MOD_SLICE[0] * math.prod(glob[1:])
    rows = _row_levels(lead, batch_axis, head_axis)
    if not mod_base:
        return rows
    if rows is None:
        return max(1, math.prod(lead)), 0, mod_base
    return rows[:2] + (rows[2] + mod_base,) + rows[3:]


def _row_levels(lead: Tuple[int, ...], batch_axis: Optional[int],
                head_axis: Optional[int]) -> Optional[Tuple[int, ...]]:
    """``batch_row_map``'s batch and head levels."""
    levels = []
    if _BATCH_SLICE is not None and batch_axis is not None:
        levels.append((batch_axis, *_BATCH_SLICE))
    if _HEAD_SLICE is not None and head_axis is not None:
        levels.append((head_axis, _HEAD_SLICE[0], _HEAD_SLICE[2]))
    if not levels:
        return None
    levels.sort(reverse=True)  # the inner axis first
    inner = _level(lead, *levels[0])
    if len(levels) == 1:
        return inner
    p, _, total = levels[0]
    widened = lead[:p] + (total,) + lead[p + 1:]  # the inner axis at its global size
    q = levels[1][0]
    span, skip, base = _level(widened, *levels[1])
    base += inner[2]
    if q == 0 or skip == 0:  # the outer level adds its base alone
        return inner[0], inner[1], base
    if inner[1] == 0:
        return span, skip, base
    return span, skip, base, inner[0], inner[1]


def map_rows(n: torch.Tensor, rows: Optional[Tuple[int, ...]]) -> torch.Tensor:
    """The global rows (``batch_row_map``) of integer row indices ``n``."""
    if rows is None:
        return n
    span, skip, base = rows[:3]
    if len(rows) > 3:
        n = n + torch.div(n, rows[3], rounding_mode="floor") * rows[4]
    return n + torch.div(n, span, rounding_mode="floor") * skip + base


def hash_keep_mask_nd(s1: int, s2: int, shape: Sequence[int], rate: float,
                      device=None, rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Bool keep-mask over ``shape`` from the salts (s1, s2): per-axis salt
    vectors (murmur-mixed iotas) combined per element by adds and a
    multiply-free avalanche, as the JAX package's ``hash_keep_mask_nd``.
    ``rows`` (``batch_row_map``) keys the collapsed leading axes by their
    global rows (batch, head and modality levels): the global call's nv
    vector at this rank's rows, O(N)."""
    threshold = min(int(rate * (1 << 32)), (1 << 32) - 1)
    shape = tuple(int(d) for d in shape)
    shape2 = (1,) * max(0, 2 - len(shape)) + shape
    R, C = shape2[-2], shape2[-1]
    N = 1
    for d in shape2[:-2]:
        N *= d
    s1, s2 = int(s1) & _U32, int(s2) & _U32

    def iota(n: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.int64, device=device)

    rv = _mix32((_mul32(iota(R), 2246822519) + s1) & _U32)
    cv = _mix32((_mul32(iota(C), 3266489917) + (s2 ^ 0x9E3779B9)) & _U32)
    nv = _mix32((_mul32(map_rows(iota(N), rows), 2654435761) + (s1 ^ ((s2 * 97) & _U32))) & _U32)
    h = (nv[:, None, None] + rv[None, :, None] + cv[None, None, :]) & _U32
    h = (h + (h << 3)) & _U32
    h ^= h >> 11
    h = (h + (h << 15)) & _U32
    h ^= h >> 7
    h = (h + (h << 9)) & _U32
    h ^= h >> 16
    return (h >= threshold).reshape(shape)


# ------------------------------------------------------------------ dropout


def dropout_salts(key) -> Tuple[int, int]:
    """The two u32 salts of a raw uint32[2] key (a tensor, array or pair)."""
    vals = [int(v) & _U32 for v in (key.tolist() if hasattr(key, "tolist") else key)]
    return vals[0], vals[-1]


def _masked_scale(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    # x / keep with keep held in x's type, as the JAX package's weak-typed
    # scalar divides (bf16 activations divide by bf16(0.8) there)
    scaled = x / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


class _HashDropout(torch.autograd.Function):
    """where(mask, x / keep, 0), whose backward regenerates the mask from the
    two salts (the JAX package's ``_dropout_cv``): no mask tensor is kept."""

    @staticmethod
    def forward(ctx, x, s1, s2, rate, rows):
        ctx.args = (s1, s2, rate, rows)
        return _masked_scale(x, hash_keep_mask_nd(s1, s2, x.shape, rate, x.device, rows), rate)

    @staticmethod
    def backward(ctx, g):
        s1, s2, rate, rows = ctx.args
        keep = hash_keep_mask_nd(s1, s2, g.shape, rate, g.device, rows)
        return _masked_scale(g, keep, rate), None, None, None, None


def dropout(x: torch.Tensor, rate: float, key: Optional[Sequence[int]], train: bool,
            batch_axis: Optional[int] = None, head_axis: Optional[int] = None,
            mod_axis: Optional[int] = None) -> torch.Tensor:
    """Inverted hash dropout; the identity when not training or rate == 0.
    ``key`` is a site's raw uint32[2] salt pair (from ``KeyGen``);
    ``batch_axis``, x's batch axis (one of its leading axes), keys the mask
    by global batch rows inside a ``batch_slice_scope``; ``head_axis`` by
    global heads inside a ``head_slice_scope``; ``mod_axis`` (0) by global
    modalities inside a ``mod_slice_scope``."""
    if not train or rate == 0.0:
        return x
    if key is None:
        raise ValueError("dropout in training needs a key")
    s1, s2 = dropout_salts(key)
    return _HashDropout.apply(x, s1, s2, float(rate),
                              batch_row_map(x.shape[:-2], batch_axis, head_axis, mod_axis))


class KeyGen:
    """Per-site dropout salts threaded through the forward (the JAX
    package's ``KeyGen`` v2): two u32 salts from the key once, the second
    rotated left by 9 bits; site i (counted from 1) gets
    (s1, s2 ^ mix32_const(i)). Returns None for every site without a key."""

    __slots__ = ("s1", "s2", "ctr")

    def __init__(self, key):
        if key is None:
            self.s1 = self.s2 = None
        else:
            self.s1, s2 = dropout_salts(key)
            self.s2 = ((s2 << 9) | (s2 >> 23)) & _U32
        self.ctr = 0

    def __call__(self) -> Optional[Tuple[int, int]]:
        if self.s1 is None:
            return None
        self.ctr += 1
        return (self.s1, self.s2 ^ mix32_const(self.ctr))
