"""Normalisation and hash dropout (port of the JAX package's ``ops/layers.py``).

LayerNorm uses eps 1e-5 with biased variance and computes its statistics in
f32 (f64 for f64 inputs), returning the activation dtype.

Dropout is inverted dropout whose keep-mask is an integer hash of the
element coordinates salted by two u32 scalars (``hash_keep_mask_nd``), as in
the JAX package; every u32 operation runs here in int64 masked to 32 bits, so
the masks are bit-identical to JAX's. ``KeyGen`` derives each site's salt
pair from a raw uint32[2] key (the port never holds a JAX key); ``dropout``
regenerates the mask in its backward from the two salts and stores no mask.
"""

from __future__ import annotations

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


def hash_keep_mask_nd(s1: int, s2: int, shape: Sequence[int], rate: float,
                      device=None) -> torch.Tensor:
    """Bool keep-mask over ``shape`` from the salts (s1, s2): per-axis salt
    vectors (murmur-mixed iotas) combined per element by adds and a
    multiply-free avalanche, as the JAX package's ``hash_keep_mask_nd``."""
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
    nv = _mix32((_mul32(iota(N), 2654435761) + (s1 ^ ((s2 * 97) & _U32))) & _U32)
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


def _keep_mask(x: torch.Tensor, s1: int, s2: int, rate: float, layout) -> torch.Tensor:
    """x's keep-mask; ``layout = (shape, perm)`` builds it over another shape
    and permutes it onto x (a JAX site whose tensor the port holds in another
    axis order), else it is built over x's own shape."""
    if layout is None:
        return hash_keep_mask_nd(s1, s2, x.shape, rate, x.device)
    shape, perm = layout
    return hash_keep_mask_nd(s1, s2, shape, rate, x.device).permute(*perm)


def _masked_scale(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    # x / keep with keep held in x's type, as the JAX package's weak-typed
    # scalar divides (bf16 activations divide by bf16(0.8) there)
    scaled = x / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


class _HashDropout(torch.autograd.Function):
    """where(mask, x / keep, 0), whose backward regenerates the mask from the
    two salts (the JAX package's ``_dropout_cv``): no mask tensor is kept."""

    @staticmethod
    def forward(ctx, x, s1, s2, rate, layout):
        ctx.args = (s1, s2, rate, layout)
        return _masked_scale(x, _keep_mask(x, s1, s2, rate, layout), rate)

    @staticmethod
    def backward(ctx, g):
        s1, s2, rate, layout = ctx.args
        return _masked_scale(g, _keep_mask(g, s1, s2, rate, layout), rate), None, None, None, None


def dropout(x: torch.Tensor, rate: float, key: Optional[Sequence[int]], train: bool,
            layout=None) -> torch.Tensor:
    """Inverted hash dropout; the identity when not training or rate == 0.
    ``key`` is a site's raw uint32[2] salt pair (from ``KeyGen``)."""
    if not train or rate == 0.0:
        return x
    if key is None:
        raise ValueError("dropout in training needs a key")
    s1, s2 = dropout_salts(key)
    return _HashDropout.apply(x, s1, s2, float(rate), layout)


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
