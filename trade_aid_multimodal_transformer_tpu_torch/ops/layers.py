"""Normalisation for the inference forward (port of the JAX package's
``ops/layers.py``).

LayerNorm uses eps 1e-5 with biased variance and computes its statistics in
f32 (f64 for f64 inputs), returning the activation dtype. Dropout is the
identity at inference; the hash dropout and ``KeyGen`` come with training.
"""

from __future__ import annotations

import torch

LN_EPS = 1e-5


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
