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
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import kernels
from .layers import dropout


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


def fused_qkv_attention_active(t: int, hs: int, impl: str, device: torch.device) -> bool:
    """True when self-attention runs the fused projection + attention kernel
    (the JAX package's ``fused_qkv_attention_active``, with CUDA in place of
    the TPU)."""
    return _kernel_device(device, impl) and kernels.in_band(t, hs) and hs % 2 == 0


def cross_short_kernel_active(t: int, hs: int, impl: str, device: torch.device) -> bool:
    """True when cross-attention runs the whole-row cross kernel (the JAX
    package's ``cross_t_attention_active``): the model then projects q and
    k/v head-major, (H, B, T, hs), whose collapsed rows key that kernel's
    dropout as the JAX kernel's; everywhere else it projects in JAX's
    (B, H, T, hs) order, whose rows key the flash kernels' and the dense
    core's masks."""
    return _kernel_device(device, impl) and kernels.in_band(t, hs)


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
    affinity, as the JAX package's dense core draws it."""
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
