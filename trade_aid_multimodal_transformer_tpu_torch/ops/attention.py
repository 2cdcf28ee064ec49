"""Causal attention cores and their dispatch (port of the JAX package's
``ops/attention.py``, inference only).

    aff = q @ k^T * head_size**-0.5 ; causal mask ; softmax ; aff @ v

The dense cores are the counterparts of ``causal_attention_jnp`` and of the
dense cross core ``causal_attention_jnp(q[None], k, v).sum(0)``: f32 scores
and softmax (f64 for f64 inputs), probabilities cast to the value dtype
before P.V. The dispatch keeps the JAX band rules: the hand-written kernels
(ops/kernels.py) run for CUDA tensors with 8 <= T <= 512, T % 8 == 0 and
hs <= 256 (hs even for the fused self-attention), and the dense cores run
everywhere else, as the JAX package leaves shapes outside its band to XLA.
``attn_impl: jnp`` keeps the dense cores on the card too.
"""

from __future__ import annotations

import torch

from . import kernels


def causal_attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense causal attention over trailing (T, head_size) axes. Leading axes
    broadcast (q may have fewer leading dims than k/v)."""
    dt = q.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    t_q, t_k = q.shape[-2], k.shape[-2]
    scale = k.shape[-1] ** -0.5
    aff = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
    aff = torch.softmax(aff.masked_fill(~mask, float("-inf")), dim=-1)
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


def cross_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str = "auto"
) -> torch.Tensor:
    """Causal attention of one query stream against J key/value streams,
    summed over the streams. q: (..., T, hs); k, v: (J, ..., T, hs)."""
    t, hs = q.shape[-2], q.shape[-1]
    if _kernel_device(q.device, impl) and kernels.in_band(t, hs):
        return kernels.short_cross_attention(q.contiguous(), k.contiguous(), v.contiguous())
    return causal_attention_dense(q[None], k, v).sum(dim=0)
