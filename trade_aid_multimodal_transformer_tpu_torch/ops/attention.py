"""Causal attention cores and their dispatch (port of the JAX package's
``ops/attention.py``).

    aff = q @ k^T * head_size**-0.5 ; causal mask ; softmax ; dropout ; aff @ v

The dense cores are the counterparts of ``causal_attention_jnp`` and of the
dense cross core ``causal_attention_jnp(q[None], k, v).sum(0)``: f32 scores
and softmax (f64 for f64 inputs), hash dropout on the normalised affinity,
probabilities cast to the value dtype before P.V. On the CPU bf16 inputs run
the whole core in f32, as the JAX package does where the backend lacks mixed
bf16 dots. The dispatch keeps the JAX band rules: the hand-written kernels
(ops/kernels.py, with in-kernel dropout) run for CUDA tensors with
8 <= T <= 512, T % 8 == 0 and hs <= 256 (hs even for the fused
self-attention), and the dense cores run everywhere else, as the JAX package
leaves shapes outside its band to XLA. ``attn_impl: jnp`` keeps the dense
cores on the card too. Cached decode attention (one query position against
the KV cache) dispatches in models/cache.py.
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
    mask_layout=None,
) -> torch.Tensor:
    """Dense causal attention over trailing (T, head_size) axes. Leading axes
    broadcast (q may have fewer leading dims than k/v). ``mask_layout``
    (shape, perm) builds the dropout mask over the JAX site's shape when the
    port holds the affinity in another axis order."""
    dt = q.dtype
    if dt == torch.bfloat16 and q.device.type == "cpu":
        return causal_attention_dense(
            q.float(), k.float(), v.float(), dropout_rate, dropout_key, train, mask_layout
        ).to(dt)
    acc = torch.float64 if dt == torch.float64 else torch.float32
    t_q, t_k = q.shape[-2], k.shape[-2]
    scale = k.shape[-1] ** -0.5
    aff = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
    aff = torch.softmax(aff.masked_fill(~mask, float("-inf")), dim=-1)
    aff = dropout(aff, dropout_rate, dropout_key, train, mask_layout)
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
    package's ``causal_attention``: in the band on the card the
    self-attention kernel (dropout keyed by the collapsed row, as the JAX
    kernel keys it), the dense core elsewhere. The model's training forward
    takes the fused kernel instead; this core serves the KV-cache prefill,
    whose k and v go into the cache."""
    t, hs = q.shape[-2], q.shape[-1]
    use_dropout = train and dropout_rate > 0.0
    if _kernel_device(q.device, impl) and kernels.in_band(t, hs) and q.shape == k.shape == v.shape:
        return kernels.short_causal_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            dropout_rate if use_dropout else 0.0, dropout_key if use_dropout else None,
        )
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
    """Causal attention of the model's head-major query (H, B, T, hs) against
    J key/value streams (J, H, B, T, hs), summed over the streams.

    In the band on the card: the cross kernel, dropout keyed per stream and
    collapsed query row as the JAX kernel keys it. Elsewhere the dense core,
    whose dropout mask the JAX package draws over its (J, B, H, T, T)
    affinity; the port's affinity is (J, H, B, T, T), so the mask is built
    over JAX's shape and permuted."""
    t, hs = q.shape[-2], q.shape[-1]
    use_dropout = train and dropout_rate > 0.0
    if _kernel_device(q.device, impl) and kernels.in_band(t, hs):
        return kernels.short_cross_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            dropout_rate if use_dropout else 0.0, dropout_key if use_dropout else None,
        )
    layout = None
    if q.ndim == 4:
        J, H, B = k.shape[0], q.shape[0], q.shape[1]
        layout = ((J, B, H, t, t), (0, 2, 1, 3, 4))
    return causal_attention_dense(
        q[None], k, v, dropout_rate, dropout_key, train, layout
    ).sum(dim=0)
