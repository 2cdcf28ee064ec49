"""Autoregressive sampling over a rolling window (port of the JAX package's
``models/sampler.py``).

Semantics are those of ``generate`` (models/transformer.py): crop to the last
``block_size`` tokens, sample the target modality from the softmax of the last
position, and keep the other modalities length-consistent by repeating their
own last token. While the context is shorter than ``block_size`` each step
runs at the true, growing length; once the window is full the loop carries
only the (M, B, block_size) window. Each token is one full-window forward; the
generator is drawn once per token, as in ``generate``, so the two produce the
same tokens for the same generator state.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .config import ModelConfig
from .transformer import forward, sample_last


def _step(
    params: Dict[str, Any], cfg: ModelConfig, window: torch.Tensor,
    generator: torch.Generator, modality_to_generate: int,
) -> torch.Tensor:
    """One sampling step on a (M, B, t) window; returns the new (M, B) column:
    the sampled token for the target modality, each other modality's last."""
    logits_list, _ = forward(params, cfg, window)
    nxt = sample_last(logits_list[modality_to_generate][:, -1, :], generator)
    col = window[:, :, -1].clone()
    col[modality_to_generate] = nxt.to(window.dtype)
    return col


@torch.inference_mode()
def generate_fast(
    params: Dict[str, Any],
    cfg: ModelConfig,
    idx: torch.Tensor,
    generator: torch.Generator,
    max_new_tokens: int = 1,
    modality_to_generate: int = 0,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` tokens for one modality.

    idx: (M, B, T0) stacked equal-length token ids on the params' device;
    ``generator`` lives on that device too. Returns (M, B, T0 + max_new_tokens).
    """
    if idx.ndim != 3:
        raise ValueError("idx must be (num_modalities, B, T) stacked ids")
    seq = idx
    produced = 0
    while seq.shape[-1] < cfg.block_size and produced < max_new_tokens:
        col = _step(params, cfg, seq, generator, modality_to_generate)
        seq = torch.cat([seq, col[:, :, None]], dim=-1)
        produced += 1
    remaining = max_new_tokens - produced
    if remaining > 0:
        window = seq[:, :, -cfg.block_size:]
        cols = []
        for _ in range(remaining):
            col = _step(params, cfg, window, generator, modality_to_generate)
            window = torch.cat([window[:, :, 1:], col[:, :, None]], dim=-1)
            cols.append(col)
        seq = torch.cat([seq, torch.stack(cols, dim=-1)], dim=-1)
    return seq
