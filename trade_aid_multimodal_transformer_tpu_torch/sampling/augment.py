"""Token augmentation on the device (port of the JAX package's
``sampling/augment.py``): each token id v with ``k < v < vocab_size - k`` is
shifted by a uniform draw from {-k, ..., k}; ids near the vocabulary edges
stay."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def apply_shifts(tokens: torch.Tensor, shifts: torch.Tensor, rand_size: int,
                 vocab_size: int) -> torch.Tensor:
    """tokens + shifts where the edge guard allows it."""
    k = int(rand_size)
    guard = (tokens > k) & (tokens < vocab_size - k)
    return tokens + shifts * guard


def augment_tokens(generator: torch.Generator, tokens: torch.Tensor, rand_size: int,
                   vocab_size: int) -> torch.Tensor:
    """Shift guarded tokens by uniform +-rand_size (any shape)."""
    k = int(rand_size)
    shifts = torch.randint(-k, k + 1, tokens.shape, generator=generator,
                           device=tokens.device, dtype=tokens.dtype)
    return apply_shifts(tokens, shifts, k, vocab_size)


def augment_windows(generator: torch.Generator, windows: torch.Tensor,
                    rand_sizes: Sequence[Optional[int]], vocab_sizes: Sequence[int]) -> torch.Tensor:
    """Per-modality augmentation over stacked (M, ...) windows; modalities
    with rand_size None pass through."""
    out: List[torch.Tensor] = []
    for m in range(windows.shape[0]):
        if rand_sizes[m] is None:
            out.append(windows[m])
        else:
            out.append(augment_tokens(generator, windows[m], rand_sizes[m], vocab_sizes[m]))
    return torch.stack(out)
