"""Device-resident batch feed (port of the JAX package's
``sampling/feed.py``): the tokenized splits live on the device, stacked over
the modality axis; each draw samples starts (``SplitIndexPlan``), gathers
(M, B, T + 1) windows with the same starts for every modality, augments the
windows (training only) and splits them into inputs and targets.

Augmentation size: slot [7] of each modality's legacy list (randomness_size,
the documented intent) by default; ``compat_legacy_rand_index`` reads slot
[2] like the reference, and with it ``augment_shared`` perturbs the whole
train array once per draw, the reference's shared-noise scope.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .augment import augment_windows
from .indices import SplitIndexPlan, gather_windows


def resolve_rand_sizes(all_modality_params: Sequence[Sequence],
                       compat_legacy_rand_index: bool = False) -> List[Optional[int]]:
    """Per-modality augmentation sizes from the legacy parameter lists."""
    out: List[Optional[int]] = []
    for params in all_modality_params:
        if compat_legacy_rand_index:
            raw = params[2] if len(params) > 2 else None
            if raw is None:
                out.append(None)
            else:
                k = int(raw)
                if k < 1 or k > 3:
                    raise ValueError("rand_size must be an integer between 1 and 3, or null.")
                out.append(k)
        else:
            raw = params[7] if len(params) > 7 else None
            out.append(int(raw) if raw is not None else None)
    return out


class BatchFeed:
    """Per-run batch source for all modalities, on ``device``."""

    def __init__(
        self,
        train_sets: Sequence[np.ndarray],
        val_sets: Sequence[np.ndarray],
        file_lengths: List[int],
        block_size: int,
        batch_size: int,
        is_percents: bool,
        rand_sizes: Sequence[Optional[int]],
        vocab_sizes: Sequence[int],
        augment_shared: bool = False,
        device: str | torch.device = "cpu",
    ):
        self.num_modalities = len(train_sets)
        self.block_size = block_size
        self.batch_size = batch_size
        self.rand_sizes = list(rand_sizes)
        self.vocab_sizes = list(vocab_sizes)
        self.augment_shared = bool(augment_shared)
        self.device = torch.device(device)
        self.train_data = torch.from_numpy(np.stack(train_sets).astype(np.int64)).to(self.device)
        self.val_data = torch.from_numpy(np.stack(val_sets).astype(np.int64)).to(self.device)
        self.train_plan = SplitIndexPlan.build(
            int(self.train_data.shape[1]), block_size, "train", file_lengths, is_percents)
        self.val_plan = SplitIndexPlan.build(
            int(self.val_data.shape[1]), block_size, "val", file_lengths, is_percents)

    def sample(self, generator: torch.Generator, split: str, augment: bool,
               batch_size: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(xb, yb), each (M, B, T) int64 on the feed's device."""
        data = self.train_data if split == "train" else self.val_data
        plan = self.train_plan if split == "train" else self.val_plan
        starts = plan.sample_starts(generator, batch_size or self.batch_size)
        if augment and self.augment_shared:
            data = augment_windows(generator, data, self.rand_sizes, self.vocab_sizes)
        windows = gather_windows(data, starts, self.block_size)  # (M, B, T + 1)
        if augment and not self.augment_shared:
            windows = augment_windows(generator, windows, self.rand_sizes, self.vocab_sizes)
        return windows[:, :, :self.block_size], windows[:, :, 1:]

    def get_batch(self, generator: torch.Generator, split: str,
                  is_training: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """One batch; augmentation only for training batches."""
        augment = bool(is_training) and any(k is not None for k in self.rand_sizes)
        return self.sample(generator, split, augment)
