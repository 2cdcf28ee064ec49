"""File-boundary-aware batch start indices (port of the JAX package's
``sampling/indices.py``).

A start is valid when the input window (block_size) and the shifted target
window both fit inside one file: ``L - (block_size + 1) - offset + 1``
positions per file of length L, where percent data skips each file's first
element (offset 1). The train split owns files from the front of
``file_lengths``; the val split owns files from the back, reversed, with the
boundary file truncated to the split size. The per-file valid counts are
computed once on the host; a step maps uniform draws over all valid
positions to starts with one ``searchsorted`` on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


def split_file_lengths(file_lengths: List[int], data_size: int, split: str) -> List[int]:
    """Per-file lengths of one split, reconstructed from the full dataset's
    file lengths."""
    if split not in ("train", "val"):
        raise ValueError("'split' must be 'train' or 'val'.")
    dataset_file_lengths: List[int] = []
    accum = 0
    n_files = len(file_lengths)
    for f in range(n_files):
        this = file_lengths[f] if split == "train" else file_lengths[n_files - 1 - f]
        accum += this
        if accum <= data_size:
            dataset_file_lengths.append(this)
        if accum > data_size:
            dataset_file_lengths.append(data_size - (accum - this))
        if accum >= data_size:
            break
    if split == "val":
        dataset_file_lengths.reverse()
    return dataset_file_lengths


@dataclass(frozen=True)
class SplitIndexPlan:
    """Host-precomputed arrays that make start sampling a single gather:
    each split-file's offset (``file_starts``), its number of valid starts
    (``valid_counts``), their exclusive prefix sums (``cum_valid``), the
    total, and the percent offset."""

    file_starts: np.ndarray
    valid_counts: np.ndarray
    cum_valid: np.ndarray
    total_valid: int
    first_offset: int
    block_size: int

    @classmethod
    def build(cls, data_size: int, block_size: int, split: str, file_lengths: List[int],
              is_percents: bool) -> "SplitIndexPlan":
        if not isinstance(data_size, int) or data_size <= 0:
            raise TypeError("'data_size' must be a positive integer.")
        if not isinstance(block_size, int) or block_size <= 0:
            raise TypeError("'block_size' must be a positive integer.")
        if block_size >= data_size:
            raise ValueError("'block_size' cannot be equal to or greater than 'data_size'.")
        if not isinstance(file_lengths, list) or len(file_lengths) < 1:
            raise TypeError("'file_lengths' must be a list containing at least 1 element.")
        if not isinstance(is_percents, bool):
            raise TypeError("'is_percents' must be a boolean.")
        first_offset = 1 if is_percents else 0
        lengths = [data_size] if len(file_lengths) == 1 else split_file_lengths(
            file_lengths, data_size, split)
        lengths_arr = np.asarray(lengths, dtype=np.int64)
        valid = np.maximum(0, lengths_arr - (block_size + 1) - first_offset + 1)
        total = int(valid.sum())
        if total <= 0:
            raise ValueError(
                "No valid starting positions available for the given block size "
                "and file lengths."
            )
        return cls(
            file_starts=np.concatenate(([0], np.cumsum(lengths_arr)[:-1])).astype(np.int64),
            valid_counts=valid.astype(np.int64),
            cum_valid=np.concatenate(([0], np.cumsum(valid))).astype(np.int64),
            total_valid=total,
            first_offset=first_offset,
            block_size=block_size,
        )

    def starts_from_draws(self, r: torch.Tensor) -> torch.Tensor:
        """Starts of uniform draws r in [0, total_valid) (int64, any device)."""
        cum = torch.as_tensor(self.cum_valid, device=r.device)
        k = torch.searchsorted(cum, r, right=True) - 1
        return torch.as_tensor(self.file_starts, device=r.device)[k] + (r - cum[k]) + self.first_offset

    def sample_starts(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Draw batch start indices uniformly over all valid positions, on
        the generator's device."""
        r = torch.randint(0, self.total_valid, (batch_size,), generator=generator,
                          device=generator.device)
        return self.starts_from_draws(r)

    def valid_start_set(self) -> np.ndarray:
        """All valid starts, enumerated on the host (testing)."""
        out = []
        for start, count in zip(self.file_starts, self.valid_counts):
            out.extend(range(start + self.first_offset, start + self.first_offset + count))
        return np.asarray(out, dtype=np.int64)


def generate_batch_starting_indices(
    data_size: int,
    block_size: int,
    batch_size: int,
    split: str,
    file_lengths: List[int],
    is_percents: bool,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The reference's one-shot signature (reference: training_utils.py:33-181):
    ``batch_size`` uniform draws over the split's valid starts, on the
    generator's device (a CPU generator seeded from numpy's global generator
    when none is given, as the JAX package draws its key)."""
    if not isinstance(batch_size, int) or batch_size <= 0:
        raise TypeError("'batch_size' must be a positive integer.")
    plan = SplitIndexPlan.build(data_size, block_size, split, file_lengths, is_percents)
    if generator is None:
        generator = torch.Generator().manual_seed(int(np.random.randint(0, 2**31 - 1)))
    return plan.sample_starts(generator, batch_size)


def gather_windows(data: torch.Tensor, starts: torch.Tensor, block_size: int) -> torch.Tensor:
    """(..., batch, block_size + 1) windows of data (..., N) at starts."""
    offsets = torch.arange(block_size + 1, device=starts.device)
    return data[..., starts[:, None] + offsets[None, :]]
