"""Sampling: boundary-aware start indices, the device-resident batch feed,
and on-device augmentation (port of the JAX package's ``sampling/``)."""

from .augment import apply_shifts, augment_tokens, augment_windows
from .feed import BatchFeed, resolve_rand_sizes
from .indices import (
    SplitIndexPlan,
    gather_windows,
    generate_batch_starting_indices,
    split_file_lengths,
)

__all__ = [
    "apply_shifts",
    "augment_tokens",
    "augment_windows",
    "BatchFeed",
    "resolve_rand_sizes",
    "SplitIndexPlan",
    "gather_windows",
    "generate_batch_starting_indices",
    "split_file_lengths",
]
