"""Train-state memory accounting (port of the JAX package's
``utils/memory.py``).

The bytes of the parameters and the optimizer state, as the JAX package
counts its train-state leaves: every tensor at its size, the optimizer's
step count as one int32 (and the schedule's count, where optax keeps one).
The per-device figure is what this rank holds: under FSDP, tensor and
modality parallelism a split leaf (and its moments) at its part's size, every other
leaf whole, as the JAX package's ``_leaf_bytes`` reads a leaf's shard
shape; where no leaf is split every rank holds the whole state, so the
figure equals the total.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..models.init import tree_leaves


def train_state_bytes(params, opt_state=None, optimizer=None,
                      parts: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """(total_bytes, per_device_bytes) of params (+ optimizer state) as this
    rank holds them. ``parts``: per leaf (``tree_leaves`` order) the number
    of ranks it is split over, over the model, modality and data axes together
    (``parallel.trainer.Fsdp.parts``; None: every leaf whole), the same for
    the moments."""
    trees = [params] + ([opt_state["mu"], opt_state["nu"]] if opt_state is not None else [])
    total = per_dev = 0
    for tree in trees:
        leaves = tree_leaves(tree)
        for t, n in zip(leaves, parts if parts is not None else [1] * len(leaves)):
            held = t.numel() * t.element_size()
            per_dev += held
            total += held * n
    if opt_state is not None:
        counts = 4  # the int32 step count
        if optimizer is not None and getattr(optimizer, "schedule_count", False):
            counts += 4
        total += counts
        per_dev += counts
    return total, per_dev


def format_train_state_memory(params, opt_state=None, optimizer: Optional[object] = None,
                              parts: Optional[Sequence[int]] = None) -> str:
    """One human line, e.g. ``train state: 12.4 MB (3.1 MB/device)``."""
    total, per_dev = train_state_bytes(params, opt_state, optimizer, parts)
    if per_dev == total:
        return f"train state: {total / 1e6:.1f} MB"
    return f"train state: {total / 1e6:.1f} MB ({per_dev / 1e6:.1f} MB/device)"
