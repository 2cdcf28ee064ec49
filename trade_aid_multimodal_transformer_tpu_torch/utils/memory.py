"""Train-state memory accounting (port of the JAX package's
``utils/memory.py``).

The bytes of the parameters and the optimizer state, as the JAX package
counts its train-state leaves: every tensor at its size, the optimizer's
step count as one int32 (and the schedule's count, where optax keeps one).
The port's parallel plans replicate the train state on every rank, so the
per-device figure equals the total.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..models.init import tree_leaves


def train_state_bytes(params, opt_state=None, optimizer=None) -> Tuple[int, int]:
    """(total_bytes, per_device_bytes) of params (+ optimizer state)."""
    total = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    if opt_state is not None:
        for part in ("mu", "nu"):
            total += sum(t.numel() * t.element_size() for t in tree_leaves(opt_state[part]))
        total += 4  # the int32 step count
        if optimizer is not None and getattr(optimizer, "schedule_count", False):
            total += 4
    return total, total


def format_train_state_memory(params, opt_state=None, optimizer: Optional[object] = None) -> str:
    """One human line, e.g. ``train state: 12.4 MB``."""
    total, per_dev = train_state_bytes(params, opt_state, optimizer)
    if per_dev == total:
        return f"train state: {total / 1e6:.1f} MB"
    return f"train state: {total / 1e6:.1f} MB ({per_dev / 1e6:.1f} MB/device)"
