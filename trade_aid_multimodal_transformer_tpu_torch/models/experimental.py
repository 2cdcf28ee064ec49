"""Experimental components of the reference kept for its API (port of the
JAX package's ``models/experimental.py``).

The reference ships two pieces that its active model does not use
(reference: model.py:247-282): a fixed (non-learnable) embedding whose
entries are drawn from a small set of configured values (the
``fixed_values`` system-config field), and a ``long_tanh`` activation.
"""

from __future__ import annotations

from typing import Sequence

import torch


def make_fixed_embedding_table(generator: torch.Generator, vocab_size: int, embed_size: int,
                               fixed_values: Sequence[float]) -> torch.Tensor:
    """Non-learnable (vocab_size, embed_size) f32 table, each entry drawn
    uniformly from ``fixed_values`` with ``generator``, on its device
    (reference: model.py:256-268). A constant: keep it out of the trained
    parameter tree."""
    vals = torch.tensor(list(fixed_values), dtype=torch.float32, device=generator.device)
    idx = torch.randint(0, vals.shape[0], (vocab_size, embed_size), generator=generator,
                        device=generator.device)
    return vals[idx]


def fixed_embedding_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T) int tokens -> (B, T, embed_size) fixed embeddings
    (reference: model.py:270-277)."""
    return table[tokens.long()]


def long_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh, then truncation toward zero to the integers {-1, 0, 1}, int64
    (reference: model.py:280-282)."""
    return torch.tanh(x).to(torch.int64)
