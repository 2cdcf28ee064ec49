"""Threefry-2x32 key derivation (the JAX package's ``threefry2x32`` keys).

The pipeline's dropout keys (parallel/pipeline.py) are not the port's
``KeyGen`` salts: the JAX package's ``pipeline_total_loss`` splits the
step's threefry key into one key per (layer, microbatch) with
``jax.random.split`` and, under a data axis, folds each with the data place
(``jax.random.fold_in``); a block then reads words 0 and 1 of its key
(``ops.layers.KeyGen``). These functions compute the same keys on raw
uint32[2] keys, as Python ints or int64 tensors whose values are u32 (every
operation masked to 32 bits), so the pipeline's masks are JAX's own.

``threefry_split``'s key i is the hash of the counter pair (0, i), the
form of JAX's ``jax_threefry_partitionable`` setting, on by default since
JAX 0.5 (its legacy form hashes the counters 0 .. 2n - 1 as two halves);
``threefry_fold_in`` is the hash of (0, data).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

_U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Union[Sequence[int], torch.Tensor]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _U32


def _words(key: Key) -> torch.Tensor:
    """A raw key (or keys, (..., 2)) as an int64 tensor of u32 words."""
    if isinstance(key, torch.Tensor):
        return key.to(torch.int64) & _U32
    return torch.tensor([int(v) & _U32 for v in key], dtype=torch.int64)


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1),
    int64 tensors of u32 values, under the raw key (k0, k1) (or keys
    (..., 2), broadcast against the counters): JAX's ``threefry2x32_p``."""
    words = _words(key)
    k0, k1 = words[..., 0], words[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x = [(x0 + ks[0]) & _U32, (x1 + ks[1]) & _U32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _U32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _U32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _U32
    return x[0], x[1]


def threefry_split(key: Key, n: int) -> torch.Tensor:
    """``jax.random.split`` of a raw threefry key into ``n`` keys: an (n, 2)
    int64 tensor of u32 words."""
    y0, y1 = threefry2x32(key, torch.zeros(n, dtype=torch.int64),
                          torch.arange(n, dtype=torch.int64))
    return torch.stack([y0, y1], dim=1)


def threefry_fold_in(key: Key, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` of a raw threefry key (or of each of keys
    (..., 2)) with a u32 ``data``: int64 u32 words of the key's shape."""
    words = _words(key)
    zero = torch.zeros(words.shape[:-1], dtype=torch.int64)
    y0, y1 = threefry2x32(words, zero, zero + (int(data) & _U32))
    return torch.stack([y0, y1], dim=-1)
