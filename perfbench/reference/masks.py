"""The model's dropout keep-masks, frozen from the program's definition.

Every mask is an integer hash of the element's coordinates salted by two
u32 values; u32 arithmetic runs in int64 masked to 32 bits. The functions
take explicit row indices (the collapsed leading axes of the tensor that
the program drops out), so that the reference can compute any block of
rows of a batch and still draw the masks of the whole batch.

Three families, as the model on the card draws them:

- ``site_keep``: the output dropout sites (self-attention and cross
  projection outputs, feed-forward): the per-axis salt hash of
  ``ops/layers.py`` ``hash_keep_mask_nd``.
- ``attention_keep``: attention-probability dropout in the whole-row band
  (T <= 512): one hash of (seed, row, query, key) per element, the
  whole-row kernels' ``hash_keep_mask`` with block indices 0.
- ``flash_keep``: the same hash on the flash kernels' block grid (T >= 256,
  T % 128 == 0, above the whole-row band): block indices (iq, jk) and the
  element's place inside its block.
"""

from __future__ import annotations

from typing import Tuple

import torch

U32 = 0xFFFFFFFF
STREAM_SEED_STRIDE = 1000003
WHOLE_ROW_MAX_T = 512
FLASH_BLOCK = 512
FLASH_BLOCK_STEP = 128


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 tensors holding u32 values."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & U32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer."""
    h = h ^ (h >> 16)
    h = mul32(h, 2246822519)
    h = h ^ (h >> 13)
    h = mul32(h, 3266489917)
    return h ^ (h >> 16)


def mix32_int(i: int) -> int:
    h = i & U32
    h ^= h >> 16
    h = (h * 2246822519) & U32
    h ^= h >> 13
    h = (h * 3266489917) & U32
    return h ^ (h >> 16)


def threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


class SiteKeys:
    """The salt pairs of a forward's dropout sites: two salts from the key,
    the second rotated left by 9 bits; site i (from 1) gets
    (s1, s2 ^ mix32(i)). The forward draws one pair per block, and each
    block draws its sites from its pair the same way."""

    def __init__(self, key: Tuple[int, int]):
        self.s1 = int(key[0]) & U32
        s2 = int(key[-1]) & U32
        self.s2 = ((s2 << 9) | (s2 >> 23)) & U32
        self.count = 0

    def __call__(self) -> Tuple[int, int]:
        self.count += 1
        return self.s1, self.s2 ^ mix32_int(self.count)


def kernel_seed(salts: Tuple[int, int]) -> int:
    """The attention kernels' seed of a site's salt pair (s0 ^ s1, u32)."""
    return (int(salts[0]) ^ int(salts[1])) & U32


def stream_seed(seed: int, j: int) -> int:
    """Cross-attention stream j's seed."""
    return (seed + (j + 1) * STREAM_SEED_STRIDE) & U32


def site_keep(salts: Tuple[int, int], rows: torch.Tensor, R: int, C: int,
              rate: float) -> torch.Tensor:
    """Keep-mask (*rows.shape, R, C) of an output site whose collapsed
    leading axes have the global indices ``rows``."""
    s1, s2 = int(salts[0]) & U32, int(salts[1]) & U32
    dev = rows.device
    rv = mix32((mul32(torch.arange(R, device=dev), 2246822519) + s1) & U32)
    cv = mix32((mul32(torch.arange(C, device=dev), 3266489917) + (s2 ^ 0x9E3779B9)) & U32)
    nv = mix32((mul32(rows.to(torch.int64), 2654435761) + (s1 ^ ((s2 * 97) & U32))) & U32)
    h = (nv[..., None, None] + rv[:, None] + cv[None, :]) & U32
    h = (h + (h << 3)) & U32
    h ^= h >> 11
    h = (h + (h << 15)) & U32
    h ^= h >> 7
    h = (h + (h << 9)) & U32
    h ^= h >> 16
    return h >= threshold(rate)


def _element_hash(seed: int, rows: torch.Tensor, iq: int, jk: int, r: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    n = rows.to(torch.int64)[..., None, None] & U32
    x = ((int(seed) & U32) * 2654435761 & U32) ^ mul32(n, 40503)
    x = x ^ ((int(iq) & U32) * 1000003 & U32) ^ ((int(jk) & U32) * 97 & U32)
    h = (mul32(r[:, None], 2246822519) + mul32(c[None, :], 3266489917) + x) & U32
    h = h ^ (h >> 13)
    h = mul32(h, 2654435761)
    return h ^ (h >> 16)


def attention_keep(seed: int, rows: torch.Tensor, T: int, rate: float) -> torch.Tensor:
    """Whole-row band keep-mask (*rows.shape, T, T) over (query, key)."""
    ar = torch.arange(T, device=rows.device)
    return _element_hash(seed, rows, 0, 0, ar, ar) >= threshold(rate)


def flash_block(t: int) -> int:
    """The flash kernels' block: the largest multiple of 128 <= 512 that
    divides t."""
    b = min(FLASH_BLOCK, t)
    while t % b:
        b -= FLASH_BLOCK_STEP
    return b


def flash_keep(seed: int, rows: torch.Tensor, T: int, rate: float) -> torch.Tensor:
    """Flash band keep-mask (*rows.shape, T, T): element (r, c) of block
    (iq, jk) hashed with the block indices and its place in the block.
    Blocks above the causal diagonal are all kept (their scores are
    masked anyway)."""
    bq = flash_block(T)
    out = torch.ones(*rows.shape, T, T, dtype=torch.bool, device=rows.device)
    ar = torch.arange(bq, device=rows.device)
    thr = threshold(rate)
    for iq in range(T // bq):
        for jk in range(iq + 1):
            out[..., iq * bq:(iq + 1) * bq, jk * bq:(jk + 1) * bq] = (
                _element_hash(seed, rows, iq, jk, ar, ar) >= thr)
    return out


def fused_batch_group(B: int, H: int, T: int, hs: int, C: int, itemsize: int) -> int:
    """The batch group of the whole-row fused self-attention mask: the
    largest of 32..1 dividing B whose rows fit the 7 MiB budget."""
    budget = 7 * 1024 * 1024
    att_row = (10 * T * hs + 5 * T * T) * 2 * itemsize * H
    proj_row = T * (C + 3 * H * (hs // 2) * 3) * 2 * itemsize
    for gb in (32, 16, 8, 4, 2, 1):
        if B % gb == 0 and gb * (att_row + proj_row) <= budget:
            return gb
    return 1


def fused_rows(M: int, b: torch.Tensor, B: int, H: int, gb: int) -> torch.Tensor:
    """(M, len(b), H) mask rows of self-attention in the whole-row band for
    global batch rows ``b`` of a batch of B."""
    m = torch.arange(M, device=b.device)[:, None, None]
    h = torch.arange(H, device=b.device)[None, None, :]
    bb = b.to(torch.int64)[None, :, None]
    pid = m * (B // gb) + bb // gb
    return pid * gb * H + h * gb + bb % gb
