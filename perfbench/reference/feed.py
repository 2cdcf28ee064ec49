"""The training batches and dropout keys of a run, worked out from the
seed as the configuration defines them.

A step draws ``B`` window starts uniformly over the valid starts of the
train split (a window of T + 1 tokens lies inside one file; where a
modality holds percent changes each file's first token is skipped), from
a generator on the device seeded with the run's seed; then, for each
modality with a randomness size k, a shift in {-k..k} for every token of
every window (tokens within k of either end of the vocabulary stay);
inputs are the first T tokens of a window, targets the last T. The step's
dropout key is two u32 drawn from a host generator seeded with
seed ^ 0x5DEECE66D.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch


def split_lengths(file_lengths: Sequence[int], data_size: int) -> List[int]:
    """Lengths of the files of the train split (files from the front, the
    last one cut to the split's size)."""
    out, acc = [], 0
    for n in file_lengths:
        take = min(n, data_size - acc)
        if take <= 0:
            break
        out.append(take)
        acc += take
    return out


class Starts:
    def __init__(self, data_size: int, file_lengths: Sequence[int], T: int, skip_first: bool):
        lengths = split_lengths(file_lengths, data_size) if len(file_lengths) > 1 else [data_size]
        off = 1 if skip_first else 0
        valid = [max(0, n - (T + 1) - off + 1) for n in lengths]
        self.offset = off
        self.file_start = [sum(lengths[:i]) for i in range(len(lengths))]
        self.cum = [sum(valid[:i]) for i in range(len(valid) + 1)]
        self.total = self.cum[-1]

    def draw(self, gen: torch.Generator, B: int) -> torch.Tensor:
        r = torch.randint(0, self.total, (B,), generator=gen, device=gen.device)
        cum = torch.tensor(self.cum, device=r.device)
        k = torch.searchsorted(cum, r, right=True) - 1
        return torch.tensor(self.file_start, device=r.device)[k] + (r - cum[k]) + self.offset


def batches(seed: int, data: torch.Tensor, file_lengths: Sequence[int], T: int, B: int,
            skip_first: bool, rand_sizes: Sequence[Optional[int]], vocab_sizes: Sequence[int],
            ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]]:
    """(inputs (M, B, T), targets (M, B, T), dropout key) of each step."""
    gen = torch.Generator(device=data.device).manual_seed(int(seed))
    host = torch.Generator().manual_seed(int(seed) ^ 0x5DEECE66D)
    starts = Starts(int(data.shape[1]), file_lengths, T, skip_first)
    offsets = torch.arange(T + 1, device=data.device)
    while True:
        s = starts.draw(gen, B)
        win = data[:, s[:, None] + offsets[None, :]]
        out = []
        for m in range(win.shape[0]):
            k = rand_sizes[m]
            if k is None:
                out.append(win[m])
                continue
            shift = torch.randint(-k, k + 1, win[m].shape, generator=gen, device=data.device,
                                  dtype=win.dtype)
            guard = (win[m] > k) & (win[m] < vocab_sizes[m] - k)
            out.append(win[m] + shift * guard)
        win = torch.stack(out)
        salts = torch.randint(0, 1 << 32, (2,), generator=host, dtype=torch.int64)
        yield win[:, :, :T], win[:, :, 1:], (int(salts[0]), int(salts[1]))
