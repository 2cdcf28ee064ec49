"""The inputs of a run, made on the device from ``--seed``: token series,
the split, the weights' seed and the seeds of the steps and requests.
Both the program and the reference get these same inputs."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def sub_seed(seed: int, tag: int) -> int:
    """An independent seed for one use of the run's seed (64-bit)."""
    return (int(seed) * 1_000_003 + tag * 7_919 + 1) % (1 << 63)


WEIGHTS, DATA, STEPS, REQUESTS, SAMPLE = range(5)


def token_series(spec, n: int, seed: int, device, rows: int = 1) -> torch.Tensor:
    """(M, rows, n) uniform token ids of each modality's vocabulary."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, DATA))
    return torch.stack([torch.randint(0, V, (rows, n), generator=gen, device=device)
                        for V in spec.vocab_sizes])


def training_data(spec, traffic: Dict[str, Any], seed: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """The training universe: ``files`` series of ``rows_per_file`` bars
    each, concatenated; the last ``validation_files`` files are the
    validation split. Returns (train (M, N_train), val (M, N_val), the
    per-file lengths)."""
    files, per = int(traffic["files"]), int(traffic["rows_per_file"])
    data = token_series(spec, files * per, seed, device)[:, 0]
    n_val = int(traffic["validation_files"]) * per
    return data[:, :-n_val], data[:, -n_val:], [per] * files
