"""Directional-prediction metrics on the device (port of the JAX package's
``train/metrics.py``).

For each modality with an all-numeric vocabulary, the last position of each
evaluation sequence gives a predicted direction (the sign of the argmax
token's value for percent data, else the sign of its change from the last
input token), a win when it agrees with the actual direction, and a
"directional certainty": the softmax mass on every token whose direction
matches the prediction. Direction signs are host tables per modality (1-D for
percent data, (V, V) indexed [prev, cur] otherwise).
"""

from __future__ import annotations

import numbers
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ModalityMetricSpec:
    """Static per-modality metric configuration and sign table."""

    eligible: bool
    is_percent: bool
    sign_table: Optional[np.ndarray]

    @classmethod
    def build(cls, vocab: Sequence, is_percent: bool, block_size: int) -> "ModalityMetricSpec":
        numeric = all(isinstance(v, numbers.Number) for v in vocab)
        if not numeric or block_size < (1 if is_percent else 2):
            return cls(eligible=False, is_percent=is_percent, sign_table=None)
        vals = np.asarray([float(v) for v in vocab])
        if is_percent:
            table = np.sign(vals).astype(np.int8)
        else:
            table = np.sign(vals[None, :] - vals[:, None]).astype(np.int8)
        return cls(eligible=True, is_percent=is_percent, sign_table=table)


def batch_directional_metrics(
    logits_last: torch.Tensor, x_last: torch.Tensor, y_last: torch.Tensor,
    spec: ModalityMetricSpec,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wins, losses and summed certainty of one modality's batch.
    logits_last (B, V); x_last, y_last (B,) token ids."""
    table = torch.as_tensor(spec.sign_table, device=logits_last.device)
    pred_tok = logits_last.argmax(dim=-1)
    x_last, y_last = x_last.long(), y_last.long()
    if spec.is_percent:
        pred_dir, actual_dir = table[pred_tok], table[y_last]
        dir_all = table[None, :].expand_as(logits_last)
    else:
        pred_dir, actual_dir = table[x_last, pred_tok], table[x_last, y_last]
        dir_all = table[x_last]
    win = pred_dir == actual_dir
    probs = torch.softmax(logits_last, dim=-1)
    certainty = (probs * (dir_all == pred_dir[:, None])).sum()
    return win.sum(), (~win).sum(), certainty


def build_metric_specs(vocabularies: Sequence[Sequence], is_percent_flags: Sequence[bool],
                       block_size: int) -> List[ModalityMetricSpec]:
    return [ModalityMetricSpec.build(v, p, block_size)
            for v, p in zip(vocabularies, is_percent_flags)]
