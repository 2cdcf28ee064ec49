"""The comparison that decides ``correct``: the numbers the program's run
gives beside the plain reference's, each held to its limit.

Training (the first three steps of the object the window then drives):
- ``loss_gap``: the largest over the three steps of |L - L_ref| / |L_ref|;
- ``grad_norm_gap``: the first gradient (as the optimizer got it, worked
  out from its first moment after one step), the worst leaf's
  | |g| - |g_ref| | over the larger of |g_ref| of that leaf and of the
  median leaf;
- ``update_norm_gap``: the parameters' change after three steps, the same
  gap by the worst leaf, leaving out leaves whose reference gradient is
  under a thousandth of the median leaf's (they move by round-off alone).

Forecasts: ``token_gap``, the widest gap by which a served token's
perturbed reference logit lies below the reference's best. A forecast
token is drawn as argmax(p / q), q ~ Exp(1) from the request's generator
(``torch.multinomial``'s one-sample draw), so the served token is the
argmax of logit - log q, and with the request's q the reference's logits
judge it as they would a greedy token.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

RELEVANT = 1e-3  # of the median leaf's reference gradient


def _median(xs: Sequence[float]) -> float:
    return float(statistics.median(xs))


def norm_gap(got: Sequence[float], ref: Sequence[float], keep: Sequence[bool]) -> float:
    scale = _median([r for r, k in zip(ref, keep) if k])
    return max(abs(g - r) / max(r, scale) for g, r, k in zip(got, ref, keep) if k)


def training_numbers(prog: Dict[str, List[float]], ref: Dict[str, List[float]]) -> Dict[str, float]:
    """prog and ref hold ``losses`` (3), ``grad_norms`` and ``update_norms``
    (a leaf each)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    every = [True] * len(ref["grad_norms"])
    g_med = _median(ref["grad_norms"])
    moved = [g >= RELEVANT * g_med for g in ref["grad_norms"]]
    return {"loss_gap": loss,
            "grad_norm_gap": norm_gap(prog["grad_norms"], ref["grad_norms"], every),
            "update_norm_gap": norm_gap(prog["update_norms"], ref["update_norms"], moved)}


def token_gaps(ref_logits: torch.Tensor, noise: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per row: the reference's best perturbed logit minus the served
    token's (inf for a token outside the vocabulary)."""
    score = ref_logits.float() - torch.log(noise)
    V = score.shape[-1]
    inside = (tokens >= 0) & (tokens < V)
    got = score.gather(-1, tokens.clamp(0, V - 1)[:, None])[:, 0]
    gap = score.amax(dim=-1) - got
    return torch.where(inside, gap, torch.full_like(gap, float("inf")))


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; a number without a limit fails."""
    return {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
