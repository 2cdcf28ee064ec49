"""Parallel training (port of the JAX package's ``parallel/trainer.py``:
``make_sharded_trainer`` for data and sequence axes, ``_compose_scopes`` and
``make_shard_map_dp_step``).

``make_sharded_trainer`` gives every rank the port's ``Trainer`` on the same
parameters, batches and dropout salts (the same seed on every rank):
- On a data axis of P ranks each rank keeps its rows [r B / P, (r + 1) B / P)
  of every global batch (drawn whole by every rank, then sliced, as the JAX
  package's ``batch_pspec`` shards it), keys its dropout masks by global
  rows, and takes the gradient of its local-mean loss; one flat all-reduce
  in ``tree_leaves`` order averages loss and gradients over the axis, so a
  step computes what the one-rank step computes on the global batch and
  every rank keeps the same parameters. Evaluation sums its statistics over
  the axis.
- On a sequence axis its training steps and evaluation passes run inside
  ``context_parallel_scope``: each attention core goes through ring
  attention over the rank's sequence group, the gradients come out the same
  on every rank of the group with no all-reduce.
- Both (data x sequence): the ring keys its masks by the rank's local rows
  with the dropout key folded with the data rank, as the JAX package's
  ``shard_map`` body does; every other site stays keyed by global rows.

``make_shard_map_dp_step`` is the explicit data-parallel step, kept as a
cross-check of the trainer: each rank draws its own B / P rows from
generators keyed by ``rank_seed(seed, rank)`` and the gradients are
averaged over the axis.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from ..models.config import ModelConfig
from ..models.init import tree_leaves
from ..models.transformer import total_loss
from ..ops.attention import context_parallel_scope, fold_key
from ..ops.layers import _U32
from ..sampling.feed import BatchFeed
from ..train.metrics import ModalityMetricSpec
from ..train.steps import AdamW, StepRng, Trainer
from .mesh import DataAxis, RankMesh


def make_sharded_trainer(cfg: ModelConfig, feed: BatchFeed, optimizer: AdamW,
                         metric_specs: Sequence[ModalityMetricSpec], eval_iters: int,
                         mesh: RankMesh, grad_accum: int = 1) -> Trainer:
    """A Trainer whose steps run over this rank's data and sequence axes
    (``parallel.mesh.make_mesh``). block_size must be divisible by the
    sequence axis."""
    seq, data = mesh.seq, mesh.data
    scopes = []
    if seq is not None and seq.size > 1:
        if cfg.block_size % seq.size != 0:
            raise ValueError(
                f"context parallelism needs block_size ({cfg.block_size}) "
                f"divisible by the 'seq' mesh axis ({seq.size})")
        data_rank = data.rank if data is not None else None
        scopes.append(lambda: context_parallel_scope(seq, data_rank))
    return Trainer(cfg, feed, optimizer, metric_specs, eval_iters, grad_accum=grad_accum,
                   scope=_compose_scopes(scopes) if scopes else None, data=data)


def _compose_scopes(factories: Sequence[Callable]) -> Callable:
    """One zero-argument context-manager factory entering all the given
    factories, in order."""

    @contextlib.contextmanager
    def combined():
        with contextlib.ExitStack() as stack:
            for f in factories:
                stack.enter_context(f())
            yield

    return combined


def rank_seed(seed: int, rank: int) -> int:
    """The seed of data rank ``rank``'s own draws in the explicit step: the
    seed's two u32 words with ``fold_key`` of the rank (``jax.random.fold_in``
    of the JAX package's step)."""
    lo, hi = fold_key((seed & _U32, (seed >> 32) & _U32), rank)
    return (hi << 32) | lo


def make_shard_map_dp_step(cfg: ModelConfig, feed: BatchFeed, optimizer: AdamW,
                           data: DataAxis) -> Callable:
    """The explicit data-parallel step over ``data``: returns ``step(params,
    opt_state, seed) -> loss``, which on each rank draws B / P augmented
    training rows and its dropout salts from ``StepRng(rank_seed(seed,
    rank))``, takes the gradients of their mean loss (masks keyed by the
    rank's own rows), averages loss and gradients over the axis and updates
    params and opt_state in place. The global batch is the union of the
    ranks' draws."""
    if feed.batch_size % data.size != 0:
        raise ValueError(f"batch_size {feed.batch_size} not divisible by data axis {data.size}")
    per_rank = feed.batch_size // data.size

    def step(params, opt_state, seed: int) -> torch.Tensor:
        rng = StepRng(rank_seed(seed, data.rank), feed.device)
        xb, yb = feed.sample(rng.batch, "train", augment=True, batch_size=per_rank)
        loss, _ = total_loss(params, cfg, xb, yb, rng.salts(), True)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        loss, grads = data.mean_grads(loss.detach(), grads)
        optimizer.update_(params, grads, opt_state)
        return loss

    return step
