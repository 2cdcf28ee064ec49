"""Context-parallel training (port of the JAX package's
``parallel/trainer.py`` ``make_sharded_trainer`` for a sequence-only mesh).

Every rank runs the port's ``Trainer`` on the same parameters, batches and
dropout salts (the same seed on every rank); its training steps and
evaluation passes run inside ``context_parallel_scope``, so each attention
core goes through ring attention over the sequence axis and nothing else is
sharded, as the JAX package's sequence-only mesh does under ``shard_map``
and GSPMD. The gradients come out the same on every rank, with no
all-reduce.
"""

from __future__ import annotations

from typing import Sequence

from ..models.config import ModelConfig
from ..ops.attention import context_parallel_scope
from ..sampling.feed import BatchFeed
from ..train.metrics import ModalityMetricSpec
from ..train.steps import AdamW, Trainer
from .mesh import SeqMesh


def make_sharded_trainer(cfg: ModelConfig, feed: BatchFeed, optimizer: AdamW,
                         metric_specs: Sequence[ModalityMetricSpec], eval_iters: int,
                         mesh: SeqMesh, grad_accum: int = 1) -> Trainer:
    """A Trainer whose steps run attention context-parallel over ``mesh``.
    block_size must be divisible by the sequence axis."""
    if cfg.block_size % mesh.size != 0:
        raise ValueError(
            f"context parallelism needs block_size ({cfg.block_size}) "
            f"divisible by the 'seq' mesh axis ({mesh.size})")
    return Trainer(cfg, feed, optimizer, metric_specs, eval_iters, grad_accum=grad_accum,
                   scope=lambda: context_parallel_scope(mesh))
