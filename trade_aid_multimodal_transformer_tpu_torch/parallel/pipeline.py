"""Pipeline parallelism: the block stack split over a pipeline axis (port of
the JAX package's ``parallel/pipeline.py``).

A GPipe schedule over S stages and µ microbatches: stage s holds layers
[s L / S, (s + 1) L / S) (``PipeAxis.layers``), microbatch i is rows
[i b, (i + 1) b) of the batch (b = B / µ: JAX's ``x.reshape(M, µ, b, T, C)``).
Stage 0 feeds from the microbatches, a later stage from the previous
stage's output (``PipeAxis.recv_prev``), every stage but the last hands its
output on (``send_next``), and the last stage's outputs, concatenated back
into the batch, are replicated over the axis (``replicate``: JAX's psum),
where every stage runs the vocabulary heads and the loss. The handoffs are
autograd functions whose backward is the reverse handoff, so the
differentiation of the loss is the backward pipeline (the last microbatch
first): a stage differentiates with ``PipeAxis.anchor`` among its inputs,
so that its receives' backward sends run.

The JAX package computes every tick of the schedule and masks the idle
ones; here a stage runs only its (layer, microbatch) pairs: the same values
and gradients, without the idle work.

Dropout: layer l of microbatch i takes the key ``keys[l, i]``, one of
``jax.random.split(rng, L µ)`` of the step's threefry key
(``utils/threefry.py``), folded with the data place under a data axis, so
that the masks are the JAX package's. The masks are keyed by the
microbatch's own rows (no ``batch_slice_scope``). ``cfg.remat`` is not
applied inside the pipeline, as in the JAX package (its body calls
``block_forward`` itself).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..models.config import ModelConfig
from ..models.init import map_tree, tree_leaves, tree_paths
from ..models.transformer import block_forward, cross_entropy, embed, logits_heads
from ..utils.threefry import threefry_fold_in, threefry_split


def stack_blocks(blocks: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The per-layer block trees as one tree with leading L axes (every
    block has the same structure, cross-attention leaves or none)."""
    columns = iter([torch.stack(leaves) for leaves in zip(*map(tree_leaves, blocks))])
    return map_tree(lambda _: next(columns), blocks[0])


def unstack_blocks(stacked: Dict[str, Any], n_layer: int) -> List[Dict[str, Any]]:
    """Inverse of ``stack_blocks``."""
    return [map_tree(lambda t, i=i: t[i], stacked) for i in range(n_layer)]


def pipeline_rows(batch: int, microbatches: int, rank: int, size: int) -> torch.Tensor:
    """The rows of a global batch that data rank ``rank`` of ``size`` holds
    under a pipeline axis: of every microbatch i of b = batch / µ rows its
    b / size rows [i b + rank b / size, i b + (rank + 1) b / size) (the JAX
    package shards each microbatch's rows over 'data'), in order."""
    if batch % (microbatches * size) != 0:
        raise ValueError(f"pipeline_microbatches ({microbatches}) x mesh.data ({size}) "
                         f"must divide batch_size ({batch})")
    b, per = batch // microbatches, batch // microbatches // size
    return (torch.arange(microbatches)[:, None] * b + rank * per + torch.arange(per)).reshape(-1)


def pipeline_keys(rng, cfg: ModelConfig, microbatches: int, train: bool
                  ) -> Optional[torch.Tensor]:
    """The (L, µ, 2) dropout keys of a step: ``jax.random.split`` of the raw
    threefry key ``rng`` into L µ keys (layer-major), or None where no
    dropout runs."""
    if rng is None or not train or cfg.dropout <= 0.0:
        return None
    return threefry_split(rng, cfg.n_layer * microbatches).reshape(
        cfg.n_layer, microbatches, 2)


def pipeline_apply(blocks, x: torch.Tensor, keys: Optional[torch.Tensor], cfg: ModelConfig,
                   train: bool, pipe=None, microbatches: int = 4, data=None) -> torch.Tensor:
    """The block stack over x (M, B, T, C) in the GPipe schedule over
    ``pipe`` (a ``parallel.mesh.PipeAxis``; None: one stage). ``blocks``:
    the per-layer list (a stage reads its own layers); ``keys``: (L, µ, 2)
    raw keys or None; ``data``: the data axis whose place folds the keys.
    On a stage after the first x is read for its shape and type alone.
    Returns the output on every stage."""
    L = len(blocks)
    S = 1 if pipe is None else pipe.size
    if L % S != 0:
        raise ValueError(f"n_layer {L} not divisible by pipe axis {S}")
    M, B, T, C = x.shape
    if B % microbatches != 0:
        raise ValueError(f"batch {B} not divisible by microbatches {microbatches}")
    b = B // microbatches
    l0, per = (0, L) if pipe is None else pipe.layers(L)
    first, last = pipe is None or pipe.rank == 0, pipe is None or pipe.rank == S - 1
    if keys is not None and data is not None and data.size > 1:
        keys = keys.clone()
        keys[l0:l0 + per] = threefry_fold_in(keys[l0:l0 + per], data.rank)
    outs, tokens = [], []
    for i in range(microbatches):
        h = x[:, i * b:(i + 1) * b] if first else pipe.recv_prev((M, b, T, C), x.dtype, x.device)
        for l in range(l0, l0 + per):
            h = block_forward(h, blocks[l], None if keys is None else keys[l, i], cfg, train)
        if last:
            outs.append(h)
        else:
            tokens.append(pipe.send_next(h))
    y = torch.cat(outs, dim=1) if last else None
    if S == 1:
        return y
    return pipe.replicate(y, (M, B, T, C), x.dtype, x.device, tokens)


def pipeline_total_loss(params: Dict[str, Any], cfg: ModelConfig, idx: torch.Tensor,
                        targets: torch.Tensor, pipe=None, microbatches: int = 4, rng=None,
                        train: bool = True, data=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Summed multimodal loss with the block stack pipelined over ``pipe``
    (the same value on every stage) and the per-modality losses. The
    embedding runs on the first stage (elsewhere untracked, for its shape);
    the vocabulary heads and the unpadded cross-entropy on every stage.
    ``rng``: the step's raw uint32[2] threefry key; the dropout keys come
    from it only in training with dropout > 0."""
    keys = pipeline_keys(rng, cfg, microbatches, train)
    if pipe is None or pipe.rank == 0:
        x = embed(params, cfg, idx)
    else:
        with torch.no_grad():
            x = embed(params, cfg, idx)
    x = pipeline_apply(params["blocks"], x, keys, cfg, train, pipe, microbatches, data)
    logits = logits_heads(params, cfg, x)
    losses = [cross_entropy(logits[m], targets[m]) for m in range(cfg.num_modalities)]
    return torch.stack(losses).sum(), losses


def stage_owners(params, n_layer: int, stages: int) -> List[int]:
    """The stage that owns each leaf's gradient (``tree_leaves`` order): a
    block's leaves its stage's, the embedding's the first stage's, every
    other leaf (the vocabulary heads, which every stage computes alike)
    the last stage's."""
    per = n_layer // stages
    owners = []
    for path, _ in tree_paths(params):
        if path[0] == "blocks":
            owners.append(int(path[1]) // per)
        else:
            owners.append(0 if path[0] == "pre" else stages - 1)
    return owners
