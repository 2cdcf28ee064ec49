"""Parallel training (port of the JAX package's ``parallel/trainer.py``:
``make_sharded_trainer`` for data, model and sequence axes,
``shard_train_state`` for tensor parallelism and FSDP, ``_compose_scopes``
and ``make_shard_map_dp_step``).

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
- With FSDP / ZeRO-3 on that axis (``tpu_options.fsdp``,
  ``shard_train_state``) a rank keeps 1/P of the train state: of every leaf
  that ``parallel.mesh.param_pspecs`` places on 'data', its slice of the
  parameters and of both Adam moments; the other leaves whole. A step
  gathers the whole parameter tree in one flat all-gather, computes the
  data-parallel step's gradients on it, and reduces them back to the
  rank's slices in one flat reduce-scatter (the whole leaves and the loss
  in one small all-reduce); the elementwise AdamW then updates the slices,
  each element as the data-parallel update does. An evaluation pass
  gathers once (``Fsdp``).
- On a model axis of N ranks (tensor parallelism) each
  rank keeps its part of every leaf that ``param_pspecs`` places on
  'model' (params and both Adam moments; ``shard_train_state``) and runs
  its training steps and evaluation passes inside ``head_slice_scope``:
  the model's layers compute on the rank's heads and columns and call the
  axis's collectives (models/transformer.py), the masks keyed by global
  heads; where N does not divide n_head the attention layers gather their
  split leaves and run whole on every rank of the axis. Every rank of a model group draws the same batch rows and computes
  the same loss; the gradients of its parts are its own, those of the
  whole leaves come out the same on every rank (they follow from
  identical all-reduce results), so no collective averages them. With a
  data axis (data x model) the data axis's one flat all-reduce runs on the
  rank's parts, and FSDP gathers and reduce-scatters over the data group
  on the rank's model slices. An evaluation pass runs replicated over the
  model group and sums over the data axis.
- On a modality axis of P ranks (modality parallelism; P divides the
  modality count) each rank keeps its modalities' slice of every
  M-stacked leaf (sa, ffwd, ln1, ln2, the post norm; 'mod' in
  ``param_pspecs``) and the other leaves whole, runs inside
  ``mod_slice_scope`` on its modalities of every global batch (the JAX
  package's ``batch_pspec(mod_axis=True)``), gathers the activations over
  the axis before each block's cross-attention, and sums the loss and the
  gradients of the whole leaves over the axis in one all-reduce (their
  owners' modalities hold the rest), so every rank of the axis keeps the
  same whole leaves. Evaluation sums its per-modality statistics over the
  axis. With a data axis (and FSDP) and a model axis it composes as they
  do: the modality sums run first, then the data axis's mean or
  reduce-scatter.
- On a sequence axis its training steps and evaluation passes run inside
  ``context_parallel_scope``: each attention core goes through ring
  attention over the rank's sequence group, the gradients come out the same
  on every rank of the group with no all-reduce.
- On a pipeline axis of S stages (GPipe, parallel/pipeline.py) every rank
  keeps the whole tree (with FSDP its data slices, as without the axis);
  a training step's loss is ``pipeline_total_loss`` over the trainer's
  microbatches, on a data rank's rows of every microbatch, and after the
  backward each leaf's gradient comes from the stage that owns it (one
  f32 all-reduce over the stages), before the data axis's mean or
  reduce-scatter, so every stage updates the same tree. Evaluation runs
  the plain forward on every stage.
- A pipeline axis with a model or a modality axis (pipe x model, pipe x
  mod; with a data axis and FSDP too): the JAX package's pipeline
  ``shard_map`` names only 'pipe' and 'data', so every rank of a model or
  modality group computes its stage whole. A rank keeps the placement's
  parts (``shard_train_state``: its 'model' or 'mod' slices); a step
  gathers every leaf those axes split once (``Fsdp.gather_split``: one
  flat all-gather of the f32 masters an axis, exact), runs the pipeline
  on the whole tree with no head or modality scope (every row, head and
  modality the model's, the keys folded with the data place alone), and
  keeps the rank's slice of each whole gradient (``Fsdp.split_part``: no
  collective, every rank of the group computed it alike; a sum over the
  group would multiply it), then sums over the stages and takes the data
  axis's mean or reduce-scatter as above. Neither the loss nor a gradient
  is summed over 'mod'. Evaluation gathers once and runs the plain
  forward on every modality.
- Both (data x sequence, model x sequence): the ring keys its masks by
  the rank's local rows and heads with the dropout key folded with the
  data rank and then the model rank (where those axes are larger than 1),
  as the JAX package's ``shard_map`` body does; every other site stays
  keyed by global rows and heads. Where the model axis does not divide
  ``n_head`` the ring runs every head on every rank of the axis, its key
  folded with model place 0 on every rank. The JAX body folds each
  device's own place there, so its devices' rings differ at dropout > 0
  and what they report is not one function: the loss is place 0's
  forward on every device, the replicated gradients differ by device
  (ROADMAP.md section 3). The port computes that loss and its exact
  gradient, the same on every rank of the axis. With a modality axis
  (modality x sequence) the ring sees the rank's modalities and keys
  their rows by their index in the whole M (the JAX body's spec leaves M
  whole and never folds the modality place): the row map's base m0 B H
  (``ops.attention``).
  FSDP's collectives run on the data groups, the ring's hops on the
  sequence groups, every rank issuing them in one order: the gather before
  the forward, the reductions after the backward.

``make_shard_map_dp_step`` is the explicit data-parallel step, kept as a
cross-check of the trainer: each rank draws its own B / P rows from
generators keyed by ``rank_seed(seed, rank)`` and the gradients are
averaged over the axis.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..models.config import ModelConfig
from ..models.init import map_tree, tree_leaves
from ..models.transformer import total_loss
from ..ops.attention import context_parallel_scope, fold_key
from ..ops.layers import _U32, head_slice_scope
from ..sampling.feed import BatchFeed
from ..train.metrics import ModalityMetricSpec
from ..train.steps import AdamW, StepRng, Trainer
from .mesh import DataAxis, ModAxis, ModelAxis, RankMesh, param_pspecs, shard_dim, shard_tree


def make_sharded_trainer(cfg: ModelConfig, feed: BatchFeed, optimizer: AdamW,
                         metric_specs: Sequence[ModalityMetricSpec], eval_iters: int,
                         mesh: RankMesh, grad_accum: int = 1,
                         fsdp: Optional["Fsdp"] = None,
                         pipeline_microbatches: int = 4) -> Trainer:
    """A Trainer whose steps run over this rank's pipeline, modality, data,
    model and sequence axes (``parallel.mesh.make_mesh``), on the train
    state's parts that ``shard_train_state`` placed (``fsdp``: its
    placement, which a modality axis and a model axis under a pipeline
    axis need; the trainer gathers and reduce-scatters where it splits
    leaves over 'data', and under a pipeline axis gathers the 'model' and
    'mod' splits too). block_size must be divisible by the sequence axis,
    the modality count by the modality axis; a pipeline axis trains over
    ``pipeline_microbatches`` microbatches, alone or with data, model and
    modality axes (and FSDP), never with a sequence axis
    (``resolve.PIPE_SEQ``)."""
    seq, data, model, mod, pipe = mesh.seq, mesh.data, mesh.model, mesh.mod, mesh.pipe
    piped = pipe is not None and pipe.size > 1
    if piped and seq is not None and seq.size > 1:
        from .resolve import PIPE_SEQ

        raise ValueError(PIPE_SEQ)
    if mod is not None and mod.size > 1 and (fsdp is None or fsdp.mod is None):
        raise ValueError("a modality axis needs the placement shard_train_state gives")
    if piped and model is not None and model.size > 1 and (fsdp is None or fsdp.model is None):
        raise ValueError("a model axis under a pipeline axis needs the placement "
                         "shard_train_state gives")
    scopes = []
    if model is not None and model.size > 1 and not piped:
        if cfg.n_head % model.size == 0:
            h0, per = model.heads(cfg.n_head)
        else:  # the attention layers run whole on every rank of the axis
            h0, per = 0, cfg.n_head
        scopes.append(lambda: head_slice_scope(h0, per, cfg.n_head, model))
    if seq is not None and seq.size > 1:
        if cfg.block_size % seq.size != 0:
            raise ValueError(
                f"context parallelism needs block_size ({cfg.block_size}) "
                f"divisible by the 'seq' mesh axis ({seq.size})")
        data_rank = data.rank if data is not None else None
        model_rank = model.rank if model is not None and model.size > 1 else None
        if model_rank is not None and cfg.n_head % model.size != 0:
            model_rank = 0  # whole heads: every rank rings place 0's masks
        scopes.append(lambda: context_parallel_scope(seq, data_rank, model_rank))
    return Trainer(cfg, feed, optimizer, metric_specs, eval_iters, grad_accum=grad_accum,
                   scope=_compose_scopes(scopes) if scopes else None, data=data, fsdp=fsdp,
                   pipe=pipe, microbatches=pipeline_microbatches)


def _gather_axis(tree, dims: Sequence[Optional[int]], axis, kind: str):
    """The tree with every leaf split over ``axis`` (its dimension in
    ``dims``, None: whole) reassembled from every rank's part (collective:
    every rank of the axis calls it, in the same order): one all-gather of
    the split leaves' parts, rank-major, each leaf a new tensor; the whole
    leaves as they are. The split leaves must share one dtype."""
    leaves = tree_leaves(tree)
    mine = [t.detach() for t, d in zip(leaves, dims) if d is not None]
    if not mine:
        return tree
    if len({t.dtype for t in mine}) != 1:
        raise TypeError(f"a gather moves one dtype a tree, got {sorted({str(t.dtype) for t in mine})}")
    rows = axis.all_gather_flat(torch.cat([t.reshape(-1) for t in mine]), kind)
    P, full, at = axis.size, [], 0
    for t, d in zip(leaves, dims):
        if d is None:
            full.append(t)
            continue
        n = t.numel()
        shape = list(t.shape)
        shape[d] *= P
        full.append(rows[:, at:at + n].reshape(P, *t.shape).movedim(0, d).reshape(shape))
        at += n
    it = iter(full)
    return map_tree(lambda _: next(it), tree)


class Fsdp:
    """The placement of a run's train state on this rank: ``specs``
    (``param_pspecs`` per leaf, ``tree_leaves`` order) over the data axis
    ``data`` (FSDP), the model axis ``model`` (tensor parallelism) and the
    modality axis ``mod`` (modality parallelism; any may be None). A tree
    that it places holds, for every leaf with a 'model', 'mod' or 'data'
    dimension, this rank's contiguous block of it (``shard_tree``: its
    slice along each, each on a dimension of its own), and every other
    leaf whole. Its collectives move one flat buffer each,
    rank-major: rank r's chunk is its slice of every split leaf in
    ``tree_leaves`` order, so a gather's row r and a reduce-scatter's
    chunk r are rank r's slices. The data axis's (``gather``,
    ``reduce_grads``) are a step's; ``whole`` also gathers the model axis,
    for a checkpoint (and the modality axis); under a pipeline axis a
    step gathers the model and modality axes too (``gather_split``) and
    keeps the rank's slices of the whole gradients (``split_part``)."""

    def __init__(self, specs: Sequence[Tuple], data: Optional[DataAxis],
                 model: Optional[ModelAxis] = None, mod: Optional[ModAxis] = None):
        self.specs = list(specs)
        self.data = data
        self.model = model
        self.mod = mod
        self.dims = [shard_dim(s) if data is not None else None for s in self.specs]
        self.model_dims = [shard_dim(s, "model") if model is not None else None
                           for s in self.specs]
        self.mod_dims = [shard_dim(s, "mod") if mod is not None else None for s in self.specs]

    def parts(self) -> List[int]:
        """Per leaf, the number of ranks it is split over (1: whole)."""
        return [(1 if d is None else self.data.size) * (1 if m is None else self.model.size)
                * (1 if o is None else self.mod.size)
                for d, m, o in zip(self.dims, self.model_dims, self.mod_dims)]

    def shard(self, tree):
        """This rank's part of a whole tree: every split leaf's block as a
        tensor of its own (the whole leaf no longer referenced), with the
        leaf's requires_grad; the other leaves as they are."""
        places = {name: (ax.rank, ax.size) for name, ax in (("data", self.data),
                                                             ("model", self.model),
                                                             ("mod", self.mod))
                  if ax is not None}
        return shard_tree(tree, self.specs, places)

    def gather(self, tree, kind: str = "all_gather"):
        """The tree whole over the data axis (collective over the data
        group): each leaf split over 'data' reassembled from every data
        rank's part; on a model axis the rank's model slices."""
        return _gather_axis(tree, self.dims, self.data, kind)

    def gather_split(self, tree, kind: str = "all_gather"):
        """A tree whole over the data axis made whole over the model axis,
        then over the modality axis (collective over their groups: one
        flat all-gather an axis that splits a leaf)."""
        tree = _gather_axis(tree, self.model_dims, self.model, kind)
        return _gather_axis(tree, self.mod_dims, self.mod, kind)

    def whole(self, tree, kind: str = "all_gather"):
        """The whole tree: gathered over the data axis, then over the model
        axis, then over the modality axis (collective over their groups)."""
        return self.gather_split(self.gather(tree, kind), kind)

    def split_part(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's model and modality slices (``shard_tree``'s) of whole
        leaves in ``tree_leaves`` order, each a tensor of its own; a leaf
        neither axis splits as it is. No collective: the transpose of
        ``gather_split`` where every rank of the groups computed the whole
        alike."""
        out = []
        for t, m, o in zip(leaves, self.model_dims, self.mod_dims):
            for d, ax in ((m, self.model), (o, self.mod)):
                if d is not None:
                    n = t.shape[d] // ax.size
                    t = t.narrow(d, ax.rank * n, n)
            out.append(t.contiguous() if (m, o) != (None, None) else t)
        return out

    def reduce_grads(self, loss: torch.Tensor, grads: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The mean over the axis of every rank's loss and whole-tree
        gradients (``tree_leaves`` order), as this rank's parts: one f32
        reduce-scatter of the sharded leaves' gradients (rank-major) divided
        by the axis size, then the whole leaves' and the loss in one
        all-reduce (``DataAxis.mean_grads``); each leaf in its own dtype."""
        P = self.data.size
        n = sum(g.numel() for g, d in zip(grads, self.dims) if d is not None) // P
        mine = None
        if n:
            # rank r's slices of every sharded gradient in row r, one copy each
            flat, at = torch.empty(P, n, dtype=torch.float32, device=grads[0].device), 0
            for g, d in zip(grads, self.dims):
                if d is not None:
                    split = g.shape[:d] + (P, g.shape[d] // P) + g.shape[d + 1:]
                    part = g.reshape(split).movedim(d, 0)
                    flat[:, at:at + g.numel() // P].view(part.shape).copy_(part)
                    at += g.numel() // P
            mine = self.data.reduce_scatter_flat(flat.view(-1)) / P
        whole = [g for g, d in zip(grads, self.dims) if d is None]
        loss, whole = self.data.mean_grads(loss, whole)
        out, at, whole = [], 0, iter(whole)
        for g, d in zip(grads, self.dims):
            if d is None:
                out.append(next(whole))
                continue
            shape = list(g.shape)
            shape[d] //= P
            n = g.numel() // P
            out.append(mine[at:at + n].view(shape).to(g.dtype))
            at += n
        return loss, out


def shard_train_state(params, opt_state: Optional[Dict[str, Any]], data: Optional[DataAxis],
                      fsdp: bool, model: Optional[ModelAxis] = None,
                      mod: Optional[ModAxis] = None
                      ) -> Tuple[Any, Optional[Dict[str, Any]], Optional[Fsdp]]:
    """This rank's train state (the JAX package's ``shard_train_state``):
    from a whole tree (fresh or loaded), over the model axis ``model``, the
    modality axis ``mod`` and, with ``fsdp``, the data axis, the rank's part
    of ``params`` and of ``opt_state``'s ``mu`` and ``nu`` (``Fsdp.shard``:
    the leaves ``param_pspecs`` places on 'model', 'mod' or 'data' sliced,
    from the whole tree's shapes, the whole originals freed once the caller
    drops them; the count shared), and the ``Fsdp`` placement the trainer
    keeps. Without ``fsdp`` (or a data axis), a model and a modality axis
    the state as it is and None."""
    data = data if fsdp and data is not None and data.size > 1 else None
    model = model if model is not None and model.size > 1 else None
    mod = mod if mod is not None and mod.size > 1 else None
    if data is None and model is None and mod is None:
        return params, opt_state, None
    specs = param_pspecs(params, n_head=0, model_axis=model is not None,
                         model_size=model.size if model is not None else 1,
                         mod_axis=mod is not None, mod_size=mod.size if mod is not None else 1,
                         fsdp_size=data.size if data is not None else 1)
    placed = Fsdp(specs, data, model, mod)
    params = placed.shard(params)
    if opt_state is not None:
        opt_state = {"count": opt_state["count"], "mu": placed.shard(opt_state["mu"]),
                     "nu": placed.shard(opt_state["nu"])}
    return params, opt_state, placed


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
