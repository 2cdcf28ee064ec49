"""Process groups of a parallel run, the processes that hold them, and the
placement of the parameters over them (port of the JAX package's
``parallel/mesh.py``).

The JAX package lays its devices out as a (pipe, mod, data, model, seq)
mesh, and so does the port: the pipeline axis ('pipe', GPipe stages over
the block stack, parallel/pipeline.py), the modality axis ('mod', modality
parallelism over the M-stacked leaves and the (M, B, T) batch), the data
axis (data parallelism, and FSDP / ZeRO-3 over it), the model axis
('model', tensor parallelism over the heads and the feed-forward,
embedding and vocabulary columns) and the sequence axis ('seq', context
parallelism) (parallel/resolve.py refuses 'pipe' with 'seq', a plan the
JAX package's trainer cannot run). A run of P ranks is P processes in one
``torch.distributed`` group: NCCL with one card per rank, gloo on the CPU.
Ranks are laid out in the JAX package's device order, pipeline outer,
modality, data, model, sequence inner: global rank (((p * Mo + m) * D + d)
* N + t) * S + s holds stage p, modality place m, data row d, model place
t and sequence place s (``make_mesh``). Every rank creates the same groups
in the same order: the sequence groups (S consecutive ranks), the data
groups, the model groups, the modality groups and the pipeline groups,
each axis's groups in the order of the other axes' places.

``SeqMesh`` is one rank's view of the sequence axis: the ring hop (to the
next place, from the previous one, as global ranks of its group) and the
all-gather along the sequence that ring attention needs. ``DataAxis`` is its
view of the data axis: its rows of a global batch (``batch_rows``, the JAX
package's ``batch_pspec``), the gradient mean over the axis in one flat
all-reduce in ``tree_leaves`` order, the sums of an evaluation pass, and
FSDP's flat all-gather and reduce-scatter. ``ModelAxis`` is its view of the
model axis: its heads, and the two collectives of the Megatron form as
autograd functions, ``copy_to`` (the identity forward, an all-reduce of the
gradient backward) at the input of each column-split product and
``reduce_from`` (an all-reduce forward, the identity backward) after each
row-split one, and ``gather`` (an all-gather forward, the rank's slice of
the gradient backward) for a leaf split where the heads do not split.
``ModAxis`` is its view of the modality axis: its modalities, the
all-gather of the activations along M before cross-attention (the backward
sums each modality's gradient back onto its owner in one reduce-scatter),
the sum over the axis of the loss and of the gradients of the leaves the
axis keeps whole, and the sums of an evaluation pass. ``PipeAxis`` is its
view of the pipeline axis: its layers, the GPipe schedule's handoffs as
autograd functions (``send_next``: a send forward, the receive of the
gradient backward; ``recv_prev`` the reverse; ``replicate``: the last
stage's output broadcast to every stage, JAX's psum), and the sum of each
leaf's gradient from the stage that owns it.

``param_pspecs`` is the JAX package's placement table, as a function of
the leaves' shapes and tree paths: per leaf a tuple of axis names or None
(``model``, ``mod``, and with ``fsdp_size`` > 1 ``data`` on the largest
free dimension the axis divides). A rank keeps ``shard_of`` each leaf: its
contiguous slice along the dimension of each axis (``shard_dim``):
'model', 'mod' and 'data', each on a dimension of its own (``shard_tree``),
the block that device (m, d, t) holds in the JAX package.

Where several ranks share one card (a test arrangement: NCCL refuses two
ranks on one device), the group is gloo and CUDA tensors travel through
host memory (``staged``): every chunk still runs on the card.

``run_ranks`` starts the processes of a run on this node (spawned, each
told its rank, the world size and a ``tcp://localhost`` address, or given
a launcher's environment to join from), collects what each returns, and
kills them all if one fails or the time limit passes. ``init_from_env``
joins the group a launcher such as ``torchrun`` describes, over one node
or several (parallel/multihost.py).
"""

from __future__ import annotations

import io
import itertools
import math
import os
import queue
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass
class SeqMesh:
    """This rank's place on the sequence axis of a context-parallel run.
    ``group``: the axis's process group (None: the default group, the axis
    being the whole run); ``ranks``: the global ranks of its places in order
    (None: 0 .. size - 1)."""

    rank: int
    size: int
    staged: bool = False  # gloo with CUDA tensors: communicate through host memory
    group: Any = None
    ranks: Optional[Tuple[int, ...]] = None

    def _peer(self, place: int) -> int:
        place %= self.size
        return place if self.ranks is None else self.ranks[place]

    def hop(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One ring hop: each tensor goes to the next place and the tensors
        of the previous place come back, in the same shapes and types."""
        nxt, prv = self._peer(self.rank + 1), self._peer(self.rank - 1)
        dev = tensors[0].device
        send = [t.contiguous().cpu() if self.staged else t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]
        ops = [dist.P2POp(dist.isend, t, nxt, self.group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, prv, self.group) for t in recv]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [t.to(dev) for t in recv] if self.staged else recv

    def all_gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Every place's chunk of x along the sequence axis (-2), in place
        order."""
        src = x.contiguous().cpu() if self.staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=-2)
        return out.to(x.device) if self.staged else out

    def chunk(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous chunk of x along the sequence axis (-2)."""
        c = x.shape[-2] // self.size
        return x.narrow(-2, self.rank * c, c).contiguous()


def batch_rows(batch_size: int, rank: int, size: int) -> Tuple[int, int]:
    """The rows [start, stop) of a global batch that data rank ``rank`` of
    ``size`` holds: the batch axis split evenly over 'data', as the JAX
    package's ``batch_pspec`` shards its (M, B, T) batches."""
    if batch_size % size != 0:
        raise ValueError(f"the data axis ({size}) must divide the batch ({batch_size})")
    per = batch_size // size
    return rank * per, (rank + 1) * per


@dataclass
class _Axis:
    """One rank's place on an axis whose collectives reduce (data, model):
    ``group`` is the axis's process group (None: the default group).
    ``timing`` keeps (kind, bytes, seconds) of each collective, the host's
    clock around the call (the device synchronised first), where timing is
    on."""

    rank: int
    size: int
    staged: bool = False  # gloo with CUDA tensors: communicate through host memory
    group: Any = None
    timing: Optional[List[Tuple[str, int, float]]] = None

    def _timed(self, kind: str, flat: torch.Tensor, collective: Callable) -> torch.Tensor:
        """``collective(flat)`` (through host memory where staged), its
        bytes (of ``flat``) and time appended to ``timing`` as ``kind``."""
        if self.timing is not None:
            if flat.is_cuda:
                torch.cuda.synchronize(flat.device)
            t0 = time.perf_counter()
        out = collective(flat.cpu() if self.staged else flat)
        out = out.to(flat.device) if self.staged else out
        if self.timing is not None:
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            self.timing.append((kind, flat.numel() * flat.element_size(),
                                time.perf_counter() - t0))
        return out

    def _all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of a flat tensor, in place, the same bits
        on every rank (each element reduced once, in one order, and
        shared)."""
        dist.all_reduce(flat, group=self.group)
        return flat

    def all_gather_flat(self, flat: torch.Tensor, kind: str = "all_gather") -> torch.Tensor:
        """Every rank's flat tensor (all of one length) as the rows of a
        (size, n) tensor, in rank order."""

        def gather(src):
            out = torch.empty(self.size * src.numel(), dtype=src.dtype, device=src.device)
            dist.all_gather_into_tensor(out, src.contiguous(), group=self.group)
            return out.view(self.size, -1)

        return self._timed(kind, flat, gather)

    def reduce_scatter_flat(self, flat: torch.Tensor, kind: str = "reduce_scatter"
                            ) -> torch.Tensor:
        """The sum over the axis of this rank's chunk of a flat tensor of
        size * n elements, rank-major (chunk r is elements [r n, (r + 1) n)):
        a tensor of n, each element reduced once."""

        def scatter(src):
            out = torch.empty(src.numel() // self.size, dtype=src.dtype, device=src.device)
            dist.reduce_scatter_tensor(out, src.contiguous(), group=self.group)
            return out

        return self._timed(kind, flat, scatter)

    def _sum_flat(self, kind: str, leaves: Sequence[torch.Tensor], dtype=torch.float32
                  ) -> List[torch.Tensor]:
        """The sum over the axis of each tensor of ``leaves``: one all-reduce
        of one flat buffer in ``dtype``, each back in its own shape and
        dtype."""
        flat = torch.cat([t.reshape(-1).to(dtype) for t in leaves])
        flat = self._timed(kind, flat, self._all_reduce)
        out, at = [], 0
        for t in leaves:
            out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
            at += t.numel()
        return out


@dataclass
class DataAxis(_Axis):
    """This rank's place on the data axis of a data-parallel run: its rows
    of each global batch, and the means, sums, gathers and scatters over
    the axis (timing kinds: "all_reduce", or the caller's tag for a gather
    or a reduce-scatter)."""

    def rows(self, batch_size: int) -> Tuple[int, int]:
        return batch_rows(batch_size, self.rank, self.size)

    def mean_grads(self, loss: torch.Tensor, grads: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The mean over the axis of every rank's loss and gradients
        (``tree_leaves`` order): one all-reduce of one flat f32 buffer (the
        leaves, then the loss), divided by the axis size, each leaf back in
        its own dtype."""
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.detach().float().reshape(1)])
        flat = self._timed("all_reduce", flat, self._all_reduce) / self.size
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        return flat[at].to(loss.dtype), out

    def sum_eval(self, stats):
        """An evaluation pass's statistics (``train.steps.EvalStats``) over
        the global batches: the mean losses averaged over the axis, the win
        and loss counts and the certainty summed (in one f64 all-reduce; the
        counts stay exact integers)."""
        M = stats.wins.numel()
        flat = torch.cat([stats.mean_loss.reshape(1), stats.mean_losses, stats.certainty,
                          stats.wins, stats.losses]).double()
        flat = self._timed("eval_sum", flat, self._all_reduce)
        mean_loss = (flat[0] / self.size).to(stats.mean_loss.dtype)
        mean_losses = (flat[1:1 + M] / self.size).to(stats.mean_losses.dtype)
        cert = flat[1 + M:1 + 2 * M].to(stats.certainty.dtype)
        wins = flat[1 + 2 * M:1 + 3 * M].round().to(stats.wins.dtype)
        losses = flat[1 + 3 * M:].round().to(stats.losses.dtype)
        return type(stats)(mean_loss, mean_losses, wins, losses, cert, stats.batches_processed)


class _ReduceFrom(torch.autograd.Function):
    """The sum over the model axis forward (one all-reduce), the identity
    backward: after a row-split product, whose partial sums every rank of
    the axis adds."""

    @staticmethod
    def forward(ctx, x, axis, kind):
        return axis._timed(kind, x.contiguous().clone(), axis._all_reduce)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """The identity forward, the sum over the model axis of the gradient
    backward (one f32 all-reduce, back in the gradient's type): at the input
    of a column-split product, whose input gradient every rank holds a part
    of."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        total = axis._timed("tp_all_reduce_bwd", g.float().contiguous(), axis._all_reduce)
        return total.to(g.dtype), None


@dataclass
class ModelAxis(_Axis):
    """This rank's place on the model axis of a tensor-parallel run: its
    heads of the model's, and the two collectives of the Megatron form
    (timing kinds "tp_all_reduce" forward and "tp_all_reduce_bwd"
    backward), issued in one order on every rank of the axis (each rank
    runs the same layers)."""

    def heads(self, n_head: int) -> Tuple[int, int]:
        """(h0, local count): this rank's heads [h0, h0 + n_head / size)."""
        if n_head % self.size != 0:
            raise ValueError(f"the model axis ({self.size}) must divide n_head ({n_head})")
        per = n_head // self.size
        return self.rank * per, per

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of every rank's ``x`` (differentiable: the
        gradient passes unchanged); timed as "tp_all_reduce" where gradients
        are on (a training forward, or its recompute), else as
        "tp_all_reduce_eval"."""
        kind = "tp_all_reduce" if torch.is_grad_enabled() else "tp_all_reduce_eval"
        return _ReduceFrom.apply(x, self, kind)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` unchanged, whose gradient is summed over the axis."""
        return _CopyTo.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole of a leaf split over the axis along ``dim`` (every
        rank's part, in rank order), whose gradient is the rank's slice of
        the whole's: for a layer that every rank of the axis computes whole
        and alike (a model axis that does not divide ``n_head``), so that
        the whole's gradient is the same on every rank. Timed as
        "tp_all_gather"."""
        return _GatherSplit.apply(x, self, dim)


class _GatherSplit(torch.autograd.Function):
    """Every rank's part of a split leaf along ``dim`` forward (one
    all-gather); the rank's slice of the whole's gradient backward (no
    collective: the computation after the gather is the same on every
    rank)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        rows = axis.all_gather_flat(x.detach().reshape(-1), "tp_all_gather")
        return rows.view(axis.size, *x.shape).movedim(0, dim).reshape(
            *x.shape[:dim], axis.size * x.shape[dim], *x.shape[dim + 1:])

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n).contiguous(), None, None


class _GatherMods(torch.autograd.Function):
    """Every rank's modalities of an (M / P, ...) activation along the
    leading axis forward (one all-gather, (M, ...)); backward each
    modality's gradient summed over the axis onto its owner (one f32
    reduce-scatter, back in the gradient's type)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        rows = axis.all_gather_flat(x.detach().contiguous().reshape(-1), "mod_all_gather")
        return rows.view(axis.size * x.shape[0], *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        mine = axis.reduce_scatter_flat(g.float().contiguous().reshape(-1),
                                        "mod_reduce_scatter_bwd")
        return mine.view(g.shape[0] // axis.size, *g.shape[1:]).to(g.dtype), None


@dataclass
class ModAxis(_Axis):
    """This rank's place on the modality axis of a modality-parallel run:
    its modalities of the model's, the gather of the activations before
    cross-attention, and the sums over the axis (timing kinds
    "mod_all_gather", "mod_reduce_scatter_bwd", "mod_all_reduce",
    "mod_eval_sum")."""

    def mods(self, n_mod: int) -> Tuple[int, int]:
        """(m0, local count): this rank's modalities [m0, m0 + M / size)."""
        if n_mod % self.size != 0:
            raise ValueError(f"the modality axis ({self.size}) must divide the modality "
                             f"count ({n_mod})")
        per = n_mod // self.size
        return self.rank * per, per

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's modalities of x (M / size, ...) as (M, ...), in
        modality order (differentiable)."""
        return _GatherMods.apply(x, self)

    def sum_grads(self, loss: torch.Tensor, grads: Sequence[torch.Tensor],
                  whole: Sequence[bool]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The loss and the gradients of the leaves the axis keeps whole
        (``whole``, ``tree_leaves`` order) summed over the axis, in one f32
        all-reduce (the same bits on every rank); the split leaves' as they
        are (their owner's modalities hold all of their gradient)."""
        picked = [g for g, w in zip(grads, whole) if w] + [loss.detach().reshape(1)]
        summed = self._sum_flat("mod_all_reduce", picked)
        it = iter(summed[:-1])
        return summed[-1].reshape(loss.shape), [next(it) if w else g
                                                for g, w in zip(grads, whole)]

    def sum_eval(self, stats):
        """An evaluation pass's statistics (``train.steps.EvalStats``) summed
        over the axis, each rank's modalities in their own slots and zeros
        elsewhere (one f64 all-reduce; the counts stay exact integers)."""
        leaves = [stats.mean_loss.reshape(1), stats.mean_losses, stats.certainty, stats.wins,
                  stats.losses]
        mean_loss, mean_losses, cert, wins, losses = self._sum_flat(
            "mod_eval_sum", leaves, torch.float64)
        return type(stats)(mean_loss.reshape(stats.mean_loss.shape), mean_losses, wins, losses,
                           cert, stats.batches_processed)


class _SendNext(torch.autograd.Function):
    """A stage's output to the next stage forward (one send), returning an
    empty token that ties the send into the loss's graph; backward the
    gradient of that output received from the next stage: the transpose of
    a forward handoff is the reverse handoff (JAX's ppermute transposed)."""

    @staticmethod
    def forward(ctx, h, axis):
        ctx.axis, ctx.like = axis, (h.shape, h.dtype, h.device)
        axis.send(h.detach(), 1)
        return h.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        return ctx.axis.recv(*ctx.like, 1), None


class _RecvPrev(torch.autograd.Function):
    """The previous stage's output forward (one receive); backward its
    gradient sent back there. ``anchor`` (``PipeAxis.anchor``) is the
    node's input, which a differentiation must ask for, so that the
    backward runs."""

    @staticmethod
    def forward(ctx, anchor, axis, shape, dtype):
        ctx.axis = axis
        return axis.recv(shape, dtype, anchor.device, -1)

    @staticmethod
    def backward(ctx, g):
        ctx.axis.send(g.contiguous(), -1)
        return None, None, None, None


class _Replicate(torch.autograd.Function):
    """The last stage's output on every stage of the axis forward (one
    broadcast: JAX's psum of the outputs only the last stage holds);
    backward the last stage's gradient of it as it is (every stage computes
    the same loss from the same output, so each holds the same gradient,
    which the last stage's layers take once), and an empty gradient for
    each send token of an earlier stage, so that its sends' backward
    receives run."""

    @staticmethod
    def forward(ctx, y, axis, shape, dtype, device, *tokens):
        ctx.last, ctx.n_tokens = axis.rank == axis.size - 1, len(tokens)
        buf = y.detach().clone() if ctx.last else torch.empty(shape, dtype=dtype, device=device)
        return axis.broadcast_last(buf)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else None, None, None, None, None,
                *[g.new_zeros(0)] * ctx.n_tokens)


@dataclass
class PipeAxis(_Axis):
    """This rank's stage on the pipeline axis of a pipelined run: its
    layers, the activation handoffs of the GPipe schedule as autograd
    functions (``send_next``, ``recv_prev``, ``replicate``) and the sum
    of the stages' gradients (timing kinds "send", "recv",
    "pipe_broadcast", "pipe_all_reduce"). ``ranks``: the global ranks of
    its stages in order (None: 0 .. size - 1). Handoffs run in one order on
    every stage: forward microbatch 0 first, backward the last first."""

    ranks: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        self._anchors: Dict[Any, torch.Tensor] = {}

    def _peer(self, place: int) -> int:
        return place if self.ranks is None else self.ranks[place]

    def layers(self, n_layer: int) -> Tuple[int, int]:
        """(l0, local count): this stage's layers [l0, l0 + n_layer / size)."""
        if n_layer % self.size != 0:
            raise ValueError(f"n_layer {n_layer} not divisible by pipe axis {self.size}")
        per = n_layer // self.size
        return self.rank * per, per

    def send(self, t: torch.Tensor, step: int) -> None:
        """``t`` to stage rank + step."""
        peer = self._peer(self.rank + step)

        def send(x):
            dist.send(x, peer, self.group)
            return x[:0]  # nothing to bring back where staged

        self._timed("send", t.contiguous(), send)

    def recv(self, shape, dtype, device, step: int) -> torch.Tensor:
        """A tensor of ``shape`` and ``dtype`` from stage rank + step, on
        ``device``."""
        peer = self._peer(self.rank + step)

        def recv(x):
            dist.recv(x, peer, self.group)
            return x

        return self._timed("recv", torch.empty(shape, dtype=dtype, device=device), recv)

    def broadcast_last(self, buf: torch.Tensor) -> torch.Tensor:
        """The last stage's ``buf`` on every stage (in place elsewhere)."""
        src = self._peer(self.size - 1)

        def broadcast(x):
            dist.broadcast(x, src, group=self.group)
            return x

        return self._timed("pipe_broadcast", buf, broadcast)

    def anchor(self, device) -> torch.Tensor:
        """The leaf every ``recv_prev`` of this axis hangs from on
        ``device``: a differentiation of a stage's loss asks for it too."""
        key = str(torch.device(device))
        if key not in self._anchors:
            self._anchors[key] = torch.zeros((), device=device, requires_grad=True)
        return self._anchors[key]

    def send_next(self, h: torch.Tensor) -> torch.Tensor:
        """``h`` to the next stage (differentiable); its token."""
        return _SendNext.apply(h, self)

    def recv_prev(self, shape, dtype, device) -> torch.Tensor:
        """The previous stage's output (differentiable)."""
        return _RecvPrev.apply(self.anchor(device), self, tuple(shape), dtype)

    def replicate(self, y: Optional[torch.Tensor], shape, dtype, device,
                  tokens: Sequence[torch.Tensor]) -> torch.Tensor:
        """The last stage's output ``y`` on every stage (differentiable);
        an earlier stage passes None and its send tokens."""
        return _Replicate.apply(y, self, tuple(shape), dtype, device, *tokens)

    def sum_grads(self, grads: Sequence[torch.Tensor], owners: Sequence[int]
                  ) -> List[torch.Tensor]:
        """Every leaf's gradient from the stage that owns it (``owners``,
        ``tree_leaves`` order): one f32 all-reduce of each stage's owned
        gradients with zeros in the others' places, so that the sum is each
        owner's gradient exactly, the same bits on every stage."""
        return self._sum_flat("pipe_all_reduce", [g if o == self.rank else torch.zeros_like(g)
                                                  for g, o in zip(grads, owners)])


@dataclass
class RankMesh:
    """One rank's view of the (pipe, mod, data, model, seq) layout of a run
    (the JAX package's ``make_mesh``): the axis sizes, this rank's place on
    each, and its data, model, sequence, modality and pipeline groups (None
    where the axis is 1)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    data: Optional[DataAxis]
    seq: Optional[SeqMesh]
    model: Optional[ModelAxis] = None
    mod: Optional[ModAxis] = None
    pipe: Optional[PipeAxis] = None


_ORDER = ("pipe", "mod", "data", "model", "seq")  # the JAX package's device order, outer first


def make_mesh(data: int = 1, model: int = 1, seq: int = 1, mod: int = 1, pipe: int = 1,
              staged: bool = False) -> RankMesh:
    """This rank's place in a (pipe, mod, data, model, seq) layout over the
    initialised default group, whose size must be the product of the axes.
    Global rank (((p * mod + m) * data + d) * model + t) * seq + s is stage
    p, modality place m, data row d, model place t, sequence place s (the
    JAX package's device order: pipe outer, seq inner). Every rank calls
    this in the same order: it creates every sequence, data, model,
    modality and pipeline group of the run, in that order, each axis's
    groups in the order of the other axes' places (an axis that spans the
    whole run takes the default group). The data axis serves data
    parallelism and FSDP alike (FSDP's collectives run on its groups)."""
    sizes = {"pipe": pipe, "mod": mod, "data": data, "model": model, "seq": seq}
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(sizes.values()) != world:
        raise ValueError(f"mesh pipe={pipe} x mod={mod} x data={data} x model={model} x "
                         f"seq={seq} needs {math.prod(sizes.values())} ranks, have {world}")
    coords, rest = {}, rank
    for name in reversed(_ORDER):
        rest, coords[name] = divmod(rest, sizes[name])

    def at(place: Dict[str, int]) -> int:
        r = 0
        for name in _ORDER:
            r = r * sizes[name] + place[name]
        return r

    def group_of(axis: str):
        """(group, ranks) of this rank's group along ``axis``: every group
        of the axis created, in the order of the other axes' places, this
        rank's kept."""
        others = [n for n in _ORDER if n != axis]
        mine = None
        for place in itertools.product(*(range(sizes[n]) for n in others)):
            fixed = dict(zip(others, place))
            ranks = tuple(at({**fixed, axis: i}) for i in range(sizes[axis]))
            group = dist.new_group(list(ranks)) if sizes[axis] != world else None
            if rank in ranks:
                mine = group, ranks
        return mine

    seq_axis = data_axis = model_axis = mod_axis = pipe_axis = None
    if seq > 1:
        group, ranks = group_of("seq")
        seq_axis = SeqMesh(coords["seq"], seq, staged, group, ranks)
    if data > 1:
        data_axis = DataAxis(coords["data"], data, staged, group_of("data")[0])
    if model > 1:
        model_axis = ModelAxis(coords["model"], model, staged, group_of("model")[0])
    if mod > 1:
        mod_axis = ModAxis(coords["mod"], mod, staged, group_of("mod")[0])
    if pipe > 1:
        group, ranks = group_of("pipe")
        pipe_axis = PipeAxis(coords["pipe"], pipe, staged, group, ranks=ranks)
    return RankMesh(sizes, coords, data_axis, seq_axis, model_axis, mod_axis, pipe_axis)


def default_mesh_shape(n_devices: int, n_head: int) -> Tuple[int, int]:
    """Pick (data, model) for n devices: tensor-parallel 2-way when the head
    count allows it and there are >= 4 devices, else pure data parallel (the
    JAX package's rule, copied as it is)."""
    if n_devices >= 4 and n_devices % 2 == 0 and n_head % 2 == 0:
        return n_devices // 2, 2
    return n_devices, 1


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, or a ``param_shapes`` (kind, shape)."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[1])


def param_pspecs(params, n_head: int, model_axis: bool = True, model_size: int = 1,
                 mod_axis: bool = False, mod_size: int = 1, fsdp_size: int = 1
                 ) -> List[Tuple[Optional[str], ...]]:
    """The JAX package's placement table (its ``param_pspecs``, copied rule
    for rule): per leaf of ``params`` (tensors or ``param_shapes`` leaves),
    in ``tree_leaves`` order, the axis name of each dimension or None, as
    the tuple of its PartitionSpec (``()``: replicated).

    Over 'model' (where ``model_axis``): sa.w1_*/b1_* and ffwd.w1/b1 and
    heads[i].w1/b1 their last dimension, sa.w2_* and sa.proj_w1 and ffwd.w2
    dimension 1, heads[i].w2 and tok_emb[i] and cross.q_w / cross.proj_w1
    dimension 0, cross.kv_w dimension 1; every other leaf replicated. A
    dimension the axis does not divide leaves the leaf replicated. Unknown
    leaf names under sa, ffwd, cross and heads raise ``ValueError``. With
    ``mod_axis`` every M-stacked leaf (sa, ffwd, ln1, ln2, the post norm)
    also puts 'mod' on its leading dimension where ``mod_size`` divides
    it. With ``fsdp_size > 1`` (ZeRO-3) each leaf puts 'data' on its
    largest dimension that is still free and that the axis divides (a tie
    to the lower index); a leaf without one stays replicated over 'data'.
    ``n_head`` is unused, as in the JAX package."""
    del n_head
    from ..models.init import tree_paths

    mdl = "model" if model_axis else None

    def sharded(shape, axis: int) -> Tuple:
        if mdl is None or shape[axis] % max(model_size, 1) != 0:
            return ()
        spec = [None] * len(shape)
        spec[axis] = mdl
        return tuple(spec)

    def with_mod(spec: Tuple, shape) -> Tuple:
        if not mod_axis or shape[0] % max(mod_size, 1) != 0:
            return spec
        dims = list(spec) + [None] * (len(shape) - len(spec))
        dims[0] = "mod"
        return tuple(dims)

    def with_fsdp(spec: Tuple, shape) -> Tuple:
        if fsdp_size <= 1 or len(shape) == 0:
            return spec
        dims = list(spec) + [None] * (len(shape) - len(spec))
        free = [i for i in range(len(shape))
                if dims[i] is None and shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size]
        if not free:
            return spec
        dims[max(free, key=lambda i: (shape[i], -i))] = "data"
        return tuple(dims)

    def spec_for(path: Tuple, shape) -> Tuple:
        joined = "/" + "/".join(str(p) for p in path) + "/"
        last = str(path[-1])
        nd = len(shape)
        stacked = (any(f"/{fam}/" in joined for fam in ("sa", "ffwd", "ln1", "ln2"))
                   or (last in ("ln_scale", "ln_bias") and "/cross/" not in joined))

        def base() -> Tuple:
            where = joined.strip("/")
            if "/sa/" in joined:
                if last.startswith("w1_") or last.startswith("b1_"):
                    return sharded(shape, nd - 1)
                if last.startswith("w2_") or last == "proj_w1":
                    return sharded(shape, 1)
                if last in ("proj_w2", "proj_b1", "proj_b2"):
                    return ()
                raise ValueError(f"unknown self-attention parameter: {where}")
            if "/ffwd/" in joined:
                if last in ("w1", "b1"):
                    return sharded(shape, nd - 1)
                if last == "w2":
                    return sharded(shape, 1)
                if last == "b2":
                    return ()
                raise ValueError(f"unknown feed-forward parameter: {where}")
            if "/cross/" in joined:
                if last in ("q_w", "proj_w1"):
                    return sharded(shape, 0)
                if last == "kv_w":
                    return sharded(shape, 1)
                if last in ("proj_b1", "proj_w2", "proj_b2", "ln_scale", "ln_bias"):
                    return ()
                raise ValueError(f"unknown cross-attention parameter: {where}")
            if "/heads/" in joined:
                if last in ("w1", "b1"):
                    return sharded(shape, nd - 1)
                if last == "w2":
                    return sharded(shape, 0)
                if last == "b2":
                    return ()
                raise ValueError(f"unknown vocab-head parameter: {where}")
            if "/tok_emb/" in joined:
                return sharded(shape, 0)
            return ()

        spec = base()
        if stacked:
            spec = with_mod(spec, shape)
        return with_fsdp(spec, shape)

    return [spec_for(path, _shape(leaf)) for path, leaf in tree_paths(params)]


def shard_dim(spec: Sequence[Optional[str]], axis: str = "data") -> Optional[int]:
    """The dimension a leaf of placement ``spec`` splits over ``axis``, or
    None (the leaf whole on every rank of the axis)."""
    return list(spec).index(axis) if axis in spec else None


def shard_of(full: torch.Tensor, spec: Sequence[Optional[str]], rank: int,
             size: int, axis: str = "data") -> torch.Tensor:
    """Rank ``rank``'s part of a leaf of placement ``spec`` over an axis of
    ``size`` named ``axis``: its contiguous slice along that axis's
    dimension (a view; the whole leaf where the spec has none)."""
    d = shard_dim(spec, axis)
    if d is None:
        return full
    n = full.shape[d] // size
    return full.narrow(d, rank * n, n)


def shard_tree(tree, specs: Sequence[Tuple], places: Dict[str, Tuple[int, int]]):
    """A rank's part of a whole tree: for each leaf (``tree_leaves`` order,
    placement ``specs``) its slice over each axis of ``places`` ({axis:
    (rank, size)}: 'model', 'mod', 'data', each on a dimension of its own),
    as a tensor of its own (the whole leaf no longer referenced) with the
    leaf's requires_grad; a leaf split over none of them as it is. Device
    (m, d, t)'s block of the JAX package's placement."""
    from ..models.init import map_tree

    specs = iter(specs)

    def part(t):
        spec, out = next(specs), t.detach()
        split = [axis for axis in ("model", "mod", "data")
                 if axis in places and shard_dim(spec, axis) is not None]
        if not split:
            return t
        for axis in split:
            out = shard_of(out, spec, *places[axis], axis)
        return out.clone(memory_format=torch.contiguous_format).requires_grad_(t.requires_grad)

    return map_tree(part, tree)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, init_method: str, backend: str, args, results,
               env=None):
    try:
        if env is None:
            if backend == "nccl":
                torch.cuda.set_device(rank)  # one card per rank
            dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        else:
            os.environ.update(env)  # fn joins, as a launcher's process does
        try:
            out = fn(rank, world, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        buf = io.BytesIO()
        torch.save(out, buf)  # by value: the rank may exit before the parent reads it
        results.put((rank, True, buf.getvalue()))
    except BaseException:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args=(), backend: str = "gloo",
              timeout: Optional[float] = 600.0,
              env: Optional[Sequence[Dict[str, str]]] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes on
    this node joined in one ``backend`` group; returns each rank's return
    value (anything ``torch.save`` takes) in rank order. ``fn`` must be
    importable by name. With ``env`` (one mapping a rank), each process
    sets those environment variables and joins no group: ``fn`` joins
    (``multihost.initialize``), as the processes of a multi-node launch do.
    Tensors in ``args`` reach every rank in one shared memory: a rank that
    changes one in place changes it for all, so it clones it first. Raises
    if a rank raises, dies or outlives ``timeout`` seconds (None: no
    limit); every rank is stopped first."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, init, backend, args, results,
                                                  None if env is None else dict(env[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    got, failure = {}, None
    deadline = time.monotonic() + (timeout if timeout is not None else float("inf"))
    try:
        while len(got) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"ranks {sorted(set(range(world)) - set(got))} still running after {timeout} s"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()]
                if dead:
                    # a rank may have put its result just before it exited
                    try:
                        rank, ok, out = results.get(timeout=2.0)
                    except queue.Empty:
                        failure = f"rank(s) {dead} exited without a result " \
                                  f"(exit codes {[procs[r].exitcode for r in dead]})"
                        break
                else:
                    continue
            if ok:
                got[rank] = torch.load(io.BytesIO(out), weights_only=False)
            else:
                failure = f"rank {rank} failed:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=5.0 if failure is None else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    if failure is not None:
        raise RuntimeError(f"parallel run of {world} ranks: {failure}")
    return [got[r] for r in range(world)]


def init_from_env() -> bool:
    """Join the group that a launcher such as ``torchrun`` describes in the
    environment (RANK, WORLD_SIZE > 1, MASTER_ADDR, MASTER_PORT, on one node
    or several) through ``multihost.initialize``; False where there is none.
    A group already initialised counts as joined."""
    if dist.is_available() and dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or "RANK" not in os.environ:
        return False
    from .multihost import initialize

    initialize()
    return True
