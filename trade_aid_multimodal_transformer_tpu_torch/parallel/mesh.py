"""Process groups of a parallel run, and the processes that hold them
(port of the JAX package's ``parallel/mesh.py``).

The JAX package lays its devices out as a (pipe, mod, data, model, seq)
mesh; the port builds the data axis (data parallelism) and the sequence axis
('seq', context parallelism) and nothing else yet (parallel/resolve.py
refuses the other axes). A run of P ranks is P processes in one
``torch.distributed`` group: NCCL with one card per rank, gloo on the CPU.
Ranks are laid out in the JAX package's device order, data outer and
sequence inner: global rank d * S + s holds data row d and sequence place s
(``make_mesh``). Every rank creates the same groups in the same order: one
sequence group per data row (S consecutive ranks) and one data group per
sequence place.

``SeqMesh`` is one rank's view of the sequence axis: the ring hop (to the
next place, from the previous one, as global ranks of its group) and the
all-gather along the sequence that ring attention needs. ``DataAxis`` is its
view of the data axis: its rows of a global batch (``batch_rows``, the JAX
package's ``batch_pspec``), the gradient mean over the axis in one flat
all-reduce in ``tree_leaves`` order, and the sums of an evaluation pass.

Where several ranks share one card (a test arrangement: NCCL refuses two
ranks on one device), the group is gloo and CUDA tensors travel through
host memory (``staged``): every chunk still runs on the card.

``run_ranks`` starts the processes of a run (spawned, each told its rank,
the world size and a ``tcp://localhost`` address), collects what each
returns, and kills them all if one fails or the time limit passes.
"""

from __future__ import annotations

import io
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
class DataAxis:
    """This rank's place on the data axis of a data-parallel run: its rows
    of each global batch, and the means and sums over the axis. ``group``:
    the axis's process group (None: the default group)."""

    rank: int
    size: int
    staged: bool = False  # gloo with CUDA tensors: reduce through host memory
    group: Any = None
    # (bytes, seconds) of each gradient all-reduce, the host's clock around
    # the call (the device synchronised first), kept where timing is on
    timing: Optional[List[Tuple[int, float]]] = None

    def rows(self, batch_size: int) -> Tuple[int, int]:
        return batch_rows(batch_size, self.rank, self.size)

    def _all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of a flat tensor, the same bits on every
        rank (each element reduced once, in one order, and shared)."""
        buf = flat.cpu() if self.staged else flat
        dist.all_reduce(buf, group=self.group)
        return buf.to(flat.device) if self.staged else buf

    def mean_grads(self, loss: torch.Tensor, grads: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The mean over the axis of every rank's loss and gradients
        (``tree_leaves`` order): one all-reduce of one flat f32 buffer (the
        leaves, then the loss), divided by the axis size, each leaf back in
        its own dtype."""
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.detach().float().reshape(1)])
        if self.timing is not None:
            if flat.is_cuda:
                torch.cuda.synchronize(flat.device)
            t0 = time.perf_counter()
        flat = self._all_reduce(flat) / self.size
        if self.timing is not None:
            if flat.is_cuda:
                torch.cuda.synchronize(flat.device)
            self.timing.append((flat.numel() * flat.element_size(), time.perf_counter() - t0))
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
        flat = self._all_reduce(flat)
        mean_loss = (flat[0] / self.size).to(stats.mean_loss.dtype)
        mean_losses = (flat[1:1 + M] / self.size).to(stats.mean_losses.dtype)
        cert = flat[1 + M:1 + 2 * M].to(stats.certainty.dtype)
        wins = flat[1 + 2 * M:1 + 3 * M].round().to(stats.wins.dtype)
        losses = flat[1 + 3 * M:].round().to(stats.losses.dtype)
        return type(stats)(mean_loss, mean_losses, wins, losses, cert, stats.batches_processed)


@dataclass
class RankMesh:
    """One rank's view of the (pipe, mod, data, model, seq) layout of a run
    (the JAX package's ``make_mesh``): the axis sizes, this rank's place on
    each, and its data and sequence groups (None where the axis is 1)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    data: Optional[DataAxis]
    seq: Optional[SeqMesh]


def make_mesh(data: int = 1, model: int = 1, seq: int = 1, mod: int = 1, pipe: int = 1,
              staged: bool = False) -> RankMesh:
    """This rank's place in a (pipe, mod, data, model, seq) layout over the
    initialised default group, whose size must be the product of the axes.
    Global rank d * seq + s is data row d, sequence place s (the JAX
    package's device order: data outer, seq inner). Every rank calls this
    in the same order: it creates every data and sequence group of the run.
    Model, modality and pipeline axes are a later slice (parallel/resolve.py
    refuses them)."""
    if model * mod * pipe != 1:
        raise NotImplementedError("tensor, modality and pipeline axes are a later slice of "
                                  "the port (ROADMAP.md, queue 1, items 5 and 6)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * seq != world:
        raise ValueError(f"mesh data={data} x seq={seq} needs {data * seq} ranks, have {world}")
    d, s = divmod(rank, seq)
    seq_axis = data_axis = None
    if seq > 1:
        for row in range(data):  # every rank creates every group, in one order
            ranks = tuple(range(row * seq, (row + 1) * seq))
            group = dist.new_group(list(ranks)) if data > 1 else None
            if row == d:
                seq_axis = SeqMesh(s, seq, staged, group, ranks)
    if data > 1:
        for place in range(seq):
            ranks = list(range(place, world, seq))
            group = dist.new_group(ranks) if seq > 1 else None
            if place == s:
                data_axis = DataAxis(d, data, staged, group)
    return RankMesh({"pipe": pipe, "mod": mod, "data": data, "model": model, "seq": seq},
                    {"pipe": 0, "mod": 0, "data": d, "model": 0, "seq": s}, data_axis, seq_axis)


def default_mesh_shape(n_devices: int, n_head: int) -> Tuple[int, int]:
    """Pick (data, model) for n devices: tensor-parallel 2-way when the head
    count allows it and there are >= 4 devices, else pure data parallel (the
    JAX package's rule, copied as it is)."""
    if n_devices >= 4 and n_devices % 2 == 0 and n_head % 2 == 0:
        return n_devices // 2, 2
    return n_devices, 1


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, init_method: str, backend: str, args, results):
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)  # one card per rank
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        buf = io.BytesIO()
        torch.save(out, buf)  # by value: the rank may exit before the parent reads it
        results.put((rank, True, buf.getvalue()))
    except BaseException:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args=(), backend: str = "gloo",
              timeout: Optional[float] = 600.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one ``backend`` group; returns each rank's return value (anything
    ``torch.save`` takes) in rank order. ``fn`` must be importable by name.
    Tensors in ``args`` reach every rank in one shared memory: a rank that
    changes one in place changes it for all, so it clones it first.
    Raises if a rank raises, dies or outlives ``timeout`` seconds (None: no
    limit); every rank is stopped first."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, init, backend, args, results))
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
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); False where
    there is none. A group already initialised counts as joined."""
    if dist.is_available() and dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or "RANK" not in os.environ:
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    dist.init_process_group(backend, init_method="env://")
    return True
