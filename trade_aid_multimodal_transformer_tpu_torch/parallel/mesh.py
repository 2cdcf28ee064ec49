"""Process groups of a parallel run, and the processes that hold them.

The JAX package lays its devices out as a (pipe, mod, data, model, seq)
mesh; the port builds the sequence axis ('seq', context parallelism) and
nothing else yet (parallel/resolve.py refuses the other axes). A run of P
ranks is P processes in one ``torch.distributed`` group: NCCL with one card
per rank, gloo on the CPU. ``SeqMesh`` is one rank's view of the axis: the
ring hop (to rank + 1, from rank - 1) and the all-gather along the sequence
that ring attention needs.

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
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass
class SeqMesh:
    """This rank's place on the sequence axis of a context-parallel run."""

    rank: int
    size: int
    staged: bool = False  # gloo with CUDA tensors: communicate through host memory

    def hop(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One ring hop: each tensor goes to rank + 1 and the tensors of
        rank - 1 come back, in the same shapes and types."""
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        dev = tensors[0].device
        send = [t.contiguous().cpu() if self.staged else t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]
        ops = [dist.P2POp(dist.isend, t, nxt) for t in send]
        ops += [dist.P2POp(dist.irecv, t, prv) for t in recv]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [t.to(dev) for t in recv] if self.staged else recv

    def all_gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's chunk of x along the sequence axis (-2), in rank
        order."""
        src = x.contiguous().cpu() if self.staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src)
        out = torch.cat(parts, dim=-2)
        return out.to(x.device) if self.staged else out

    def chunk(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous chunk of x along the sequence axis (-2)."""
        c = x.shape[-2] // self.size
        return x.narrow(-2, self.rank * c, c).contiguous()


def seq_mesh(size: int, staged: bool = False) -> SeqMesh:
    """The sequence axis of the initialised default group (a sequence-only
    mesh: the axis is the whole group)."""
    if dist.get_world_size() != size:
        raise ValueError(f"a sequence axis of {size} needs a group of {size} ranks, "
                         f"have {dist.get_world_size()}")
    return SeqMesh(dist.get_rank(), size, staged)


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
