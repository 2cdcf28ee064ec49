"""Multi-host (multi-node) training: one process group over every node
(port of the JAX package's ``parallel/multihost.py``).

In the JAX package a process is a host: it drives the host's chips, and
``jax.distributed`` joins the hosts' processes into one global device set.
In the port a process is one rank holding one device (``cuda:LOCAL_RANK``,
or the CPU), and a host is a node that runs ``LOCAL_WORLD_SIZE`` of them,
as ``torchrun --nnodes N --node-rank i --nproc-per-node P`` starts them
(ranks i P .. i P + P - 1 on node i). This module joins them into one
``torch.distributed`` group; the plan then counts the group's ranks as its
devices (parallel/resolve.py), so a mesh spans the nodes as the JAX
package's spans the hosts, and everything after runs as on one node.
``tpu_options.multihost: true`` has the training entry print the node and
the node count (train/runner.py).

- ``initialize()`` joins the group (idempotent; parallel/mesh.py
  ``init_from_env`` goes through it): from the torchrun environment, or
  from a coordinator address, a world size and a rank.
- ``process_index()`` / ``process_count()``: this rank's node and the node
  count (JAX's process index and count); ``is_multiprocess()``: whether
  the group spans more than one node.
- ``gather_to_host(tree, fsdp)``: the whole tree on the host, the same on
  every rank (a sharded state gathered from every rank's part).

The JAX package's ``place_sharded`` and ``place_global`` have no
counterpart: they turn identical per-process host data into global arrays
(jax:parallel/trainer.py:70-75, the feed's token arrays for a
process-spanning mesh; :164-172, the train state's placement;
jax:sampling/feed.py:154-164). Every rank of the port holds local tensors:
each reads the same files into its own feed (JAX's invariant: every host
sees the same data) and ``shard_train_state`` (parallel/trainer.py) keeps
its part of the whole state it built from the same seed or file.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = timedelta(minutes=30)


def local_rank() -> int:
    """This rank's place on its node (``LOCAL_RANK``; without it the group
    counts as one node)."""
    default = dist.get_rank() if dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", default))


def local_world_size() -> int:
    """The ranks on this node (``LOCAL_WORLD_SIZE``; without it the whole
    group)."""
    default = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", default))


def process_index() -> int:
    """This rank's node, 0 .. ``process_count() - 1``."""
    return dist.get_rank() // local_world_size() if dist.is_initialized() else 0


def process_count() -> int:
    """The nodes of the group (1 without a group)."""
    return max(1, dist.get_world_size() // local_world_size()) if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    """True where the group spans more than one node."""
    return process_count() > 1


def card_id() -> str:
    """The card this rank would use (``cuda:LOCAL_RANK`` of the node's
    visible cards), by its UUID; '' without CUDA."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        return ""
    return str(torch.cuda.get_device_properties(local_rank() % torch.cuda.device_count()).uuid)


def backend_for(cards: Sequence[str]) -> str:
    """The group's backend from every rank's ``card_id``: NCCL where every
    rank has a card of its own; gloo where two ranks share one (NCCL
    refuses them: ``make_mesh(staged=True)`` then runs the collectives
    through host memory) or a rank has none (the CPU)."""
    if all(cards) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the group of every node's ranks (idempotent: a group already
    initialised is left alone).

    With ``coordinator_address`` ('host:port', rank 0's), the group of
    ``num_processes`` ranks as rank ``process_id``; a node's launcher sets
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``. Without it, the torchrun
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK,
    LOCAL_WORLD_SIZE; under torchrun's agent its store); raises
    ``RuntimeError`` where there is neither. Every rank publishes its card
    in the rendezvous store and the group takes ``backend_for`` them; a
    rank with cards uses ``cuda:LOCAL_RANK`` (modulo the node's visible
    cards)."""
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("initialize(coordinator_address) needs num_processes and process_id")
        url, rank, world = f"tcp://{coordinator_address}", int(process_id), int(num_processes)
    else:
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group to join: no coordinator_address, and the "
                               f"launcher's environment lacks {', '.join(missing)}")
        url, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    store, rank, world = next(dist.rendezvous(url, rank, world, timeout=TIMEOUT))
    cards = dist.PrefixStore("tat_card", store)
    cards.set(str(rank), card_id())
    backend = backend_for([cards.get(str(r)).decode() for r in range(world)])
    if torch.cuda.is_available() and torch.cuda.device_count():
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg", store), rank=rank,
                            world_size=world, timeout=TIMEOUT)


def gather_to_host(tree, fsdp=None, kind: str = "all_gather_save"):
    """The whole of a rank's ``tree`` on the host, the same on every rank
    (the JAX package's ``gather_to_host``): under FSDP, tensor or modality
    parallelism (``fsdp``: the run's parallel/trainer.py ``Fsdp``) every
    rank takes part in gathering the parts (``Fsdp.whole``, collectives of
    ``kind``), else the tree is whole already. The leaves come back as CPU
    tensors in their own dtypes (numpy has no bfloat16, the moments'
    dtype)."""
    from ..models.init import map_tree

    whole = fsdp.whole(tree, kind) if fsdp is not None else tree
    return map_tree(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, whole)
