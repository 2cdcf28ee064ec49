"""Parallel training: the parallelism plan, the process groups of a run and
ring (context-parallel) attention."""

from .mesh import SeqMesh, run_ranks, seq_mesh
from .resolve import MESH_AXES, MeshPlan, plan_mesh
from .ring_attention import (
    ring_causal_attention,
    ring_causal_attention_local,
    ring_cross_attention,
)
from .trainer import make_sharded_trainer

__all__ = [
    "MESH_AXES",
    "MeshPlan",
    "SeqMesh",
    "make_sharded_trainer",
    "plan_mesh",
    "ring_causal_attention",
    "ring_causal_attention_local",
    "ring_cross_attention",
    "run_ranks",
    "seq_mesh",
]
