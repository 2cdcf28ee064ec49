"""Parallel training: the parallelism plan, the process groups of a run
(pipeline, modality, data, model and sequence axes), data-, tensor-,
modality- and pipeline-parallel training and ring (context-parallel)
attention."""

from .mesh import (
    DataAxis,
    ModAxis,
    ModelAxis,
    PipeAxis,
    RankMesh,
    SeqMesh,
    batch_rows,
    default_mesh_shape,
    make_mesh,
    run_ranks,
)
from .resolve import MESH_AXES, MeshPlan, plan_mesh
from .ring_attention import (
    ring_causal_attention,
    ring_causal_attention_local,
    ring_cross_attention,
)
from .trainer import make_shard_map_dp_step, make_sharded_trainer, rank_seed

__all__ = [
    "MESH_AXES",
    "DataAxis",
    "MeshPlan",
    "ModAxis",
    "ModelAxis",
    "PipeAxis",
    "RankMesh",
    "SeqMesh",
    "batch_rows",
    "default_mesh_shape",
    "make_mesh",
    "make_shard_map_dp_step",
    "make_sharded_trainer",
    "plan_mesh",
    "rank_seed",
    "ring_causal_attention",
    "ring_causal_attention_local",
    "ring_cross_attention",
    "run_ranks",
]
