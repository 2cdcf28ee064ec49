"""Config -> parallelism plan (port of the JAX package's
``parallel/resolve.py``).

``tpu_options.mesh`` and ``tpu_options.context_parallel`` resolve here with
the JAX package's rules and messages: ``"auto"`` (default) takes data
parallelism over the devices left after ``context_parallel``, ``"off"`` one
device (context parallelism still honoured), an int N ``{data: N}``, a
mapping ``{data, model, mod, pipe}`` explicit axis sizes; impossible
requests raise ``ValueError``. Inside a process group (``torchrun``'s, on
one node or several: parallel/multihost.py) the devices are its ranks.
Else they are the CUDA cards, or on the CPU the gloo processes that a run
starts: as many as an explicit mesh asks for times ``context_parallel``,
and for ``auto`` and ``off`` the ``context_parallel`` processes alone (CPU
processes are not devices the user has, so ``auto`` adds no data axis
there).

The port builds the data axis (data parallelism, parallel/trainer.py, and
with ``tpu_options.fsdp: true`` FSDP / ZeRO-3 over it), the model axis
(tensor parallelism: over whole heads where it divides ``n_head``, else
over the columns the JAX package's placement splits, the attention layers
computed whole on every rank of the axis), the modality axis (modality
parallelism over the M-stacked leaves and the batch's modalities), the
sequence axis (ring attention, parallel/ring_attention.py) and the
pipeline axis (GPipe over the block stack, parallel/pipeline.py), in every
combination the JAX package's trainer runs. One plan it resolves the
trainer cannot run: a pipeline axis with a sequence axis (the ring
attention's ``shard_map`` nests inside the pipeline's and fails at trace),
which raises ``ValueError`` here (``PIPE_SEQ``) after every check of the
JAX package's ``plan_mesh``. As in the JAX package, ``fsdp`` takes effect
only where the data axis is larger than 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Union

MESH_AXES = ("data", "model", "mod", "pipe")
PIPE_SEQ = ("a pipeline axis with context parallelism: the JAX package's trainer cannot run "
            "this plan (its ring attention's shard_map, ops/attention.py, nests inside the "
            "pipeline's shard_map, trade_aid_multimodal_transformer_tpu/parallel/pipeline.py, "
            "and fails at trace with a nested shard_map mesh error)")


@dataclass
class MeshPlan:
    """Resolved parallelism layout for one run."""

    data: int = 1
    model: int = 1
    mod: int = 1
    pipe: int = 1
    seq: int = 1
    fsdp: bool = False

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.mod * self.pipe * self.seq

    @property
    def trivial(self) -> bool:
        """True when the plan is single-device."""
        return self.n_devices == 1

    def describe(self) -> str:
        parts = []
        if self.pipe > 1:
            parts.append(f"pipeline x{self.pipe}")
        if self.mod > 1:
            parts.append(f"modality x{self.mod}")
        if self.data > 1:
            parts.append(f"data x{self.data}" + (" (fsdp/zero-3)" if self.fsdp else ""))
        if self.model > 1:
            parts.append(f"tensor x{self.model}")
        if self.seq > 1:
            parts.append(f"context x{self.seq}")
        return " * ".join(parts) if parts else "single device"


def available_devices(device: str, context_parallel: int, mesh_cfg=None) -> int:
    """The devices a plan may use. Inside a process group (``torchrun``'s,
    over one node or several, or the ranks a run starts), its world size:
    every rank is one device, as every chip of every host is in the JAX
    package's global device set. Else the CUDA cards, or on the CPU as many
    gloo processes as an explicit ``mesh_cfg`` asks for times
    ``context_parallel`` (``auto``, ``off`` and no mesh: the
    ``context_parallel`` processes alone)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if str(device).startswith("cpu"):
        cp = max(1, int(context_parallel))
        if isinstance(mesh_cfg, int) and not isinstance(mesh_cfg, bool):
            return max(1, mesh_cfg) * cp
        if isinstance(mesh_cfg, dict):
            return math.prod(max(1, int(mesh_cfg.get(k, 1))) for k in MESH_AXES) * cp
        return cp
    import torch

    return torch.cuda.device_count()


def _resolve(mesh_cfg, seq: int, fsdp: bool, batch_size: int, block_size: int,
             num_modalities: int, n_layer: int, pipeline_microbatches: int,
             n_avail: int) -> MeshPlan:
    """The JAX package's ``plan_mesh`` rules, on a device count."""
    if seq > 1:
        if n_avail < seq:
            raise ValueError(
                f"tpu_options.context_parallel={seq} but only {n_avail} device(s) are available")
        if block_size % seq != 0:
            raise ValueError(f"context_parallel ({seq}) must divide block_size ({block_size})")
    if mesh_cfg is None:
        mesh_cfg = "auto"
    if mesh_cfg == "off":
        return MeshPlan(seq=seq)
    if mesh_cfg == "auto":
        # largest data axis that uses the devices evenly AND divides the batch
        data = 1
        for d in range(n_avail // seq, 0, -1):
            if batch_size % d == 0:
                data = d
                break
        return MeshPlan(data=data, seq=seq, fsdp=fsdp and data > 1)
    if isinstance(mesh_cfg, int):
        mesh_cfg = {"data": mesh_cfg}
    if not isinstance(mesh_cfg, dict):
        raise ValueError(
            f"tpu_options.mesh must be 'auto', 'off', an int, or a mapping "
            f"with keys {MESH_AXES}, got {mesh_cfg!r}")
    unknown = set(mesh_cfg) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown tpu_options.mesh axes {sorted(unknown)}; valid axes: {MESH_AXES}")
    axes = {k: int(mesh_cfg.get(k, 1)) for k in MESH_AXES}
    for k, v in axes.items():
        if v < 1:
            raise ValueError(f"tpu_options.mesh.{k} must be >= 1, got {v}")
    plan = MeshPlan(seq=seq, fsdp=fsdp and axes["data"] > 1, **axes)
    if plan.n_devices > n_avail:
        raise ValueError(
            f"tpu_options.mesh {axes} x context_parallel {seq} needs "
            f"{plan.n_devices} devices, have {n_avail}")
    if batch_size % plan.data != 0:
        raise ValueError(
            f"tpu_options.mesh.data ({plan.data}) must divide batch_size ({batch_size})")
    if plan.mod > 1 and num_modalities % plan.mod != 0:
        raise ValueError(
            f"tpu_options.mesh.mod ({plan.mod}) must divide the modality count ({num_modalities})")
    if plan.pipe > 1:
        if n_layer % plan.pipe != 0:
            raise ValueError(
                f"tpu_options.mesh.pipe ({plan.pipe}) must divide n_layer ({n_layer})")
        mu = int(pipeline_microbatches)
        if mu < 1 or batch_size % (plan.data * mu) != 0:
            raise ValueError(
                f"pipeline_microbatches ({mu}) x mesh.data ({plan.data}) "
                f"must divide batch_size ({batch_size})")
    return plan


def plan_mesh(
    mesh_cfg: Union[str, int, Dict[str, int], None],
    context_parallel: int = 1,
    *,
    fsdp: bool = False,
    batch_size: int,
    block_size: int,
    n_head: int,
    num_modalities: int,
    n_layer: int,
    pipeline_microbatches: int = 4,
    n_devices: Optional[int] = None,
) -> MeshPlan:
    """Resolve the config surface into a MeshPlan over ``n_devices``
    devices (default: the CUDA cards). Raises ``ValueError`` where the JAX
    package's ``plan_mesh`` raises, and for a plan with a pipeline axis and
    a sequence axis, which the JAX package's trainer cannot run
    (``PIPE_SEQ``)."""
    seq = max(1, int(context_parallel))
    if n_devices is None:
        n_devices = available_devices("cuda", seq)
    plan = _resolve(mesh_cfg, seq, fsdp, batch_size, block_size, num_modalities, n_layer,
                    pipeline_microbatches, int(n_devices))
    if plan.pipe > 1 and plan.seq > 1:
        raise ValueError(f"parallelism plan {plan.describe()} over {plan.n_devices} devices: "
                         f"{PIPE_SEQ}")
    return plan
