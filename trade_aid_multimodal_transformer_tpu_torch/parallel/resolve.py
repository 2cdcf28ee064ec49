"""Config -> parallelism plan (port of the JAX package's
``parallel/resolve.py``).

``tpu_options.mesh`` and ``tpu_options.context_parallel`` resolve here with
the JAX package's rules and messages: ``"auto"`` (default) takes data
parallelism over the devices left after ``context_parallel``, ``"off"`` one
device (context parallelism still honoured), an int N ``{data: N}``, a
mapping ``{data, model, mod, pipe}`` explicit axis sizes; impossible
requests raise ``ValueError``. The devices are the CUDA cards, or on the
CPU the ``context_parallel`` gloo processes that a run starts.

The port builds the sequence axis (ring attention, parallel/ring_attention.py)
and nothing else yet: a plan with a data, tensor, modality or pipeline axis
(including ``mesh: auto`` on a machine with spare cards for data
parallelism) raises ``NotImplementedError``; ``mesh: off`` keeps such a
machine to the sequence axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

MESH_AXES = ("data", "model", "mod", "pipe")
LATER_SLICE = ("multi-device training beyond context parallelism (data, tensor, modality and "
               "pipeline axes, FSDP, multi-host) is a later slice of the port (ROADMAP 1.5b)")


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


def available_devices(device: str, context_parallel: int) -> int:
    """The devices a plan may use: the CUDA cards, or on the CPU as many
    gloo processes as ``context_parallel`` asks for."""
    if str(device).startswith("cpu"):
        return max(1, int(context_parallel))
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
    package's ``plan_mesh`` raises, and ``NotImplementedError`` for a plan
    with an axis other than the sequence axis."""
    seq = max(1, int(context_parallel))
    if n_devices is None:
        n_devices = available_devices("cuda", seq)
    plan = _resolve(mesh_cfg, seq, fsdp, batch_size, block_size, num_modalities, n_layer,
                    pipeline_microbatches, int(n_devices))
    if plan.n_devices != plan.seq or plan.fsdp:
        hint = " (tpu_options.mesh: off keeps the run to the sequence axis)" \
            if mesh_cfg in (None, "auto") else ""
        raise NotImplementedError(f"parallelism plan {plan.describe()} over {plan.n_devices} "
                                  f"devices: {LATER_SLICE}{hint}")
    return plan
