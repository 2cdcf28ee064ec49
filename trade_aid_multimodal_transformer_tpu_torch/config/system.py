"""System configuration: training/model hyperparameters from ``config.yaml``.

A copy of the JAX package's ``config/system.py``: field names, nesting,
defaults and validation rules are the same, so one ``config.yaml`` serves
both packages. Two changes, both about where the work runs: ``resolve_device``
resolves ``'auto' | 'cuda' | 'gpu'`` to the CUDA device and raises when
there is none, and a config without a ``device`` key resolves like ``auto``
(the JAX package defaults the field to ``'cpu'`` but only prints it, and
runs on its default backend). ``'cpu'`` runs on the CPU only when named.

``tpu_options`` on the GPU: ``compute_dtype`` selects bf16 activations as on
the TPU, ``attn_impl: jnp`` keeps the dense attention cores, and the Adam
dtypes, ``params_dtype``, ``lr_schedule``, ``grad_accum``, ``fused_update``
(the flat-state AdamW, on one rank) and ``remat`` (each block recomputed in
the backward) shape training as there. ``context_parallel`` runs ring
attention over that many ranks, ``mesh`` data parallelism (``{data: P}``,
``auto``; with ``fsdp: true`` FSDP / ZeRO-3 over the data axis), tensor
parallelism (``{model: N}``: over whole heads where N divides ``n_head``,
else over the columns the placement splits; alone, with a data axis, with
``fsdp`` and with ``context_parallel``) and modality parallelism
(``{mod: P}``, P dividing the modality count; alone and with the data and
model axes) and pipeline parallelism (``{pipe: S}`` over
``pipeline_microbatches`` microbatches; alone, with data, model and
modality axes and with ``fsdp``), one card a rank (parallel/); every axis
also with ``context_parallel`` but the pipeline axis: a plan with both
raises, as the JAX package's trainer cannot run it. ``multihost: true``
runs a group over several nodes (``torchrun --nnodes``) as the JAX
package's pod (parallel/multihost.py): the entry prints the node and the
node count, or trains single-process where there is no group to join.
``rng_impl`` is a documented no-op: its four values choose JAX key
implementations, and the port's dropout hash and ``StepRng``
(train/steps.py) use none of them, so every value trains the same bits.
The other keys (``scan_unroll``, ``matmul_precision``, ...) are parsed and
validated so that every config that loads in the JAX package loads here,
and change nothing in the port.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import yaml

from .schema import SchemaManager

logger = logging.getLogger(__name__)

# Defaults pinned by the reference (reference: config_manager.py:112-145).
_DEFAULT_FIXED_VALUES = [-0.5, -0.2, -0.1, 0, 0.1, 0.2, 0.5]

# Mesh axis names accepted in tpu_options.mesh (the JAX package's
# parallel/resolve.py:MESH_AXES).
MESH_AXES = ("data", "model", "mod", "pipe")


def _normalize_mesh(value):
    """YAML 1.1 reads bare ``off``/``on`` as booleans; map them back to the
    documented string forms."""
    if value is False:
        return "off"
    if value is True:
        return "auto"
    return value


@dataclass
class SystemConfig:
    """Flat view of ``config.yaml`` (reference: config_manager.py:30-98)."""

    # Project settings
    project_file_path: str
    output_file_name: str
    model_file_name: str
    create_new_model: bool
    save_model: bool
    device: str

    # Data splitting
    validation_size: float
    num_validation_files: int

    # Training parameters
    batch_size: int
    block_size: int
    max_iters: int
    eval_interval: int
    eval_iters: int
    learning_rate: float

    # Model architecture
    n_embd: int
    n_head: int
    n_layer: int
    dropout: float
    fixed_values: List[float]

    # TPU options (framework extension — absent from the reference; an
    # optional `tpu_options:` YAML section with safe defaults, so every
    # reference config.yaml loads unchanged)
    compute_dtype: str = "float32"   # 'float32' | 'bfloat16' (mixed precision)
    # bf16 MASTER params (contract change, opt-in): parameters are STORED
    # in bfloat16 — halves param read/write traffic in both the matmuls and
    # the optimizer. AdamW math still runs in f32 (_adamw_lowmem), but each
    # applied update rounds through bf16 storage, so trajectories diverge
    # from the f32-master contract at the ~1e-3 relative level (measured
    # deltas in TECHNICAL_NOTES). Requires compute_dtype: bfloat16.
    params_dtype: str = "float32"    # 'float32' | 'bfloat16' (master params)
    attn_impl: str = "auto"          # 'auto' | 'jnp' | 'pallas'
    remat: bool = False              # rematerialize blocks in backward
    rng_impl: str = "auto"           # 'auto' | 'threefry2x32' | 'rbg' (a no-op in the port)
    adam_moment_dtype: str = "float32"  # 'float32' | 'bfloat16' (Adam mu)
    adam_nu_dtype: str = "float32"   # 'float32' | 'bfloat16' (Adam nu)
    scan_unroll: int = 1             # train-chunk lax.scan unroll factor
    # Fused flat-state AdamW (train/steps.AdamWSpec): the train chunk's scan
    # carries three flat param/mu/nu vectors instead of the per-leaf pytree.
    # Measured SLOWER on v5e at demo and production scale (grad concat +
    # param unflatten outweigh the carry copies removed — see AdamWSpec),
    # so 'auto' (default) resolves to OFF; `true` opts in explicitly.
    # Sharded runs (mesh/fsdp) always keep per-leaf state.
    fused_update: Any = "auto"
    # Gradient accumulation: average gradients over this many microbatch
    # draws per optimizer step (effective batch = grad_accum x batch_size
    # at single-batch activation memory). 1 = reference semantics.
    grad_accum: int = 1
    # Optional LR schedule (train/steps.build_lr_schedule): None keeps the
    # reference's constant lr; a mapping {type: cosine|linear|constant,
    # warmup_steps, decay_steps (default max_iters), min_lr_ratio}.
    lr_schedule: Any = None
    # Context parallelism: shard the attention sequence axis over this many
    # devices (ring attention, parallel/ring_attention.py). 1 = off.
    context_parallel: int = 1
    # Device mesh for multi-chip training (parallel/resolve.py):
    # 'auto' (default) = data-parallel over all visible devices; 'off' =
    # single device; an int N = {data: N}; or a mapping with axes
    # {data, model, mod, pipe}. Composes with context_parallel ('seq').
    mesh: Any = "auto"
    # FSDP / ZeRO-3: shard parameters and optimizer state over the mesh's
    # 'data' axis (parallel/mesh.py param_pspecs) — per-device train-state
    # memory scales 1/data. No-op when the resolved data axis is 1.
    fsdp: bool = False
    # Multi-host: the entry runs as a rank of a group over several nodes
    # (`torchrun --nnodes N --node-rank i --nproc-per-node P -m
    # trade_aid_multimodal_transformer_tpu_torch.main` on each node) and
    # prints the node and the node count; the plan spans every node's ranks
    # (parallel/multihost.py). Without a group or a launcher's environment
    # it trains single-process.
    multihost: bool = False
    # GPipe microbatch count when mesh.pipe > 1 (parallel/pipeline.py).
    pipeline_microbatches: int = 4
    # MXU matmul precision for f32 operands: 'default' = native bf16
    # multiplies (fastest; ~1e-2 per-layer deviation vs a float64 oracle),
    # 'float32'/'highest' = full f32 via multi-pass bf16 (matches the
    # reference's torch-CPU f32 matmuls, reference: model.py:65-72).
    matmul_precision: str = "default"
    # Reference-quirk compatibility flags (SURVEY §7; default = documented
    # intent, True = reproduce the reference's as-shipped behavior):
    # Q1 — the reference reads the augmentation size from legacy-list slot
    # [2] (has_header) instead of [7] (randomness_size)
    # (reference: training_utils.py:353).
    compat_legacy_rand_index: bool = False
    # The reference's loader reads the *ranging* step's decimal_places
    # (legacy slot [5]) for percent-change rounding instead of the percent
    # step's own argument (reference: file_cache.py:271,302).
    compat_percent_decimals_from_ranging: bool = False

    def __post_init__(self):
        """Validation rules pinned by the reference (config_manager.py:60-98)."""
        project_path = Path(self.project_file_path)
        if not project_path.exists():
            raise FileNotFoundError(f"Project path does not exist: {project_path}")

        if not 0.0 <= self.validation_size <= 1.0:
            raise ValueError(
                f"validation_size must be between 0.0 and 1.0, got {self.validation_size}"
            )
        if self.num_validation_files < 0:
            raise ValueError("num_validation_files must be non-negative")

        for name in ("batch_size", "block_size", "max_iters", "eval_interval"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if self.learning_rate <= 0:
            raise ValueError("learning_rate must be positive")

        for name in ("n_embd", "n_head", "n_layer"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if not 0.0 <= self.dropout <= 1.0:
            raise ValueError(f"dropout must be between 0.0 and 1.0, got {self.dropout}")

        if not isinstance(self.fixed_values, list) or not self.fixed_values:
            raise ValueError("fixed_values must be a non-empty list")
        for i, val in enumerate(self.fixed_values):
            if not isinstance(val, (int, float)):
                raise ValueError(
                    f"fixed_values[{i}] must be a number, got {type(val).__name__}"
                )

        if self.device not in ["cpu", "cuda", "gpu", "auto"]:
            logger.warning(
                f"Device '{self.device}' may not be supported. "
                "Common values: 'cpu', 'cuda', 'auto'"
            )

        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got {self.compute_dtype!r}"
            )
        if self.params_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"params_dtype must be 'float32' or 'bfloat16', got {self.params_dtype!r}"
            )
        if self.params_dtype == "bfloat16" and self.compute_dtype != "bfloat16":
            raise ValueError(
                "params_dtype: bfloat16 requires compute_dtype: bfloat16 "
                "(bf16 master params only pay off when the matmuls consume "
                "them directly)"
            )
        if self.attn_impl not in ("auto", "jnp", "pallas"):
            raise ValueError(
                f"attn_impl must be 'auto', 'jnp' or 'pallas', got {self.attn_impl!r}"
            )
        if self.rng_impl not in ("auto", "threefry2x32", "rbg", "unsafe_rbg"):
            raise ValueError(
                f"rng_impl must be 'auto', 'threefry2x32', 'rbg' or 'unsafe_rbg', "
                f"got {self.rng_impl!r}"
            )
        if self.adam_moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "adam_moment_dtype must be 'float32' or 'bfloat16', "
                f"got {self.adam_moment_dtype!r}"
            )
        if self.adam_nu_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "adam_nu_dtype must be 'float32' or 'bfloat16', "
                f"got {self.adam_nu_dtype!r}"
            )
        if not isinstance(self.scan_unroll, int) or self.scan_unroll < 1:
            raise ValueError(
                f"scan_unroll must be a positive integer, got {self.scan_unroll!r}"
            )
        if not isinstance(self.grad_accum, int) or self.grad_accum < 1:
            raise ValueError(
                f"grad_accum must be a positive integer, got {self.grad_accum!r}"
            )
        if self.lr_schedule is not None:
            if not isinstance(self.lr_schedule, dict):
                raise ValueError(
                    f"lr_schedule must be a mapping, got {self.lr_schedule!r}"
                )
            unknown = set(self.lr_schedule) - {
                "type", "warmup_steps", "decay_steps", "min_lr_ratio"
            }
            if unknown:
                raise ValueError(f"unknown lr_schedule keys {sorted(unknown)}")
            typ = self.lr_schedule.get("type", "cosine")
            if typ not in ("cosine", "linear", "constant"):
                raise ValueError(
                    "lr_schedule.type must be 'cosine', 'linear' or "
                    f"'constant', got {typ!r}"
                )
            w = self.lr_schedule.get("warmup_steps", 0)
            if not isinstance(w, int) or w < 0:
                raise ValueError(
                    f"lr_schedule.warmup_steps must be a non-negative "
                    f"integer, got {w!r}"
                )
            d = self.lr_schedule.get("decay_steps")
            if d is not None and (not isinstance(d, int) or d < 1):
                raise ValueError(
                    f"lr_schedule.decay_steps must be a positive integer, "
                    f"got {d!r}"
                )
            r = self.lr_schedule.get("min_lr_ratio", 0.0)
            if not isinstance(r, (int, float)) or not 0.0 <= r <= 1.0:
                raise ValueError(
                    f"lr_schedule.min_lr_ratio must be in [0, 1], got {r!r}"
                )
        if not isinstance(self.context_parallel, int) or self.context_parallel < 1:
            raise ValueError(
                f"context_parallel must be a positive integer, "
                f"got {self.context_parallel!r}"
            )
        if self.context_parallel > 1 and self.block_size % self.context_parallel != 0:
            raise ValueError(
                f"context_parallel ({self.context_parallel}) must divide "
                f"block_size ({self.block_size})"
            )
        if isinstance(self.mesh, dict):
            unknown = set(self.mesh) - set(MESH_AXES)
            if unknown:
                raise ValueError(
                    f"unknown tpu_options.mesh axes {sorted(unknown)}; "
                    f"valid axes: {list(MESH_AXES)}"
                )
            for k, v in self.mesh.items():
                if not isinstance(v, int) or v < 1:
                    raise ValueError(
                        f"tpu_options.mesh.{k} must be a positive integer, got {v!r}"
                    )
        elif isinstance(self.mesh, int):
            if self.mesh < 1:
                raise ValueError(f"tpu_options.mesh must be >= 1, got {self.mesh}")
        elif self.mesh not in ("auto", "off"):
            raise ValueError(
                f"tpu_options.mesh must be 'auto', 'off', an int, or a mapping "
                f"of axis sizes, got {self.mesh!r}"
            )
        if not isinstance(self.pipeline_microbatches, int) or self.pipeline_microbatches < 1:
            raise ValueError(
                "pipeline_microbatches must be a positive integer, "
                f"got {self.pipeline_microbatches!r}"
            )
        if self.matmul_precision not in ("default", "float32", "highest"):
            raise ValueError(
                "matmul_precision must be 'default', 'float32' or 'highest', "
                f"got {self.matmul_precision!r}"
            )
        if self.fused_update not in ("auto", True, False):
            raise ValueError(
                "fused_update must be 'auto', true or false, "
                f"got {self.fused_update!r}"
            )

    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any]) -> "SystemConfig":
        """Flatten the nested YAML structure with reference defaults
        (reference: config_manager.py:100-147)."""
        config_dict = config_dict or {}
        project = config_dict.get("project_settings", {})
        splitting = config_dict.get("data_splitting", {})
        training = config_dict.get("training_parameters", {})
        arch = config_dict.get("model_architecture", {})
        tpu = config_dict.get("tpu_options", {}) or {}
        return cls(
            compute_dtype=tpu.get("compute_dtype", "float32"),
            params_dtype=tpu.get("params_dtype", "float32"),
            attn_impl=tpu.get("attn_impl", "auto"),
            remat=bool(tpu.get("remat", False)),
            rng_impl=tpu.get("rng_impl", "auto"),
            adam_moment_dtype=tpu.get("adam_moment_dtype", "float32"),
            adam_nu_dtype=tpu.get("adam_nu_dtype", "float32"),
            scan_unroll=int(tpu.get("scan_unroll", 1)),
            fused_update=tpu.get("fused_update", "auto"),
            grad_accum=int(tpu.get("grad_accum", 1)),
            lr_schedule=tpu.get("lr_schedule"),
            context_parallel=int(tpu.get("context_parallel", 1)),
            # YAML 1.1 parses bare `off`/`on` as booleans — normalize back
            mesh=_normalize_mesh(tpu.get("mesh", "auto")),
            fsdp=bool(tpu.get("fsdp", False)),
            multihost=bool(tpu.get("multihost", False)),
            pipeline_microbatches=int(tpu.get("pipeline_microbatches", 4)),
            matmul_precision=tpu.get("matmul_precision", "default"),
            compat_legacy_rand_index=bool(tpu.get("compat_legacy_rand_index", False)),
            compat_percent_decimals_from_ranging=bool(
                tpu.get("compat_percent_decimals_from_ranging", False)
            ),
            project_file_path=project.get("project_file_path", ""),
            output_file_name=project.get("output_file_name", "training_log.txt"),
            model_file_name=project.get("model_file_name", "model.pth"),
            create_new_model=bool(project.get("create_new_model", 1)),
            save_model=bool(project.get("save_model", 1)),
            device=project.get("device", "auto"),
            validation_size=float(splitting.get("validation_size", 0.1)),
            num_validation_files=int(splitting.get("num_validation_files", 0)),
            batch_size=int(training.get("batch_size", 32)),
            block_size=int(training.get("block_size", 64)),
            max_iters=int(training.get("max_iters", 5000)),
            eval_interval=int(training.get("eval_interval", 500)),
            eval_iters=int(training.get("eval_iters", 40)),
            # YAML 1.1 reads bare scientific notation ("3e-4") as a string
            learning_rate=float(training.get("learning_rate", 3e-4)),
            n_embd=int(arch.get("n_embd", 384)),
            n_head=int(arch.get("n_head", 6)),
            n_layer=int(arch.get("n_layer", 6)),
            dropout=float(arch.get("dropout", 0.2)),
            fixed_values=arch.get("fixed_values", list(_DEFAULT_FIXED_VALUES)),
        )

    def to_dict(self) -> Dict[str, Any]:
        """Re-nest into the YAML structure (reference: config_manager.py:149-183)."""
        return {
            "project_settings": {
                "project_file_path": self.project_file_path,
                "output_file_name": self.output_file_name,
                "model_file_name": self.model_file_name,
                "create_new_model": int(self.create_new_model),
                "save_model": int(self.save_model),
                "device": self.device,
            },
            "data_splitting": {
                "validation_size": self.validation_size,
                "num_validation_files": self.num_validation_files,
            },
            "training_parameters": {
                "batch_size": self.batch_size,
                "block_size": self.block_size,
                "max_iters": self.max_iters,
                "eval_interval": self.eval_interval,
                "eval_iters": self.eval_iters,
                "learning_rate": self.learning_rate,
            },
            "model_architecture": {
                "n_embd": self.n_embd,
                "n_head": self.n_head,
                "n_layer": self.n_layer,
                "dropout": self.dropout,
                "fixed_values": self.fixed_values,
            },
            "tpu_options": {
                "compute_dtype": self.compute_dtype,
                "params_dtype": self.params_dtype,
                "attn_impl": self.attn_impl,
                "remat": self.remat,
                "rng_impl": self.rng_impl,
                "adam_moment_dtype": self.adam_moment_dtype,
                "adam_nu_dtype": self.adam_nu_dtype,
                "scan_unroll": self.scan_unroll,
                "fused_update": self.fused_update,
                "grad_accum": self.grad_accum,
                "lr_schedule": self.lr_schedule,
                "context_parallel": self.context_parallel,
                "mesh": self.mesh,
                "fsdp": self.fsdp,
                "multihost": self.multihost,
                "pipeline_microbatches": self.pipeline_microbatches,
                "matmul_precision": self.matmul_precision,
                "compat_legacy_rand_index": self.compat_legacy_rand_index,
                "compat_percent_decimals_from_ranging": self.compat_percent_decimals_from_ranging,
            },
        }


def resolve_device(device: str) -> str:
    """Resolve the configured device to a torch device name.

    ``'auto'``, ``'cuda'`` and ``'gpu'`` resolve to ``'cuda'`` and raise when
    no CUDA device is visible: the port never drops to the CPU on its own.
    ``'cpu'`` resolves to ``'cpu'``, and only when asked for by name.
    """
    if device in ("auto", "cuda", "gpu"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} needs a CUDA device and none is visible; "
                "set device: cpu to run on the CPU"
            )
        return "cuda"
    if device == "cpu":
        return "cpu"
    raise ValueError(f"unknown device {device!r}; expected auto, cuda, gpu or cpu")


class ConfigManager:
    """Loads + validates ``config.yaml`` and ``input_schemas.yaml``
    (reference: config_manager.py:186-409)."""

    def __init__(self, config_dir: Optional[Union[str, Path]] = None):
        self.config_dir = Path(config_dir) if config_dir else Path.cwd()
        self.schema_manager = SchemaManager()
        self.system_config: Optional[SystemConfig] = None
        self.input_schemas_path = self.config_dir / "input_schemas.yaml"
        self.system_config_path = self.config_dir / "config.yaml"

    def load_all_configs(self) -> None:
        logger.info("Loading all configuration files...")
        try:
            self.load_system_config()
            self.load_input_schemas()
            self.validate_all_functions()
        except Exception as e:
            error_msg = f"Configuration loading failed: {e}"
            logger.error(error_msg)
            raise RuntimeError(error_msg)

    def load_system_config(
        self, file_path: Optional[Union[str, Path]] = None
    ) -> SystemConfig:
        config_path = Path(file_path) if file_path else self.system_config_path
        if not config_path.exists():
            raise FileNotFoundError(f"System config file not found: {config_path}")
        try:
            with open(config_path, "r") as f:
                config_data = yaml.safe_load(f)
            self.system_config = SystemConfig.from_dict(config_data)
            return self.system_config
        except yaml.YAMLError as e:
            raise ValueError(f"Invalid YAML in system config file: {e}")
        except (FileNotFoundError, ValueError):
            raise
        except Exception as e:
            raise RuntimeError(f"Failed to load system config: {e}")

    def load_input_schemas(
        self, file_path: Optional[Union[str, Path]] = None
    ) -> SchemaManager:
        schemas_path = Path(file_path) if file_path else self.input_schemas_path
        if not schemas_path.exists():
            raise FileNotFoundError(f"Input schemas file not found: {schemas_path}")
        try:
            self.schema_manager.load_from_yaml(schemas_path)
            return self.schema_manager
        except yaml.YAMLError as e:
            raise ValueError(f"Invalid YAML in input schemas file: {e}")
        except SystemExit:
            raise
        except Exception as e:
            raise RuntimeError(f"Failed to load input schemas: {e}")

    def save_system_config(self, file_path: Optional[Union[str, Path]] = None) -> None:
        if not self.system_config:
            raise RuntimeError("No system configuration loaded to save")
        config_path = Path(file_path) if file_path else self.system_config_path
        with open(config_path, "w") as f:
            yaml.dump(self.system_config.to_dict(), f, default_flow_style=False, sort_keys=False)

    def save_input_schemas(self, file_path: Optional[Union[str, Path]] = None) -> None:
        schemas_path = Path(file_path) if file_path else self.input_schemas_path
        self.schema_manager.save_to_yaml(schemas_path)

    def validate_all_functions(self) -> None:
        """Startup validation of every enabled step's function
        (reference: config_manager.py:329-344)."""
        from .registry import validate_function_exists

        errors = []
        for schema in self.schema_manager.schemas:
            for step in schema.processing_steps:
                if step.enabled and not validate_function_exists(step.function):
                    errors.append(
                        f"Modality '{schema.modality_name}': "
                        f"Function '{step.function}' cannot be resolved"
                    )
        if errors:
            raise ImportError(
                "Function validation failed:\n"
                + "\n".join(f"  - {e}" for e in errors)
            )

    def get_config_summary(self) -> Dict[str, Any]:
        """Summary dict for debugging (reference: config_manager.py:346-385)."""
        summary: Dict[str, Any] = {
            "system_config_loaded": self.system_config is not None,
            "input_schemas_loaded": len(self.schema_manager.schemas) > 0,
            "total_modalities": len(self.schema_manager.schemas),
            "config_files": {
                "system_config_path": str(self.system_config_path),
                "input_schemas_path": str(self.input_schemas_path),
                "system_config_exists": self.system_config_path.exists(),
                "input_schemas_exists": self.input_schemas_path.exists(),
            },
        }
        if self.system_config:
            sc = self.system_config
            summary["system_config"] = {
                "device": sc.device,
                "batch_size": sc.batch_size,
                "max_iters": sc.max_iters,
                "n_embd": sc.n_embd,
                "n_head": sc.n_head,
                "n_layer": sc.n_layer,
                "fixed_values": len(sc.fixed_values),
            }
        if self.schema_manager.schemas:
            summary["modalities"] = [
                {
                    "name": s.modality_name,
                    "processing_steps": len(s.processing_steps),
                    "cross_attention": s.cross_attention,
                }
                for s in self.schema_manager.schemas
            ]
        return summary
