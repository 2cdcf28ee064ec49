"""Dual-mode configuration compatibility layer (YAML vs programmatic).

Capability parity with the reference compatibility layer
(reference: compatibility_layer.py:27-337). Mode detection is CWD-file-based:
when both ``input_schemas.yaml`` and ``config.yaml`` exist in the working
directory the 'modern' YAML system is used; otherwise the 'legacy'
programmatic system (a ``config.py`` module defining ``input_schema_1..N``
plus hyperparameter globals; reference: config.py:39-93) takes over.

One deliberate fix over the reference: in legacy mode with no schemas found in
the caller's globals, we also look for a ``config`` module on the import path
and collect its ``input_schema_N`` lists — the documented programmatic
workflow (reference README), which the reference's own entry script never
wires up (its ``globals()`` never contain the schemas).
"""

from __future__ import annotations

import importlib
import logging
from pathlib import Path
from typing import Any, Dict, List, Tuple

from .pipeline import ProcessingPipeline
from .system import ConfigManager, resolve_device

logger = logging.getLogger(__name__)

# Hyperparameter names exported by a programmatic config module
# (reference: config.py:24-36, compatibility_layer.py:150-175).
_LEGACY_SYSTEM_KEYS = [
    "batch_size", "block_size", "max_iters", "eval_interval", "eval_iters",
    "learning_rate", "device", "n_embd", "n_head", "n_layer", "dropout",
    "validation_size", "num_validation_files", "create_new_model", "save_model",
    "model_file_name", "project_file_path", "output_file_name", "fixed_values",
]


class CompatibilityMode:
    """Singleton state machine for configuration-mode detection
    (reference: compatibility_layer.py:27-286)."""

    def __init__(self):
        self.mode = None
        self.config_manager: ConfigManager | None = None
        self.legacy_schemas: List[List[Any]] = []
        self.is_initialized = False

    # ------------------------------------------------------------- detection

    def detect_and_initialize(self, globals_dict: dict) -> str:
        if self.is_initialized:
            return self.mode

        yaml_config_exists = (
            Path("input_schemas.yaml").exists() and Path("config.yaml").exists()
        )
        programmatic_schemas_exist = any(
            key.startswith("input_schema_") and globals_dict.get(key)
            for key in globals_dict.keys()
        )

        if yaml_config_exists:
            self.mode = "modern"
            logger.info("YAML configuration system detected")
            self._initialize_modern_system()
        elif programmatic_schemas_exist:
            self.mode = "legacy"
            logger.info("Programmatic configuration system detected")
            self._initialize_legacy_system(globals_dict)
        else:
            self.mode = "legacy"
            logger.warning("No configuration detected, defaulting to programmatic mode")
            self._initialize_legacy_from_module()

        self.is_initialized = True
        return self.mode

    def _initialize_modern_system(self) -> None:
        try:
            self.config_manager = ConfigManager()
            self.config_manager.load_all_configs()
            logger.info(
                "YAML system initialized with "
                f"{len(self.config_manager.schema_manager.schemas)} modalities"
            )
        except SystemExit:
            raise
        except Exception as e:
            logger.error(f"Failed to initialize YAML system: {e}")
            self.mode = "legacy"
            self.config_manager = None

    def _initialize_legacy_system(self, globals_dict: dict) -> None:
        try:
            config_module = importlib.import_module("config")
            num_input_schemas = getattr(config_module, "num_input_schemas", 10)
            self.legacy_schemas = []
            for i in range(1, num_input_schemas + 1):
                schema_name = f"input_schema_{i}"
                if globals_dict.get(schema_name):
                    self.legacy_schemas.append(globals_dict[schema_name])
            logger.info(
                f"Programmatic system initialized with {len(self.legacy_schemas)} input schemas"
            )
        except Exception as e:
            logger.error(f"Failed to initialize programmatic system: {e}")
            self.legacy_schemas = []

    def _initialize_legacy_from_module(self) -> None:
        """Collect input_schema_N directly from a ``config`` module, the
        documented programmatic workflow."""
        try:
            config_module = importlib.import_module("config")
        except ImportError:
            self.legacy_schemas = []
            return
        num_input_schemas = getattr(config_module, "num_input_schemas", 10)
        self.legacy_schemas = [
            getattr(config_module, f"input_schema_{i}")
            for i in range(1, num_input_schemas + 1)
            if getattr(config_module, f"input_schema_{i}", None)
        ]
        if self.legacy_schemas:
            logger.info(
                f"Programmatic system initialized with {len(self.legacy_schemas)} "
                "input schemas (from config module)"
            )

    # --------------------------------------------------------------- queries

    def get_all_modality_params(self) -> List[List[Any]]:
        """Modality parameter lists in the legacy interchange format
        (reference: compatibility_layer.py:101-111)."""
        if self.mode == "modern" and self.config_manager:
            return [
                schema.to_legacy_list()
                for schema in self.config_manager.schema_manager.schemas
            ]
        return self.legacy_schemas

    def get_system_parameters(self) -> Dict[str, Any]:
        """Flat hyperparameter dict with device auto-resolution
        (reference: compatibility_layer.py:113-175)."""
        if self.mode == "modern" and self.config_manager and self.config_manager.system_config:
            sc = self.config_manager.system_config
            params = {
                "batch_size": sc.batch_size,
                "block_size": sc.block_size,
                "max_iters": sc.max_iters,
                "eval_interval": sc.eval_interval,
                "eval_iters": sc.eval_iters,
                "learning_rate": sc.learning_rate,
                "device": resolve_device(sc.device),
                "n_embd": sc.n_embd,
                "n_head": sc.n_head,
                "n_layer": sc.n_layer,
                "dropout": sc.dropout,
                "validation_size": sc.validation_size,
                "num_validation_files": sc.num_validation_files,
                "create_new_model": sc.create_new_model,
                "save_model": sc.save_model,
                "model_file_name": sc.model_file_name,
                "project_file_path": sc.project_file_path,
                "output_file_name": sc.output_file_name,
                "fixed_values": sc.fixed_values,
            }
            # TPU options (framework extension; defaults preserve reference
            # behavior). Surfaced generically from the dataclass so a field
            # added to SystemConfig can never silently drop here.
            params.update(sc.to_dict()["tpu_options"])
            return params

        config_module = importlib.import_module("config")
        params = {key: getattr(config_module, key) for key in _LEGACY_SYSTEM_KEYS}
        params["device"] = resolve_device(params["device"])
        return params

    def process_modality_data(self, modality_index: int, raw_data: Any) -> Tuple[Any, Dict[str, Any]]:
        """Run a modality's pipeline on raw data
        (reference: compatibility_layer.py:177-204)."""
        if self.mode == "modern" and self.config_manager:
            schemas = self.config_manager.schema_manager.schemas
            if modality_index < len(schemas):
                schema = schemas[modality_index]
                pipeline = ProcessingPipeline()
                result = pipeline.execute_for_schema(raw_data, schema)
                if result.success:
                    return result.processed_data, result.metadata
                logger.error(
                    f"Modern pipeline failed for modality {modality_index}: {result.error}"
                )
                return raw_data, {"error": result.error}
            logger.warning(f"Modality index {modality_index} out of range")
            return raw_data, {}
        return raw_data, {}

    def get_modality_metadata(self, modality_index: int) -> Dict[str, Any]:
        """Per-modality metadata (reference: compatibility_layer.py:206-238)."""
        if self.mode == "modern" and self.config_manager:
            schemas = self.config_manager.schema_manager.schemas
            if modality_index < len(schemas):
                schema = schemas[modality_index]
                return {
                    "modality_name": schema.modality_name,
                    "cross_attention": schema.cross_attention,
                    "randomness_size": schema.randomness_size,
                    "processing_steps_count": len(schema.processing_steps),
                    "mode": "modern",
                }
        if modality_index < len(self.legacy_schemas):
            p = self.legacy_schemas[modality_index]
            return {
                "modality_name": p[9] if len(p) > 9 else f"Modality {modality_index + 1}",
                "cross_attention": p[8] if len(p) > 8 else False,
                "randomness_size": p[7] if len(p) > 7 else None,
                "processing_steps_count": 0,
                "mode": "programmatic",
            }
        return {"mode": self.mode}

    def is_percent_modality(self, modality_index: int) -> bool:
        """Whether the modality converts to percent changes
        (reference: compatibility_layer.py:240-263)."""
        if self.mode == "modern" and self.config_manager:
            schemas = self.config_manager.schema_manager.schemas
            if modality_index < len(schemas):
                return schemas[modality_index].is_percent
            return False
        if modality_index < len(self.legacy_schemas):
            p = self.legacy_schemas[modality_index]
            return len(p) > 3 and bool(p[3])
        return False

    def get_configuration_summary(self) -> Dict[str, Any]:
        summary = {
            "mode": self.mode,
            "initialized": self.is_initialized,
            "modalities_count": 0,
        }
        if self.mode == "modern" and self.config_manager:
            summary.update(
                {
                    "modalities_count": len(self.config_manager.schema_manager.schemas),
                    "yaml_configs_loaded": True,
                    "system_config_loaded": self.config_manager.system_config is not None,
                }
            )
        else:
            summary.update(
                {
                    "modalities_count": len(self.legacy_schemas),
                    "yaml_configs_loaded": False,
                    "system_config_loaded": False,
                }
            )
        return summary


compatibility_layer = CompatibilityMode()


def initialize_compatibility_layer(globals_dict: dict) -> str:
    """Detect and initialize configuration; returns 'legacy' or 'modern'
    (reference: compatibility_layer.py:292-305)."""
    return compatibility_layer.detect_and_initialize(globals_dict)


def get_modality_parameters() -> List[List[Any]]:
    return compatibility_layer.get_all_modality_params()


def get_system_configuration() -> Dict[str, Any]:
    if not compatibility_layer.is_initialized:
        compatibility_layer.detect_and_initialize(globals())
    return compatibility_layer.get_system_parameters()


def is_modern_mode() -> bool:
    return compatibility_layer.mode == "modern"


def is_legacy_mode() -> bool:
    return compatibility_layer.mode == "legacy"


def reset_compatibility_layer() -> None:
    """Forget detection state (needed by tests and multi-run tooling; the
    reference offers no reset, relying on process restarts)."""
    global compatibility_layer
    compatibility_layer.__init__()
