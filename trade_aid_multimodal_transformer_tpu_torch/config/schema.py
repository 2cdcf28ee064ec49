"""Typed modality schemas and the legacy positional interchange format.

Capability parity with the reference schema system (reference: schema.py:23-394).
The load-bearing contract is the *legacy list*: a positional encoding of one
modality's configuration used throughout the reference as the interchange
format between the config layer and the data/model layers
(reference: schema.py:207-250, config.py:80-81, data_utils.py:57):

    [0]  path                 str   file or folder of CSV/TXT
    [1]  column_number        int   1-based column to extract
    [2]  has_header           bool
    [3]  convert_to_percents  bool
    [4]  num_whole_digits     int|None   (range_numeric_data)
    [5]  decimal_places       int|None   (range_numeric_data)
    [6]  num_bins             int|None   (bin_numeric_data)
    [7]  randomness_size      int|None   (training augmentation, 1..3)
    [8]  cross_attention      bool
    [9]  modality_name        str|None
    [10] outlier_percentile   float|None  (bin_numeric_data; modern mode only)
    [11] exponent             float|None  (bin_numeric_data; modern mode only)

Modern (YAML) mode always emits the 12-element form; programmatic mode may
supply only the first 10. Disabled processing steps are dropped during the
conversion (reference: schema.py:226-236) — that behavior is pinned by the
reference's own test suite and by ours (tests/test_config_contract.py).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import yaml


@dataclass
class ProcessingStep:
    """One step of a modality's processing pipeline (reference: schema.py:23-35)."""

    function: str
    args: Dict[str, Any] = field(default_factory=dict)
    enabled: bool = True

    def __post_init__(self):
        if not isinstance(self.function, str):
            raise TypeError(
                f"Processing function must be a string, got {type(self.function)}"
            )
        if not isinstance(self.args, dict):
            raise TypeError(
                f"Processing args must be a dictionary, got {type(self.args)}"
            )


@dataclass
class InputSchema:
    """One modality's configuration (reference: schema.py:38-271).

    Validation rules match the reference exactly: the data path must exist at
    construction time, column numbers are 1-based positive ints, and
    randomness_size is constrained to 1..3 or None.
    """

    modality_name: str
    path: Union[str, Path]
    column_number: int
    has_header: bool = True
    processing_steps: List[ProcessingStep] = field(default_factory=list)
    cross_attention: bool = False
    randomness_size: Optional[int] = None

    def __post_init__(self):
        if not self.modality_name or not isinstance(self.modality_name, str):
            raise ValueError("modality_name must be a non-empty string")

        self.path = Path(self.path)
        if not self.path.exists():
            raise FileNotFoundError(f"Data path does not exist: {self.path}")

        if not isinstance(self.column_number, int) or self.column_number < 1:
            raise ValueError(
                f"column_number must be a positive integer, got {self.column_number}"
            )
        if not isinstance(self.has_header, bool):
            raise TypeError(
                f"has_header must be a boolean, got {type(self.has_header).__name__}"
            )
        if not (isinstance(self.cross_attention, bool) or self.cross_attention is None):
            raise TypeError(
                "cross_attention must be a boolean or None, "
                f"got {type(self.cross_attention).__name__}"
            )
        for i, step in enumerate(self.processing_steps):
            if not isinstance(step, ProcessingStep):
                raise TypeError(f"Processing step {i} must be a ProcessingStep instance")
        if self.randomness_size is not None:
            if not isinstance(self.randomness_size, int) or not (
                1 <= self.randomness_size <= 3
            ):
                raise ValueError("randomness_size must be an integer between 1-3 or null")

    # ------------------------------------------------------------------ legacy

    @classmethod
    def from_legacy_list(cls, legacy_list: List[Any], modality_name: str = "") -> "InputSchema":
        """Build a schema from the positional list format (reference: schema.py:90-158)."""
        if len(legacy_list) < 3:
            raise ValueError(
                "Legacy list must have at least 3 elements (path, column, header)"
            )

        def at(i):
            return legacy_list[i] if len(legacy_list) > i else None

        steps: List[ProcessingStep] = []
        if at(3):
            steps.append(ProcessingStep(function="convert_to_percent_changes", args={}))
        if at(4) is not None or at(5) is not None:
            args = {}
            if at(4) is not None:
                args["num_whole_digits"] = at(4)
            if at(5) is not None:
                args["decimal_places"] = at(5)
            steps.append(ProcessingStep(function="range_numeric_data", args=args))
        if at(6) is not None:
            steps.append(
                ProcessingStep(function="bin_numeric_data", args={"num_bins": at(6)})
            )

        name = modality_name
        if at(9):
            name = legacy_list[9]
        elif not modality_name:
            name = f"Legacy Schema {Path(legacy_list[0]).name}"

        return cls(
            modality_name=name,
            path=legacy_list[0],
            column_number=legacy_list[1],
            has_header=legacy_list[2] if len(legacy_list) > 2 else True,
            processing_steps=steps,
            cross_attention=bool(at(8)) if at(8) is not None else False,
            randomness_size=at(7),
        )

    def to_legacy_list(self) -> List[Any]:
        """Flatten to the 12-element positional format (reference: schema.py:207-250).

        Only *enabled* processing steps contribute; disabled steps leave their
        slots as None/False (reference: schema.py:226-236).
        """
        convert_to_percents = False
        num_whole_digits = None
        decimal_places = None
        num_bins = None
        outlier_percentile = None
        exponent = None

        for step in self.processing_steps:
            if not step.enabled:
                continue
            if step.function == "convert_to_percent_changes":
                convert_to_percents = True
            elif step.function == "range_numeric_data":
                num_whole_digits = step.args.get("num_whole_digits")
                decimal_places = step.args.get("decimal_places")
            elif step.function == "bin_numeric_data":
                num_bins = step.args.get("num_bins")
                outlier_percentile = step.args.get("outlier_percentile")
                exponent = step.args.get("exponent")

        return [
            str(self.path),
            self.column_number,
            self.has_header,
            convert_to_percents,
            num_whole_digits,
            decimal_places,
            num_bins,
            self.randomness_size,
            self.cross_attention,
            self.modality_name,
            outlier_percentile,
            exponent,
        ]

    # -------------------------------------------------------------------- dict

    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any]) -> "InputSchema":
        """Build a schema from a YAML-loaded dict (reference: schema.py:160-182)."""
        steps = [ProcessingStep(**d) for d in config_dict.get("processing_steps", [])]
        return cls(
            modality_name=config_dict["modality_name"],
            path=config_dict["path"],
            column_number=config_dict["column_number"],
            has_header=config_dict.get("has_header", True),
            processing_steps=steps,
            cross_attention=config_dict.get("cross_attention", False),
            randomness_size=config_dict.get("randomness_size"),
        )

    def to_dict(self) -> Dict[str, Any]:
        """Serialize for YAML/JSON (reference: schema.py:184-205)."""
        return {
            "modality_name": self.modality_name,
            "path": str(self.path),
            "column_number": self.column_number,
            "has_header": self.has_header,
            "processing_steps": [
                {"function": s.function, "args": s.args, "enabled": s.enabled}
                for s in self.processing_steps
            ],
            "cross_attention": self.cross_attention,
            "randomness_size": self.randomness_size,
        }

    # -------------------------------------------------------------- validation

    def validate(self) -> bool:
        """Resolve + argument-check every enabled step (reference: schema.py:252-271)."""
        from .registry import validate_function_arguments, validate_function_exists

        for step in self.processing_steps:
            if step.enabled:
                if not validate_function_exists(step.function):
                    raise ImportError(
                        f"Processing function '{step.function}' cannot be resolved"
                    )
                validate_function_arguments(step.function, step.args)
        return True

    # ------------------------------------------------------------- conveniences

    @property
    def enabled_steps(self) -> List[ProcessingStep]:
        return [s for s in self.processing_steps if s.enabled]

    @property
    def is_percent(self) -> bool:
        """Whether this modality converts to percent changes (any enabled step)."""
        return any(
            s.function == "convert_to_percent_changes" for s in self.enabled_steps
        )


class SchemaManager:
    """Holds the ordered set of modality schemas (reference: schema.py:274-371)."""

    def __init__(self):
        self.schemas: List[InputSchema] = []

    def add_schema(self, schema: InputSchema) -> None:
        schema.validate()
        self.schemas.append(schema)

    def add_from_legacy_list(self, legacy_list: List[Any], modality_name: str = "") -> None:
        self.add_schema(InputSchema.from_legacy_list(legacy_list, modality_name))

    def get_schema_by_name(self, name: str) -> Optional[InputSchema]:
        for schema in self.schemas:
            if schema.modality_name == name:
                return schema
        return None

    def to_legacy_format(self) -> List[List[Any]]:
        return [schema.to_legacy_list() for schema in self.schemas]

    def validate_all(self) -> bool:
        for schema in self.schemas:
            schema.validate()
        return True

    def save_to_yaml(self, file_path: Union[str, Path]) -> None:
        config = {"modalities": [schema.to_dict() for schema in self.schemas]}
        with open(file_path, "w") as f:
            yaml.dump(config, f, default_flow_style=False, sort_keys=False)

    def load_from_yaml(self, file_path: Union[str, Path]) -> None:
        """Load modalities from YAML.

        Matches the reference's user-facing behavior of terminating with a
        help message when no modalities are configured
        (reference: schema.py:358-367).
        """
        with open(file_path, "r") as f:
            config = yaml.safe_load(f)

        self.schemas = []
        modalities = (config or {}).get("modalities", [])

        if not modalities:
            print("\n[ERROR] No modalities found in input_schemas.yaml")
            print("\nTo configure modalities:")
            print("  1. See input_schemas.yaml for configuration examples and documentation")
            print("  2. For a quick demo: Copy examples/demo_*.yaml files to config.yaml and input_schemas.yaml")
            print("  3. For real use: Edit input_schemas.yaml with your data (minimum 1M rows required)")
            print("\nSee README.md for detailed instructions.")
            sys.exit(1)

        for modality_config in modalities:
            self.add_schema(InputSchema.from_dict(modality_config))


def convert_legacy_input_schemas(num_schemas: int, globals_dict: dict) -> SchemaManager:
    """Convert programmatic input_schema_1..N globals (reference: schema.py:374-394)."""
    manager = SchemaManager()
    for i in range(1, num_schemas + 1):
        legacy_list = globals_dict.get(f"input_schema_{i}")
        if legacy_list:
            manager.add_schema(InputSchema.from_legacy_list(legacy_list, f"Schema {i}"))
    return manager
