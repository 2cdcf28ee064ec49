"""Canonical main-path modality ingestion: load once, then drive each enabled
step through the ``ProcessingPipeline`` engine exactly once, with the
reference entry-script's defaults and per-file percent semantics.

This is the single entry the training runner uses per modality. It subsumes
what the reference spreads across file_cache.load_file_data_cached (percent
inside the loader, reference: file_cache.py:298-325) and main.py's inline
transform calls (reference: main.py:116-207), and additionally executes
external registry functions in declared order — the documented capability the
reference validates but never runs (SURVEY Quirk Q5). Step execution itself
lives in ``config.pipeline.ProcessingPipeline.execute`` (one engine, one
ingestion path); this module owns loading, the per-segment percent helper,
and the quirk-flag plumbing.

Main-path defaults preserved here:
- bin_numeric_data: missing outlier_percentile -> 0.1, missing exponent -> 2.2
  (reference: main.py:167-174 — these override the function's own 5 / 2.0
  defaults on the main path, and they are what produced the demo's golden
  vocabulary [-3, 0, 2]).
- convert_to_percent_changes: applied per file segment with the lenient
  warn-and-emit-0.0 zero handling (reference: file_cache.py:298-325), using
  the step's own decimal_places (default 2). [The reference instead reads the
  *ranging* step's decimal_places for this — legacy slot [5],
  file_cache.py:271,302 — an index quirk; ``compat_percent_decimals_from_ranging=True``
  reproduces it, the default is the documented intent.]
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ..config.pipeline import default_pipeline
from ..config.schema import InputSchema, ProcessingStep
from .loader import get_file_cache
from .transforms import percent_changes_lenient


@dataclass
class ModalityData:
    """Everything downstream layers need about one ingested modality."""

    name: str
    data: List                       # processed data points (pre-tokenization)
    file_info: List                  # flat [name1, len1, name2, len2, ...]
    raw_vocab_size: int              # unique count before processing
    is_percent: bool
    steps_applied: List[str] = field(default_factory=list)
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def file_lengths(self) -> List[int]:
        return [self.file_info[i] for i in range(1, len(self.file_info), 2)]


def load_modality_raw(
    path: str, column_number: int, has_header: bool, quiet: bool = False
) -> Tuple[List, List]:
    """Load a raw column (file or folder concat) through the cache with the
    reference's console output (reference: file_cache.py:276-296)."""
    cache = get_file_cache()
    data_name = Path(path).name

    if os.path.isfile(path):
        if not quiet:
            print(f"  Loading data from file: '{data_name}'")
        column_data = cache.get_column_data(path, column_number, has_header)
        file_name = os.path.basename(path)
        if not quiet:
            print(f"    Successfully read file: {file_name}")
        return column_data, [file_name, len(column_data)]

    if not quiet:
        print(f"    Loading data from folder: '{data_name}'")
    all_data, file_info = cache.load_multiple_files(path, column_number, has_header)
    if not quiet:
        for i in range(0, len(file_info), 2):
            print(f"    Successfully read file: {file_info[i]}")
    return all_data, file_info


def apply_percent_per_segment(
    data: List, file_info: List, decimal_places: Optional[int]
) -> List:
    """Percent conversion applied per file segment so each file's first
    element resets to 0.0 (reference: file_cache.py:298-325)."""
    dp = decimal_places if decimal_places is not None else 2
    converted: List = []
    index = 0
    for i in range(0, len(file_info), 2):
        file_name = file_info[i]
        file_length = file_info[i + 1]
        segment = data[index : index + file_length]
        converted.extend(percent_changes_lenient(segment, dp, file_name))
        index += file_length
    return converted


def _percent_decimals_override(
    steps: List[ProcessingStep], compat_percent_decimals_from_ranging: bool
):
    """Quirk-flag plumbing: with the flag on, percent conversion rounds to the
    *ranging* step's decimal_places — legacy slot [5], with the reference's
    falsy-check fallback to 2 (reference: file_cache.py:271,302,325:
    ``num_dec_places if num_dec_places else 2``)."""
    from ..config.pipeline import _UNSET

    if not compat_percent_decimals_from_ranging:
        return _UNSET
    dp = next(
        (
            s.args.get("decimal_places")
            for s in steps
            if s.enabled and s.function == "range_numeric_data"
        ),
        None,
    )
    return dp if dp else 2


def apply_processing_steps(
    data: List,
    file_info: List,
    steps: List[ProcessingStep],
    on_step=None,
    modality_name: str = "Unknown",
    compat_percent_decimals_from_ranging: bool = False,
) -> Tuple[List, List[str]]:
    """Execute the enabled steps in declared order through the
    ``ProcessingPipeline`` engine with main-path defaults.

    ``on_step(step_index, step, effective_args, current_data)`` is invoked
    before each step runs, letting the caller print the reference's per-step
    console lines (which inspect the pre-step data, e.g. the binning
    description at main.py:176-197). Errors propagate (the reference entry
    script crashes on transform errors). Returns
    (processed_data, applied_function_names).
    """
    result = default_pipeline.execute(
        data,
        steps,
        modality_name,
        file_info=file_info,
        main_path_defaults=True,
        percent_decimal_places=_percent_decimals_override(
            steps, compat_percent_decimals_from_ranging
        ),
        on_step=on_step,
        raise_errors=True,
    )
    applied = [s.function for s in steps if s.enabled]
    return result.processed_data, applied


def load_and_process_modality(
    schema: InputSchema,
    quiet: bool = False,
    on_step=None,
    compat_percent_decimals_from_ranging: bool = False,
) -> ModalityData:
    """Full per-modality ingestion: raw load + pipeline execution.

    ``raw_vocab_size`` follows the reference's accounting: unique count AFTER
    percent conversion (which its loader applies internally) but BEFORE any
    other transform (reference: main.py:93-95 with file_cache.py:298-325) —
    snapshotted at the first non-percent step, falling back to the processed
    data when every step is a percent conversion (or no steps ran).
    """
    raw, file_info = load_modality_raw(
        str(schema.path), schema.column_number, schema.has_header, quiet=quiet
    )
    if not quiet:
        file_count = len(file_info) // 2 if file_info else 0
        print(f"  Summary: {len(raw):,} data points ({file_count} files loaded)")

    raw_vocab_snapshot: List[Optional[int]] = [None]

    def _snap_and_forward(i, step, args, data):
        if raw_vocab_snapshot[0] is None and step.function != "convert_to_percent_changes":
            raw_vocab_snapshot[0] = len(set(data))
        if on_step is not None:
            on_step(i, step, args, data)

    enabled_steps = schema.enabled_steps
    if enabled_steps:
        processed, applied = apply_processing_steps(
            raw,
            file_info,
            schema.processing_steps,
            on_step=_snap_and_forward,
            modality_name=schema.modality_name,
            compat_percent_decimals_from_ranging=compat_percent_decimals_from_ranging,
        )
    else:
        if not quiet:
            print()
            print("  Processing: No processing specified")
        processed, applied = raw, []

    raw_vocab_size = (
        raw_vocab_snapshot[0]
        if raw_vocab_snapshot[0] is not None
        else len(set(processed))
    )
    return ModalityData(
        name=schema.modality_name,
        data=processed,
        file_info=file_info,
        raw_vocab_size=raw_vocab_size,
        is_percent=schema.is_percent,
        steps_applied=applied,
    )
