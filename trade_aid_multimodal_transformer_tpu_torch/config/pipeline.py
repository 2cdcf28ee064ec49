"""Sequential processing-pipeline engine.

Capability parity with the reference pipeline
(reference: processing_pipeline.py:26-277) — with one deliberate upgrade: in
this framework the engine is actually *used* on the main data path. The
reference ships the engine but its entry script re-implements only the three
built-ins inline and never executes configured external functions (verified:
reference main.py:116-207 vs processing_pipeline.py — the engine is only
reachable through compatibility_layer.process_modality_data, which nothing
calls). Here, ``data.ingest.apply_processing_steps`` — the single per-modality
ingestion path used by ``train.runner`` — delegates every enabled step, built-in
or external, to ``ProcessingPipeline.execute`` in declared order, which is the
behavior the reference documents (reference README.md custom-processing
sections). A test pins that ``default_pipeline.execution_history`` is populated
by a real ``run_training`` demo run.

Main-path execution options (keyword-only on ``execute``):

- ``file_info`` — when given, percent-change conversion runs per file segment
  so each file's first element resets to 0.0, with the lenient warn-and-emit-
  0.0 zero handling (reference: file_cache.py:298-325); all other steps see
  the concatenated stream.
- ``main_path_defaults`` — the entry script's binning defaults
  (outlier_percentile 0.1, exponent 2.2; reference: main.py:167-174), which
  override the function's own 5 / 2.0 defaults.
- ``percent_decimal_places`` — overrides the percent step's own
  ``decimal_places`` (used by the ``compat_percent_decimals_from_ranging``
  quirk flag, reference: file_cache.py:271,302).
- ``on_step`` / ``raise_errors`` — console-parity callback; error propagation
  for the entry path (the reference entry script crashes on transform errors
  rather than recording them).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .registry import resolve_function
from .schema import InputSchema, ProcessingStep

logger = logging.getLogger(__name__)

# Sentinel: distinguish "no override" from "override with None (use 2)".
_UNSET = object()


@dataclass
class PipelineResult:
    """Execution record (reference: processing_pipeline.py:26-46)."""

    processed_data: Any
    metadata: Dict[str, Any] = field(default_factory=dict)
    execution_log: List[str] = field(default_factory=list)
    successful_steps: int = 0
    total_steps: int = 0
    error: Optional[str] = None

    @property
    def success(self) -> bool:
        return self.error is None

    @property
    def completion_percentage(self) -> float:
        if self.total_steps == 0:
            return 100.0
        return (self.successful_steps / self.total_steps) * 100.0


class ProcessingPipeline:
    """Executes a modality's enabled steps sequentially
    (reference: processing_pipeline.py:49-250)."""

    def __init__(self, enable_logging: bool = True):
        self.enable_logging = enable_logging
        self.execution_history: List[PipelineResult] = []

    def execute(
        self,
        initial_data: Any,
        processing_steps: List[ProcessingStep],
        modality_name: str = "Unknown",
        *,
        file_info: Optional[List] = None,
        main_path_defaults: bool = False,
        percent_decimal_places: Any = _UNSET,
        on_step: Optional[Callable[[int, ProcessingStep, Dict[str, Any], Any], None]] = None,
        raise_errors: bool = False,
    ) -> PipelineResult:
        result = PipelineResult(
            processed_data=initial_data,
            total_steps=len([s for s in processing_steps if s.enabled]),
        )

        enabled_steps = [s for s in processing_steps if s.enabled]
        if not processing_steps:
            result.execution_log.append(
                "No processing steps defined - returning original data"
            )
            self.execution_history.append(result)
            return result
        if not enabled_steps:
            result.execution_log.append(
                "No enabled processing steps - returning original data"
            )
            self.execution_history.append(result)
            return result

        current_data = initial_data
        try:
            for i, step in enumerate(enabled_steps):
                step_name = f"Step {i+1}: {step.function}"
                if self.enable_logging:
                    logger.info(f"Executing {step_name} for modality '{modality_name}'")

                args = dict(step.args)
                if main_path_defaults and step.function == "bin_numeric_data":
                    # Entry-script defaults (reference: main.py:167-174).
                    if args.get("outlier_percentile") is None:
                        args["outlier_percentile"] = 0.1
                    if args.get("exponent") is None:
                        args["exponent"] = 2.2
                if (
                    percent_decimal_places is not _UNSET
                    and step.function == "convert_to_percent_changes"
                ):
                    args["decimal_places"] = percent_decimal_places

                per_segment_percent = (
                    file_info is not None
                    and step.function == "convert_to_percent_changes"
                )
                if per_segment_percent:
                    function = None
                    result.execution_log.append(
                        f"OK {step_name} - Per-file-segment built-in"
                    )
                else:
                    try:
                        function = resolve_function(step.function)
                        result.execution_log.append(
                            f"OK {step_name} - Function resolved successfully"
                        )
                    except Exception as e:
                        if raise_errors:
                            raise
                        msg = f"ERROR {step_name} - Failed to resolve function: {e}"
                        result.execution_log.append(msg)
                        result.error = msg
                        logger.error(msg)
                        break

                if on_step is not None:
                    on_step(i, step, args, current_data)

                try:
                    if per_segment_percent:
                        from ..data.ingest import apply_percent_per_segment

                        current_data = apply_percent_per_segment(
                            current_data, file_info, args.get("decimal_places")
                        )
                    else:
                        current_data = function(current_data, **args)
                    result.successful_steps += 1
                    args_str = f" with args {args}" if args else ""
                    result.execution_log.append(
                        f"OK {step_name} - Executed successfully{args_str}"
                    )
                except Exception as e:
                    if raise_errors:
                        raise
                    msg = f"ERROR {step_name} - Execution failed: {e}"
                    result.execution_log.append(msg)
                    result.error = msg
                    logger.error(msg)
                    break

            result.processed_data = current_data
            result.metadata.update(
                {
                    "modality_name": modality_name,
                    "initial_data_type": type(initial_data).__name__,
                    "final_data_type": type(current_data).__name__,
                    "steps_executed": result.successful_steps,
                    "steps_total": result.total_steps,
                }
            )
            self._track_special_processing(enabled_steps, result.metadata)
        except Exception as e:  # pragma: no cover - defensive
            msg = f"Pipeline execution failed with unexpected error: {e}"
            result.execution_log.append(msg)
            result.error = msg
            logger.error(msg)

        self.execution_history.append(result)
        return result

    def execute_for_schema(self, initial_data: Any, schema: InputSchema) -> PipelineResult:
        return self.execute(initial_data, schema.processing_steps, schema.modality_name)

    def _track_special_processing(
        self, steps: List[ProcessingStep], metadata: Dict[str, Any]
    ) -> None:
        """Flags consumed downstream (reference: processing_pipeline.py:183-205)."""
        special = {
            "convert_to_percent_changes": "is_percent_data",
            "bin_numeric_data": "is_binned_data",
            "range_numeric_data": "is_ranged_data",
        }
        for step in steps:
            if step.function in special and step.enabled:
                metadata[special[step.function]] = True
                if step.function == "bin_numeric_data":
                    metadata["num_bins"] = step.args.get("num_bins")
                elif step.function == "range_numeric_data":
                    metadata["num_whole_digits"] = step.args.get("num_whole_digits")
                    metadata["decimal_places"] = step.args.get("decimal_places")

    def validate_pipeline(
        self, processing_steps: List[ProcessingStep]
    ) -> Tuple[bool, List[str]]:
        errors = []
        for i, step in enumerate([s for s in processing_steps if s.enabled]):
            try:
                resolve_function(step.function)
            except Exception as e:
                errors.append(f"Step {i+1} ({step.function}): {e}")
        return len(errors) == 0, errors

    def get_execution_summary(self) -> Dict[str, Any]:
        if not self.execution_history:
            return {"total_executions": 0}
        successful = sum(1 for r in self.execution_history if r.success)
        total = len(self.execution_history)
        return {
            "total_executions": total,
            "successful_executions": successful,
            "failure_rate": (total - successful) / total * 100 if total > 0 else 0,
            "average_steps_per_execution": (
                sum(r.total_steps for r in self.execution_history) / total
                if total > 0
                else 0
            ),
            "most_recent_execution": (
                self.execution_history[-1].success if self.execution_history else None
            ),
        }

    def clear_history(self) -> None:
        self.execution_history.clear()


default_pipeline = ProcessingPipeline()


def execute_processing_pipeline(data: Any, schema: InputSchema) -> PipelineResult:
    return default_pipeline.execute_for_schema(data, schema)


def validate_schema_pipeline(schema: InputSchema) -> Tuple[bool, List[str]]:
    return default_pipeline.validate_pipeline(schema.processing_steps)
