"""Run-log writing and data-error reporting (a copy of the JAX package's
``data/runlog.py``).

The append-only text log is part of the reference's observable surface; its
layout is preserved verbatim (reference: data_utils.py:665-756). Error
reporting for non-numeric data mirrors data_utils.py:163-209.
"""

from __future__ import annotations

import numbers
from datetime import datetime
from typing import Dict, List


def report_non_numeric_error(data_list: List, file_info: List, this_modality) -> None:
    """Locate and report the first non-numeric element, attributing it to its
    source file via the flat file_info layout (reference: data_utils.py:163-209)."""
    first_non_numeric_index = -1
    non_numeric_value = None
    non_numeric_type = None

    for idx, item in enumerate(data_list):
        if not isinstance(item, numbers.Number):
            first_non_numeric_index = idx
            non_numeric_value = item
            non_numeric_type = type(item).__name__
            break

    if first_non_numeric_index != -1:
        cumulative_length = 0
        file_name = "Unknown"
        element_index_in_file = first_non_numeric_index
        for f_idx in range(0, len(file_info), 2):
            current_file_name = file_info[f_idx]
            current_file_length = file_info[f_idx + 1]
            if first_non_numeric_index < cumulative_length + current_file_length:
                file_name = current_file_name
                element_index_in_file = first_non_numeric_index - cumulative_length
                break
            cumulative_length += current_file_length

        raise ValueError(
            f"Non-numeric element found in Modality '{this_modality}' at index "
            f"{first_non_numeric_index} (approximately element "
            f"{element_index_in_file} in file '{file_name}'). "
            f"Element value: '{non_numeric_value}', Element type: {non_numeric_type}. "
            "Data must be entirely numeric for ranging or decimal places processing."
        )


def write_initial_run_details(
    file_path: str,
    hyperparams: Dict,
    data_info: Dict,
    modality_configs: List[Dict],
    run_stats: Dict,
) -> None:
    """Write the training-log header (reference: data_utils.py:665-756).

    The section layout, separators, and field wording are kept identical so
    downstream log parsers written against the reference keep working.
    """
    if not file_path:
        return

    with open(file_path, "a", encoding="utf-8") as f:
        now = datetime.now()
        current_time_date = now.strftime("%Y-%m-%d %H:%M:%S")

        f.write("=" * 80 + "\n")
        f.write("TRADE-AID MULTIMODAL TRANSFORMER TRAINING LOG\n")
        f.write("=" * 80 + "\n")
        f.write(f"Training Started: {current_time_date}\n")
        f.write("=" * 80 + "\n\n")

        f.write("SYSTEM CONFIGURATION\n")
        f.write("-" * 50 + "\n")
        f.write(
            f"Model Parameters: {run_stats.get('Model parameter size (M)', 'Unknown')} million\n"
        )
        f.write(f"Device: {hyperparams.get('device', 'Unknown')}\n")
        f.write(f"Training Iterations: {hyperparams.get('max_iters', 'Unknown')}\n")
        f.write(f"Evaluation Interval: {hyperparams.get('eval_interval', 'Unknown')}\n\n")

        f.write("MODEL ARCHITECTURE\n")
        f.write("-" * 50 + "\n")
        f.write(f"Embedding Dimension: {hyperparams.get('n_embd', 'Unknown')}\n")
        f.write(f"Attention Heads: {hyperparams.get('n_head', 'Unknown')}\n")
        f.write(f"Transformer Layers: {hyperparams.get('n_layer', 'Unknown')}\n")
        f.write(f"Block Size (Sequence Length): {hyperparams.get('block_size', 'Unknown')}\n")
        f.write(f"Dropout Rate: {hyperparams.get('dropout', 'Unknown')}\n\n")

        f.write("TRAINING PARAMETERS\n")
        f.write("-" * 50 + "\n")
        f.write(f"Batch Size: {hyperparams.get('batch_size', 'Unknown')}\n")
        f.write(f"Learning Rate: {hyperparams.get('learning_rate', 'Unknown')}\n")
        f.write(f"Validation Size: {data_info.get('Split method', 'Unknown')}\n")
        validation_filenames = data_info.get("Validation filenames", [])
        if validation_filenames:
            for filename in validation_filenames:
                f.write(f"    {filename}\n")
        f.write("\n")

        f.write("DATASET INFORMATION\n")
        f.write("-" * 50 + "\n")
        f.write(f"Number of Modalities: {data_info.get('Number of modalities', 'Unknown')}\n")
        f.write(f"Training Set Size: {data_info.get('Train set size', 'Unknown'):,} samples\n")
        f.write(f"Validation Set Size: {data_info.get('Val set size', 'Unknown'):,} samples\n")
        f.write(f"Vocabulary Sizes: {data_info.get('Modality vocabulary sizes', 'Unknown')}\n")
        f.write(f"Data Lengths: {data_info.get('Modality data lengths', 'Unknown')}\n\n")

        f.write("MODALITY CONFIGURATIONS\n")
        f.write("-" * 50 + "\n")
        for i, config in enumerate(modality_configs):
            f.write(f"\n{config.get('Modality Name', f'Modality {i+1}')}\n")
            f.write(f"   {config.get('Source', 'Unknown')}\n")

            processing_steps = []
            if config.get("Convert to Percents"):
                processing_steps.append("Percentage Conversion")
            if (
                config.get("Num Whole Digits") is not None
                or config.get("Decimal Places") is not None
            ):
                digits_text = (
                    f"{config.get('Num Whole Digits', 'N/A')} digits"
                    if config.get("Num Whole Digits") is not None
                    else ""
                )
                decimals_text = (
                    f"{config.get('Decimal Places', 'N/A')} decimals"
                    if config.get("Decimal Places") is not None
                    else ""
                )
                range_parts = [
                    part
                    for part in [digits_text, decimals_text]
                    if part and part != "N/A digits" and part != "N/A decimals"
                ]
                if range_parts:
                    processing_steps.append(f"Ranging ({', '.join(range_parts)})")
            if config.get("Num Bins") is not None:
                processing_steps.append(f"Binning ({config.get('Num Bins')} groups)")

            f.write(
                f"   Processing: {', '.join(processing_steps) if processing_steps else 'None'}\n"
            )
            if config.get("Rand Size") is not None:
                f.write(f"   Randomness: size {config.get('Rand Size')}\n")
            f.write(
                f"   Cross-Attention: {'Enabled' if config.get('Cross-Attend') else 'Disabled'}\n"
            )

        f.write("\n" + "=" * 80 + "\n\n")
