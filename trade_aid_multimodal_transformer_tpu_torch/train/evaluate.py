"""Evaluation with the reference's console and log-file surface (port of the
JAX package's ``train/evaluate.py``).

The console sections, the per-modality directional-metric lines and the
append-only log-file lines are those of the JAX package (reference:
training_utils.py:387-520); the numerics run on the device
(steps.Trainer.eval_pass).
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, Optional, Sequence

from .steps import EvalStats, StepRng, Trainer


def modality_display_name(
    modality_params: Sequence, modality_index: int, file_info: Optional[Sequence] = None
) -> str:
    """Name with the reference's fallbacks (training_utils.py:241-246)."""
    name = modality_params[9] if len(modality_params) > 9 else None
    if name and isinstance(name, str):
        return name
    if file_info:
        return os.path.basename(file_info[0])
    return f"Modality {modality_index + 1}"


def estimate_loss(
    trainer: Trainer,
    params,
    rng: StepRng,
    *,
    all_modality_params: Sequence[Sequence],
    all_file_info: Sequence[Sequence],
    batch_size: int,
    eval_iters: int,
    output_file_path: str = "",
    current_step: Optional[int] = None,
    max_steps: Optional[int] = None,
) -> Dict[str, float]:
    """Evaluate on both splits with full console/log parity.

    Returns {'train': mean summed CE, 'val': ...} like the reference.
    The reference evaluates the *train* split too, without augmentation
    (training_utils.py:402, 420 — its Quirk Q11, intentional surface).
    """
    out: Dict[str, float] = {}
    num_modalities = trainer.cfg.num_modalities

    for state in ("train", "val"):
        current_time = datetime.now().strftime("%H:%M:%S")
        step_info = (
            f"Step {current_step}/{max_steps} | " if current_step is not None else ""
        )
        batch_calc = f" * {batch_size} batches = {eval_iters * batch_size} samples"
        print(
            f"Evaluation: {step_info}{state.title()} set "
            f"({eval_iters} iterations{batch_calc}) | {current_time}"
        )

        stats: EvalStats = trainer.eval_pass(params, rng, state)
        out[state] = float(stats.mean_loss)
        wins = [int(w) for w in stats.wins]
        losses = [int(l) for l in stats.losses]
        processed = [int(p) for p in stats.batches_processed]

        print_state_display = "Train Set" if state == "train" else "Val Set"
        print(f"\nDIRECTIONAL METRICS - {print_state_display} (Correct/Total)")
        for m in range(num_modalities):
            name = modality_display_name(all_modality_params[m], m, all_file_info[m] if m < len(all_file_info) else None)
            if processed[m] > 0:
                total_predictions = wins[m] + losses[m]
                if total_predictions > 0:
                    rate = round(wins[m] / total_predictions * 100, 1)
                    print(f"  - {name:<30}{wins[m]}/{total_predictions} ({rate}%)")
                else:
                    print(f"  - {name}: No directional predictions")
            else:
                print(f"  - {name}: No data processed (non-numeric)")

        if output_file_path:
            with open(output_file_path, "a", encoding="utf-8") as f:
                for m in range(num_modalities):
                    name = modality_display_name(
                        all_modality_params[m], m,
                        all_file_info[m] if m < len(all_file_info) else None,
                    )
                    if processed[m] > 0:
                        total_predictions = wins[m] + losses[m]
                        if total_predictions > 0:
                            rate = round(wins[m] / total_predictions * 100, 1)
                            f.write(
                                f"   DIRECTIONAL PREDICTION {print_state_display} - "
                                f"{name}: Correct={wins[m]:,} | Incorrect={losses[m]:,} "
                                f"| Accuracy={rate}%\n"
                            )
                        else:
                            f.write(
                                f"   DIRECTIONAL PREDICTION {print_state_display} - "
                                f"{name}: Correct={wins[m]:,} | Incorrect={losses[m]:,} "
                                f"| Accuracy=N/A\n"
                            )
                    else:
                        f.write(
                            f"   DIRECTIONAL PREDICTION {print_state_display} - "
                            f"{name}: Correct=0 | Incorrect=0 | Accuracy=N/A\n"
                        )
                if state == "train":
                    f.write("\n")

        if state == "train":
            print()

    return out
