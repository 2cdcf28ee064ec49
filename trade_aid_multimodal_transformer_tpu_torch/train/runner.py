"""End-to-end training workflow, the zero-flag ``main`` path (port of the JAX
package's ``train/runner.py``).

The same console sections (data loading, VOCABULARY BUILDING, DATASET
SPLITTING, MODEL CREATION & TRAINING, TRAINING PROGRESS, LOSS METRICS), the
same training-log file layout, early stopping (patience 1000 evaluations),
and the same eval / checkpoint boundaries: evaluate and save at every
multiple of eval_interval and at max_iters - 1, train in chunks between
them, save once more at the end.

It runs on the card unless the config says ``device: cpu``. The
parallelism plan resolves as the JAX package's (parallel/resolve.py):
``tpu_options.mesh`` (``{data: P}``, or ``auto`` over the cards) trains data
parallel over P ranks, ``tpu_options.context_parallel: P`` with the sequence
sharded over P ranks (ring attention), and both together over their product
(data outer, sequence inner). ``run_training`` starts the plan's rank
processes itself, one card each over NCCL (on the CPU, gloo processes),
after building the kernels once; inside a process group that already exists
(``torchrun``) it runs as that group's rank. Rank 0 alone prints the
console, writes the log and the checkpoints (the parameters and moments are
the same on every rank: no gather), and returns the result. Tensor,
modality, pipeline and FSDP plans raise (a later slice of the port).
``multihost`` prints that it is unavailable and trains single-process, as
the JAX package does without a pod. f32 products run in full f32
(PyTorch's default, TF32 off) whatever ``matmul_precision`` says.
``TAT_SEED`` pins the run seed; ``TAT_TIMING`` prints the training rate
and, under a data axis, the gradient all-reduce's bytes and time per step;
``TAT_PROFILE_DIR`` writes a ``torch.profiler`` trace of the second training
chunk there (utils/profiling.py). On one rank ``tpu_options.fused_update:
true`` trains with the flat-state AdamW (train/steps.py), and ``remat``
recomputes each block in the backward. ``create_new_model: 0`` resumes from
``model_file_name``: the port's or the JAX package's ``.npz`` (moments
included), or the reference model's ``.pth`` (weights only).
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import numbers
import os
import sys
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config.compat import (
    compatibility_layer,
    get_modality_parameters,
    get_system_configuration,
    initialize_compatibility_layer,
    is_modern_mode,
)
from ..config.schema import InputSchema
from ..data.ingest import ModalityData, load_and_process_modality
from ..data.loader import cleanup_cache
from ..data.runlog import write_initial_run_details
from ..data.vocab import create_train_val_datasets, numerical_representation
from ..models.config import ModelConfig
from ..models.init import init_params, map_tree, tree_leaves
from ..models.param_count import estimate_model_params
from ..ops import kernels
from ..parallel import mesh as pmesh
from ..parallel.resolve import available_devices, plan_mesh
from ..sampling.feed import BatchFeed, resolve_rand_sizes
from ..utils.profiling import StepTimer, annotate, profile_dir_from_env, trace
from .checkpoint import load_checkpoint, load_optimizer_state, save_checkpoint
from .evaluate import estimate_loss
from .metrics import build_metric_specs
from .steps import StepRng, Trainer, make_optimizer


# ---------------------------------------------------------------------------
# console helpers (reference print formats)
# ---------------------------------------------------------------------------

class _StepPrinter:
    """Prints per-step processing lines in the reference's format
    (reference: main.py:101-247)."""

    def __init__(self, total_steps: int):
        self.use_numbering = total_steps > 1
        self.first = True
        self.n = 1

    def _prefix(self) -> str:
        if self.first:
            print()
            self.first = False
        if self.use_numbering:
            p = f"  Processing {self.n}: "
        else:
            p = "  Processing: "
        self.n += 1
        return p

    def __call__(self, i, step, args, data):
        fn = step.function
        if fn == "convert_to_percent_changes":
            print(f"{self._prefix()}Converting to percentages")
        elif fn == "range_numeric_data":
            nwd = args.get("num_whole_digits")
            dp = args.get("decimal_places")
            if not all(isinstance(x, numbers.Number) for x in data):
                print("    Warning: Ranging/decimal places specified but data is not numeric")
                return
            if nwd is not None:
                adp = dp if dp is not None else 0
                low = 10 ** (nwd - 1)
                high = 10 ** nwd - (10 ** (-adp) if adp > 0 else 1)
                range_str = f"{low:.{adp}f}-{high:.{adp}f}"
                range_details = f"{nwd} whole digits" if nwd else ""
                decimal_details = f"{dp} decimals" if dp else ""
                details = ", ".join(filter(None, [range_details, decimal_details]))
                print(f"{self._prefix()}Ranging to {range_str} ({details})")
            else:
                print(f"{self._prefix()}Rounding to {dp} decimal places (no ranging)")
        elif fn == "bin_numeric_data":
            num_bins = args.get("num_bins", args.get("num_groups"))
            has_positive = any(x > 0 for x in data if isinstance(x, numbers.Number))
            has_negative = any(x < 0 for x in data if isinstance(x, numbers.Number))
            has_zero = any(x == 0 for x in data if isinstance(x, numbers.Number))
            bin_parts = []
            if has_positive:
                bin_parts.append(f"{num_bins} positive")
            if has_negative:
                bin_parts.append(f"{num_bins} negative")
            if has_zero:
                bin_parts.append("1 zero")
            if len(bin_parts) == 1:
                bin_description = "1 bin" if has_zero else f"{num_bins} bins"
            else:
                bin_description = ", ".join(bin_parts) + " bins"
            print(f"{self._prefix()}Binning ({bin_description})")
        else:
            print(f"{self._prefix()}External function ({fn})")


_STEP_DISPLAY = {
    "convert_to_percent_changes": "percentages",
    "range_numeric_data": "ranging",
    "bin_numeric_data": "binning",
}


def _plan(sc: Dict[str, Any], num_modalities: int):
    """The run's parallelism plan (parallel/resolve.py) over the devices
    of the config's device."""
    cp = int(sc.get("context_parallel", 1))
    mesh = sc.get("mesh", "auto")
    return plan_mesh(
        mesh, cp,
        fsdp=bool(sc.get("fsdp", False)),
        batch_size=sc["batch_size"], block_size=sc["block_size"], n_head=sc["n_head"],
        num_modalities=num_modalities, n_layer=sc["n_layer"],
        pipeline_microbatches=int(sc.get("pipeline_microbatches", 4)),
        n_devices=available_devices(sc["device"], cp, mesh),
    )


def _run_seed(seed: Optional[int]) -> int:
    if seed is None and os.environ.get("TAT_SEED"):
        # harness hook (tools/parity.py): pin the run seed from the
        # environment without touching the zero-flag CLI surface
        seed = int(os.environ["TAT_SEED"])
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    return seed


def _picklable(caller_globals: Optional[dict]) -> dict:
    """The plain values of a caller's globals (what programmatic mode
    reads), to hand to the rank processes."""
    plain = (bool, int, float, str, list, tuple, dict, type(None))
    return {k: v for k, v in (caller_globals or {}).items()
            if not k.startswith("__") and isinstance(v, plain)}


def param_checksum(params) -> Dict[str, Any]:
    """A rank's parameters in two numbers: the float64 sum of every leaf and
    the SHA-256 of every leaf's bytes in tree order. The ranks of a parallel
    run keep equal parameters (a data axis averages the gradients in one
    order, shared by every rank), so these must be equal on every rank."""
    h = hashlib.sha256()
    total = 0.0
    for leaf in tree_leaves(params):
        t = leaf.detach().cpu().contiguous()
        total += float(t.double().sum())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return {"sum": total, "sha256": h.hexdigest()}


def _rank_entry(rank: int, world: int, caller_globals: dict, seed: int):
    """One rank of a parallel run: the workflow, silent but on rank 0;
    rank 0 returns its result with the tensors on the CPU, every rank its
    parameters' checksum."""
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    if dist.get_backend() == "gloo":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))  # P ranks share the cores
    res = _run_training(caller_globals, seed, rank)
    sys.stdout.flush()
    checksum = param_checksum(res["params"])
    if rank != 0:
        return {"param_checksum": checksum}
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    state = res["opt_state"]
    return {"param_checksum": checksum, "params": map_tree(cpu, res["params"]),
            "opt_state": {"count": state["count"], "mu": map_tree(cpu, state["mu"]),
                          "nu": map_tree(cpu, state["nu"])},
            "launches": kernels.launch_counts(),
            **{k: res[k] for k in ("cfg", "losses", "vocabularies", "step_timer", "plan",
                                   "allreduce")}}


# ---------------------------------------------------------------------------
# the workflow
# ---------------------------------------------------------------------------

def run_training(caller_globals: Optional[dict] = None, seed: Optional[int] = None,
                 rank_timeout: Optional[float] = None) -> Dict[str, Any]:
    """Run the full workflow; returns a summary dict (final params, losses,
    vocabularies) for programmatic callers. With a parallel plan (more than
    one device) and no process group yet, the ranks run in processes of
    their own (each given at most ``rank_timeout`` seconds, where set) and
    the result is rank 0's, on the CPU, without the trainer and the feed,
    with rank 0's kernel launches (``launches``) and every rank's
    ``param_checksum`` (``param_checksums``, in rank order)."""
    if pmesh.init_from_env():
        rank = dist.get_rank()
        if torch.cuda.is_available():
            if rank == 0:
                kernels.build_kernels()  # once; the other ranks load it after the barrier
            dist.barrier()
        if seed is None:
            box = [_run_seed(None)]
            dist.broadcast_object_list(box, src=0)
            seed = box[0]
        if rank != 0:
            sys.stdout = open(os.devnull, "w")
        return _run_training(caller_globals, seed, rank)
    initialize_compatibility_layer(caller_globals if caller_globals is not None else {})
    sc = get_system_configuration()
    plan = _plan(sc, len(get_modality_parameters()))
    if plan.trivial:
        return _run_training(caller_globals, seed)
    cpu = str(sc["device"]).startswith("cpu")
    if not cpu:
        kernels.build_kernels()  # once, before the ranks load the libraries
    results = pmesh.run_ranks(
        _rank_entry, plan.n_devices, (_picklable(caller_globals), _run_seed(seed)),
        backend="gloo" if cpu else "nccl", timeout=rank_timeout)
    return {**results[0], "param_checksums": [r["param_checksum"] for r in results]}


def _run_training(caller_globals: Optional[dict], seed: Optional[int],
                  rank: int = 0) -> Dict[str, Any]:
    print("TRADE-AID MULTIMODAL TRANSFORMER")
    print("=" * 45)
    print("Initializing configuration system...")
    config_mode = initialize_compatibility_layer(
        caller_globals if caller_globals is not None else {}
    )
    print(
        f"Configuration: "
        f"{'YAML mode detected' if config_mode == 'modern' else 'Programmatic mode detected'}"
    )
    print()

    system_config = get_system_configuration()
    modality_params_list = get_modality_parameters()

    if not modality_params_list:
        print("\n[ERROR] No modalities configured")
        print("Please check that input_schemas.yaml exists and contains at least one modality")
        raise SystemExit(1)

    print(f"Modalities: Loaded {len(modality_params_list)} configurations")
    print()

    sc = system_config

    if sc.get("multihost", False):
        # as the JAX package does where no pod is found
        print("Multi-host: initialization unavailable (multi-host training is "
              "a later slice of the port); continuing single-process")

    batch_size = sc["batch_size"]
    block_size = sc["block_size"]
    max_iters = sc["max_iters"]
    eval_interval = sc["eval_interval"]
    eval_iters = sc["eval_iters"]
    learning_rate = sc["learning_rate"]
    device = sc["device"]
    validation_size = sc["validation_size"]
    num_validation_files = sc["num_validation_files"]
    create_new_model = sc["create_new_model"]
    save_model = sc["save_model"]
    model_file_name = sc["model_file_name"]
    project_file_path = sc["project_file_path"]
    output_file_name = sc["output_file_name"]

    # ---------------------------------------------------------- data loading
    schemas = _schemas_from_params(modality_params_list)
    is_percents = any(s.is_percent for s in schemas)

    print(f"Data Loading: Processing {len(schemas)} modalities...")
    modalities: List[ModalityData] = []
    for i, schema in enumerate(schemas):
        print(f"  Loading modality {i + 1}: '{schema.modality_name}'")
        printer = _StepPrinter(len(schema.enabled_steps))
        modalities.append(
            load_and_process_modality(
                schema,
                on_step=printer,
                compat_percent_decimals_from_ranging=sc.get(
                    "compat_percent_decimals_from_ranging", False
                ),
            )
        )
        if i < len(schemas) - 1:
            print()

    print()
    print("Data Loading and Processing: Complete")
    print()

    num_modalities = len(modalities)
    if num_modalities > 1:
        first_len = len(modalities[0].data)
        for i in range(1, num_modalities):
            if len(modalities[i].data) != first_len:
                raise ValueError(
                    f"Modality {i+1} has a different data length "
                    f"({len(modalities[i].data)}) than the first modality "
                    f"({first_len}). All modalities must have the same length "
                    "for proper training."
                )

    # ------------------------------------------------------ vocabulary build
    print("\nVOCABULARY BUILDING")
    all_vocabularies: List[List] = []
    all_numeric_reps: List[np.ndarray] = []
    for m, md in enumerate(modalities):
        ids, vocab = numerical_representation(md.data)
        all_numeric_reps.append(ids)
        all_vocabularies.append(vocab)

        parts = [_STEP_DISPLAY.get(f, f) for f in md.steps_applied]
        processing_text = f"({'+'.join(parts)})" if parts else "(no processing)"
        print(
            f"  - {md.name}  Vocab size: {md.raw_vocab_size:,} -> "
            f"{len(vocab):,}  {processing_text}"
        )
        if len(vocab) <= 20:
            print(f"    Vocabulary: {vocab}")
        else:
            truncated = vocab[:10] + ["..."]
            print(f"    Vocabulary: {str(truncated).replace(chr(39) + '...' + chr(39), '...')}")

    file_lengths = modalities[0].file_lengths or [len(modalities[0].data)]

    # --------------------------------------------------------- dataset split
    print()
    print("Dataset Splitting: Creating training/validation sets...")

    num_files_loaded = len(file_lengths)
    use_file_based_split = num_validation_files > 0
    if use_file_based_split and num_files_loaded <= 1:
        print(
            f"  NOTE: File-based splitting requested "
            f"(num_validation_files={num_validation_files})"
        )
        print(
            f"        but only {num_files_loaded} file(s) loaded. "
            "Reverting to percentage-based splitting."
        )
        print("        (File-based splitting requires multiple files)")
        use_file_based_split = False

    file_info0 = modalities[0].file_info
    if use_file_based_split:
        print(f"Method: File-based: Last {num_validation_files} file(s) for validation")
        val_files_counter = 0
        for j in range(len(file_info0) - 2, -1, -2):
            print(f"  - {file_info0[j]}")
            val_files_counter += 1
            if val_files_counter >= num_validation_files:
                break
    else:
        print(f"Method: Percentage-based ({validation_size*100:.1f}% validation)")

    print()
    print("DATASET SPLITTING")
    all_train_sets: List[np.ndarray] = []
    all_val_sets: List[np.ndarray] = []
    effective_num_validation_files = num_validation_files if use_file_based_split else 0
    for i, md in enumerate(modalities):
        params_i = modality_params_list[i]
        rand_size = params_i[7] if len(params_i) > 7 and params_i[7] is not None else None
        rand_text = f" | Randomness: {rand_size}" if rand_size is not None else ""
        cross = params_i[8] if len(params_i) > 8 and params_i[8] is not None else False
        cross_text = " | Cross-attention: ON" if cross else " | Cross-attention: OFF"

        tr, va = create_train_val_datasets(
            all_numeric_reps[i], validation_size, effective_num_validation_files, file_lengths
        )
        all_train_sets.append(tr)
        all_val_sets.append(va)
        print(f"  - {md.name:<25}Train {len(tr):,} | Val {len(va):,}{rand_text}{cross_text}")

    cleanup_cache()
    print()
    print("Data Preparation: Complete")
    print()

    # ----------------------------------------------------------- model setup
    all_vocab_sizes = [len(v) for v in all_vocabularies]
    model_params_estimate = estimate_model_params(
        sc["n_embd"], sc["n_head"], sc["n_layer"], block_size,
        all_vocab_sizes,
        [bool(p[8]) if len(p) > 8 and p[8] is not None else False for p in modality_params_list],
    )

    print("=" * 60)
    print("MODEL CREATION & TRAINING")
    print("=" * 60)
    print()
    print("Model Configuration:")
    print(f"  Modalities: {num_modalities}")
    print(f"  Vocabulary sizes: {all_vocab_sizes}")
    print(f"  Parameters: {model_params_estimate/1e6:.1f}M")
    print()

    cfg = ModelConfig.from_modality_params(sc, all_vocab_sizes, modality_params_list)
    seed = _run_seed(seed)
    dev = torch.device(device)
    init_gen = torch.Generator().manual_seed(seed)
    rng = StepRng(seed + 1, dev)

    lr_schedule = sc.get("lr_schedule")
    if lr_schedule:
        # decay over the whole run unless the config pins a length
        lr_schedule = dict(lr_schedule)
        lr_schedule.setdefault("decay_steps", max_iters)
    params_dtype = sc.get("params_dtype", "float32")
    optimizer = make_optimizer(
        learning_rate,
        moment_dtype=sc.get("adam_moment_dtype", "float32"),
        nu_dtype=sc.get("adam_nu_dtype", "float32"),
        lr_schedule=lr_schedule,
        params_dtype=params_dtype,
    )

    def _trainable(p):
        if params_dtype == "bfloat16":
            # bf16 master params: stored bf16, AdamW math f32 (lowmem)
            p = map_tree(lambda t: t.to(torch.bfloat16), p)
        return map_tree(lambda t: t.requires_grad_(True), p)

    if create_new_model:
        print("Model: Creating new transformer...")
        params = _trainable(init_params(cfg, init_gen, dev))
        opt_state = optimizer.init(params)
        print("Model: Created successfully")
    else:
        print(f"Model: Loading from {model_file_name}...")
        params = _trainable(init_params(cfg, init_gen, dev))
        opt_state = optimizer.init(params)
        try:
            params = _trainable(load_checkpoint(model_file_name, cfg, dev)[0])
            opt_loaded = load_optimizer_state(model_file_name, params, optimizer)
            opt_state = opt_loaded if opt_loaded is not None else optimizer.init(params)
            print("Model: Loaded successfully")
            print("Optimizer: Created with loaded parameters")
        except FileNotFoundError:
            print("Model: File not found, creating new model instead")
            print("Model: Created successfully")
        except Exception as e:
            print(f"Model: Loading failed ({e}), creating new model")
            print("Model: Created successfully")

    # --------------------------------------------------- feed, trainer, logs
    rand_sizes = resolve_rand_sizes(
        modality_params_list,
        compat_legacy_rand_index=sc.get("compat_legacy_rand_index", False),
    )
    feed = BatchFeed(
        all_train_sets, all_val_sets, file_lengths, block_size, batch_size,
        is_percents, rand_sizes, all_vocab_sizes,
        # as-shipped reference behavior bundles the augmentation SOURCE
        # quirk (slot [2]) with its shared-noise SCOPE (whole train array
        # perturbed once per step) — both behind the same compat flag
        augment_shared=bool(sc.get("compat_legacy_rand_index", False)),
        device=dev,
    )
    metric_specs = build_metric_specs(
        all_vocabularies, [md.is_percent for md in modalities], block_size
    )

    # ----------------------------------------------------- parallelism plan
    plan = _plan(sc, num_modalities)
    allreduce = None  # (bytes, seconds) of each gradient all-reduce, under TAT_TIMING
    if plan.trivial:
        # tpu_options.fused_update: the flat-state AdamW (steps.Trainer);
        # 'auto' resolves to off, as in the JAX package, and the sharded
        # trainers below keep per-leaf state
        trainer = Trainer(cfg, feed, optimizer, metric_specs, eval_iters,
                          grad_accum=sc.get("grad_accum", 1),
                          fused_update=sc.get("fused_update", "auto") is True)
    else:
        from ..parallel.trainer import make_sharded_trainer
        from ..utils.memory import format_train_state_memory

        if not dist.is_initialized():
            raise RuntimeError(f"the plan {plan.describe()} runs in a process group of "
                               f"{plan.n_devices} ranks; run_training starts them itself")
        print(f"Parallelism: {plan.describe()} over {plan.n_devices} devices")
        # gloo with tensors on a card: ranks that share the card, whose
        # collectives go through host memory
        mesh = pmesh.make_mesh(data=plan.data, seq=plan.seq,
                               staged=dev.type == "cuda" and dist.get_backend() == "gloo")
        if mesh.data is not None and os.environ.get("TAT_TIMING"):
            allreduce = mesh.data.timing = []
        trainer = make_sharded_trainer(cfg, feed, optimizer, metric_specs, eval_iters, mesh,
                                       grad_accum=sc.get("grad_accum", 1))
        print(f"Parallelism: {format_train_state_memory(params, opt_state, optimizer)}")
    writer = rank == 0  # only rank 0 writes the log and the checkpoints

    hyperparams = {
        "n_embd": sc["n_embd"], "n_head": sc["n_head"], "n_layer": sc["n_layer"],
        "block_size": block_size, "batch_size": batch_size, "dropout": sc["dropout"],
        "learning_rate": learning_rate, "device": device, "max_iters": max_iters,
        "eval_interval": eval_interval,
    }
    vocab_summary = ", ".join(
        f"Modality {i+1}={len(all_vocabularies[i])}" for i in range(num_modalities)
    )
    length_summary = ", ".join(
        f"Modality {i+1}={len(modalities[i].data)}" for i in range(num_modalities)
    )
    validation_filenames: List[str] = []
    if use_file_based_split:
        c = 0
        for j in range(len(file_info0) - 2, -1, -2):
            validation_filenames.append(file_info0[j])
            c += 1
            if c >= num_validation_files:
                break
        split_method = f"num_validation_files={num_validation_files}"
    else:
        split_method = f"validation_size={validation_size}"

    data_info = {
        "Number of modalities": num_modalities,
        "Train set size": len(all_train_sets[0]),
        "Val set size": len(all_val_sets[0]),
        "Split method": split_method,
        "Validation filenames": validation_filenames,
        "Modality vocabulary sizes": vocab_summary,
        "Modality data lengths": length_summary,
    }
    modality_configs = []
    for i, md in enumerate(modalities):
        p = modality_params_list[i]
        source_path = p[0]
        if md.file_info:
            if os.path.isdir(source_path):
                files_loaded = len(md.file_info) // 2
                source_info = (
                    f"Source Folder: {os.path.basename(source_path)} "
                    f"({files_loaded} files loaded)"
                )
            else:
                source_info = f"Source File: {md.file_info[0]}"
        else:
            source_info = "Unknown"
        modality_configs.append(
            {
                "Source": source_info,
                "Modality Name": md.name,
                "Convert to Percents": p[3] if len(p) > 3 else False,
                "Num Whole Digits": p[4] if len(p) > 4 else None,
                "Decimal Places": p[5] if len(p) > 5 else None,
                "Num Bins": p[6] if len(p) > 6 else None,
                "Rand Size": p[7] if len(p) > 7 else None,
                "Cross-Attend": p[8] if len(p) > 8 else False,
            }
        )

    run_stats = {"Model parameter size (M)": round(model_params_estimate / 1e6, 1)}
    output_file_path = project_file_path + "output/" + output_file_name
    output_dir = os.path.dirname(output_file_path)
    if writer and output_dir and not os.path.exists(output_dir):
        os.makedirs(output_dir, exist_ok=True)
    log_to = output_file_path if writer and output_file_name != "" else ""

    if log_to:
        write_initial_run_details(
            output_file_path, hyperparams, data_info, modality_configs, run_stats
        )
        with open(output_file_path, "a", encoding="utf-8") as f:
            f.write("\n--- TRAINING & EVALUATION RESULTS ---\n\n")
            f.write(
                f"Directional Prediction Analysis ({eval_iters} iterations x "
                f"{batch_size} batches = {eval_iters * batch_size:,} samples per evaluation)\n"
            )

    print()
    print("TRAINING PROGRESS")
    print(f"  - Iterations: {max_iters}")
    print(f"  - Device: {device}")
    print("  - Note: ** Intensive computation ahead **")
    print()

    # ---------------------------------------------------------- training loop
    best_val_loss = float("inf")
    patience = 1000  # evaluations without improvement (reference: main.py:595)
    no_improvement_count = 0
    losses: Dict[str, float] = {}
    all_file_infos = [md.file_info for md in modalities]

    def handle_eval(it: int) -> bool:
        """Eval + logging + early-stop bookkeeping. Returns True to stop."""
        nonlocal best_val_loss, no_improvement_count, losses
        losses = estimate_loss(
            trainer, params, rng,
            all_modality_params=modality_params_list,
            all_file_info=all_file_infos,
            batch_size=batch_size,
            eval_iters=eval_iters,
            output_file_path=log_to,
            current_step=it, max_steps=max_iters,
        )
        current_time = datetime.now().strftime("%H:%M:%S")
        if not (math.isnan(losses["train"]) or math.isnan(losses["val"])):
            print(
                f"\nLOSS METRICS: Step {it}/{max_iters} | "
                f"Train: {losses['train']:.4f} | Val: {losses['val']:.4f} | "
                f"Time: {current_time}"
            )
            print("-" * 80)
            if log_to:
                with open(output_file_path, "a", encoding="utf-8") as f:
                    progress_pct = (it / max_iters) * 100
                    f.write(
                        f"\nSTEP {it:,}/{max_iters:,} ({progress_pct:.1f}% Complete) | "
                        f"Training Loss: {losses['train']:.6f} | "
                        f"Validation Loss: {losses['val']:.6f} | {current_time}\n\n"
                    )
        else:
            print(f"Warning: Step {it} losses are NaN, skipping save | {current_time}")

        if not math.isnan(losses["val"]):
            if losses["val"] < best_val_loss:
                best_val_loss = losses["val"]
                no_improvement_count = 0
            else:
                no_improvement_count += 1
            if no_improvement_count >= patience:
                print(
                    f"Training: Early stopping (no improvement for {patience} evaluations)"
                )
                return True
        return False

    def handle_save(it: int):
        current_time = datetime.now().strftime("%H:%M:%S")
        size = save_checkpoint(
            model_file_name, params, step=it, opt_state=opt_state, optimizer=optimizer
        ) if writer else 0
        print()
        print(f"Saved: Model checkpoint ({round(size/1024**2, 2)} MB) | {current_time}")
        print()

    timer = StepTimer()
    profile_dir = profile_dir_from_env()
    chunks_run = 0

    def print_progress(lo: int, hi: int):
        """The reference prints 'Training: Iteration k/N' at every multiple
        of 100 (reference: main.py:601). Fused chunks span whole
        eval-intervals, so the lines for (lo, hi] print in one burst after
        the chunk; the console sequence is the same (they still precede
        the next eval's lines)."""
        k = (lo // 100 + 1) * 100
        while k <= hi and k < max_iters:
            print(f"Training: Iteration {k}/{max_iters}")
            k += 100

    it = 0
    stopped = False
    while it < max_iters and not stopped:
        if it == 0:
            print(f"Training: Iteration 0/{max_iters}")
        if it % eval_interval == 0 or it == max_iters - 1:
            stopped = handle_eval(it)
            if stopped:
                break
        if save_model and (it % eval_interval == 0 or it == max_iters - 1):
            handle_save(it)

        # run fused steps up to the next host-visible boundary
        next_boundaries = [max_iters]
        next_boundaries.append(((it // eval_interval) + 1) * eval_interval)
        if it < max_iters - 1:
            next_boundaries.append(max_iters - 1)
        nxt = min(b for b in next_boundaries if b > it)
        n_steps = nxt - it
        timer.start()
        # trace the second chunk (the first builds the kernels and warms up)
        with (trace(profile_dir, dev) if profile_dir and chunks_run == 1
              else contextlib.nullcontext()), annotate("train_chunk"):
            params, opt_state, step_losses = trainer.train_chunk(params, opt_state, rng, n_steps)
            step_losses = step_losses.cpu()  # waits for the chunk's device work
        timer.stop(n_steps)
        chunks_run += 1
        print_progress(it, nxt)
        it = nxt

    print("\nTRAINING COMPLETED SUCCESSFULLY")
    if os.environ.get("TAT_TIMING") and timer.steps:
        print(f"Training rate: {timer.summary()}")
        if allreduce:
            print(f"Gradient all-reduce: {allreduce[-1][0]} bytes, "
                  f"{1e3 * sum(t for _, t in allreduce) / len(allreduce):.3f} ms per step")

    if save_model:
        current_time = datetime.now().strftime("%H:%M:%S")
        print(f"Final Save: Model checkpoint | {current_time}")
        size = save_checkpoint(
            model_file_name, params, step=max_iters, opt_state=opt_state, optimizer=optimizer
        ) if writer else 0
        print(f"Final Save: {round(size/1024**2, 2)} MB complete")

    return {
        "params": params,
        "opt_state": opt_state,
        "cfg": cfg,
        "losses": losses,
        "vocabularies": all_vocabularies,
        "trainer": trainer,
        "feed": feed,
        "modalities": modalities,
        "step_timer": timer,
        "plan": plan,
        "allreduce": allreduce,
    }


def _schemas_from_params(modality_params_list) -> List[InputSchema]:
    """Schemas for ingestion: in modern mode the live schema objects (so
    external steps and declared ordering are preserved); in programmatic mode
    reconstructed from the legacy lists."""
    if is_modern_mode() and compatibility_layer.config_manager:
        return list(compatibility_layer.config_manager.schema_manager.schemas)
    return [
        InputSchema.from_legacy_list(p, f"Modality {i+1}")
        for i, p in enumerate(modality_params_list)
    ]
