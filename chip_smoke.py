#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card (forward and
backward, dropout off and on), drives the port's generation entry point
(full-window sampling and KV-cached serving, ``--serve``, with bf16 and int8
caches) and its training entry point at the production configuration's full
width (examples/production_config.yaml: 4 modalities, n_embd 384, 6 heads, 6
layers, block_size 64, batch 32, dropout 0.2, bf16) with seeded random
weights on seeded synthetic CSVs, then the same config at block_size 1024
(long context: the flash kernels, training at batch 8) and under context
parallelism (ring attention over ranks sharing the card), drives the public
ops and the tool that reach the remaining kernels (``causal_attention``
differentiated in the whole-row band through the port of
tools/flash_crossover.py, ``causal_attention_packed``, ``decode_attention_t``),
checks that each path went through its kernels with the expected launch
counts and that what comes out is right (the card's forward, cached forward
and training step against the CPU's, every backward kernel call of the
T = 64 step against its plain version, the training loss falling), and
times the kernels, batched serving, cached serving and training. Each phase
prints one line; any failed check raises and the script exits non-zero. The
last line is ``{"ok": true, "device": {...}}``.

Data parallelism (``tpu_options.mesh: {data: P}``) runs on the one card too:
the kernels of both training steps called on half a batch with the
global-row arguments against the global call's rows (``dp_kernel_check``),
one production step over two ranks sharing the card against the one-rank
step on the global batch (``dp_reference``), and the training entry over
those two ranks (``dp_training``). So does FSDP (``tpu_options.fsdp:
true`` on that axis): one production step bit-equal to the data-parallel
step, with planted faults that must break it (``fsdp_reference``), and the
entry over the two ranks at dropout 0 and 0.2, its checkpoint and a resume
(``fsdp_training``). So does tensor parallelism (``tpu_options.mesh:
{model: 2}``): the kernels on half the heads (and of the batch) with the
global-head arguments against the global call's heads
(``tp_kernel_check``), one production step over two ranks against the
one-rank step, with planted faults that must break it (``tp_reference``),
and the entry over the two ranks at dropout 0 and 0.2, its checkpoint
loaded on one rank and a resume (``tp_training``). So does modality
parallelism (``tpu_options.mesh: {mod: 2}``): the kernels on half the
modalities with the modality offset against the global call's rows
(``mod_kernel_check``), one production step over two ranks (and over
``{mod: 4}``) against the one-rank step, with planted faults
(``mod_reference``), and the entry over the two ranks at dropout 0 and 0.2,
its checkpoint loaded on one rank (``mod_training``); and the other tensor
plans: ``{model: 4}`` over the 6 heads (``tp_split_reference``)
and ``{model: 2}`` x ``context_parallel: 2`` at block_size 1024
(``tp_seq_reference``). So does pipeline parallelism (``tpu_options.mesh:
{pipe: 2}``, 4 microbatches): one production step over the two stages
bit-equal to the one-rank pipeline, the kernels held in-path, with planted
faults (``pp_reference``), and the entry over the two ranks at dropout 0
and 0.2, its checkpoint loaded on one rank (``pp_training``). So does
multi-host training (``tpu_options.multihost: true``): the entry (``main``)
launched as two nodes of one rank each in torchrun's environment, sharing
the card (gloo, staged), ``mesh: auto`` with FSDP, bit-equal to
``fsdp_training`` (``multihost``). The entries over ranks sharing the card
run 4 steps (``PARALLEL_ENTRY``). The ``build`` phase also builds the
port's native C++ data transforms (``g++``) and holds them bit-equal to
their numpy paths on the synthetic CSVs (``native_check``).

Right after the build, the training entry with ``TAT_PROFILE_DIR`` must
write a trace holding the training step's kernels (``profile_trace``).
After the T = 64 training run come the flat-state AdamW (``fused_update``:
one step's gradients through the per-leaf and the flat update, bit-equal,
then the entry with ``fused_update: true`` against the per-leaf entry),
``remat`` (one step at T = 64 and 1024 with and without it: the same
values, the forward kernels launched twice, less memory at 1024; also one
step in ``cp_reference``) and ``reference_checkpoint`` (the reference
fixtures' ``.pth`` files and a production-width one through
``load_checkpoint``, ``generate.run`` and ``run_training``).

Needs a CUDA device and the port package beside this file; without either it
exits non-zero before printing any result.

    python3 chip_smoke.py --multi-card

on a machine with 2 or 4 cards instead runs the training entry with
context parallelism, data parallelism (``{data: 2}``, ``{data: 4}`` and
``mesh: auto``, each size also with ``fsdp: true``), tensor parallelism
(``{model: 2}`` at block_size 64 and 1024) and, on 4 cards, data x
sequence (also with FSDP), data x tensor (``{data: 2, model: 2}``, also
with FSDP), modality (``{mod: 2, data: 2}``, also with FSDP, ``{mod: 4}``,
``{mod: 2, model: 2}``), ``{model: 4}`` and ``{model: 2}`` x
``context_parallel: 2``, pipeline parallelism (``{pipe: 2}``, on 4
cards ``{pipe: 2, data: 2}``, also with FSDP) and, on 4 cards, multi-host
training (two nodes of two cards each, ``multihost: true``, ``{data: 4}``
and ``mesh: auto`` with FSDP: ``multi_card_multihost``), one card per rank
over NCCL, against the same run on one card, and compares every rank's
parameters (``multi_card``).

    python3 chip_smoke.py --k1b-split

builds the kernels and prints only the device time of each kernel one
production K1b call launches (``k1b_split``; the full run prints it too).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "trade_aid_multimodal_transformer_tpu_torch"
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense; f32 off the tensor cores
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# backward kernels and dropout forwards: max-abs error <= tol * max(1, max|ref|)
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# one training step on the card against the CPU dense step: loss absolute;
# every gradient leaf by its L2-relative error |g - ref| / |ref|. (A per-leaf
# max-abs bound relative to the leaf's max failed in f32 at 1.5e-2 on the
# card's dense path as on its kernel path: summation order moves ReLU
# pre-activations across zero, which changes single gradient elements.) The
# gate must also reject planted faults (one backward output 20% off), which
# the phase runs every time.
STEP_TOL = {"float32": {"loss": 1e-4, "grad_l2": 1e-2}, "bfloat16": {"loss": 5e-2, "grad_l2": 0.15}}
SALTS = (123456789, 3141592653)
SOURCES = {
    "fused_qkv_attention": (
        f"{PKG}/ops/csrc/fused_qkv_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:1959",
    ),
    "short_cross_attention": (
        f"{PKG}/ops/csrc/short_cross_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:1643",
    ),
    "fused_qkv_attention_bwd": (
        f"{PKG}/ops/csrc/fused_qkv_attention_bwd.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:1984",
    ),
    "short_cross_attention_bwd": (
        f"{PKG}/ops/csrc/short_cross_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:1694",
    ),
    "short_causal_attention": (
        f"{PKG}/ops/csrc/short_causal_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:1436",
    ),
    "short_causal_attention_bwd": (
        f"{PKG}/ops/csrc/short_causal_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:1456",
    ),
    "short_causal_attention_packed": (
        f"{PKG}/ops/csrc/short_causal_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:2257",
    ),
    "short_causal_attention_packed_bwd": (
        f"{PKG}/ops/csrc/short_causal_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:2281",
    ),
    "decode_attention": (
        f"{PKG}/ops/csrc/decode_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:2566",
    ),
    "decode_attention_t": (
        f"{PKG}/ops/csrc/decode_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:2667",
    ),
    "decode_attention_packed": (
        f"{PKG}/ops/csrc/decode_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:2762",
    ),
    "decode_attention_packed_q8": (
        f"{PKG}/ops/csrc/decode_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:2879",
    ),
    "flash_attention": (
        f"{PKG}/ops/csrc/flash_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:164",
    ),
    "flash_attention_bwd": (
        f"{PKG}/ops/csrc/flash_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:627",
    ),
    "flash_cross_attention": (
        f"{PKG}/ops/csrc/flash_cross_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:1054",
    ),
    "flash_cross_attention_res": (
        f"{PKG}/ops/csrc/flash_cross_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:1125",
    ),
    **{f"flash_chunk_{d}_{m}": (
        f"{PKG}/ops/csrc/flash_attention.cu",
        f"trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:{3078 if d == 'fwd' else 3098}",
    ) for d in ("fwd", "bwd") for m in ("causal", "full")},
}
# the path whose launches each kernel's entry of the last line reports
MAIN_PATH = {"fused_qkv_attention": "training", "fused_qkv_attention_bwd": "training",
             "short_cross_attention": "training", "short_cross_attention_bwd": "training",
             "short_causal_attention": "serve", "short_causal_attention_bwd": "crossover",
             "short_causal_attention_packed": "packed_op",
             "short_causal_attention_packed_bwd": "packed_op", "decode_attention_t": "decode_t_op",
             "decode_attention_packed": "serve",
             "decode_attention_packed_q8": "serve_int8", "decode_attention": "serve_plain",
             "flash_attention": "long_training", "flash_attention_bwd": "long_training",
             "flash_cross_attention": "long_generate", "flash_cross_attention_res": "long_training",
             **{f"flash_chunk_{d}_{m}": "cp_training" for d in ("fwd", "bwd")
                for m in ("causal", "full")}}
# the production shapes of the flash kernels' entries in the last line: the
# training step at block_size 1024, batch 8 (self-attention 4 x 8 x 6 rows,
# cross-attention 8 x 6 rows against J = 3 streams)
LONG_BLOCK = 1024
FLASH_PROD = (4 * 8 * 6, LONG_BLOCK, 64)
FLASH_CROSS_PROD = (3, 8 * 6, LONG_BLOCK, 64)
# serve_reference: the card's cached logits against its full-window forward
# and the CPU's cached f32 forward, max-abs (f32: 1e-5 against sound readings
# of <= 6.4e-7 and the planted fault below reading >= 1.4e-4 at block_size
# 1024; bf16: 2e-2 against sound readings of 3.9e-3-6.9e-3, NVIDIA H100 80GB
# HBM3, 700 W). The bf16 logits
# (|max| 0.5, rms 0.12) round in steps of ~2e-3, and one bf16 ulp anywhere in
# six layers moves them by 5e-3-7e-3 L2-relative, more than a one-column mask
# fault does (2.6e-3-6.7e-3 in f32). So in bf16 every kernel call of the
# cached run is held against its plain version on the same inputs, as
# |out - plain| / |plain| (L2) <= SERVE_BF16_IN_PATH, and that fault must
# exceed it. Sound calls read <= 4.1e-4 at block_size 64 and <= 5.7e-4 at
# 1024; the fault reads >= 0.0797 at 64 but 6.9e-3 at 1024 (one column of
# ~1000), so the limit is 2e-3
SERVE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SERVE_BF16_IN_PATH = 2e-3
# context parallelism (tpu_options.context_parallel) at block_size 1024: the
# ring's chunk pairs at context_parallel 2 (chunks of 512), self-attention
# 4 x 8 x 6 rows and cross-attention 8 x 6 rows per stream at batch 8
CP_SELF = (4 * 8 * 6, 512, 512, 64)
CP_CROSS = (8 * 6, 512, 512, 64)
# the phases' rank processes share the one card; each spawn is stopped after
RANK_TIMEOUT = 420.0
# the step count of the entries over ranks sharing the card (dp_training,
# fsdp_training, tp_training, mod_training and their one-rank runs), cut
# from 8 to 4 for the smoke's time limit
PARALLEL_ENTRY = dict(max_iters=4, eval_interval=2, eval_iters=2)
# the kernels that only public ops and tools reach: K3b at the
# production training step's self-attention rows (M B H = 4 x 32 x 6, T 64,
# hs 64), K4 over the same rows packed (nb = M B = 128, H = 6), K9 at the
# long-context serving rows (24 B at B = 16, hs 64, S = 1024)
K3B_PROD = (4 * 32 * 6, 64, 64)
K4_PROD = (4 * 32, 6, 64, 64)
# K1f and K1b at the production training step: x (M, B, T, C), H heads of hs
PROD_K1 = (4, 32, 64, 384, 6, 64)
K9_PROD = (24 * 16, 64, 1024)


T_START = time.perf_counter()


def emit(obj) -> None:
    """Print a string, or a phase's dict with the script's elapsed seconds."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def device_ms(fn, reps: int = 10, inner: int = 10) -> float:
    """Device time of one call of ``fn``: the median over ``reps`` samples of
    CUDA events around ``inner`` back-to-back calls that wait in the queue
    behind a spin kernel (``torch.cuda._sleep``, twice the host's enqueue
    time of the calls at 2 GHz), so the window holds their device work and
    none of the host's launch gaps (which would set the time of a kernel of
    a few microseconds)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    cycles = int(4e9 * (time.perf_counter() - t0)) + 1_000_000
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def ptxas_report(log: str) -> list:
    """Registers a thread and spill bytes of each kernel (entry function) in
    what ``nvcc -Xptxas -v`` printed for one source."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_backward_ms(fwd, inputs, dout, reps: int = 10, inner: int = 10):
    """The library yardsticks of a backward kernel: device ms of the backward
    alone of ``fwd(*inputs)`` (a PyTorch fused attention call), its graph
    built once and differentiated with ``retain_graph`` as K1b's and K2b's
    rows do, and of forward plus backward (reported beside it)."""
    import torch

    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    with torch.enable_grad():
        out = fwd(*leaves)

    def fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(fwd(*leaves), leaves, dout)

    bwd = device_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), reps, inner)
    return bwd, device_ms(fwd_bwd, reps, inner)


def write_stock_folder(folder: Path, n_files: int, rows: int, seed: int) -> None:
    """Synthetic per-stock CSVs with a header and 14 columns: hour of day in
    column 6, close in column 13, volume in column 14 (1-based)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    header = ",".join(f"c{i}" for i in range(1, 15))
    for f in range(n_files):
        close = 40.0 * np.exp(np.cumsum(rng.normal(0.0, 0.01, rows)))
        volume = rng.integers(1_000, 5_000_000, rows)
        hour = 9 + np.arange(rows) % 8
        lines = [header]
        for r in range(rows):
            cols = [f"2024-01-{1 + r % 28:02d}"] + [f"{close[r] * 1.01:.4f}"] * 4
            cols += [str(hour[r])] + ["0"] * 6 + [f"{close[r]:.4f}", str(volume[r])]
            lines.append(",".join(cols))
        (folder / f"stock_{f:02d}.csv").write_text("\n".join(lines) + "\n")


def check_close(name, out, ref, dtype, shape) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    ok = err <= TOL[dtype]
    emit({"phase": "kernel_check", "kernel": name, "shape": list(shape), "dtype": dtype,
          "max_abs_err": err, "tol": TOL[dtype], "ok": ok})
    if not ok:
        raise AssertionError(f"{name} {shape} {dtype}: max abs err {err} > {TOL[dtype]}")
    return err


def check_rel(name, out, ref, dtype, shape, rate) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    bound = REL_TOL[dtype] * max(1.0, ref.float().abs().max().item())
    ok = err <= bound
    emit({"phase": "kernel_check", "kernel": name, "shape": list(shape), "dtype": dtype,
          "dropout": rate, "max_abs_err": err, "bound": bound, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} {shape} {dtype} rate {rate}: max abs err {err} > {bound}")
    return err


def same_bits(name, a, b, shape) -> None:
    """Two runs of a kernel gave the same bits in every output."""
    import torch

    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name} {shape}: two runs differ")


def mma_forward(dtype: str, hs: int) -> bool:
    """Whether the whole-row forwards (K2f, K3f, K4f) run the mma.sync body
    at this type and head size (bf16, hs % 16 == 0, hs <= 128), whose two
    runs must give the same bits."""
    return dtype == "bfloat16" and hs % 16 == 0 and hs <= 128


def launch_split(fn, reps: int = 20) -> list:
    """Device time of each kernel that one call of ``fn`` launches:
    ``torch.profiler`` over ``reps`` calls after a warm-up, the device ms
    per call of each launch in launch order (``launch``); where the calls
    did not all launch the same kernels in the same order, per kernel name
    its launches per call and their device ms, the longest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    names = [e.name for e in kernels]
    per, rest = divmod(len(kernels), reps)
    if per and not rest and all(n == names[i % per] for i, n in enumerate(names)):
        return [{"kernel": names[i], "launch": i,
                 "ms": sum(kernels[i + r * per].time_range.elapsed_us() for r in range(reps))
                 / reps / 1e3} for i in range(per)]
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return sorted(({"kernel": k, "launches": n / reps, "ms": us / 1e3 / reps}
                   for k, (n, us) in by_name.items()), key=lambda k: -k["ms"])


def k1b_split(K, card: str) -> list:
    """The device time of each kernel launched by one K1b call at the
    production shape (bf16, dropout 0.2, as the training step runs it),
    emitted as phase ``k1b_split``."""
    import torch

    M, B, T, C, H, hs = 4, 32, 64, 384, 6, 64
    gen = torch.Generator().manual_seed(7)
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    x = randn(M, B, T, C).bfloat16()
    w1, b1 = randn(M, C, 3 * H * hs // 2, scale=0.05), randn(M, 3 * H * hs // 2, scale=0.05)
    w2 = randn(M, 3 * H, hs // 2, hs, scale=0.2)
    out = K.fused_qkv_attention_fwd(x, w1, b1, w2, H, 0.2, SALTS)
    dout = randn(*out.shape).bfloat16()
    split = launch_split(lambda: K.fused_qkv_attention_bwd(x, w1, b1, w2, out, dout, H, 0.2, SALTS))
    emit({"phase": "k1b_split", "card": card, "shape": [M, B, T, C, H, hs], "dropout": 0.2,
          "total_ms": sum(k["ms"] for k in split), "kernels": split})
    return split


def serve_launches(K, cfg, t0: int, tokens: int, refresh: int, decode: str) -> dict:
    """Kernel launches of generate_serve from a prompt of t0 tokens: per
    prefill n_layer self-attention and n_layer per cross modality cross
    kernels, K3f and K2f in the whole-row band and K5f and K6f in the flash
    band (the exact phase's prefill over t0 tokens, then one per chunk over
    block_size - refresh), and per generated token n_layer * (1 + cross
    modalities) launches of the layout's decode kernel."""
    L, n_cross, S, hs = cfg.n_layer, sum(cfg.cross_attention), cfg.block_size, cfg.head_size
    n_exact = max(0, min(tokens, S - t0))
    lengths = ([t0] if n_exact else []) + [S - refresh] * math.ceil((tokens - n_exact) / refresh)
    short = sum(K.in_band(t, hs) for t in lengths)
    flash = sum(K.flash_eligible(t, hs) and not K.in_band(t, hs) for t in lengths)
    want = dict.fromkeys(K.KERNELS, 0)
    want.update(short_causal_attention=L * short, short_cross_attention=L * n_cross * short,
                flash_attention=L * flash, flash_cross_attention=L * n_cross * flash)
    want[decode] = tokens * L * (1 + n_cross)
    return want


def production_config_dir(d: Path, tpu: dict | None = None, **training) -> None:
    """examples/production_config.yaml (with the given settings changed, and
    the ``tpu`` ones set under tpu_options) + its schemas + the synthetic
    stock folder, in d."""
    text = (REPO / "examples" / "production_config.yaml").read_text()
    for key, value in training.items():
        text, n = re.subn(rf"(\n  {key}: )\S+", rf"\g<1>{value}", text)
        if n != 1:
            raise AssertionError(f"production config has no single {key}")
    for key, value in (tpu or {}).items():
        text, n = re.subn(rf"(\n  {key}: )\S+", rf"\g<1>{value}", text)
        if n == 0:
            text = text.replace("\ntpu_options:\n", f"\ntpu_options:\n  {key}: {value}\n")
    (d / "config.yaml").write_text(text)
    shutil.copy(REPO / "examples" / "production_input_schemas.yaml", d / "input_schemas.yaml")
    write_stock_folder(d / "your_data" / "stocks", n_files=6, rows=1500, seed=1)


def expected_evals(max_iters: int, eval_interval: int) -> int:
    """Evaluations run_training makes: at every multiple of eval_interval
    and at max_iters - 1, walking its chunk boundaries."""
    it = n = 0
    while it < max_iters:
        if it % eval_interval == 0 or it == max_iters - 1:
            n += 1
        nxt = [max_iters, (it // eval_interval + 1) * eval_interval]
        if it < max_iters - 1:
            nxt.append(max_iters - 1)
        it = min(b for b in nxt if b > it)
    return n


@contextlib.contextmanager
def patched(K, **fns):
    """Swap wrappers of the kernels module K for the given functions."""
    real = {name: getattr(K, name) for name in fns}
    for name, fn in fns.items():
        setattr(K, name, fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(K, name, fn)


def errs_of(got, refs):
    """Max-abs and L2-relative error of got against each reference."""
    return {name: {"max_abs": (got - r).abs().max().item(),
                   "l2_rel": ((got - r).norm() / r.norm()).item()} for name, r in refs.items()}


# the tuple-valued wrappers held in-path output by output, by output name
OUTPUTS = {"fused_qkv_attention_bwd": ("dx", "dw1", "db1", "dw2"),
           "short_cross_attention_bwd": ("dq", "dk", "dv"),
           "short_causal_attention_bwd": ("dq", "dk", "dv"),
           "flash_chunk_bwd": ("dq", "dk", "dv")}


def checked(K, name, fn, worst, plain=None):
    """``fn`` (a kernel's wrapper, or a planted fault) with each output held
    against the kernel's plain version on the same inputs (``plain``, by
    default ``K.<name>_plain``): worst keeps the largest L2-relative error
    |out - plain| / |plain|, under "<name>.<output>" for each output of a
    wrapper in OUTPUTS, else under name for the output (of a pair such as
    (out, lse), the first)."""
    plain_fn = plain or getattr(K, f"{name}_plain")

    def run(*args):
        out = fn(*args)
        ref = plain_fn(*args)
        if name in OUTPUTS:
            pairs = [(f"{name}.{o}", a, r) for o, a, r in zip(OUTPUTS[name], out, ref)]
        else:
            pairs = [(name,) + ((out[0], ref[0]) if isinstance(out, tuple) else (out, ref))]
        for key, a, r in pairs:
            err = ((a.float() - r.float()).norm() / r.float().norm().clamp_min(1e-30)).item()
            worst[key] = max(worst.get(key, 0.0), err)
        return out

    run.launches = 0  # the wrapper counts on the module name it is patched over
    return run


def k8p_reading_pos_plus_1(K):
    """The planted fault of the reference phases: K8p reading one column
    past pos."""
    real = K.decode_attention_packed

    def wrong(q, kp, vp, pos):
        return real(q, kp, vp, pos + 1)

    wrong.launches = 0  # the wrapper counts on the module name it is patched over
    return wrong


def k9_reading_pos_plus_1(K):
    """The planted fault of the K9 check: K9 reading one column past pos."""
    real = K.decode_attention_t

    def wrong(q, kT, vT, pos):
        return real(q, kT, vT, pos + 1)

    return wrong


def k2b_dk_x1_2(K):
    """The planted fault of train_reference's in-path gate: K2b returning dk
    20% too large on every call."""
    real = K.short_cross_attention_bwd

    def wrong(*args):
        dq, dk, dv = real(*args)
        return dq, dk * 1.2, dv

    return wrong


def cached_logits(C, p, c, ids, t_first, S):
    """The cached path's logits of modality 0: a prefill over ids[..., :t_first],
    then one cached step at each position t_first..S-1 (CPU, f32)."""
    import torch

    with torch.inference_mode():
        logits, cache = C._prefill(p, c, ids[:, :, :t_first], 0)
        out = [logits.float().cpu()]
        for pos in range(t_first, S):
            logits, cache = C.forward_cached(p, c, ids[:, :, pos:pos + 1], cache, pos, 0)
            out.append(logits.float().cpu())
    return torch.stack(out)


def full_logits(forward, p, c, ids, t_first, S):
    """The full forward's last-position logits of modality 0 for each prefix
    ids[..., :n], n = t_first..S (CPU, f32)."""
    import torch

    with torch.inference_mode():
        return torch.stack([forward(p, c, ids[:, :, :n_])[0][0][:, -1].float().cpu()
                            for n_ in range(t_first, S + 1)])


def serve_reference(K, C, forward, params, cpu_params, cfg, ids_ref, cases, prefill_kernels,
                    phase="serve_reference"):
    """The card's cached logits (a prefill over ids[..., :t_first], then one
    cached step at each position up to block_size - 1, for each case) against
    the card's full forward at the same prefix and the CPU's cached f32
    forward: f32 at SERVE_TOL max-abs, which K8p reading one column past pos
    must fail; bf16 at SERVE_TOL max-abs, and every call of the prefill's
    kernels (``prefill_kernels``: the wrapper's module name -> (its KERNELS
    name, its plain version, launches per prefill)) and of K8p against its
    plain version on the same inputs (SERVE_BF16_IN_PATH), which that fault
    must exceed. Emits one line per case and dtype; returns the failures."""
    import torch

    S, L, n_cross = cfg.block_size, cfg.n_layer, sum(cfg.cross_attention)
    dev = params["pre"]["pos_emb"].device
    ids_dev = ids_ref.to(dev)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu_cached = {case: cached_logits(C, cpu_params, f32, ids_ref, t_first, S)
                  for case, t_first in cases.items()}
    failed = []
    for case, t_first in cases.items():
        want_ref = dict.fromkeys(K.KERNELS, 0)
        want_ref.update({name: n for name, _, n in prefill_kernels.values()})
        want_ref["decode_attention_packed"] = (S - t_first) * L * (1 + n_cross)
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, compute_dtype=dtype)
            K.reset_launch_counts()
            got = cached_logits(C, params, c, ids_dev, t_first, S)
            counts = K.launch_counts()
            in_path, in_path_bad = {}, {}
            with patched(K, decode_attention_packed=checked(
                    K, "decode_attention_packed", k8p_reading_pos_plus_1(K), in_path_bad)):
                bad = cached_logits(C, params, c, ids_dev, t_first, S)
            refs = {"vs_card_full": full_logits(forward, params, c, ids_dev, t_first, S),
                    "vs_cpu_cached_f32": cpu_cached[case]}
            sound, planted = errs_of(got, refs), errs_of(bad, refs)
            ok = (bool(torch.isfinite(got).all()) and counts == want_ref
                  and all(e["max_abs"] <= SERVE_TOL[dtype] for e in sound.values()))
            if dtype == "float32":
                ok = ok and all(e["max_abs"] > SERVE_TOL[dtype] for e in planted.values())
            else:
                wrappers = {attr: checked(K, attr, getattr(K, attr), in_path, plain)
                            for attr, (_, plain, _) in prefill_kernels.items()}
                wrappers["decode_attention_packed"] = checked(
                    K, "decode_attention_packed", K.decode_attention_packed, in_path)
                with patched(K, **wrappers):
                    cached_logits(C, params, c, ids_dev, t_first, S)
                ok = ok and (max(in_path.values()) <= SERVE_BF16_IN_PATH
                             < in_path_bad["decode_attention_packed"])
            emit({"phase": phase, "case": case, "what": f"card cached logits "
                  f"(prefill of {t_first}, then positions {t_first}..{S - 1}) vs the card's full "
                  "forward and the CPU's cached f32 forward; bf16: each kernel call against "
                  "its plain version", "dtype": dtype, "batch": ids_ref.shape[1],
                  "block_size": S,
                  "logits_abs_max": refs["vs_card_full"].abs().max().item(),
                  "logits_rms": refs["vs_card_full"].pow(2).mean().sqrt().item(),
                  "err": sound, "tol": SERVE_TOL[dtype], "planted_k8p_pos_plus_1": planted,
                  "in_path_rel_err": in_path or None,
                  "in_path_planted_k8p_pos_plus_1": in_path_bad["decode_attention_packed"],
                  "in_path_tol": SERVE_BF16_IN_PATH if in_path else None,
                  "launches": counts, "ok": ok})
            if not ok:
                failed.append(f"{case} {dtype}")
    return failed


def train_reference(K, cfg, ids, faults, must_fail, want_step, phase="train_reference",
                    in_path=(), in_path_faults=None):
    """One training step on the card (the kernels forward and backward)
    against the CPU's dense step on the same params (seed 1234) and batch
    ``ids`` (M, B, T + 1), dropout 0, f32 and bf16: the loss and every gradient
    leaf's L2-relative error within STEP_TOL, the kernels launched as
    ``want_step`` says, every call of the backward wrappers ``in_path`` held
    against its plain version within REL_TOL (L2-relative, each output), and
    each planted fault of ``must_fail`` rejected: a fault of ``faults`` (name
    -> (autograd Function, index of the backward output scaled by 1.2)) by
    the step gate, one of ``in_path_faults`` (name -> {wrapper name: a
    function of K giving the planted wrapper}) by the in-path gate. Emits one
    line per dtype; raises on a failure."""
    in_path_faults = in_path_faults or {}
    import torch

    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        init_params, map_tree, tree_leaves, tree_paths)
    from trade_aid_multimodal_transformer_tpu_torch.models.transformer import total_loss

    dev = torch.device("cuda")
    xb, yb = ids[..., :-1], ids[..., 1:]
    step_cfg = dataclasses.replace(cfg, dropout=0.0, compute_dtype="float32")
    cpu_p = map_tree(lambda t: t.requires_grad_(),
                     init_params(cfg, torch.Generator().manual_seed(1234), "cpu"))
    loss_ref, _ = total_loss(cpu_p, step_cfg, xb, yb, None, True)
    g_ref = torch.autograd.grad(loss_ref, tree_leaves(cpu_p))
    dev_p = map_tree(lambda t: t.detach().to(dev).requires_grad_(), cpu_p)
    names = ["/".join(map(str, path)) for path, _ in tree_paths(cpu_p)]
    ref_norms = [r.norm().item() for r in g_ref]
    floor = 1e-6 * math.sqrt(sum(n * n for n in ref_norms))

    def leaf_errs(grads):
        """Per leaf |g - ref| / max(|ref|, 1e-6 |all of ref|), L2 norms."""
        return [(a.float().cpu() - r).norm().item() / max(n, floor)
                for a, r, n in zip(grads, g_ref, ref_norms)]

    def step_grads(c, fault=None):
        """Loss and gradients of one step on the card; ``fault`` = (autograd
        Function, gradient index) scales that gradient of its backward by 1.2."""
        real = fault[0].backward if fault else None
        if fault:
            def wrong(ctx, dout):
                grads = list(real(ctx, dout))
                grads[fault[1]] = grads[fault[1]] * 1.2
                return tuple(grads)
            fault[0].backward = staticmethod(wrong)
        try:
            loss = total_loss(dev_p, c, xb.to(dev), yb.to(dev), None, True)[0]
            return loss, torch.autograd.grad(loss, tree_leaves(dev_p))
        finally:
            if fault:
                fault[0].backward = staticmethod(real)

    failed = []
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(step_cfg, compute_dtype=dtype)
        # the card's dense cores (no kernel), for scale: how far the card is
        # from the CPU at this dtype without the kernels
        dense_err = max(leaf_errs(step_grads(dataclasses.replace(c, attn_impl="jnp"))[1]))
        K.reset_launch_counts()
        loss, g = step_grads(c)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        in_path_worst = {}  # the same step again, each in-path call beside its plain version
        with patched(K, **{n: checked(K, n, getattr(K, n), in_path_worst) for n in in_path}):
            step_grads(c)
        loss_err = abs(loss.item() - loss_ref.item())
        errs_leaf = leaf_errs(g)
        grad_err = max(errs_leaf)
        worst = sorted(zip(errs_leaf, names), reverse=True)[:3]
        # the smallest error that any one leaf 20% too large reads (leaves
        # above the floor: below it no relative error is held)
        one_leaf = min((1.2 * a.float().cpu() - r).norm().item() / n
                       for a, r, n in zip(g, g_ref, ref_norms) if n >= floor)
        planted = {f: max(leaf_errs(step_grads(c, faults[f])[1])) for f in faults}
        planted_in_path = {}
        for f, makers in in_path_faults.items():
            bad = {}
            with patched(K, **{n: checked(K, n, makers[n](K) if n in makers else getattr(K, n), bad)
                               for n in in_path}):
                planted[f] = max(leaf_errs(step_grads(c)[1]))
            planted_in_path[f] = max(bad.values())
        tol = STEP_TOL[dtype]
        rejected = {f: (planted_in_path[f] > REL_TOL[dtype] if f in planted_in_path
                        else planted[f] > tol["grad_l2"]) for f in must_fail}
        ok = (loss_err <= tol["loss"] and grad_err <= tol["grad_l2"] and counts == want_step
              and math.isfinite(loss.item()) and one_leaf > tol["grad_l2"]
              and all(v <= REL_TOL[dtype] for v in in_path_worst.values())
              and all(rejected.values()))
        emit({"phase": phase, "what": "card training step vs CPU dense step, "
              "loss and every gradient leaf (dropout 0, TF32 off)", "dtype": dtype,
              "batch": xb.shape[1], "block_size": cfg.block_size, "loss_card": loss.item(),
              "loss_cpu": loss_ref.item(),
              "loss_abs_err": loss_err, "grad_l2_rel_err_max": grad_err, "worst_leaves": worst,
              "leaves": len(g), "card_dense_grad_l2_rel_err_max": dense_err,
              "one_leaf_x1.2_min": one_leaf, "planted": planted, "planted_must_fail": must_fail,
              "tol": tol, "in_path_l2_rel": in_path_worst or None,
              "in_path_tol": REL_TOL[dtype] if in_path else None,
              "planted_in_path": planted_in_path or None, "planted_rejected": rejected,
              "launches": counts, "ok": ok})
        if not ok:
            failed.append(dtype)
    if failed:
        raise AssertionError(f"training step on the card disagrees with the CPU, or the gate "
                             f"passed a planted fault ({', '.join(failed)})")


def training_run(K, card, phase, per_step, per_eval_batch, tpu=None, **config):
    """``run_training`` on a copy of the production config with ``config``
    (and the ``tpu`` options) changed, then one profiled step. Asserts the
    exact launches (``per_step`` per training step and ``per_eval_batch``
    per evaluated batch: each evaluation runs eval_iters train and
    eval_iters val batches), the eval train loss falling, the console's
    completion line and the checkpoint reloading (params and optimizer
    count). Emits the run's line and the profile's; returns (the launches,
    steps/s after the first chunk, the evaluations (step, train, val))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trade_aid_multimodal_transformer_tpu_torch.config.compat import reset_compatibility_layer
    from trade_aid_multimodal_transformer_tpu_torch.models.init import tree_leaves
    from trade_aid_multimodal_transformer_tpu_torch.train import runner
    from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import (
        load_checkpoint, load_optimizer_state)
    from trade_aid_multimodal_transformer_tpu_torch.train.steps import StepRng

    dev = torch.device("cuda")
    iters, interval, e_iters = config["max_iters"], config["eval_interval"], config["eval_iters"]
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d, tpu, **config)
        cwd, buf = os.getcwd(), io.StringIO()
        os.chdir(d)  # config detection is CWD-relative
        try:
            reset_compatibility_layer()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = runner.run_training(caller_globals={}, seed=7)
            train_s = time.perf_counter() - t0
            launches = K.launch_counts()
        finally:
            os.chdir(cwd)
            reset_compatibility_layer()
        ckpt = d / "output" / "model.ckpt"
        back, back_step = load_checkpoint(str(ckpt), res["cfg"], dev)
        opt_back = load_optimizer_state(str(ckpt), back, res["trainer"].optimizer)
    console = buf.getvalue()
    evals = [(int(m[0]), float(m[1]), float(m[2])) for m in re.findall(
        r"LOSS METRICS: Step (\d+)/\d+ \| Train: ([-\d.naif]+) \| Val: ([-\d.naif]+)", console)]
    n_evals = expected_evals(iters, interval)
    eval_batches = n_evals * 2 * e_iters
    want = dict.fromkeys(K.KERNELS, 0)
    for name in set(per_step) | set(per_eval_batch):
        want[name] = per_step.get(name, 0) * iters + per_eval_batch.get(name, 0) * eval_batches
    timer = res["step_timer"]
    later = timer.chunks[1:]
    steps_per_s = sum(n for n, _ in later) / sum(t for _, t in later)
    finite = all(math.isfinite(v) for e in evals for v in e[1:])
    reloaded = (back_step == iters and opt_back is not None and opt_back["count"] == iters
                and all(torch.equal(a.detach().float(), b) for a, b in
                        zip(tree_leaves(res["params"]), tree_leaves(back))))
    ok = (launches == want and len(evals) == n_evals and finite
          and evals[-1][1] < evals[0][1] and reloaded and "TRAINING COMPLETED SUCCESSFULLY" in console)
    rc = res["cfg"]
    emit({"phase": phase, "config": "examples/production_config.yaml", "card": card,
          "changed": {**config, **(tpu or {})}, "fused_update": res["trainer"].fused_update,
          "batch": res["feed"].batch_size, "block_size": rc.block_size,
          "dropout": rc.dropout,
          "compute_dtype": rc.compute_dtype, "seconds": train_s, "evals": evals,
          "launches": launches, "expected_launches": want,
          "steps_per_s_after_first_chunk": steps_per_s, "chunks": timer.chunks,
          "checkpoint_reloaded": reloaded, "ok": ok})
    if not ok:
        raise AssertionError(f"the training run ({phase}) failed its checks")

    # where a training step's time goes (torch.profiler, device events)
    params, opt_state, trainer = res["params"], res["opt_state"], res["trainer"]
    step_rng = StepRng(11, dev)
    trainer.train_chunk(params, opt_state, step_rng, 1)
    torch.cuda.synchronize()
    n_prof = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_chunk(params, opt_state, step_rng, n_prof)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in kern) / 1e6 / n_prof
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    emit({"phase": "profile", "path": phase, "card": card, "block_size": rc.block_size,
          "steps": n_prof, "step_ms_unprofiled": 1e3 / steps_per_s,
          "device_ms_per_step": 1e3 * dev_s if kern else None,
          "device_busy_share": dev_s * steps_per_s if kern else None,
          "kernels_per_step": sum(e.count for e in kern) / n_prof,
          "top": [[e.key[:72], e.self_device_time_total / 1e3 / n_prof, e.count / n_prof]
                  for e in top]})
    return launches, steps_per_s, evals


def cuda_kernels(fn):
    """A Counter of the names of the CUDA kernels one call of ``fn``
    launches, from ``torch.profiler``."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)


def flat_update_check(K, card, cfg, ids) -> None:
    """Phase ``fused_update`` (the update): the gradients of one production
    training step (B = 32, T = 64, bf16, bf16 moments, dropout 0.2),
    computed once, given twice over to the per-leaf AdamW update and to the
    flat-state one (``AdamW.update_flat_``, what ``fused_update: true``
    runs): every parameter, both moments and the count must be bit-equal,
    and a planted fault, the weight decay skipped on the last leaf's span of
    the flat vector, must break that. Each update's kernels a call
    (``torch.profiler``) and device ms (CUDA events, ``device_ms``) are
    reported."""
    import copy

    import torch

    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        init_params, map_tree, tree_leaves)
    from trade_aid_multimodal_transformer_tpu_torch.train.steps import Trainer, make_optimizer

    dev = torch.device("cuda")
    params = map_tree(lambda t: t.requires_grad_(),
                      init_params(cfg, torch.Generator().manual_seed(1234), dev))
    opt = make_optimizer(3e-4, moment_dtype="bfloat16", nu_dtype="bfloat16")
    _, grads = Trainer(cfg, None, opt, [], 1).loss_and_grads(
        params, [(ids[..., :-1].to(dev), ids[..., 1:].to(dev))], [SALTS])

    def flat(tree):
        return torch.cat([t.detach().reshape(-1) for t in tree_leaves(tree)])

    leaf_p = map_tree(lambda t: t.detach().clone(), params)
    leaf_s = opt.init(leaf_p)
    g = flat(list(grads))
    theta, mu, nu, state = flat(params), flat(leaf_s["mu"]), flat(leaf_s["nu"]), {"count": 0}
    bad = [theta.clone(), mu.clone(), nu.clone(), {"count": 0}]
    split = theta.numel() - tree_leaves(params)[-1].numel()
    no_decay = copy.copy(opt)
    no_decay.weight_decay = 0.0
    for _ in range(2):
        opt.update_(leaf_p, grads, leaf_s)
        opt.update_flat_(theta, g, mu, nu, state)
        with torch.no_grad():  # the planted flat update
            lr_t, c1, c2 = opt._advance(bad[3])
            opt.apply_(*(x[:split] for x in (bad[0], g, bad[1], bad[2])), lr_t, c1, c2)
            no_decay.apply_(*(x[split:] for x in (bad[0], g, bad[1], bad[2])), lr_t, c1, c2)
    torch.cuda.synchronize()
    equal = {"params": torch.equal(flat(leaf_p), theta), "mu": torch.equal(flat(leaf_s["mu"]), mu),
             "nu": torch.equal(flat(leaf_s["nu"]), nu),
             "count": leaf_s["count"] == state["count"] == 2}
    planted_equal = torch.equal(flat(leaf_p), bad[0])
    # kernels a call (the flat update profiled first: a profile that follows
    # one of thousands of kernels has been seen to miss some) and device ms
    n_flat = cuda_kernels(lambda: [opt.update_flat_(theta, g, mu, nu, state)
                                   for _ in range(3)]).total()
    n_leaf = cuda_kernels(lambda: opt.update_(leaf_p, grads, leaf_s)).total()
    ms_flat = device_ms(lambda: opt.update_flat_(theta, g, mu, nu, state), reps=5, inner=3)
    ms_leaf = device_ms(lambda: opt.update_(leaf_p, grads, leaf_s), reps=5, inner=3)
    ok = all(equal.values()) and not planted_equal
    emit({"phase": "fused_update", "part": "update", "card": card,
          "what": "one production step's gradients through the per-leaf and the flat update",
          "leaves": len(grads), "elements": theta.numel(), "bit_equal": equal,
          "planted": "weight decay skipped on the last leaf's span", "planted_bit_equal": planted_equal,
          "per_leaf": {"kernels": n_leaf, "device_ms": ms_leaf},
          "flat": {"kernels": n_flat / 3, "device_ms": ms_flat}, "ok": ok})
    if not ok:
        raise AssertionError("the flat-state update differs from the per-leaf update, or the "
                             "planted fault kept the bits")


def salt_swapped_recompute(real, blocks):
    """A ``block_forward`` whose second call for a block (the recompute of a
    rematerialised block inside the backward) takes the next block's salt
    pair: the planted fault of phase ``remat``."""
    first = {}

    def block_forward(x, block, key, cfg, train=False):
        i = next(j for j, b in enumerate(blocks) if b is block)
        if i in first:
            key = first[(i + 1) % len(blocks)]
        else:
            first[i] = key
        return real(x, block, key, cfg, train)

    return block_forward


def remat_check(K, card, cfg) -> None:
    """Phase ``remat``: one production training step (dropout 0.2, bf16) at
    T = 64 (B = 32) and at T = 1024 (B = 8), with ``remat`` and without, on
    the same batch and salts: the loss and every gradient leaf within the
    step gate (STEP_TOL) of the plain step, bit-equality reported per leaf;
    the forward kernels launched twice (the backward recomputes every
    block), the backward kernels once; the peak of allocated memory in each
    step; at T = 1024 the ``remat`` step's peak must be below the plain
    step's. A planted recompute with the next block's salt pair must fail
    the gate."""
    import numpy as np
    import torch

    from trade_aid_multimodal_transformer_tpu_torch.models import transformer as TM
    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        init_params, map_tree, tree_leaves, tree_paths)
    from trade_aid_multimodal_transformer_tpu_torch.models.transformer import total_loss

    dev = torch.device("cuda")
    L, n_cross = cfg.n_layer, sum(cfg.cross_attention)
    streams = sum(len(cfg.kv_modalities(i)) for i in range(cfg.num_modalities)
                  if cfg.cross_attention[i])
    tol = STEP_TOL[cfg.compute_dtype]
    failed = []
    for T, B in ((cfg.block_size, 32), (LONG_BLOCK, 8)):
        c = dataclasses.replace(cfg, block_size=T)
        rng = np.random.default_rng(T)
        ids = torch.from_numpy(np.stack([rng.integers(0, v, (B, T + 1))
                                         for v in c.vocab_sizes])).to(dev)
        xb, yb = ids[..., :-1], ids[..., 1:]
        params = map_tree(lambda t: t.requires_grad_(),
                          init_params(c, torch.Generator().manual_seed(1234), dev))
        leaves = tree_leaves(params)
        names = ["/".join(map(str, path)) for path, _ in tree_paths(params)]
        if K.in_band(T, c.head_size):
            fwd = dict(fused_qkv_attention=L, short_cross_attention=n_cross * L)
            bwd = dict(fused_qkv_attention_bwd=L, short_cross_attention_bwd=n_cross * L)
        else:
            fwd = dict(flash_attention=L, flash_cross_attention_res=n_cross * L)
            bwd = dict(flash_attention_bwd=L + streams * L)

        def step(remat, planted=False):
            real = TM.block_forward
            if planted:
                TM.block_forward = salt_swapped_recompute(real, params["blocks"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            try:
                loss = total_loss(params, dataclasses.replace(c, remat=remat), xb, yb, SALTS, True)[0]
                grads = torch.autograd.grad(loss, leaves)
            finally:
                TM.block_forward = real
            torch.cuda.synchronize()
            return loss.detach(), grads, K.launch_counts(), torch.cuda.max_memory_allocated()

        base, rem, bad = step(False), step(True), step(True, planted=True)
        norms = [g.float().norm().item() for g in base[1]]
        floor = 1e-6 * math.sqrt(sum(n * n for n in norms))

        def leaf_errs(grads):
            return [(a.float() - r.float()).norm().item() / max(n, floor)
                    for a, r, n in zip(grads, base[1], norms)]

        errs, bad_errs = leaf_errs(rem[1]), leaf_errs(bad[1])
        want = dict.fromkeys(K.KERNELS, 0)
        want_plain = {**want, **fwd, **bwd}
        want_remat = {**want, **{k: 2 * v for k, v in fwd.items()}, **bwd}
        loss_err = abs(rem[0].item() - base[0].item())
        not_bit_equal = [n for n, a, b in zip(names, rem[1], base[1]) if not torch.equal(a, b)]
        memory_ok = T <= 64 or rem[3] < base[3]
        ok = (base[2] == want_plain and rem[2] == want_remat and loss_err <= tol["loss"]
              and max(errs) <= tol["grad_l2"] and max(bad_errs) > tol["grad_l2"] and memory_ok
              and math.isfinite(base[0].item()))
        emit({"phase": "remat", "card": card, "block_size": T, "batch": B, "dropout": c.dropout,
              "dtype": c.compute_dtype, "loss": base[0].item(), "loss_abs_err": loss_err,
              "loss_bit_equal": torch.equal(rem[0], base[0]),
              "grad_l2_rel_err_max": max(errs), "tol": tol, "leaves": len(names),
              "leaves_not_bit_equal": not_bit_equal,
              "planted": "recompute with the next block's salt pair",
              "planted_grad_l2_rel_err_max": max(bad_errs),
              "launches": {"plain": {k: v for k, v in base[2].items() if v},
                           "remat": {k: v for k, v in rem[2].items() if v}},
              "launches_exact": base[2] == want_plain and rem[2] == want_remat,
              "peak_allocated_bytes": {"plain": base[3], "remat": rem[3]},
              "peak_ratio": rem[3] / base[3], "ok": ok})
        if not ok:
            failed.append(T)
        del params, leaves, base, rem, bad
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"remat changed a value, miscounted, kept its memory, or the gate "
                             f"passed the planted fault (block_size {failed})")


def wrapper_kernel_names(K) -> dict:
    """The CUDA functions of the port's sources (with counts) that one call
    of each of K1f, K1b, K2f and K2b launches at the production training
    step's shapes (bf16, dropout 0.2)."""
    import torch

    ours = set()
    for src in (REPO / PKG / "ops" / "csrc").iterdir():
        ours |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                               src.read_text()))
    # the bare name, in a demangled ("qkv::fqkv_fwd_mma_kernel<64, 2, 1>(...)")
    # or a mangled ("_ZN3qkv19fqkv_fwd_mma_kernelILi64E...") function name
    pattern = re.compile(r"(?<![A-Za-z_])(?:" + "|".join(sorted(ours)) + r")(?![a-z0-9_])")

    M, B, T, C, H, hs = PROD_K1
    gen = torch.Generator().manual_seed(3)
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    x = randn(M, B, T, C).bfloat16()
    w1, b1 = randn(M, C, 3 * H * hs // 2, scale=0.05), randn(M, 3 * H * hs // 2, scale=0.05)
    w2 = randn(M, 3 * H, hs // 2, hs, scale=0.2)
    out = K.fused_qkv_attention_fwd(x, w1, b1, w2, H, 0.2, SALTS)
    dout = randn(*out.shape).bfloat16()
    J, n = 3, H * B
    q, k, v = randn(n, T, hs).bfloat16(), randn(J, n, T, hs).bfloat16(), randn(J, n, T, hs).bfloat16()
    do = randn(n, T, hs).bfloat16()
    calls = {"fused_qkv_attention": lambda: K.fused_qkv_attention_fwd(x, w1, b1, w2, H, 0.2, SALTS),
             "fused_qkv_attention_bwd": lambda: K.fused_qkv_attention_bwd(
                 x, w1, b1, w2, out, dout, H, 0.2, SALTS),
             "short_cross_attention": lambda: K.short_cross_attention_fwd(q, k, v, 0.2, SALTS),
             "short_cross_attention_bwd": lambda: K.short_cross_attention_bwd(
                 q, k, v, do, 0.2, SALTS)}
    for fn in calls.values():
        fn()
    # the process's first profiler session has been seen to record none of
    # K1f's kernels: one session first whose record is not read
    cuda_kernels(calls["fused_qkv_attention"])
    return {name: {k: n for k, n in cuda_kernels(fn).items() if pattern.search(k)}
            for name, fn in calls.items()}


def profile_trace_check(K, card) -> None:
    """Phase ``profile_trace``: the training entry on the production config
    with ``TAT_PROFILE_DIR`` set writes one ``torch.profiler`` trace (of its
    second chunk) into that directory, whose CUDA kernel events hold K1f,
    K1b, K2f and K2b: every CUDA function that one call of each launches
    (profiled alone at the same shapes) appears as often as the chunk's
    steps launch it. Runs before any other profile of the script: a
    profile that follows one of thousands of kernels has been seen to miss
    some of its kernels."""
    import collections

    from trade_aid_multimodal_transformer_tpu_torch.config.compat import reset_compatibility_layer
    from trade_aid_multimodal_transformer_tpu_torch.train import runner

    names = wrapper_kernel_names(K)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d, max_iters=4, eval_interval=2, eval_iters=1, save_model=0)
        prof = d / "trace"
        cwd, env = os.getcwd(), os.environ.get("TAT_PROFILE_DIR")
        os.chdir(d)
        os.environ["TAT_PROFILE_DIR"] = str(prof)
        try:
            reset_compatibility_layer()
            with contextlib.redirect_stdout(io.StringIO()):
                res = runner.run_training(caller_globals={}, seed=7)
        finally:
            os.chdir(cwd)
            if env is None:
                del os.environ["TAT_PROFILE_DIR"]
            else:
                os.environ["TAT_PROFILE_DIR"] = env
            reset_compatibility_layer()
        traces = sorted(prof.glob("*.pt.trace.json"))
        events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
    steps = res["step_timer"].chunks[1][0]
    L, n_cross = res["cfg"].n_layer, sum(res["cfg"].cross_attention)
    per_step = dict(fused_qkv_attention=L, fused_qkv_attention_bwd=L,
                    short_cross_attention=n_cross * L, short_cross_attention_bwd=n_cross * L)
    seen = collections.Counter(e["name"] for e in events if e.get("cat") == "kernel")
    want = collections.Counter()
    for name, counts in names.items():
        for fn, n in counts.items():
            want[fn] += steps * per_step[name] * n
    found = {name: {fn: seen[fn] for fn in counts} for name, counts in names.items()}
    ok = (len(traces) == 1 and all(names.values())
          and all(seen[fn] == n for fn, n in want.items()))
    emit({"phase": "profile_trace", "card": card, "traces": [t.name for t in traces],
          "traced_steps": steps, "kernel_events": sum(seen.values()),
          "categories": sorted({e.get("cat") for e in events if e.get("cat")}),
          "traced_port_functions": {k: n for k, n in seen.items()
                                    if any(k in c for c in names.values())},
          "functions_by_kernel": found, "expected": dict(want), "ok": ok})
    if not ok:
        raise AssertionError("TAT_PROFILE_DIR wrote no single trace holding the training "
                             "step's kernels")


def reference_checkpoint(K, card) -> None:
    """Phase ``reference_checkpoint``: the reference model's ``.pth``
    checkpoints on the card. (1) Both fixtures' state_dicts
    (tests/fixtures/model_parity*.npz, ``sd::`` keys) written with
    ``torch.save`` load through ``load_checkpoint``; their f32 logits within
    1e-4 of the reference model's. (2) A reference-layout state_dict at the
    production config (the port's seeded weights through
    ``reference_state_dict``) as ``.pth``: its logits bit-equal to the same
    weights through ``.npz``, and ``generate.run`` serves it with exact K1f
    and K2f launches and the ``.npz`` run's tokens. (3) ``run_training``
    with ``create_new_model: 0`` on it prints the loaded line."""
    import numpy as np
    import torch

    from trade_aid_multimodal_transformer_tpu_torch import generate as entry
    from trade_aid_multimodal_transformer_tpu_torch.config.compat import reset_compatibility_layer
    from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
    from trade_aid_multimodal_transformer_tpu_torch.models.init import init_params
    from trade_aid_multimodal_transformer_tpu_torch.models.transformer import forward
    from trade_aid_multimodal_transformer_tpu_torch.train import runner
    from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import (
        load_checkpoint, save_checkpoint)
    from trade_aid_multimodal_transformer_tpu_torch.utils.torch_compat import reference_state_dict

    dev = torch.device("cuda")
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        for name in ("model_parity", "model_parity_selective"):
            z = np.load(REPO / "tests" / "fixtures" / f"{name}.npz")
            cfg = ModelConfig(vocab_sizes=tuple(z["vocab_sizes"].tolist()),
                              cross_attention=tuple(bool(c) for c in z["cross"]),
                              n_embd=int(z["n_embd"]), n_head=int(z["n_head"]),
                              n_layer=int(z["n_layer"]), block_size=int(z["block_size"]))
            pth = d / f"{name}.pth"
            torch.save({k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}, pth)
            params, step = load_checkpoint(str(pth), cfg, dev)
            K.reset_launch_counts()
            logits, _ = forward(params, cfg, torch.from_numpy(z["idx"]).to(dev))
            torch.cuda.synchronize()
            err = max((logits[m].cpu() - torch.from_numpy(z[f"logits_{m}"])).abs().max().item()
                      for m in range(cfg.num_modalities))
            ok = err <= 1e-4 and step is None
            emit({"phase": "reference_checkpoint", "fixture": name, "card": card,
                  "f32_logits_max_abs_err": err, "tol": 1e-4, "step": step,
                  "launches": {k: v for k, v in K.launch_counts().items() if v}, "ok": ok})
            if not ok:
                failed.append(name)

        production_config_dir(d, max_iters=2, eval_interval=1, eval_iters=1, save_model=0,
                              create_new_model=0, model_file_name='"model.pth"')
        data = entry.load_config_and_data(str(d))
        cfg = data["cfg"]
        params = init_params(cfg, torch.Generator().manual_seed(4321), "cpu")
        torch.save(reference_state_dict(params, cfg), d / "model.pth")
        save_checkpoint(str(d / "model.npz"), params)
        rng = np.random.default_rng(9)
        idx = torch.from_numpy(np.stack([rng.integers(0, v, (2, cfg.block_size))
                                         for v in cfg.vocab_sizes])).to(dev)
        logits = [forward(load_checkpoint(str(d / f"model.{ext}"), cfg, dev)[0], cfg, idx)[0]
                  for ext in ("pth", "npz")]
        bit_equal = all(torch.equal(a, b) for a, b in zip(*logits))
        tokens = 8
        runs = {}
        for ext in ("pth", "npz"):
            K.reset_launch_counts()
            res = entry.run(str(d), tokens=tokens, modality=0, seed=0,
                            checkpoint=str(d / f"model.{ext}"))
            runs[ext] = (res, K.launch_counts())
        want = dict.fromkeys(K.KERNELS, 0)
        want.update(fused_qkv_attention=cfg.n_layer * tokens,
                    short_cross_attention=sum(cfg.cross_attention) * cfg.n_layer * tokens)
        same_tokens = (runs["pth"][0]["new"] == runs["npz"][0]["new"]).all()
        cwd, buf = os.getcwd(), io.StringIO()
        os.chdir(d)
        try:
            reset_compatibility_layer()
            with contextlib.redirect_stdout(buf):
                trained = runner.run_training(caller_globals={}, seed=7)
        finally:
            os.chdir(cwd)
            reset_compatibility_layer()
    console = buf.getvalue()
    loaded = ("Model: Loading from model.pth..." in console and "Model: Loaded successfully" in console
              and "Optimizer: Created with loaded parameters" in console)
    ok = (bit_equal and runs["pth"][1] == want and bool(same_tokens) and loaded
          and str(runs["pth"][0]["device"]) == "cuda" and trained["opt_state"]["count"] == 2)
    emit({"phase": "reference_checkpoint", "config": "examples/production_config.yaml", "card": card,
          "pth_logits_bit_equal_npz": bit_equal, "generate_tokens": tokens,
          "generate_launches": {k: v for k, v in runs["pth"][1].items() if v},
          "expected_launches": {k: v for k, v in want.items() if v},
          "generated_tokens_equal_npz": bool(same_tokens), "run_training_loaded": loaded,
          "ok": ok})
    if not ok:
        failed.append("production")
    if failed:
        raise AssertionError(f"a reference .pth failed on the card: {failed}")


def long_context(K, card, gen, timing, errs, by_path):
    """The production config at block_size 1024 (the JAX package's
    long-context mode, bench.py's T = 1024 training and --serve cells): the
    flash kernels K5f, K5b, K6f and K6f-r held against their plain versions
    (production, edge and tier shapes) and timed; the generation entry, full
    window and --serve (bf16, int8), with exact launches; the card's logits,
    a steady --serve chunk and a training step against the CPU; a training
    run with exact launches; long-context serving rates. Adds to ``timing``,
    ``errs`` and ``by_path``; raises on a failed check."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from trade_aid_multimodal_transformer_tpu_torch import generate as entry
    from trade_aid_multimodal_transformer_tpu_torch.models import cache as C
    from trade_aid_multimodal_transformer_tpu_torch.models.init import init_params
    from trade_aid_multimodal_transformer_tpu_torch.models.sampler import generate_fast
    from trade_aid_multimodal_transformer_tpu_torch.models.transformer import forward
    from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import save_checkpoint

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def fwd_check(name, out, ref, dtype, shape, rate):
        if rate:
            return check_rel(name, out, ref, dtype, shape, rate)
        return check_close(name, out, ref, dtype, shape)

    # kernel_check: K5f (out, lse), K5b and K6f / K6f-r against their plain
    # versions at the production shapes (training B = 8, generation B = 1,
    # the --serve prefill over 896 at B = 16), at T 256 / 640 / 768 / 896 /
    # 1024 / 2048 (the dropout keyed on JAX blocks of 256 / 128 / 384 / 128 /
    # 512 / 512) x hs 16 / 64 / 128 / 256, at T 256 / 1024 x hs 36 / 96 /
    # 200, and at the shapes where the JAX package switches tiers (T 3072
    # hs 256: the split backward; T 8192 hs 256: the streamed kernels), which
    # the port's kernels also serve
    cases = [(FLASH_PROD[0], LONG_BLOCK, 64, FLASH_CROSS_PROD[1]), (24, LONG_BLOCK, 64, 6),
             (24 * 16, 896, 64, 6 * 16)]
    cases += [(2, t_, hs_, 2) for t_ in (256, 640, 768, 896, 1024, 2048)
              for hs_ in (16, 64, 128, 256)]
    # the bf16 forward's template edges: hs 36 (not a multiple of 8: the
    # element loader and stores), 96 and 200 (zeros up to D = 128 and 256)
    cases += [(2, t_, hs_, 2) for t_ in (256, 1024) for hs_ in (36, 96, 200)]
    cases += [(2, 3072, 256, 0), (2, 8192, 256, 0)]
    for n, t_, hs_, nc in cases:
        q, k, v, do = (randn(n, t_, hs_) for _ in range(4))
        qc, kc, vc = ((randn(nc, t_, hs_), randn(3, nc, t_, hs_), randn(3, nc, t_, hs_)) if nc
                      else (None,) * 3)
        shape, cshape = (n, t_, hs_), (3, nc, t_, hs_)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            qq, kk, vv, dd = (x.to(dt) for x in (q, k, v, do))
            for rate in (0.0, 0.2):
                salts = SALTS if rate else None
                tag = (dtype, rate) if rate else (dtype,)
                out, lse = K.flash_attention_fwd(qq, kk, vv, rate, salts)
                grads = K.flash_attention_bwd(qq, kk, vv, out, lse, dd, rate, salts)
                again = K.flash_attention_bwd(qq, kk, vv, out, lse, dd, rate, salts)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                    raise AssertionError(f"flash_attention_bwd {shape} {dtype}: two runs differ")
                ref_out, ref_lse = K.flash_attention_plain(qq, kk, vv, rate, salts)
                errs[("flash_attention", shape) + tag] = fwd_check(
                    "flash_attention", out, ref_out, dtype, shape, rate)
                check_rel("flash_attention.lse", lse, ref_lse, "float32", shape, rate)
                ref = K.flash_attention_bwd_plain(qq, kk, vv, out, lse, dd, rate, salts)
                errs[("flash_attention_bwd", shape, dtype, rate)] = max(
                    check_rel(f"flash_attention_bwd.{g}", a, r, dtype, shape, rate)
                    for g, a, r in zip(("dq", "dk", "dv"), grads, ref))
                if not nc:
                    continue
                qcc, kcc, vcc = (x.to(dt) for x in (qc, kc, vc))
                out_c = K.flash_cross_attention_fwd(qcc, kcc, vcc, rate, salts)
                res_c = K.flash_cross_attention_res(qcc, kcc, vcc, rate, salts)
                torch.cuda.synchronize()
                if not torch.equal(out_c, res_c[0]):
                    raise AssertionError(f"K6f and K6f-r sums differ at {cshape} {dtype}")
                ref_c = K.flash_cross_attention_plain(qcc, kcc, vcc, rate, salts, residuals=True)
                errs[("flash_cross_attention", cshape) + tag] = fwd_check(
                    "flash_cross_attention", out_c, ref_c[0], dtype, cshape, rate)
                errs[("flash_cross_attention_res", cshape) + tag] = fwd_check(
                    "flash_cross_attention_res.outs", res_c[1], ref_c[1], dtype, cshape, rate)
                check_rel("flash_cross_attention_res.lses", res_c[2], ref_c[2], "float32", cshape,
                          rate)

    # kernel_time at the production shapes, bf16: K5f and K5b at the training
    # step's self-attention (192 rows), B = 1 at generation's (24 rows); K6f
    # and K6f-r at the training step's cross-attention (48 rows, J = 3), B = 1
    # at 6 rows. Bounds count the causal half of each product and every
    # input read once, every output written once.
    bf = torch.bfloat16
    n, t_, hs_ = FLASH_PROD
    tri = t_ * (t_ + 1) // 2
    q, k, v, do = (randn(n, t_, hs_).to(bf) for _ in range(4))
    out0, lse0 = K.flash_attention_fwd(q, k, v)
    out1, lse1 = K.flash_attention_fwd(q, k, v, 0.2, SALTS)
    q1, k1, v1, o1, l1, d1 = (x[:24].contiguous() for x in (q, k, v, out0, lse0, do))
    # the library yardsticks take (1, rows, T, hs), the layout of PyTorch's
    # fused attention kernels
    plane = n * t_ * hs_ * 2

    def sdpa_causal(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True)

    lib_bwd, lib_fwd_bwd = sdpa_backward_ms(sdpa_causal, (q[None], k[None], v[None]), do[None])
    timing["flash_attention"] = dict(
        ms=device_ms(lambda: K.flash_attention_fwd(q, k, v)),
        ms_dropout=device_ms(lambda: K.flash_attention_fwd(q, k, v, 0.2, SALTS)),
        ms_b1=device_ms(lambda: K.flash_attention_fwd(q1, k1, v1)),
        plain_ms=device_ms(lambda: K.flash_attention_plain(q, k, v)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                                    is_causal=True)),
        bound=bound_ms(2 * 2 * n * tri * hs_, 4 * plane + n * t_ * 4, "bfloat16"),
        bound_b1=bound_ms(2 * 2 * 24 * tri * hs_, 4 * plane * 24 // n + 24 * t_ * 4, "bfloat16"),
    )
    timing["flash_attention_bwd"] = dict(
        ms=device_ms(lambda: K.flash_attention_bwd(q, k, v, out0, lse0, do)),
        ms_dropout=device_ms(lambda: K.flash_attention_bwd(q, k, v, out1, lse1, do, 0.2, SALTS)),
        ms_b1=device_ms(lambda: K.flash_attention_bwd(q1, k1, v1, o1, l1, d1)),
        plain_ms=device_ms(lambda: K.flash_attention_bwd_plain(q, k, v, out0, lse0, do)),
        library_ms=lib_bwd,
        library_fwd_bwd_ms=lib_fwd_bwd,
        # reads q, k, v, out, dout and lse; writes dq, dk, dv
        bound=bound_ms(5 * 2 * n * tri * hs_, 8 * plane + n * t_ * 4, "bfloat16"),
        bound_b1=bound_ms(5 * 2 * 24 * tri * hs_, 8 * plane * 24 // n + 24 * t_ * 4, "bfloat16"),
    )
    J, nc, _, _ = FLASH_CROSS_PROD
    qc, kc, vc = randn(nc, t_, hs_).to(bf), randn(J, nc, t_, hs_).to(bf), randn(J, nc, t_, hs_).to(bf)
    qc1, kc1, vc1 = qc[:6].contiguous(), kc[:, :6].contiguous(), vc[:, :6].contiguous()
    cplane = nc * t_ * hs_ * 2
    for name, fn_ in (("flash_cross_attention", K.flash_cross_attention_fwd),
                      ("flash_cross_attention_res", K.flash_cross_attention_res)):
        res_bytes = (J * cplane + J * nc * t_ * 4) if name.endswith("_res") else 0
        res_b1 = res_bytes * 6 // nc
        timing[name] = dict(
            ms=device_ms(lambda: fn_(qc, kc, vc)),
            ms_dropout=device_ms(lambda: fn_(qc, kc, vc, 0.2, SALTS)),
            ms_b1=device_ms(lambda: fn_(qc1, kc1, vc1)),
            plain_ms=device_ms(lambda: K.flash_cross_attention_plain(
                qc, kc, vc, residuals=name.endswith("_res"))),
            library_ms=None,  # no one PyTorch call sums attention over J streams
            bound=bound_ms(J * 2 * 2 * nc * tri * hs_, (2 + 2 * J) * cplane + res_bytes,
                           "bfloat16"),
            bound_b1=bound_ms(J * 2 * 2 * 6 * tri * hs_, (2 + 2 * J) * cplane * 6 // nc + res_b1,
                              "bfloat16"),
        )
    for name in ("flash_attention", "flash_attention_bwd", "flash_cross_attention",
                 "flash_cross_attention_res"):
        t = timing[name]
        emit({"phase": "kernel_time", "kernel": name, "card": card, "kernel_ms": t["ms"],
              "kernel_ms_dropout": t["ms_dropout"], "kernel_ms_b1": t["ms_b1"],
              "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
              "library_fwd_bwd_ms": t.get("library_fwd_bwd_ms"),
              "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
              "bound_ms_b1": t["bound_b1"][0]})
    del q, k, v, do, out0, out1, qc, kc, vc

    # kernel_time at the JAX package's K5 tier shapes (hs 256; T 3072 takes
    # its split backward, T 8192 its streamed forward and backward), which
    # K5f and K5b serve: their rows of the kernel table
    for n, t_, hs_ in ((2, 3072, 256), (2, 8192, 256)):
        tri = t_ * (t_ + 1) // 2
        q, k, v, do = (randn(n, t_, hs_).to(bf) for _ in range(4))
        out0, lse0 = K.flash_attention_fwd(q, k, v)
        plane = n * t_ * hs_ * 2
        lib_bwd, lib_fwd_bwd = sdpa_backward_ms(sdpa_causal, (q[None], k[None], v[None]),
                                                do[None], reps=5, inner=4)

        tiers = {
            "flash_attention": dict(
                ms=device_ms(lambda: K.flash_attention_fwd(q, k, v), reps=5, inner=4),
                plain_ms=device_ms(lambda: K.flash_attention_plain(q, k, v), reps=3, inner=2),
                library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True), reps=5, inner=4),
                bound=bound_ms(2 * 2 * n * tri * hs_, 4 * plane + n * t_ * 4, "bfloat16")),
            "flash_attention_bwd": dict(
                ms=device_ms(lambda: K.flash_attention_bwd(q, k, v, out0, lse0, do), reps=5,
                             inner=4),
                plain_ms=device_ms(lambda: K.flash_attention_bwd_plain(q, k, v, out0, lse0, do),
                                   reps=3, inner=2),
                library_ms=lib_bwd,
                library_fwd_bwd_ms=lib_fwd_bwd,
                bound=bound_ms(5 * 2 * n * tri * hs_, 8 * plane + n * t_ * 4, "bfloat16"))}
        for name, t in tiers.items():
            emit({"phase": "kernel_time", "kernel": name, "tier_shape": True, "card": card,
                  "shape": [n, t_, hs_], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
                  "library_ms": t["library_ms"],
                  "library_fwd_bwd_ms": t.get("library_fwd_bwd_ms"),
              "library_3d_ms": t.get("library_3d_ms"), "bound_ms": t["bound"][0],
                  "bound_by": t["bound"][1]})
        del q, k, v, do, out0, lse0

    # long_entry: the generation entry at block_size 1024 from the last 1024
    # tokens: 4 full-window tokens (6 K5f and 12 K6f per token, no whole-row
    # kernel), and --serve for 128 tokens (one chunk: a prefill over 896 with
    # 6 K5f and 12 K6f, then 128 decode steps of 18 K8p, or K8q with int8)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d, block_size=LONG_BLOCK)
        data = entry.load_config_and_data(str(d))
        cfg = data["cfg"]
        params = init_params(cfg, torch.Generator().manual_seed(1234), dev)
        save_checkpoint(str(d / data["sc"]["model_file_name"]), params)
        S, L, n_cross = cfg.block_size, cfg.n_layer, sum(cfg.cross_attention)
        for label, tokens, kw, decode in (
                ("long_generate", 4, {}, None),
                ("long_serve", 128, dict(serve=True), "decode_attention_packed"),
                ("long_serve_int8", 128, dict(serve=True, kv_dtype="int8"),
                 "decode_attention_packed_q8")):
            K.reset_launch_counts()
            t0 = time.perf_counter()
            res = entry.run(str(d), tokens=tokens, modality=0, seed=0, **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = K.launch_counts()
            by_path[label] = counts
            if decode:
                want = serve_launches(K, cfg, S, tokens, S // 8, decode)
            else:
                want = dict.fromkeys(K.KERNELS, 0)
                want.update(flash_attention=L * tokens, flash_cross_attention=L * n_cross * tokens)
            new = res["new"]
            ok = (str(res["device"]) == "cuda" and res["model"].startswith("checkpoint")
                  and len(data["ids"][0]) >= S and new.shape == (cfg.num_modalities, tokens)
                  and 0 <= new[0].min() and new[0].max() < len(res["vocabs"][0])
                  and all((new[m] == res["last_prompt_tokens"][m]).all()
                          for m in range(1, cfg.num_modalities))
                  and counts == want)
            emit({"phase": "long_entry", "run": label, "block_size": S, "kv_dtype": kw.get("kv_dtype"),
                  "refresh": S // 8 if decode else None, "tokens": tokens, "batch": 1,
                  "prompt": S, "seconds": sec, "launches": counts, "expected_launches": want,
                  "generated": new[0].tolist(), "ok": ok})
            if not ok:
                raise AssertionError(f"the long-context entry ({label}) failed its checks")

    # long_reference: the card's logits at T = 1024, B = 2, against the CPU's
    # dense forward (f32 1e-4, bf16 5e-2); a steady --serve chunk (a prefill
    # over 896, then positions 896..1023) against the card's full forward and
    # the CPU's cached f32 forward, f32 and bf16, with the planted K8p fault
    # (serve_reference; in bf16 every K5f, K6f and K8p call of the run held
    # against its plain version)
    rng = np.random.default_rng(9)
    ids = torch.from_numpy(np.stack([rng.integers(0, v, (2, S)) for v in cfg.vocab_sizes]))
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu_params = init_params(cfg, torch.Generator().manual_seed(1234), "cpu")
    with torch.inference_mode():
        ref = forward(cpu_params, f32, ids)[0]
        K.reset_launch_counts()
        got = forward(params, f32, ids.to(dev))[0]
        counts = K.launch_counts()
        bf_logits = forward(params, cfg, ids.to(dev))[0]
    f32_err = max((a.cpu() - b).abs().max().item() for a, b in zip(got, ref))
    bf_err = max((a.float().cpu() - b).abs().max().item() for a, b in zip(bf_logits, ref))
    finite = all(torch.isfinite(x).all().item() for x in got + bf_logits)
    want = dict.fromkeys(K.KERNELS, 0)
    want.update(flash_attention=L, flash_cross_attention=L * n_cross)
    ok = finite and f32_err <= 1e-4 and bf_err <= 5e-2 and counts == want
    emit({"phase": "long_reference", "what": "card flash kernels vs CPU dense forward, logits",
          "block_size": S, "batch": 2, "f32_max_abs_err": f32_err, "f32_tol": 1e-4,
          "bf16_max_abs_err": bf_err, "bf16_tol": 5e-2, "finite": finite, "launches": counts,
          "ok": ok})
    if not ok:
        raise AssertionError("the long-context forward on the card disagrees with the CPU")
    failed = serve_reference(K, C, forward, params, cpu_params, cfg, ids,
                             {"steady_chunk": S - S // 8}, {
        "flash_attention_fwd": ("flash_attention", K.flash_attention_plain, L),
        "flash_cross_attention_fwd": ("flash_cross_attention", K.flash_cross_attention_plain,
                                      L * n_cross)}, phase="long_reference")
    if failed:
        raise AssertionError(f"long-context cached logits on the card disagree, or the gate "
                             f"passed the planted fault ({', '.join(failed)})")
    del cpu_params

    # long_train_reference: one training step at T = 1024, B = 1, against the
    # CPU's dense step; K5b's dk 20% too large must fail the gate
    n_bwd = L * (1 + sum(len(cfg.kv_modalities(i)) for i in range(cfg.num_modalities)
                         if cfg.cross_attention[i]))
    want_step = dict.fromkeys(K.KERNELS, 0)
    want_step.update(flash_attention=L, flash_attention_bwd=n_bwd,
                     flash_cross_attention_res=L * n_cross)
    ids = torch.from_numpy(np.stack([rng.integers(0, v, (1, S + 1)) for v in cfg.vocab_sizes]))
    train_reference(K, cfg, ids, {"K5b_dk_x1.2": (K.FlashCausalAttention, 1)}, ("K5b_dk_x1.2",),
                    want_step, phase="long_train_reference")

    # long_training: run_training at block_size 1024, batch 8 (per step 6 K5f,
    # 12 K6f-r and 42 K5b: 6 for self-attention, 3 streams x 12 cross calls;
    # per evaluated batch 6 K5f and 12 K6f), and a profiled step
    by_path["long_training"], long_steps, _ = training_run(
        K, card, "long_training",
        dict(flash_attention=L, flash_attention_bwd=n_bwd, flash_cross_attention_res=L * n_cross),
        dict(flash_attention=L, flash_cross_attention=L * n_cross),
        block_size=LONG_BLOCK, batch_size=8, max_iters=40, eval_interval=20, eval_iters=2)

    # long_serving: ms per token at B = 1 and tokens/s at B = 16 from a full
    # window of 1024: generate_fast (8 tokens) and --serve (one chunk of 128
    # tokens, bf16 and int8 caches)
    for batch in (1, 16):
        window = torch.from_numpy(
            np.stack([rng.integers(0, v, (batch, S)) for v in cfg.vocab_sizes])).to(dev)
        rates = {}
        for label, n_tok, run in (
                ("generate_fast", 8, lambda g, n_: generate_fast(params, cfg, window, g, n_, 0)),
                ("serve", 128, lambda g, n_: C.generate_serve(params, cfg, window, g, n_, 0)),
                ("serve_int8", 128, lambda g, n_: C.generate_serve(params, cfg, window, g, n_, 0,
                                                                   kv_dtype="int8"))):
            g = torch.Generator(device=dev).manual_seed(0)
            run(g, 2)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(g, n_tok)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            if out.shape != (cfg.num_modalities, batch, S + n_tok):
                raise AssertionError(f"long-context {label} output shape {tuple(out.shape)}")
            rates[label] = {"tokens": n_tok, "seconds": sec, "ms_per_token": 1e3 * sec / n_tok,
                            "tokens_per_s": batch * n_tok / sec}
        emit({"phase": "long_serving", "card": card, "block_size": S, "batch": batch,
              "refresh": S // 8, **rates})
    emit({"phase": "long_training_rate", "card": card, "block_size": S, "batch": 8,
          "steps_per_s_after_first_chunk": long_steps})


def cp_want(K, cfg, rank: int, per: str) -> dict:
    """K7 launches of one rank of a ring over the sequence axis: per forward
    n_layer x (1 + cross streams) rings, each one causal chunk and one
    full-mask chunk per earlier rank (later ranks are skipped); the backward
    the same. ``per``: "step" (forward and backward) or "forward"."""
    rings = cfg.n_layer * (1 + sum(len(cfg.kv_modalities(i)) for i in range(cfg.num_modalities)
                                   if cfg.cross_attention[i]))
    want = dict.fromkeys(K.KERNELS, 0)
    want.update(flash_chunk_fwd_causal=rings, flash_chunk_fwd_full=rings * rank)
    if per == "step":
        want.update(flash_chunk_bwd_causal=rings, flash_chunk_bwd_full=rings * rank)
    return want


def k7b_full_dk_x1_2(K):
    """The planted fault of cp_reference: the first full-mask K7b call of a
    self-attention ring in the step (q (M, B, H, c, hs); the last layer's)
    returns dk 20% too large: one chunk pair."""
    real, done = K.flash_chunk_bwd, []

    def wrong(q, k, v, out, lse, g, causal, seed=None, rate=0.0, base=0):
        dq, dk, dv = real(q, k, v, out, lse, g, causal, seed, rate, base)
        if not causal and q.dim() == 5 and not done:
            done.append(True)
            dk = dk * 1.2
        return dq, dk, dv

    return wrong


def cp_rank(rank: int, world: int, job: dict):
    """One rank of the context-parallel phases, in a process of its own. All
    ranks share the one card, so the group is gloo and the ring's hops and
    gathers go through host memory; every chunk runs K7 on the card.

    job "reference": one step per variant (name, dtype, dropout, change:
    None, "planted", "plain" K7, "remat" or "export") on batch
    ``job["batch"]``; rank 0 holds each against ``job["refs"][dtype]`` (the
    card's single-rank step) or, at dropout, the variant computed with K7's
    plain versions, and a "remat" variant (each block recomputed in the
    backward, under the ring's scope) against the variant of its name
    without "_remat"; an "export" variant is held in-path only and rank 0
    returns its loss and gradients (on the CPU) as a later phase's
    reference. job "training":
    ``job["steps"]`` steps of the production training step, one eval batch,
    and a profiled step. Returns what the parent checks."""
    sys.path.insert(0, str(REPO))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        init_params, map_tree, tree_leaves, tree_paths)
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import make_sharded_trainer
    from trade_aid_multimodal_transformer_tpu_torch.sampling.feed import BatchFeed
    from trade_aid_multimodal_transformer_tpu_torch.train.steps import StepRng, make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    mesh = pmesh.make_mesh(seq=world, staged=True)
    cfg = job["cfg"]
    if job["kind"] == "reference":
        xb, yb = (x.to(dev) for x in job["batch"])
        got, out = {}, {}
        for name, dtype, rate, change in job["variants"]:
            c = dataclasses.replace(cfg, compute_dtype=dtype, dropout=rate, remat=change == "remat")
            params = map_tree(lambda t: t.detach().to(dev).clone().requires_grad_(), job["params"])
            trainer = make_sharded_trainer(c, None, make_optimizer(1e-3), [], 1, mesh)
            worst = {}
            bwd = k7b_full_dk_x1_2(K) if change == "planted" else K.flash_chunk_bwd
            fns = (dict(flash_chunk_fwd=K.flash_chunk_fwd_plain,
                        flash_chunk_bwd=K.flash_chunk_bwd_plain) if change == "plain"
                   else dict(flash_chunk_fwd=checked(K, "flash_chunk_fwd", K.flash_chunk_fwd, worst),
                             flash_chunk_bwd=checked(K, "flash_chunk_bwd", bwd, worst)))
            with patched(K, **fns):
                K.reset_launch_counts()
                loss, grads = trainer.loss_and_grads(params, [(xb, yb)], [SALTS])
                torch.cuda.synchronize()
                counts = K.launch_counts()
            got[name] = (loss.item(), [g.float() for g in grads])
            out[name] = {"loss": loss.item(), "launches": counts, "in_path": worst}
        if rank != 0:
            return out
        for name, dtype, rate, change in job["variants"]:
            if change == "plain":
                continue
            loss, grads = got[name]
            if change == "export":
                out[name]["reference"] = (loss, [g.cpu() for g in grads])
                continue
            if change == "remat":
                ref_loss, ref = got[name[:-len("_remat")]]
                out[name]["bit_equal"] = loss == ref_loss and all(
                    torch.equal(g, r) for g, r in zip(grads, ref))
            else:
                ref_loss, ref = job["refs"][dtype] if not rate else got[name + "_plain"]
            norms = [r.norm().item() for r in ref]
            floor = 1e-6 * math.sqrt(sum(n * n for n in norms))
            errs_leaf = [(g - r.to(dev)).norm().item() / max(n, floor)
                         for g, r, n in zip(grads, ref, norms)]
            names = ["/".join(map(str, path)) for path, _ in tree_paths(job["params"])]
            out[name].update(against="the same step without remat" if change == "remat" else
                             "K7 plain on the card" if rate else
                             "single-rank step on the card (K5/K6)",
                             loss_ref=float(ref_loss), loss_abs_err=abs(loss - float(ref_loss)),
                             grad_l2_rel_err_max=max(errs_leaf),
                             worst_leaves=sorted(zip(errs_leaf, names), reverse=True)[:3])
        return out

    # training: the production step at block_size 1024, batch 8
    feed = BatchFeed(job["train"], job["val"], [len(job["train"][0]) + len(job["val"][0])],
                     cfg.block_size, job["batch_size"], False, [None] * cfg.num_modalities,
                     list(cfg.vocab_sizes), device=dev)
    params = map_tree(lambda t: t.to(dev).requires_grad_(),
                      init_params(cfg, torch.Generator().manual_seed(1234), "cpu"))
    opt = make_optimizer(job["lr"], moment_dtype="bfloat16", nu_dtype="bfloat16")
    state = opt.init(params)
    trainer = make_sharded_trainer(cfg, feed, opt, [], job["eval_iters"], mesh)
    rng = StepRng(7, dev)
    K.reset_launch_counts()
    losses = trainer.train_chunk(params, state, rng, 2)[2].tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += trainer.train_chunk(params, state, rng, job["steps"] - 2)[2].tolist()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    train_counts = K.launch_counts()
    K.reset_launch_counts()
    ev = trainer.eval_pass(params, rng, "train")
    torch.cuda.synchronize()
    eval_counts = K.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        trainer.train_chunk(params, state, rng, 1)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t1
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"losses": losses, "steps_per_s": (job["steps"] - 2) / sec,
            "eval_train_loss": ev.mean_loss.item(), "train_launches": train_counts,
            "eval_launches": eval_counts,
            "param_sums": [float(p.detach().double().sum()) for p in tree_leaves(params)],
            "profile": {"step_ms_profiled": 1e3 * prof_s,
                        "device_ms": 1e3 * dev_s if kern else None,
                        "kernels": sum(e.count for e in kern),
                        "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                                for e in top]}}


def cp_batch(cfg):
    """cp_reference's global batch (B = 1, the config's block_size), seeded."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    ids = torch.from_numpy(np.stack([rng.integers(0, v, (1, cfg.block_size + 1))
                                     for v in cfg.vocab_sizes]))
    return ids[..., :-1], ids[..., 1:]


def cp_reference_job(cfg, depth: int, p_size: int, xb, yb) -> dict:
    """cp_reference's ``cp_rank`` job over ``p_size`` ranks at ``depth``
    layers: one step (B = 1, T = 1024) against the card's single-rank step
    (K5f, K6f-r, K5b) at dropout 0 in f32 and bf16 (its references, taken
    here), the planted K7b fault (full-mask dk x 1.2 on one chunk pair),
    and at P = 2 the step at dropout 0.2 against the same step with K7's
    plain versions and with remat against the same step without it."""
    import torch

    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        init_params, map_tree, tree_leaves)
    from trade_aid_multimodal_transformer_tpu_torch.models.transformer import total_loss

    dev = torch.device("cuda")
    c = dataclasses.replace(cfg, n_layer=depth, dropout=0.0)
    cpu_p = init_params(c, torch.Generator().manual_seed(1234), "cpu")
    refs = {}
    for dtype in ("float32", "bfloat16"):
        cd = dataclasses.replace(c, compute_dtype=dtype)
        dev_p = map_tree(lambda t: t.detach().to(dev).requires_grad_(), cpu_p)
        loss = total_loss(dev_p, cd, xb.to(dev), yb.to(dev), None, True)[0]
        refs[dtype] = (loss.item(), [g.float().cpu() for g in
                                     torch.autograd.grad(loss, tree_leaves(dev_p))])
        del dev_p, loss
    variants = [("f32", "float32", 0.0, None), ("f32_planted", "float32", 0.0, "planted"),
                ("bf16", "bfloat16", 0.0, None)]
    if p_size == 2:
        variants += [("bf16_dropout_plain", "bfloat16", 0.2, "plain"),
                     ("bf16_dropout", "bfloat16", 0.2, None),
                     ("bf16_dropout_remat", "bfloat16", 0.2, "remat")]
    return dict(kind="reference", cfg=c, params=cpu_p, batch=(xb, yb), refs=refs,
                variants=variants, ranks=p_size)


def hold_cp_reference(K, res, job, sec) -> None:
    """One ``cp_reference`` line per variant of ``job`` (``res``: every
    rank's ``cp_rank`` results): exact K7 launches per rank, every K7 call
    in-path within REL_TOL and the step within STEP_TOL of its reference;
    the planted fault must fail the in-path gate (its whole-step reading is
    printed, not held: a chunk pair's dk is a few per cent of its layer's
    key gradient at random weights). Raises on a failure."""
    c, p_size = job["cfg"], job["ranks"]
    failed = []
    for name, dtype, rate, change in job["variants"]:
        want = [cp_want(K, c, r, "step") for r in range(p_size)]
        if change == "remat":  # the backward recomputes every block's rings
            for w in want:
                w["flash_chunk_fwd_causal"] *= 2
                w["flash_chunk_fwd_full"] *= 2
        counts_ok = change == "plain" or all(res[r][name]["launches"] == want[r]
                                            for r in range(p_size))
        line = res[0][name]
        if change == "plain":
            continue
        tol = STEP_TOL[dtype]
        in_path = {k_: max(res[r][name]["in_path"][k_] for r in range(p_size)
                           if k_ in res[r][name]["in_path"])
                   for k_ in set().union(*(res[r][name]["in_path"] for r in range(p_size)))}
        in_path_ok = max(in_path.values()) <= REL_TOL[dtype]
        step_ok = (line["loss_abs_err"] <= tol["loss"]
                   and line["grad_l2_rel_err_max"] <= tol["grad_l2"])
        ok = counts_ok and (not in_path_ok if change == "planted" else in_path_ok and step_ok)
        emit({"phase": "cp_reference", "ranks": p_size, "n_layer": c.n_layer, "variant": name,
              "dtype": dtype, "dropout": rate, "batch": 1, "block_size": c.block_size,
              "must_fail": change == "planted", "tol": tol,
              "in_path_l2_rel": in_path, "in_path_tol": REL_TOL[dtype],
              "step_gate_passed": step_ok, "launches_by_rank": [
                  {k_: v_ for k_, v_ in res[r][name]["launches"].items() if v_}
                  for r in range(p_size)], "launches_exact": counts_ok,
              "losses_by_rank": [res[r][name]["loss"] for r in range(p_size)],
              "seconds_with_spawn_all_jobs": sec, **{k_: line[k_] for k_ in (
                  "against", "loss_ref", "loss_abs_err", "grad_l2_rel_err_max", "worst_leaves",
                  "bit_equal") if k_ in line},
              "ok": ok})
        if not ok:
            failed.append(f"P={p_size} {name}")
    if failed:
        raise AssertionError(f"context-parallel step disagrees, miscounts, or the gate "
                             f"passed the planted fault: {', '.join(failed)}")


def context_parallel(K, card, gen, timing, errs, by_path):
    """Context parallelism (tpu_options.context_parallel) at block_size 1024:
    the ring's chunk kernels K7f and K7b held against their plain versions
    (production chunk pairs, t_q != t_k, hs 16 / 128 / 256, the backward from
    a logsumexp merged over two chunks and run twice for the same bits) and
    timed; one context-parallel step over 2 ranks at full depth against the
    card's single-rank step, with a planted fault (over 4 ranks at depth 2
    in ``four_rank_references``); a context-parallel training run over 2
    ranks with exact launches per rank and a profiled step; and, in the same
    start of the ranks, the ring step at depth 2 and dropout 0.2 that
    ``mod_seq_reference`` is held against. The ranks are processes that
    share the card (gloo through host memory), started below the training
    entry's card-count check. Adds to ``timing``, ``errs`` and ``by_path``;
    returns that step's (loss, gradients); raises on a failed check."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from trade_aid_multimodal_transformer_tpu_torch import generate as entry
    from trade_aid_multimodal_transformer_tpu_torch.data.vocab import create_train_val_datasets
    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        init_params, map_tree, tree_leaves)
    from trade_aid_multimodal_transformer_tpu_torch.models.transformer import total_loss
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    # kernel_check: K7f (out, lse) and K7b, causal and full mask, dropout 0
    # and 0.2, f32 and bf16; the backward given the output and logsumexp
    # merged with a second (full-mask) chunk, as the ring gives them
    # (hs 200 and 256: key tiles of 32 rows against 64 query rows a block, so
    # under the causal mask the block's last key tile is wholly masked for
    # two of its warps)
    shapes = [CP_SELF, (4 * 8 * 6, 256, 256, 64), CP_CROSS, (2, 128, 512, 64),
              (2, 512, 256, 64), (2, 384, 1024, 64), (2, 256, 256, 16), (2, 256, 256, 128),
              (2, 256, 256, 256), (2, 256, 512, 200), (2, 512, 384, 256)]
    for n, tq, tk, hs in shapes:
        q, do = randn(n, tq, hs), randn(n, tq, hs)
        k, v, k2, v2 = (randn(n, tk, hs) for _ in range(4))
        shape = (n, tq, tk, hs)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            qq, dd, kk, vv, kk2, vv2 = (x.to(dt) for x in (q, do, k, v, k2, v2))
            for rate in (0.0, 0.2):
                seed = 1234567 if rate else None
                for causal in (True, False):
                    mask = "causal" if causal else "full"
                    tag = (dtype, rate) if rate else (dtype,)
                    out, lse = K.flash_chunk_fwd(qq, kk, vv, causal, seed, rate)
                    out2, lse2 = K.flash_chunk_fwd(qq, kk2, vv2, False, seed, rate)
                    m = torch.logaddexp(lse, lse2)
                    o = (out.float() * torch.exp(lse - m)[..., None]
                         + out2.float() * torch.exp(lse2 - m)[..., None]).to(dt)
                    grads = K.flash_chunk_bwd(qq, kk, vv, o, m, dd, causal, seed, rate)
                    again = K.flash_chunk_bwd(qq, kk, vv, o, m, dd, causal, seed, rate)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                        raise AssertionError(f"flash_chunk_bwd {shape} {dtype}: two runs differ")
                    ref_out, ref_lse = K.flash_chunk_fwd_plain(qq, kk, vv, causal, seed, rate)
                    name = f"flash_chunk_fwd_{mask}"
                    errs[(name, shape) + tag] = (
                        check_rel(name, out, ref_out, dtype, shape, rate) if rate else
                        check_close(name, out, ref_out, dtype, shape))
                    check_rel(f"{name}.lse", lse, ref_lse, "float32", shape, rate)
                    ref = K.flash_chunk_bwd_plain(qq, kk, vv, o, m, dd, causal, seed, rate)
                    name = f"flash_chunk_bwd_{mask}"
                    errs[(name, shape, dtype, rate)] = max(
                        check_rel(f"{name}.{g}", a, r, dtype, shape, rate)
                        for g, a, r in zip(("dq", "dk", "dv"), grads, ref))

    # kernel_time at the production chunk pair (192 rows, 512 x 512, bf16;
    # B = 1: 24 rows): bounds count the visible pairs (all of them without
    # the mask, t(t + 1) / 2 with it), every input read once, every output
    # written once; the library yardstick is SDPA over the same pair (for
    # K7b its backward alone, forward + backward in library_fwd_bwd_ms)
    bf = torch.bfloat16
    n, tq, tk, hs = CP_SELF
    q, k, v, do = (randn(n, tq, hs).to(bf) for _ in range(4))
    plane = n * tq * hs * 2
    for causal in (True, False):
        mask = "causal" if causal else "full"
        pairs = tq * (tq + 1) // 2 if causal else tq * tk
        out0, lse0 = K.flash_chunk_fwd(q, k, v, causal)
        out1, lse1 = K.flash_chunk_fwd(q, k, v, causal, 99, 0.2)
        q1, k1, v1, o1, l1, d1 = (x[:24].contiguous() for x in (q, k, v, out0, lse0, do))

        def sdpa_chunk(a, b, c, causal=causal):
            return F.scaled_dot_product_attention(a, b, c, is_causal=causal)

        lib_bwd, lib_fwd_bwd = sdpa_backward_ms(sdpa_chunk, (q[None], k[None], v[None]), do[None])

        timing[f"flash_chunk_fwd_{mask}"] = dict(
            ms=device_ms(lambda: K.flash_chunk_fwd(q, k, v, causal)),
            ms_dropout=device_ms(lambda: K.flash_chunk_fwd(q, k, v, causal, 99, 0.2)),
            ms_b1=device_ms(lambda: K.flash_chunk_fwd(q1, k1, v1, causal)),
            plain_ms=device_ms(lambda: K.flash_chunk_fwd_plain(q, k, v, causal)),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=causal)),
            bound=bound_ms(2 * 2 * n * pairs * hs, 4 * plane + n * tq * 4, "bfloat16"),
            bound_b1=bound_ms(2 * 2 * 24 * pairs * hs, 4 * plane * 24 // n + 24 * tq * 4,
                              "bfloat16"))
        timing[f"flash_chunk_bwd_{mask}"] = dict(
            ms=device_ms(lambda: K.flash_chunk_bwd(q, k, v, out0, lse0, do, causal)),
            ms_dropout=device_ms(lambda: K.flash_chunk_bwd(q, k, v, out1, lse1, do, causal, 99,
                                                           0.2)),
            ms_b1=device_ms(lambda: K.flash_chunk_bwd(q1, k1, v1, o1, l1, d1, causal)),
            plain_ms=device_ms(lambda: K.flash_chunk_bwd_plain(q, k, v, out0, lse0, do, causal)),
            library_ms=lib_bwd,
            library_fwd_bwd_ms=lib_fwd_bwd,
            # reads q, k, v, out, dout and lse; writes dq, dk, dv
            bound=bound_ms(5 * 2 * n * pairs * hs, 8 * plane + n * tq * 4, "bfloat16"),
            bound_b1=bound_ms(5 * 2 * 24 * pairs * hs, 8 * plane * 24 // n + 24 * tq * 4,
                              "bfloat16"))
        for name in (f"flash_chunk_fwd_{mask}", f"flash_chunk_bwd_{mask}"):
            t = timing[name]
            emit({"phase": "kernel_time", "kernel": name, "card": card, "shape": list(CP_SELF),
                  "kernel_ms": t["ms"], "kernel_ms_dropout": t["ms_dropout"],
                  "kernel_ms_b1": t["ms_b1"], "plain_ms": t["plain_ms"],
                  "library_ms": t["library_ms"],
                  "library_fwd_bwd_ms": t.get("library_fwd_bwd_ms"),
                  "library_3d_ms": t.get("library_3d_ms"), "bound_ms": t["bound"][0],
                  "bound_by": t["bound"][1], "bound_ms_b1": t["bound_b1"][0]})
    del q, k, v, do

    # the production config at block_size 1024: data, and the parameters of
    # the reference steps (seed 1234)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d, block_size=LONG_BLOCK)
        data = entry.load_config_and_data(str(d))
    cfg, sc = data["cfg"], data["sc"]
    emit({"phase": "cp_setup", "card": card, "backend": "gloo (hops and gathers through host "
          "memory)", "ranks_on_one_card": [2, 4], "cards": torch.cuda.device_count(),
          "entry_plan_check": "below it: the ranks share one card"})

    # cp_reference at P = 2, full depth (P = 4 runs in four_rank_references'
    # start of the ranks)
    xb, yb = cp_batch(cfg)
    # cp_training's job (below), run in the start of cp_reference's P = 2 ranks:
    # the production training step at block_size 1024, batch 8, dropout 0.2,
    # bf16, over 2 ranks: 4 steps (cut from 8 for the smoke's time limit), one
    # eval batch, exact K7 launches per rank, the loss falling (the last two
    # steps' mean below the first two's), a profiled step on every rank. The
    # synthetic series is split 80/20 (the config's file split leaves one
    # training file), without augmentation
    splits = [create_train_val_datasets(x, 0.2, 0, [len(x)]) for x in data["ids"]]
    steps = 4
    train_job = dict(kind="training", cfg=cfg, train=[np.asarray(a) for a, _ in splits],
                     val=[np.asarray(b) for _, b in splits], batch_size=8,
                     lr=sc["learning_rate"], eval_iters=1, steps=steps)
    ref_job = cp_reference_job(cfg, cfg.n_layer, 2, xb, yb)
    # mod_seq_reference's reference at dropout 0.2 (four_rank_references): the
    # same P = 2 ring step at depth 2, bf16, rank 0's loss and gradients
    c2 = dataclasses.replace(cfg, n_layer=2, dropout=0.0)
    export_job = dict(kind="reference", cfg=c2,
                      params=init_params(c2, torch.Generator().manual_seed(1234), "cpu"),
                      batch=(xb, yb), refs={},
                      variants=[("mod_seq_ref", "bfloat16", 0.2, "export")])
    torch.cuda.empty_cache()  # the ranks' activations need the card's memory
    t0 = time.perf_counter()
    calls = [(cp_rank, (ref_job,)), (cp_rank, (train_job,)), (cp_rank, (export_job,))]
    got = pmesh.run_ranks(rank_calls, 2, (calls,), timeout=RANK_TIMEOUT * len(calls))
    train_sec = time.perf_counter() - t0
    hold_cp_reference(K, [g[0] for g in got], ref_job, train_sec)
    trained = [g[1] for g in got]
    mod_seq_ref = got[0][2]["mod_seq_ref"]["reference"]

    # cp_training (run above, after the P = 2 reference)
    res, p_size, job = trained, 2, train_job
    want_train = [{k_: steps * v_ for k_, v_ in cp_want(K, cfg, r, "step").items()}
                  for r in range(p_size)]
    want_eval = [cp_want(K, cfg, r, "forward") for r in range(p_size)]
    counts_ok = all(res[r]["train_launches"] == want_train[r]
                    and res[r]["eval_launches"] == want_eval[r] for r in range(p_size))
    emit({"phase": "cp_entry", "ranks": p_size, "steps": steps, "eval_batches": 1,
          "launches_per_rank_train": [{k_: v_ for k_, v_ in res[r]["train_launches"].items() if v_}
                                      for r in range(p_size)],
          "launches_per_rank_eval": [{k_: v_ for k_, v_ in res[r]["eval_launches"].items() if v_}
                                     for r in range(p_size)],
          "ok": counts_ok})
    by_path["cp_training"] = {k_: sum(res[r]["train_launches"][k_] + res[r]["eval_launches"][k_]
                                      for r in range(p_size)) for k_ in K.KERNELS}
    losses = res[0]["losses"]
    finite = all(math.isfinite(x) for x in losses)
    falls = finite and statistics.mean(losses[-2:]) < statistics.mean(losses[:2])
    same = all(res[r]["losses"] == losses for r in range(p_size))
    drift = max(abs(a - b) for r in range(1, p_size)
                for a, b in zip(res[r]["param_sums"], res[0]["param_sums"]))
    ok = counts_ok and falls and math.isfinite(res[0]["eval_train_loss"])
    prof = [res[r]["profile"] for r in range(p_size)]
    steps_per_s = res[0]["steps_per_s"]
    emit({"phase": "cp_training", "config": "examples/production_config.yaml", "card": card,
          "changed": {"block_size": LONG_BLOCK, "batch_size": job["batch_size"],
                      "context_parallel": p_size},
          "ranks_on_one_card": p_size, "backend": "gloo through host memory",
          "dropout": cfg.dropout, "compute_dtype": cfg.compute_dtype, "steps": steps,
          "losses": losses, "same_losses_on_every_rank": same,
          "param_sum_max_diff_between_ranks": drift, "eval_train_loss": res[0]["eval_train_loss"],
          "steps_per_s_after_two": steps_per_s,
          "seconds_with_spawn_and_reference": train_sec,
          "split": "80/20 of the series", "augmentation": "off", "ok": ok})
    emit({"phase": "profile", "path": "cp_training", "card": card, "block_size": LONG_BLOCK,
          "steps": 1, "step_ms_unprofiled": 1e3 / steps_per_s,
          "device_ms_per_step_by_rank": [p_["device_ms"] for p_ in prof],
          "device_busy_share_of_card": (sum(p_["device_ms"] for p_ in prof) * steps_per_s / 1e3
                                        if all(p_["device_ms"] for p_ in prof) else None),
          "kernels_per_step_by_rank": [p_["kernels"] for p_ in prof],
          "step_ms_profiled_by_rank": [p_["step_ms_profiled"] for p_ in prof],
          "top_rank1": prof[-1]["top"]})
    if not ok:
        raise AssertionError("the context-parallel training run failed its checks")
    return mod_seq_ref


# data parallelism: the second half of the batch is the rank whose row offset
# matters (the first half's offset is 0 either way)
DP_RANKS = 2


def dp_row_map(lead, axis: int, start: int, total: int):
    """The global-row launch arguments (span, skip, base) of collapsed rows
    of the leading axes ``lead`` whose axis ``axis`` holds rows
    [start, start + lead[axis]) of a global batch of ``total`` rows."""
    from trade_aid_multimodal_transformer_tpu_torch.ops.layers import (
        batch_row_map, batch_slice_scope)

    with batch_slice_scope(start, total):
        return batch_row_map(lead, axis)


def rel_err(out, ref) -> float:
    """check_rel's measure: max-abs error over max(1, max|ref|)."""
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max().clamp_min(1.0)).item()


def dp_kernel_check(K, card, gen):
    """kernel_check under data parallelism: K1f and K1b (the production
    step's x (4, 32, 64, 384), 6 heads), K2f and K2b (its head-major cross
    rows (6, 32, 64, 64) against 3 streams), K5f and K5b (the long step's
    self-attention rows (4, 8, 6, 1024, 64)) and K6f-r (its cross rows
    (8, 6, 1024, 64) against 3 streams), bf16, dropout 0.2, each called on
    the second half of the batch with the global-row arguments. Held against
    the same rows of the one call on the global batch: outputs and
    gradients whose rows depend on no other row (recorded bit-equal or not;
    the gate is the backward gate REL_TOL), weight gradients as the two
    halves' sum; and against the plain version on the same inputs (REL_TOL).
    The offset forced to 0 must fail against the global rows. One line per
    kernel; raises on a failure."""
    import torch

    from trade_aid_multimodal_transformer_tpu_torch.ops.layers import map_rows

    dev, bf, rate, tol = torch.device("cuda"), torch.bfloat16, 0.2, REL_TOL["bfloat16"]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    failed = []

    def report(name, shape, vs_global, vs_plain, planted, extra=None):
        """Each of vs_global, vs_plain, planted: {output: (the half's call's
        tensor, the reference's)}: the global call's same rows (or, for a
        weight gradient, the two halves' sum against the global call's), the
        plain version on the half's inputs, and the call with the offset
        forced to 0 against the global call's rows."""
        torch.cuda.synchronize()
        errs_g = {o: rel_err(a, b) for o, (a, b) in vs_global.items()}
        errs_p = {o: rel_err(a, b) for o, (a, b) in vs_plain.items()}
        bits = {o: bool(torch.equal(a, b)) for o, (a, b) in vs_global.items()}
        offset_0 = max(rel_err(a, b) for a, b in planted.values())
        ok = max(errs_g.values()) <= tol and max(errs_p.values()) <= tol and offset_0 > tol
        emit({"phase": "dp_kernel_check", "kernel": name, "card": card, "shape": list(shape),
              "rows": "second half of the batch, global-row arguments", "dtype": "bfloat16",
              "dropout": rate, "bit_equal_to_global": bits, "rel_err_vs_global": errs_g,
              "rel_err_vs_plain": errs_p, "offset_0_rel_err_vs_global": offset_0, "tol": tol,
              **(extra or {}), "ok": ok})
        if not ok:
            failed.append(name)

    # K1f, K1b: the mask's batch group gb comes from the global batch
    M, B, T, C, H, hs = PROD_K1
    h = B // DP_RANKS
    x, w1 = randn(M, B, T, C).to(bf), randn(M, C, 3 * H * hs // 2, scale=0.05)
    b1, w2 = randn(M, 3 * H * hs // 2, scale=0.05), randn(M, 3 * H, hs // 2, hs, scale=0.2)
    dout = randn(M, H, B, T, hs).to(bf)
    g_out = K.fused_qkv_attention_fwd(x, w1, b1, w2, H, rate, SALTS)
    g_grads = K.fused_qkv_attention_bwd(x, w1, b1, w2, g_out, dout, H, rate, SALTS)
    halves = []
    for start in (0, h):
        xl, dl = x[:, start:start + h].contiguous(), dout[:, :, start:start + h].contiguous()
        out = K.fused_qkv_attention_fwd(xl, w1, b1, w2, H, rate, SALTS, (start, B))
        halves.append((xl, dl, out, K.fused_qkv_attention_bwd(xl, w1, b1, w2, out, dl, H, rate,
                                                              SALTS, (start, B))))
    xl, dl, out, grads = halves[1]
    p_out = K.fused_qkv_attention_plain(xl, w1, b1, w2, H, rate, SALTS, (h, B))
    p_grads = K.fused_qkv_attention_bwd_plain(xl, w1, b1, w2, out, dl, H, rate, SALTS, (h, B))
    names = ("dx", "dw1", "db1", "dw2")
    report("fused_qkv_attention + fused_qkv_attention_bwd", PROD_K1,
           {"out": (out, g_out[:, :, h:]), "dx": (grads[0], g_grads[0][:, h:]),
            **{o: (a + b, g) for o, a, b, g in zip(names[1:], halves[0][3][1:], grads[1:],
                                                    g_grads[1:])}},
           {"out": (out, p_out), **{o: (a, b) for o, a, b in zip(names, grads, p_grads)}},
           {"out": (K.fused_qkv_attention_fwd(xl, w1, b1, w2, H, rate, SALTS, (0, B)),
                    g_out[:, :, h:])},
           {"weight_gradients": "the two halves' sum against the global call's",
            "gb_global_batch": K.fqkv_pick_gb(B, H, T, hs, C, 2),
            "gb_half_batch": K.fqkv_pick_gb(h, H, T, hs, C, 2)})
    del x, dout, g_out, g_grads, halves

    # K2f, K2b: head-major q (H, B, T, hs), k, v (J, H, B, T, hs)
    J, n, T2, hs2 = 3, 6 * 32, 64, 64
    H2, B2 = 6, n // 6
    h2 = B2 // DP_RANKS
    q, k, v, do = (randn(*s).to(bf) for s in ((H2, B2, T2, hs2), (J, H2, B2, T2, hs2),
                                                (J, H2, B2, T2, hs2), (H2, B2, T2, hs2)))
    g_out = K.short_cross_attention_fwd(q, k, v, rate, SALTS)
    g_grads = K.short_cross_attention_bwd(q, k, v, do, rate, SALTS)
    ql, dl = q[:, h2:].contiguous(), do[:, h2:].contiguous()
    kl, vl = k[:, :, h2:].contiguous(), v[:, :, h2:].contiguous()
    rows = dp_row_map((H2, h2), 1, h2, B2)
    out = K.short_cross_attention_fwd(ql, kl, vl, rate, SALTS, rows)
    grads = K.short_cross_attention_bwd(ql, kl, vl, dl, rate, SALTS, rows)
    p_out = K.short_cross_attention_plain(ql, kl, vl, rate, SALTS, rows)
    p_grads = K.short_cross_attention_bwd_plain(ql, kl, vl, dl, rate, SALTS, rows)
    bad = K.short_cross_attention_fwd(ql, kl, vl, rate, SALTS, (rows[0], rows[1], 0))
    report("short_cross_attention + short_cross_attention_bwd", (J, n, T2, hs2),
           {"out": (out, g_out[:, h2:]), "dq": (grads[0], g_grads[0][:, h2:]),
            "dk": (grads[1], g_grads[1][:, :, h2:]), "dv": (grads[2], g_grads[2][:, :, h2:])},
           {"out": (out, p_out), **{o: (a, b) for o, a, b in zip(("dq", "dk", "dv"), grads,
                                                                p_grads)}},
           {"out": (bad, g_out[:, h2:])}, {"row_map": list(rows)})
    del q, k, v, do

    # K5f, K5b: the long step's self-attention rows (M, B, H) collapsed; the
    # half's rows are not contiguous in the global call's (M > 1)
    M5, B5, H5, T5, hs5 = 4, 8, 6, LONG_BLOCK, 64
    h5 = B5 // DP_RANKS
    q, k, v, do = (randn(M5, B5, H5, T5, hs5).to(bf) for _ in range(4))
    flat = lambda t: t.reshape(-1, T5, hs5).contiguous()  # noqa: E731
    g_out, g_lse = K.flash_attention_fwd(flat(q), flat(k), flat(v), rate, SALTS)
    g_grads = K.flash_attention_bwd(flat(q), flat(k), flat(v), g_out, g_lse, flat(do), rate,
                                    SALTS)
    ql, kl, vl, dl = (flat(t[:, h5:]) for t in (q, k, v, do))
    rows = dp_row_map((M5, h5, H5), 1, h5, B5)
    idx = map_rows(torch.arange(ql.shape[0], device=dev), rows)
    out, lse = K.flash_attention_fwd(ql, kl, vl, rate, SALTS, rows)
    grads = K.flash_attention_bwd(ql, kl, vl, out, lse, dl, rate, SALTS, rows=rows)
    p_out, p_lse = K.flash_attention_plain(ql, kl, vl, rate, SALTS, rows)
    p_grads = K.flash_attention_bwd_plain(ql, kl, vl, out, lse, dl, rate, SALTS, rows=rows)
    bad = K.flash_attention_fwd(ql, kl, vl, rate, SALTS, (rows[0], rows[1], 0))[0]
    report("flash_attention + flash_attention_bwd", (M5, B5, H5, T5, hs5),
           {"out": (out, g_out[idx]), "lse": (lse, g_lse[idx]),
            **{o: (a, g[idx]) for o, a, g in zip(("dq", "dk", "dv"), grads, g_grads)}},
           {"out": (out, p_out), "lse": (lse, p_lse),
            **{o: (a, b) for o, a, b in zip(("dq", "dk", "dv"), grads, p_grads)}},
           {"out": (bad, g_out[idx])},
           {"row_map": list(rows), "rows_of_the_global_call": "not contiguous (M > 1)"})
    del q, k, v, do

    # K6f-r: the long step's cross rows (B, H) in JAX's order against J
    # streams: each stream's output and logsumexp, and their sum
    J6, B6, H6 = 3, 8, 6
    h6 = B6 // DP_RANKS
    q = randn(B6, H6, T5, hs5).to(bf)
    k, v = (randn(J6, B6, H6, T5, hs5).to(bf) for _ in range(2))
    g = K.flash_cross_attention_res(q.reshape(-1, T5, hs5), k.reshape(J6, -1, T5, hs5),
                                    v.reshape(J6, -1, T5, hs5), rate, SALTS)
    ql = q[h6:].reshape(-1, T5, hs5).contiguous()
    kl, vl = (t[:, h6:].reshape(J6, -1, T5, hs5).contiguous() for t in (k, v))
    rows = dp_row_map((h6, H6), 0, h6, B6)
    got = K.flash_cross_attention_res(ql, kl, vl, rate, SALTS, rows)
    plain = K.flash_cross_attention_plain(ql, kl, vl, rate, SALTS, residuals=True, rows=rows)
    bad = K.flash_cross_attention_res(ql, kl, vl, rate, SALTS, (rows[0], rows[1], 0))[0]
    rs = slice(h6 * H6, B6 * H6)
    report("flash_cross_attention_res", (J6, B6 * H6, T5, hs5),
           {o: (a, b) for o, a, b in zip(("out", "outs", "lses"), got,
                                         (g[0][rs], g[1][:, rs], g[2][:, rs]))},
           {o: (a, b) for o, a, b in zip(("out", "outs", "lses"), got, plain)},
           {"out": (bad, g[0][rs])}, {"row_map": list(rows)})
    if failed:
        raise AssertionError(f"data-parallel kernel calls disagree with the global call or "
                             f"their plain versions, or the zero offset passed: {failed}")


# tensor parallelism: rank 1 of a model axis of 2 holds heads [H / 2, H),
# the heads whose offset matters
TP_RANKS = 2


def tp_row_map(lead, batch_axis, head_axis, start: int, total: int, h0: int, n_head: int):
    """The global-row launch arguments of collapsed rows of the leading axes
    ``lead`` whose axis ``head_axis`` holds heads [h0, h0 + lead[head_axis])
    of ``n_head`` and, where ``batch_axis`` is given, whose batch axis holds
    rows [start, start + lead[batch_axis]) of ``total``."""
    from trade_aid_multimodal_transformer_tpu_torch.ops.layers import (
        batch_row_map, batch_slice_scope, head_slice_scope)

    with batch_slice_scope(start, total), head_slice_scope(h0, lead[head_axis], n_head):
        return batch_row_map(lead, batch_axis, head_axis)


def head_cols(w, h0: int, per: int, H: int, dim: int, width: int):
    """Heads [h0, h0 + per) of each of the three q/k/v groups of a fused
    weight whose dimension ``dim`` holds 3 groups of H heads of ``width``."""
    import torch

    return torch.cat([w.narrow(dim, (g * H + h0) * width, per * width) for g in range(3)],
                     dim).contiguous()


def tp_kernel_check(K, card, gen):
    """kernel_check under tensor parallelism: rank 1 of ``{model: 2}``
    (heads [3, 6) of 6) calls K1f and K1b (the production step's x (4, 32,
    64, 384): its heads' columns of w1, b1 and w2, ``heads`` = (3, 6)), K2f
    and K2b (its head-major cross rows (3, 32, 64, 64) against 3 streams),
    K5f and K5b (the long step's self-attention rows (4, 8, 3, 1024, 64))
    and K6f, K6f-r (its cross rows (8, 3, 1024, 64) against 3 streams),
    bf16, dropout 0.2, with the global-head arguments; K1 and the flash
    kernels also as rank (1, 1) of ``{data: 2, model: 2}`` (the second half
    of the batch as well: two row levels for the flash kernels). Held
    against the global call's heads (dx of K1b as the two head halves' sum,
    the weight gradients as the rank's columns of the global call's) and
    against the plain version on the same inputs, REL_TOL; the head offset
    forced to 0 must fail against the global heads. One line per kernel
    and layout; raises on a failure."""
    import torch

    from trade_aid_multimodal_transformer_tpu_torch.ops.layers import map_rows

    dev, bf, rate, tol = torch.device("cuda"), torch.bfloat16, 0.2, REL_TOL["bfloat16"]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    failed = []

    def report(name, layout, shape, vs_global, vs_plain, planted, extra=None):
        torch.cuda.synchronize()
        errs_g = {o: rel_err(a, b) for o, (a, b) in vs_global.items()}
        errs_p = {o: rel_err(a, b) for o, (a, b) in vs_plain.items()}
        bits = {o: bool(torch.equal(a, b)) for o, (a, b) in vs_global.items()}
        offset_0 = max(rel_err(a, b) for a, b in planted.values())
        ok = max(errs_g.values()) <= tol and max(errs_p.values()) <= tol and offset_0 > tol
        emit({"phase": "tp_kernel_check", "kernel": name, "layout": layout, "card": card,
              "shape": list(shape), "dtype": "bfloat16", "dropout": rate,
              "bit_equal_to_global": bits, "rel_err_vs_global": errs_g,
              "rel_err_vs_plain": errs_p, "head_offset_0_rel_err_vs_global": offset_0,
              "tol": tol, **(extra or {}), "ok": ok})
        if not ok:
            failed.append(f"{name} {layout}")

    # K1f, K1b: the rank's heads' columns; gb from the global batch and heads
    M, B, T, C, H, hs = PROD_K1
    per, hs2 = H // TP_RANKS, hs // 2
    x, w1 = randn(M, B, T, C).to(bf), randn(M, C, 3 * H * hs2, scale=0.05)
    b1, w2 = randn(M, 3 * H * hs2, scale=0.05), randn(M, 3 * H, hs2, hs, scale=0.2)
    dout = randn(M, H, B, T, hs).to(bf)
    g_out = K.fused_qkv_attention_fwd(x, w1, b1, w2, H, rate, SALTS)
    g_grads = K.fused_qkv_attention_bwd(x, w1, b1, w2, g_out, dout, H, rate, SALTS)
    names = ("dx", "dw1", "db1", "dw2")
    for layout, (start, nb) in (("model 2", (0, B)), ("data 2 x model 2", (B // 2, B // 2))):
        rows_b = slice(start, start + nb)
        xl = x[:, rows_b].contiguous()
        batch = (start, B) if nb < B else None
        halves = []
        for h0 in (0, per):
            w1l, b1l = head_cols(w1, h0, per, H, 2, hs2), head_cols(b1, h0, per, H, 1, hs2)
            w2l = head_cols(w2, h0, per, H, 1, 1)
            dl = dout[:, h0:h0 + per, rows_b].contiguous()
            out = K.fused_qkv_attention_fwd(xl, w1l, b1l, w2l, per, rate, SALTS, batch, (h0, H))
            halves.append((w1l, b1l, w2l, dl, out, K.fused_qkv_attention_bwd(
                xl, w1l, b1l, w2l, out, dl, per, rate, SALTS, batch, (h0, H))))
        w1l, b1l, w2l, dl, out, grads = halves[1]
        p_out = K.fused_qkv_attention_plain(xl, w1l, b1l, w2l, per, rate, SALTS, batch, (per, H))
        p_grads = K.fused_qkv_attention_bwd_plain(xl, w1l, b1l, w2l, out, dl, per, rate, SALTS,
                                                  batch, (per, H))
        vs_global = {"out": (out, g_out[:, per:, rows_b]),
                     "dx": (halves[0][5][0].float() + grads[0].float(),
                            g_grads[0][:, rows_b].float())}
        if nb == B:  # the rank's columns of the global call's weight gradients
            g_cols = (head_cols(g_grads[1], per, per, H, 2, hs2),
                      head_cols(g_grads[2], per, per, H, 1, hs2),
                      head_cols(g_grads[3], per, per, H, 1, 1))
            vs_global.update(zip(names[1:], zip(grads[1:], g_cols)))
        report("fused_qkv_attention + fused_qkv_attention_bwd", layout, (M, nb, T, C, per, hs),
               vs_global,
               {"out": (out, p_out), **{o: (a, b) for o, a, b in zip(names, grads, p_grads)}},
               {"out": (K.fused_qkv_attention_fwd(xl, w1l, b1l, w2l, per, rate, SALTS, batch,
                                                  (0, H)), g_out[:, per:, rows_b])},
               {"dx": "the two head halves' sum against the global call's",
                "weight_gradients": "the rank's columns of the global call's",
                "gb_global": K.fqkv_pick_gb(B, H, T, hs, C, 2),
                "gb_local_heads": K.fqkv_pick_gb(nb, per, T, hs, C, 2)}
               if nb == B else {"weight_gradients": "not held (half the batch)"})
    del x, dout, g_out, g_grads, halves

    # K2f, K2b: head-major q (H, B, T, hs), k, v (J, H, B, T, hs)
    J, T2, hs2_ = 3, 64, 64
    B2 = 32
    q, k, v, do = (randn(*s_).to(bf) for s_ in ((H, B2, T2, hs2_), (J, H, B2, T2, hs2_),
                                                 (J, H, B2, T2, hs2_), (H, B2, T2, hs2_)))
    g_out = K.short_cross_attention_fwd(q, k, v, rate, SALTS)
    g_grads = K.short_cross_attention_bwd(q, k, v, do, rate, SALTS)
    ql, dl = q[per:].contiguous(), do[per:].contiguous()
    kl, vl = k[:, per:].contiguous(), v[:, per:].contiguous()
    rows = tp_row_map((per, B2), None, 0, 0, B2, per, H)
    out = K.short_cross_attention_fwd(ql, kl, vl, rate, SALTS, rows)
    grads = K.short_cross_attention_bwd(ql, kl, vl, dl, rate, SALTS, rows)
    p_out = K.short_cross_attention_plain(ql, kl, vl, rate, SALTS, rows)
    p_grads = K.short_cross_attention_bwd_plain(ql, kl, vl, dl, rate, SALTS, rows)
    bad = K.short_cross_attention_fwd(ql, kl, vl, rate, SALTS, (rows[0], rows[1], 0))
    report("short_cross_attention + short_cross_attention_bwd", "model 2", (J, per * B2, T2, hs2_),
           {"out": (out, g_out[per:]), "dq": (grads[0], g_grads[0][per:]),
            "dk": (grads[1], g_grads[1][:, per:]), "dv": (grads[2], g_grads[2][:, per:])},
           {"out": (out, p_out), **{o: (a, b) for o, a, b in zip(("dq", "dk", "dv"), grads,
                                                                p_grads)}},
           {"out": (bad, g_out[per:])}, {"row_map": list(rows)})
    del q, k, v, do

    # K5f, K5b: the long step's self-attention rows (M, B, H) collapsed
    M5, B5, H5, T5, hs5 = 4, 8, 6, LONG_BLOCK, 64
    q, k, v, do = (randn(M5, B5, H5, T5, hs5).to(bf) for _ in range(4))
    flat = lambda t: t.reshape(-1, T5, hs5).contiguous()  # noqa: E731
    g_out, g_lse = K.flash_attention_fwd(flat(q), flat(k), flat(v), rate, SALTS)
    g_grads = K.flash_attention_bwd(flat(q), flat(k), flat(v), g_out, g_lse, flat(do), rate,
                                    SALTS)
    for layout, start, nb in (("model 2", 0, B5), ("data 2 x model 2", B5 // 2, B5 // 2)):
        ql, kl, vl, dl = (flat(t[:, start:start + nb, per:]) for t in (q, k, v, do))
        rows = tp_row_map((M5, nb, per), 1 if nb < B5 else None, 2, start, B5, per, H5)
        idx = map_rows(torch.arange(ql.shape[0], device=dev), rows)
        out, lse = K.flash_attention_fwd(ql, kl, vl, rate, SALTS, rows)
        grads = K.flash_attention_bwd(ql, kl, vl, out, lse, dl, rate, SALTS, rows=rows)
        p_out, p_lse = K.flash_attention_plain(ql, kl, vl, rate, SALTS, rows)
        p_grads = K.flash_attention_bwd_plain(ql, kl, vl, out, lse, dl, rate, SALTS, rows=rows)
        bad_rows = tuple(rows[:2]) + (rows[2] - per,) + tuple(rows[3:])
        bad = K.flash_attention_fwd(ql, kl, vl, rate, SALTS, bad_rows)[0]
        report("flash_attention + flash_attention_bwd", layout, (M5, nb, per, T5, hs5),
               {"out": (out, g_out[idx]), "lse": (lse, g_lse[idx]),
                **{o: (a, g[idx]) for o, a, g in zip(("dq", "dk", "dv"), grads, g_grads)}},
               {"out": (out, p_out), "lse": (lse, p_lse),
                **{o: (a, b) for o, a, b in zip(("dq", "dk", "dv"), grads, p_grads)}},
               {"out": (bad, g_out[idx])}, {"row_map": list(rows)})
    del q, k, v, do

    # K6f, K6f-r: the long step's cross rows (B, H) in JAX's order
    J6, B6, H6 = 3, 8, 6
    q = randn(B6, H6, T5, hs5).to(bf)
    k, v = (randn(J6, B6, H6, T5, hs5).to(bf) for _ in range(2))
    g = K.flash_cross_attention_res(q.reshape(-1, T5, hs5), k.reshape(J6, -1, T5, hs5),
                                    v.reshape(J6, -1, T5, hs5), rate, SALTS)
    for layout, start, nb in (("model 2", 0, B6), ("data 2 x model 2", B6 // 2, B6 // 2)):
        ql = q[start:start + nb, per:].reshape(-1, T5, hs5).contiguous()
        kl, vl = (t[:, start:start + nb, per:].reshape(J6, -1, T5, hs5).contiguous()
                  for t in (k, v))
        rows = tp_row_map((nb, per), 0 if nb < B6 else None, 1, start, B6, per, H6)
        idx = map_rows(torch.arange(ql.shape[0], device=dev), rows)
        got = K.flash_cross_attention_res(ql, kl, vl, rate, SALTS, rows)
        summed = K.flash_cross_attention_fwd(ql, kl, vl, rate, SALTS, rows)
        plain = K.flash_cross_attention_plain(ql, kl, vl, rate, SALTS, residuals=True, rows=rows)
        bad_rows = tuple(rows[:2]) + (rows[2] - per,) + tuple(rows[3:])
        bad = K.flash_cross_attention_res(ql, kl, vl, rate, SALTS, bad_rows)[0]
        report("flash_cross_attention + flash_cross_attention_res", layout,
               (J6, nb * per, T5, hs5),
               {"out": (got[0], g[0][idx]), "outs": (got[1], g[1][:, idx]),
                "lses": (got[2], g[2][:, idx]), "K6f_out": (summed, g[0][idx])},
               {o: (a, b) for o, a, b in zip(("out", "outs", "lses"), got, plain)},
               {"out": (bad, g[0][idx])}, {"row_map": list(rows)})
    if failed:
        raise AssertionError(f"tensor-parallel kernel calls disagree with the global call or "
                             f"their plain versions, or the zero head offset passed: {failed}")


# modality parallelism: modality place 1 of {mod: 2} holds modalities [2, 4)
# of the production config's 4
MOD_RANKS = 2


def mod_row_map(lead, batch_axis, start: int, total: int, m0: int, n_mod: int):
    """The global-row launch arguments of collapsed rows of the leading axes
    ``lead`` whose axis 0 holds modalities [m0, m0 + lead[0]) of ``n_mod``
    and, where ``batch_axis`` is given, whose batch axis holds rows [start,
    start + lead[batch_axis]) of ``total``."""
    from trade_aid_multimodal_transformer_tpu_torch.ops.layers import (
        batch_row_map, batch_slice_scope, mod_slice_scope)

    with batch_slice_scope(start, total), mod_slice_scope(m0, lead[0], n_mod):
        return batch_row_map(lead, batch_axis, None, 0)


def mod_kernel_check(K, card, gen):
    """kernel_check under modality parallelism: modality place 1 of ``{mod:
    2}`` (modalities [2, 4) of 4) calls K1f and K1b (the production step's x
    (2 of 4 modalities, 32, 64, 384), its modalities' slices of w1, b1 and
    w2, ``mods`` = (2, 4)) and K5f and K5b (the long step's self-attention
    rows (2 of 4, 8, 6, 1024, 64): the modality level in the row map's
    base), bf16, dropout 0.2; both also as rank (1, 1) of ``{mod: 2, data:
    2}`` (the second half of the batch too). Held against the global call's
    rows (K1b's weight gradients: the rank's modalities' slices) and the
    plain version, REL_TOL; the modality offset forced to 0 must fail
    against the global call. K6f-r runs once per querying modality on (B,
    H) rows, whose map a modality scope leaves the one-rank map: its call
    inside rank 1's scope is held bit-equal to the one-rank call and within
    REL_TOL of its plain version. One line per kernel and layout; raises on
    a failure."""
    import torch

    from trade_aid_multimodal_transformer_tpu_torch.ops.layers import (
        batch_row_map, map_rows, mod_slice_scope)

    dev, bf, rate, tol = torch.device("cuda"), torch.bfloat16, 0.2, REL_TOL["bfloat16"]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    failed = []

    def report(name, layout, shape, vs_global, vs_plain, planted, extra=None):
        torch.cuda.synchronize()
        errs_g = {o: rel_err(a, b) for o, (a, b) in vs_global.items()}
        errs_p = {o: rel_err(a, b) for o, (a, b) in vs_plain.items()}
        bits = {o: bool(torch.equal(a, b)) for o, (a, b) in vs_global.items()}
        offset_0 = max((rel_err(a, b) for a, b in planted.values()), default=None)
        ok = (max(errs_g.values()) <= tol and max(errs_p.values()) <= tol
              and (offset_0 is None or offset_0 > tol))
        emit({"phase": "mod_kernel_check", "kernel": name, "layout": layout, "card": card,
              "shape": list(shape), "dtype": "bfloat16", "dropout": rate,
              "bit_equal_to_global": bits, "rel_err_vs_global": errs_g,
              "rel_err_vs_plain": errs_p, "mod_offset_0_rel_err_vs_global": offset_0,
              "tol": tol, **(extra or {}), "ok": ok})
        if not ok:
            failed.append(f"{name} {layout}")

    # K1f, K1b: modalities [2, 4) of the production step's x
    M, B, T, C, H, hs = PROD_K1
    m0, per, hs2 = M // MOD_RANKS, M // MOD_RANKS, hs // 2
    mine = slice(m0, m0 + per)
    x, w1 = randn(M, B, T, C).to(bf), randn(M, C, 3 * H * hs2, scale=0.05)
    b1, w2 = randn(M, 3 * H * hs2, scale=0.05), randn(M, 3 * H, hs2, hs, scale=0.2)
    dout = randn(M, H, B, T, hs).to(bf)
    g_out = K.fused_qkv_attention_fwd(x, w1, b1, w2, H, rate, SALTS)
    g_grads = K.fused_qkv_attention_bwd(x, w1, b1, w2, g_out, dout, H, rate, SALTS)
    names = ("dx", "dw1", "db1", "dw2")
    w1l, b1l, w2l = (w[mine].contiguous() for w in (w1, b1, w2))
    for layout, (start, nb) in (("mod 2", (0, B)), ("mod 2 x data 2", (B // 2, B // 2))):
        rows_b = slice(start, start + nb)
        xl = x[mine, rows_b].contiguous()
        dl = dout[mine, :, rows_b].contiguous()
        batch = (start, B) if nb < B else None
        mods = (m0, M)
        out = K.fused_qkv_attention_fwd(xl, w1l, b1l, w2l, H, rate, SALTS, batch, None, mods)
        grads = K.fused_qkv_attention_bwd(xl, w1l, b1l, w2l, out, dl, H, rate, SALTS, batch,
                                          None, mods)
        p_out = K.fused_qkv_attention_plain(xl, w1l, b1l, w2l, H, rate, SALTS, batch, None, mods)
        p_grads = K.fused_qkv_attention_bwd_plain(xl, w1l, b1l, w2l, out, dl, H, rate, SALTS,
                                                  batch, None, mods)
        vs_global = {"out": (out, g_out[mine, :, rows_b]),
                     "dx": (grads[0], g_grads[0][mine, rows_b])}
        if nb == B:  # the rank's modalities' slices of the weight gradients
            vs_global.update({o: (a, g[mine]) for o, a, g in zip(names[1:], grads[1:],
                                                                 g_grads[1:])})
        bad = K.fused_qkv_attention_fwd(xl, w1l, b1l, w2l, H, rate, SALTS, batch, None, (0, M))
        report("fused_qkv_attention + fused_qkv_attention_bwd", layout, (per, nb, T, C, H, hs),
               vs_global,
               {"out": (out, p_out), **{o: (a, b) for o, a, b in zip(names, grads, p_grads)}},
               {"out": (bad, g_out[mine, :, rows_b])},
               {"mods": list(mods), "launch_first_row": start + m0 * B})
    del x, dout, g_out, g_grads

    # K5f, K5b: the long step's self-attention rows (M, B, H) collapsed
    M5, B5, H5, T5, hs5 = 4, 8, 6, LONG_BLOCK, 64
    q, k, v, do = (randn(M5, B5, H5, T5, hs5).to(bf) for _ in range(4))
    flat = lambda t: t.reshape(-1, T5, hs5).contiguous()  # noqa: E731
    g_out, g_lse = K.flash_attention_fwd(flat(q), flat(k), flat(v), rate, SALTS)
    g_grads = K.flash_attention_bwd(flat(q), flat(k), flat(v), g_out, g_lse, flat(do), rate,
                                    SALTS)
    for layout, start, nb in (("mod 2", 0, B5), ("mod 2 x data 2", B5 // 2, B5 // 2)):
        ql, kl, vl, dl = (flat(t[2:4, start:start + nb]) for t in (q, k, v, do))
        rows = mod_row_map((2, nb, H5), 1 if nb < B5 else None, start, B5, 2, M5)
        idx = map_rows(torch.arange(ql.shape[0], device=dev), rows)
        out, lse = K.flash_attention_fwd(ql, kl, vl, rate, SALTS, rows)
        grads = K.flash_attention_bwd(ql, kl, vl, out, lse, dl, rate, SALTS, rows=rows)
        p_out, p_lse = K.flash_attention_plain(ql, kl, vl, rate, SALTS, rows)
        p_grads = K.flash_attention_bwd_plain(ql, kl, vl, out, lse, dl, rate, SALTS, rows=rows)
        bad_rows = tuple(rows[:2]) + (rows[2] - 2 * B5 * H5,) + tuple(rows[3:])
        bad = K.flash_attention_fwd(ql, kl, vl, rate, SALTS, bad_rows)[0]
        report("flash_attention + flash_attention_bwd", layout, (2, nb, H5, T5, hs5),
               {"out": (out, g_out[idx]), "lse": (lse, g_lse[idx]),
                **{o: (a, g[idx]) for o, a, g in zip(("dq", "dk", "dv"), grads, g_grads)}},
               {"out": (out, p_out), "lse": (lse, p_lse),
                **{o: (a, b) for o, a, b in zip(("dq", "dk", "dv"), grads, p_grads)}},
               {"out": (bad, g_out[idx])}, {"row_map": list(rows)})
    del q, k, v, do

    # K6f-r: one querying modality's cross rows (B, H) in JAX's order
    J6, B6, H6 = 3, 8, 6
    q = randn(B6, H6, T5, hs5).to(bf)
    k, v = (randn(J6, B6, H6, T5, hs5).to(bf) for _ in range(2))
    qf, kf, vf = q.reshape(-1, T5, hs5), k.reshape(J6, -1, T5, hs5), v.reshape(J6, -1, T5, hs5)
    g = K.flash_cross_attention_res(qf, kf, vf, rate, SALTS)
    with mod_slice_scope(2, 2, 4):
        rows = batch_row_map((B6, H6), 0, 1)
    got = K.flash_cross_attention_res(qf, kf, vf, rate, SALTS, rows)
    plain = K.flash_cross_attention_plain(qf, kf, vf, rate, SALTS, residuals=True, rows=rows)
    report("flash_cross_attention_res", "mod 2", (J6, B6 * H6, T5, hs5),
           {o: (a, b) for o, a, b in zip(("out", "outs", "lses"), got, g)},
           {o: (a, b) for o, a, b in zip(("out", "outs", "lses"), got, plain)}, {},
           {"row_map_in_scope": rows, "no_modality_level": rows is None,
            "bit_equal_required": True})
    if rows is not None or not all(torch.equal(a, b) for a, b in zip(got, g)):
        failed.append("flash_cross_attention_res: a modality level reached the cross rows")
    if failed:
        raise AssertionError(f"modality-parallel kernel calls disagree with the global call or "
                             f"their plain versions, or the zero modality offset passed: {failed}")


def dp_rank(rank: int, world: int, job: dict):
    """One rank of ``dp_reference``, in a process of its own: the ranks
    share the one card, so the data axis reduces through host memory (gloo,
    staged). Rank 0 first takes the one-rank step on the card on the global
    batch (the plain Trainer); then every rank takes the data-parallel step
    (its half of the batch, masks keyed by global rows, the gradients
    averaged) and an AdamW update, sound and with rank 1's row offset forced
    to 0. Returns each variant's loss, launches, parameter checksum and, on
    rank 0, its errors against the one-rank step."""
    sys.path.insert(0, str(REPO))
    import torch

    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        map_tree, tree_leaves, tree_paths)
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import make_sharded_trainer
    from trade_aid_multimodal_transformer_tpu_torch.train import steps as tsteps
    from trade_aid_multimodal_transformer_tpu_torch.train.runner import param_checksum

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = job["cfg"]
    mesh = pmesh.make_mesh(data=world, staged=True)
    xb, yb = (t.to(dev) for t in job["batch"])

    def fresh():
        return map_tree(lambda t: t.detach().to(dev).clone().requires_grad_(), job["params"])

    def optimizer():
        return tsteps.make_optimizer(job["lr"], moment_dtype="bfloat16", nu_dtype="bfloat16")

    if rank == 0:
        loss_ref, g_ref = tsteps.Trainer(cfg, None, optimizer(), [], 1).loss_and_grads(
            fresh(), [(xb, yb)], [SALTS])
        loss_ref, g_ref = loss_ref.item(), [g.float() for g in g_ref]
        norms = [r.norm().item() for r in g_ref]
        names = ["/".join(map(str, path)) for path, _ in tree_paths(job["params"])]
    out = {}
    for variant in ("sound", "offset_0"):
        params, opt = fresh(), optimizer()
        state = opt.init(params)
        trainer = make_sharded_trainer(cfg, None, opt, [], 1, mesh)
        real = tsteps.batch_slice_scope
        if variant == "offset_0" and rank == 1:
            tsteps.batch_slice_scope = lambda start, total: real(0, total)
        try:
            K.reset_launch_counts()
            loss, grads = trainer.loss_and_grads(params, [(xb, yb)], [SALTS])
            torch.cuda.synchronize()
            counts = K.launch_counts()
            opt.update_(params, grads, state)
        finally:
            tsteps.batch_slice_scope = real
        res = {"loss": loss.item(), "launches": counts, "checksum": param_checksum(params)}
        if rank == 0:
            # each leaf against its own scale; a leaf below a 1e-4 share of
            # the whole (the key biases' gradients, rounding noise) is held
            # to that share, as the CPU tests hold theirs. The token tables'
            # gradients are bf16 scatter-adds over every token of the batch
            # (the gather's backward, as in the JAX package), which sum 2048
            # rows in one order on one rank and 1024 a half on two: they
            # are held apart, at STEP_TOL's bf16 leaf limit
            floor = 1e-4 * math.sqrt(sum(n_ * n_ for n_ in norms))
            errs_leaf = [(g.float() - r).norm().item() / max(n_, floor)
                         for g, r, n_ in zip(grads, g_ref, norms)]
            table = [name.startswith("pre/tok_emb/") for name in names]
            res.update(loss_ref=loss_ref, loss_abs_err=abs(loss.item() - loss_ref),
                       grad_l2_rel_err_max=max(e for e, t in zip(errs_leaf, table) if not t),
                       token_table_grad_l2_rel_err_max=max(e for e, t in zip(errs_leaf, table)
                                                           if t),
                       worst_leaves=sorted(zip(errs_leaf, names), reverse=True)[:4])
        out[variant] = res
    return out


def per_step(collectives, kind: str):
    """(bytes of the last call, mean ms a call, calls) of one kind of a
    run's timed collectives (``runner`` result ``collectives``)."""
    calls = [(n_, t_) for k_, n_, t_ in collectives or [] if k_ == kind]
    if not calls:
        return None, None, 0
    return calls[-1][0], 1e3 * sum(t_ for _, t_ in calls) / len(calls), len(calls)


def state_bytes(cfg, data: int = 1, model: int = 1, fsdp: bool = False, mod: int = 1) -> tuple:
    """(total, per rank) bytes of the train state the production config
    trains (f32 parameters, bf16 mu and nu, the int32 count) over a model
    axis of ``model`` ranks, a modality axis of ``mod`` and, with ``fsdp``,
    a data axis of ``data``, from the tree's shapes and ``param_pspecs``: a
    leaf it puts on 'model' at 1/model, on 'mod' at 1/mod, on 'data' at
    1/data (on several at the product) on every rank, every other leaf
    whole."""
    from trade_aid_multimodal_transformer_tpu_torch.models.init import param_shapes, tree_leaves
    from trade_aid_multimodal_transformer_tpu_torch.parallel.mesh import param_pspecs

    shapes = param_shapes(cfg)
    specs = param_pspecs(shapes, n_head=0, model_axis=model > 1, model_size=model,
                         mod_axis=mod > 1, mod_size=mod, fsdp_size=data if fsdp else 1)
    per_element = 4 + 2 + 2
    sizes = [math.prod(shape) for _, shape in tree_leaves(shapes)]
    held = sum(n // ((model if "model" in spec else 1) * (data if "data" in spec else 1)
                     * (mod if "mod" in spec else 1))
               for n, spec in zip(sizes, specs))
    return per_element * sum(sizes) + 4, per_element * held + 4


def data_parallel(K, card, by_path):
    """Data parallelism (``tpu_options.mesh: {data: 2}``) on the one card,
    two ranks sharing it (gloo through host memory): ``dp_reference``, one
    production training step (block_size 64, global batch 32, dropout 0.2,
    bf16) against the one-rank step on the global batch with the same salts
    (loss within STEP_TOL, every all-reduced gradient leaf within REL_TOL),
    which the step with rank 1's row offset forced to 0 must exceed, both
    ranks' parameters bit-equal after the update; ``dp_training``, the
    training entry over the two ranks for 4 steps against the one-rank
    entry with the same seed (final eval losses within STEP_TOL, the ranks'
    parameter checksums equal, the eval train loss falling, exact launches
    per rank), with its steps/s and the gradient all-reduce's bytes and
    milliseconds per step. Adds to ``by_path``; returns the entry runs (the
    data-parallel one with each rank's result and its last checkpoint's
    arrays) for ``fsdp_phases``; raises on a failed check."""
    import numpy as np
    import torch

    from trade_aid_multimodal_transformer_tpu_torch import generate as entry
    from trade_aid_multimodal_transformer_tpu_torch.models.init import init_params
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
    from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import _read_native

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d)
        data = entry.load_config_and_data(str(d))
    cfg, sc = data["cfg"], data["sc"]
    L, n_cross = cfg.n_layer, sum(cfg.cross_attention)
    per_step = dict(fused_qkv_attention=L, fused_qkv_attention_bwd=L,
                    short_cross_attention=n_cross * L, short_cross_attention_bwd=n_cross * L)
    want_step = {**dict.fromkeys(K.KERNELS, 0), **per_step}

    # dp_reference
    rng = np.random.default_rng(13)
    B = sc["batch_size"]
    ids = torch.from_numpy(np.stack([rng.integers(0, v, (B, cfg.block_size + 1))
                                     for v in cfg.vocab_sizes]))
    params = init_params(cfg, torch.Generator().manual_seed(1234), "cpu")
    # the dp_training entry over the two ranks runs after the reference
    # step in the same start of the rank processes
    config = dict(PARALLEL_ENTRY)
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    production_config_dir(d, **config)
    text = (d / "config.yaml").read_text()
    if text.count("  mesh: auto") != 1:
        raise AssertionError("production config has no single mesh: auto")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res, (dp,) = entry_runs(
        K, [(d, text.replace("  mesh: auto", "  mesh: {data: 2}"), None)], DP_RANKS,
        before=(dp_rank, (dict(cfg=cfg, params=params, batch=(ids[..., :-1], ids[..., 1:]),
                               lr=sc["learning_rate"]),)))
    sec = time.perf_counter() - t0
    tol = STEP_TOL["bfloat16"]["loss"], REL_TOL["bfloat16"]
    lines = {}
    for variant in ("sound", "offset_0"):
        r0 = res[0][variant]
        within = (r0["loss_abs_err"] <= tol[0] and r0["grad_l2_rel_err_max"] <= tol[1]
                  and r0["token_table_grad_l2_rel_err_max"] <= STEP_TOL["bfloat16"]["grad_l2"])
        equal = all(res[r][variant]["checksum"] == r0["checksum"] for r in range(DP_RANKS))
        counts_ok = all(res[r][variant]["launches"] == want_step for r in range(DP_RANKS))
        ok = counts_ok and equal and (within if variant == "sound" else not within)
        lines[variant] = ok
        emit({"phase": "dp_reference", "variant": variant, "card": card,
              "ranks_on_one_card": DP_RANKS, "backend": "gloo through host memory",
              "config": "examples/production_config.yaml", "global_batch": B,
              "block_size": cfg.block_size, "dropout": cfg.dropout, "dtype": cfg.compute_dtype,
              "against": "the one-rank step on the card on the global batch, same salts",
              "must_fail": variant == "offset_0", "loss_tol": tol[0], "grad_l2_rel_tol": tol[1],
              "token_table_grad_l2_rel_tol": STEP_TOL["bfloat16"]["grad_l2"],
              **{k_: r0[k_] for k_ in ("loss_ref", "loss_abs_err", "grad_l2_rel_err_max",
                                       "token_table_grad_l2_rel_err_max", "worst_leaves")},
              "losses_by_rank": [res[r][variant]["loss"] for r in range(DP_RANKS)],
              "params_bit_equal_after_update": equal,
              "launches_by_rank": [{k_: v_ for k_, v_ in res[r][variant]["launches"].items() if v_}
                                   for r in range(DP_RANKS)], "launches_exact": counts_ok,
              "seconds_with_spawn_and_entry": sec, "ok": ok})
    if not all(lines.values()):
        raise AssertionError("the data-parallel step disagrees with the one-rank step, the ranks "
                             "differ, or the gate passed the zero offset")

    # dp_training: the entry over two ranks (run above), then the one-rank
    # entry, seed 5 (the data-parallel run's last checkpoint kept for
    # fsdp_training)
    dp["checkpoint"] = _read_native(str(d / "output" / "model.ckpt"))
    (d / "config.yaml").write_text(text.replace("  mesh: auto", "  mesh: \"off\""))
    runs = {"{data: 2}": dp, "\"off\"": entry_run(K, d)}
    tmp.cleanup()
    one = runs["\"off\""]
    eval_batches = expected_evals(config["max_iters"], config["eval_interval"]) * 2 * 2
    per_eval = dict(fused_qkv_attention=L, short_cross_attention=n_cross * L)
    want = {**dict.fromkeys(K.KERNELS, 0),
            **{name: n_ * config["max_iters"] + per_eval.get(name, 0) * eval_batches
               for name, n_ in per_step.items()}}
    sums = dp["param_checksums"]
    errs_ = {k_: abs(dp["losses"][k_] - one["losses"][k_]) for k_ in ("train", "val")}
    ar = [(n_, t_) for k_, n_, t_ in dp["collectives"] or [] if k_ == "all_reduce"]
    ok = (len(sums) == DP_RANKS and all(s == sums[0] for s in sums)
          and all(e <= STEP_TOL["bfloat16"]["loss"] for e in errs_.values())
          and len(dp["evals"]) == len(one["evals"]) > 1 and dp["evals"][-1][1] < dp["evals"][0][1]
          and dp["launches"] == want and one["launches"] == want
          and "Parallelism: data x2 over 2 devices" in dp["console"]
          and "TRAINING COMPLETED SUCCESSFULLY" in dp["console"] and len(ar) == config["max_iters"])
    by_path["dp_training"] = dp["launches"]
    emit({"phase": "dp_training", "config": "examples/production_config.yaml", "card": card,
          "changed": {**config, "mesh": "{data: 2}"}, "ranks_on_one_card": DP_RANKS,
          "backend": "gloo through host memory", "plan": dp["plan"].describe(),
          "global_batch": B, "dropout": cfg.dropout, "evals": dp["evals"],
          "evals_one_rank": one["evals"], "final_eval_losses": dp["losses"],
          "final_eval_losses_one_rank": one["losses"], "abs_err_vs_one_rank": errs_,
          "tol": STEP_TOL["bfloat16"]["loss"], "param_checksums_by_rank": sums,
          "steps_per_s_after_first_chunk": dp["steps_per_s"],
          "steps_per_s_one_rank": one["steps_per_s"],
          "allreduce_bytes_per_step": ar[-1][0] if ar else None,
          "allreduce_ms_per_step": 1e3 * sum(t for _, t in ar) / len(ar) if ar else None,
          "allreduce_note": "host clock around the staged gloo all-reduce (copy to the host, "
                            "reduce, copy back), the card synchronised before and after",
          "launches_rank0": dp["launches"], "expected_launches_per_rank": want,
          "seconds_with_spawn": dp["seconds"], "ok": ok})
    if not ok:
        raise AssertionError("the data-parallel training entry failed its checks")
    return runs


def fsdp_rank(rank: int, world: int, job: dict):
    """One rank of ``fsdp_reference``, in a process of its own (the ranks
    share the one card: gloo through host memory). Each variant starts from
    the same parameters and takes one production step (the data-parallel
    trainer's ``loss_and_grads`` on the global batch, then the AdamW
    update): ``dp`` and ``dp_again`` without FSDP, ``fsdp`` with it, and two
    planted faults: rank 1 holding rank 0's slices, and the reduce-scatter
    handing each rank the other's chunk. Returns per variant the loss, the
    launches, the train-state bytes the rank holds (the per-device figure,
    the tensors' bytes, the allocated bytes they added) and, against
    ``dp``, whether the gathered parameters, mu, nu and count and the
    rank's parts (its slices of ``dp``'s) are bit-equal."""
    sys.path.insert(0, str(REPO))
    import torch

    from trade_aid_multimodal_transformer_tpu_torch.models.init import map_tree, tree_leaves
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import (
        Fsdp, make_sharded_trainer, shard_train_state)
    from trade_aid_multimodal_transformer_tpu_torch.train import steps as tsteps
    from trade_aid_multimodal_transformer_tpu_torch.utils.memory import train_state_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = job["cfg"]
    mesh = pmesh.make_mesh(data=world, staged=True)
    xb, yb = (t.to(dev) for t in job["batch"])

    def fresh():
        return map_tree(lambda t: t.detach().to(dev).clone().requires_grad_(), job["params"])

    def equal(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    def max_diff(a, b) -> float:
        return max((x.float() - y.float()).abs().max().item()
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    out, ref = {}, None
    for variant in ("dp", "dp_again", "fsdp", "fsdp_rank1_keeps_rank0_slice",
                    "fsdp_reduce_scatter_reversed"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        opt = tsteps.make_optimizer(job["lr"], moment_dtype="bfloat16", nu_dtype="bfloat16")
        params = fresh()
        params, state, placed = shard_train_state(params, opt.init(params), mesh.data,
                                                  variant.startswith("fsdp"))
        if variant == "fsdp_rank1_keeps_rank0_slice" and rank == 1:
            params = Fsdp(placed.specs, pmesh.DataAxis(0, world)).shard(fresh())
        torch.cuda.synchronize()
        held_allocated = torch.cuda.memory_allocated() - base
        trees = (params, state["mu"], state["nu"])
        tensors = sum(t.numel() * t.element_size() for tr in trees for t in tree_leaves(tr))
        total, per_dev = train_state_bytes(params, state, opt,
                                           placed.parts() if placed else None)
        trainer = make_sharded_trainer(cfg, None, opt, [], 1, mesh, fsdp=placed)
        if variant == "fsdp_reduce_scatter_reversed":
            real = mesh.data.reduce_scatter_flat
            mesh.data.reduce_scatter_flat = lambda flat, kind="reduce_scatter": real(
                flat.view(world, -1).flip(0).reshape(-1), kind)
        try:
            K.reset_launch_counts()
            loss, grads = trainer.loss_and_grads(params, [(xb, yb)], [SALTS])
            torch.cuda.synchronize()
            counts = K.launch_counts()
            opt.update_(params, grads, state)
        finally:
            mesh.data.__dict__.pop("reduce_scatter_flat", None)
        res = {"loss": loss.item(), "launches": counts, "count": state["count"],
               "total_bytes": total, "per_device_bytes": per_dev, "tensor_bytes": tensors,
               "held_allocated_bytes": held_allocated}
        whole = [params, state["mu"], state["nu"]]
        if placed is not None:
            whole = [placed.gather(t) for t in whole]
        if ref is None:
            ref = {"whole": whole, "count": state["count"]}
        else:
            res["bit_equal_to_dp"] = {n_: equal(a, b)
                                      for n_, a, b in zip(("params", "mu", "nu"), whole,
                                                          ref["whole"])}
            res["max_abs_diff_to_dp"] = {n_: max_diff(a, b)
                                         for n_, a, b in zip(("params", "mu", "nu"), whole,
                                                             ref["whole"])}
            res["count_equal"] = state["count"] == ref["count"]
            if placed is not None:
                mine = Fsdp(placed.specs, mesh.data)
                res["parts_equal_dp_slices"] = all(
                    equal(part, mine.shard(w)) for part, w in zip(trees, ref["whole"]))
        out[variant] = res
        del params, state, loss, grads, whole, trees, trainer
    return out


def entry_run(K, d: Path) -> dict:
    """The training entry in ``d`` (seed 5) on one rank in this process:
    its result, its console, its evaluations, seconds and steps/s after
    the first chunk (the runs over ranks: ``entry_runs``)."""
    from trade_aid_multimodal_transformer_tpu_torch.config.compat import reset_compatibility_layer
    from trade_aid_multimodal_transformer_tpu_torch.train import runner

    cwd = os.getcwd()
    os.chdir(d)
    try:
        reset_compatibility_layer()
        K.reset_launch_counts()
        t0_ = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            r = runner.run_training(caller_globals={}, seed=5)
        r["launches"] = K.launch_counts()
        r["ranks"] = [dict(launches_rank=r["launches"])]
        sec_ = time.perf_counter() - t0_
    finally:
        os.chdir(cwd)
        reset_compatibility_layer()
    return dict(r, console=buf.getvalue(), evals=evals_of(buf.getvalue()), seconds=sec_,
                steps_per_s=steps_per_s(r))


def evals_of(console: str) -> list:
    """(step, train, val) of each evaluation an entry's console prints."""
    return [(int(m[0]), float(m[1]), float(m[2])) for m in re.findall(
        r"LOSS METRICS: Step (\d+)/\d+ \| Train: ([-\d.naif]+) \| Val: ([-\d.naif]+)",
        console)]


def steps_per_s(r: dict) -> float:
    """An entry's training steps a second after its first chunk."""
    later = r["step_timer"].chunks[1:]
    return sum(n_ for n_, _ in later) / sum(t for _, t in later)


def parallel_entry_dirs(root: Path, mesh: str, tpu: dict | None = None) -> dict:
    """Directories under ``root`` for a parallel phase's entries over ranks
    sharing the card (``PARALLEL_ENTRY`` steps, ``mesh`` and the ``tpu``
    options set): runs at dropout 0 and 0.2 and a resume at 0.2 (2 steps
    from the checkpoint, ``create_new_model: 0``), each a production
    config folder; under ("text", key) each run's config text."""
    dirs = {}
    for key, rate in ((0.0, 0.0), (0.2, 0.2), ("resume", 0.2)):
        d = root / f"run_{key}"
        d.mkdir()
        production_config_dir(d, dropout=rate, tpu=tpu, **PARALLEL_ENTRY)
        text = (d / "config.yaml").read_text().replace("  mesh: auto", f"  mesh: {mesh}")
        if key == "resume":
            text = text.replace("create_new_model: 1", "create_new_model: 0")
            for name, v in (("max_iters", 2), ("eval_interval", 1), ("eval_iters", 1)):
                text = re.sub(rf"(\n  {name}: )\S+", rf"\g<1>{v}", text)
        dirs[key], dirs["text", key] = d, text
    return dirs


def entry_runs_rank(rank: int, world: int, seed: int, plan):
    """One rank of ``entry_runs``: the training entry's rank
    (``runner._rank_entry``) once per run of ``plan`` (dir, config text,
    dir whose ``output/`` to copy in first, or None), in order, in this one
    process: rank 0 writes the run's config (and copies the output folder)
    before a barrier, and its console goes to the run's ``rank0.log``;
    the collectives timed (TAT_TIMING). Returns per run the entry's result
    with the rank's kernel launches, the peak of its allocated device
    memory and the run's seconds."""
    sys.path.insert(0, str(REPO))
    os.environ["TAT_TIMING"] = "1"
    import torch
    import torch.distributed as dist

    from trade_aid_multimodal_transformer_tpu_torch.config.compat import reset_compatibility_layer
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
    from trade_aid_multimodal_transformer_tpu_torch.train import runner

    threads, stdout, outs = torch.get_num_threads(), sys.stdout, []
    for d, text, output_from in plan:
        d = Path(d)
        if rank == 0:
            if output_from is not None:
                shutil.copytree(Path(output_from) / "output", d / "output", dirs_exist_ok=True)
            (d / "config.yaml").write_text(text)
        dist.barrier()
        os.chdir(d)
        reset_compatibility_layer()
        K.reset_launch_counts()
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        torch.set_num_threads(threads)
        if rank == 0:
            sys.stdout = open(d / "rank0.log", "w")
        t0 = time.perf_counter()
        try:
            out = runner._rank_entry(rank, world, {}, seed)
        finally:
            if sys.stdout is not stdout:
                sys.stdout.close()
            sys.stdout = stdout
        outs.append(dict(out, launches_rank=K.launch_counts(), seconds=time.perf_counter() - t0,
                         max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None))
        dist.barrier()  # the run's checkpoint is written before the next run reads it
    return outs


def rank_calls(rank: int, world: int, calls):
    """Several rank functions ``fn(rank, world, *args)`` of ``calls`` in
    one start of the rank processes, in order: their results."""
    return [fn(rank, world, *args) for fn, args in calls]


def entry_runs(K, plan, ranks: int, before=None):
    """The training entry (seed 5) once per run of ``plan`` (dir, config
    text, dir whose ``output/`` the run starts from, or None), in order, on
    ``ranks`` rank processes sharing the card, started once for all the
    runs (``entry_runs_rank``), after ``before`` (a rank function and its
    arguments: a phase's reference step) where given: (``before``'s
    per-rank results or None, per run ``entry_run``'s result)."""
    from trade_aid_multimodal_transformer_tpu_torch.config.compat import reset_compatibility_layer
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh

    plan = [(str(d), text, None if src is None else str(src)) for d, text, src in plan]
    calls = ([before] if before is not None else []) + [(entry_runs_rank, (5, plan))]
    try:
        got = pmesh.run_ranks(rank_calls, ranks, (calls,),
                              timeout=RANK_TIMEOUT * (len(plan) + len(calls) - 1))
    finally:
        reset_compatibility_layer()
    first = [g[0] for g in got] if before is not None else None
    results = []
    for i, (d, _, _) in enumerate(plan):
        rows = [g[-1][i] for g in got]
        r = {**rows[0], "ranks": rows, "param_checksums": [x["param_checksum"] for x in rows]}
        console = (Path(d) / "rank0.log").read_text()
        results.append(dict(r, console=console, evals=evals_of(console), steps_per_s=steps_per_s(r)))
    return first, results


def fsdp_phases(K, card, by_path, dp_runs):
    """FSDP / ZeRO-3 (``mesh: {data: 2}``, ``fsdp: true``) on the one card,
    two ranks sharing it (gloo through host memory):
    - ``fsdp_reference``: one production step (bf16, dropout 0.2, global
      batch 32, bf16 moments) with FSDP against the data-parallel step on
      the same batch and salts: the gathered parameters, mu, nu and the
      count bit-equal to it (both ranks), each rank's parts its slices of
      the data-parallel result, the launches the data-parallel step's, the
      rank's train-state tensors the per-device figure, that figure the one
      ``state_bytes`` gives (without FSDP the whole), and the allocated
      bytes they add within 10% of it (the caching allocator hands out
      blocks up to 1 MB larger than asked; the whole tree left alive would
      add 2x). The data-parallel step
      is taken twice (reported). Planted faults that must break the bit
      equality: rank 1 holding rank 0's slices; the reduce-scatter's chunks
      handed out in reverse rank order.
    - ``fsdp_training``: the entry over the two ranks, 4 steps, at dropout
      0 and 0.2 against the one-rank entry with the same seed (final eval
      losses within STEP_TOL), every rank's checksum of the gathered
      parameters equal, exact launches on every rank (those of
      ``dp_training``'s ranks at 0.2), every rank's train-state bytes those
      ``state_bytes`` gives, one all-gather, one reduce-scatter
      and one all-reduce a step (their bytes and ms, TAT_TIMING), the peak
      of allocated memory per rank beside the data-parallel run's, the
      last checkpoint (dropout 0.2) bit-equal to ``dp_training``'s, and a
      resume from it (``create_new_model: 0``) under FSDP.
    Adds ``by_path["fsdp_training"]``; returns the one-rank entries of both
    rates and the FSDP entry at 0.2 (with its checkpoint's arrays); raises
    on a failed check."""
    import numpy as np
    import torch

    from trade_aid_multimodal_transformer_tpu_torch import generate as entry
    from trade_aid_multimodal_transformer_tpu_torch.config.compat import reset_compatibility_layer
    from trade_aid_multimodal_transformer_tpu_torch.models.init import init_params
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
    from trade_aid_multimodal_transformer_tpu_torch.train import runner
    from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import _read_native

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d)
        data = entry.load_config_and_data(str(d))
    cfg, sc = data["cfg"], data["sc"]
    L, n_cross = cfg.n_layer, sum(cfg.cross_attention)
    step_launches = dict(fused_qkv_attention=L, fused_qkv_attention_bwd=L,
                         short_cross_attention=n_cross * L, short_cross_attention_bwd=n_cross * L)
    want_step = {**dict.fromkeys(K.KERNELS, 0), **step_launches}

    # fsdp_reference
    rng = np.random.default_rng(13)
    B = sc["batch_size"]
    ids = torch.from_numpy(np.stack([rng.integers(0, v, (B, cfg.block_size + 1))
                                     for v in cfg.vocab_sizes]))
    params = init_params(cfg, torch.Generator().manual_seed(1234), "cpu")
    want_bytes = state_bytes(cfg, DP_RANKS, fsdp=True)
    # fsdp_training's three runs over the two ranks (dropout 0 and 0.2, and
    # a resume from a copy of the 0.2 run's output folder) after the
    # reference step, in one start of the rank processes
    tmp = tempfile.TemporaryDirectory()
    dirs = parallel_entry_dirs(Path(tmp.name), "{data: 2}", {"fsdp": "true"})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res, (fs0, fs2, resumed) = entry_runs(
        K, [(dirs[0.0], dirs["text", 0.0], None), (dirs[0.2], dirs["text", 0.2], None),
            (dirs["resume"], dirs["text", "resume"], dirs[0.2])], DP_RANKS,
        before=(fsdp_rank, (dict(cfg=cfg, params=params, batch=(ids[..., :-1], ids[..., 1:]),
                                 lr=sc["learning_rate"]),)))
    sec = time.perf_counter() - t0
    failed = []
    for variant in ("dp_again", "fsdp", "fsdp_rank1_keeps_rank0_slice",
                    "fsdp_reduce_scatter_reversed"):
        rows = [res[r][variant] for r in range(DP_RANKS)]
        bit_equal = all(all(x["bit_equal_to_dp"].values()) and x["count_equal"] for x in rows)
        parts = all(x.get("parts_equal_dp_slices", True) for x in rows)
        launches = all(x["launches"] == want_step == res[r]["dp"]["launches"]
                       for r, x in enumerate(rows))
        held = all(x["tensor_bytes"] + 4 == x["per_device_bytes"]
                   and (x["total_bytes"], x["per_device_bytes"])
                   == (want_bytes if variant.startswith("fsdp") else (want_bytes[0],) * 2)
                   and res[r]["dp"]["per_device_bytes"] == want_bytes[0]
                   and x["tensor_bytes"] <= x["held_allocated_bytes"]
                   <= 1.1 * x["tensor_bytes"] for r, x in enumerate(rows))
        planted = variant.startswith("fsdp_") and variant != "fsdp"
        sound = bit_equal and parts and launches and held
        ok = (not bit_equal) if planted else (bit_equal or variant == "dp_again")
        ok = ok and launches and held
        if variant == "fsdp":
            ok = ok and sound
        emit({"phase": "fsdp_reference", "variant": variant, "card": card,
              "ranks_on_one_card": DP_RANKS, "backend": "gloo through host memory",
              "config": "examples/production_config.yaml", "global_batch": B,
              "block_size": cfg.block_size, "dropout": cfg.dropout, "dtype": cfg.compute_dtype,
              "moments": "bfloat16", "against": "the data-parallel step on the card, same batch "
              "and salts", "must_fail": planted,
              "losses_by_rank": [x["loss"] for x in rows],
              "loss_dp": res[0]["dp"]["loss"],
              "bit_equal_to_dp_by_rank": [x["bit_equal_to_dp"] for x in rows],
              "max_abs_diff_to_dp_by_rank": [x["max_abs_diff_to_dp"] for x in rows],
              "parts_equal_dp_slices_by_rank": [x.get("parts_equal_dp_slices") for x in rows],
              "launches_equal_dp": launches,
              "train_state_bytes_total": rows[0]["total_bytes"],
              "train_state_bytes_per_rank": [x["per_device_bytes"] for x in rows],
              "train_state_bytes_expected": want_bytes,
              "train_state_tensor_bytes_by_rank": [x["tensor_bytes"] for x in rows],
              "train_state_allocated_bytes_by_rank": [x["held_allocated_bytes"] for x in rows],
              "train_state_bytes_dp_per_rank": res[0]["dp"]["per_device_bytes"],
              "seconds_with_spawn": sec, "ok": ok})
        if not ok:
            failed.append(variant)
    if failed:
        raise AssertionError(f"fsdp_reference failed: {failed}")

    # fsdp_training: the entry over two ranks at dropout 0 and 0.2 and the
    # resume (run above), then the one-rank entry at 0 (dp_training ran it
    # at 0.2), seed 5
    config = dict(PARALLEL_ENTRY)
    one = {0.2: dp_runs["\"off\""]}
    fs2["checkpoint"] = _read_native(str(dirs[0.2] / "output" / "model.ckpt"))
    fs = {0.0: fs0, 0.2: fs2}
    d = dirs[0.0]
    (d / "config.yaml").write_text(dirs["text", 0.0].replace(
        "mesh: {data: 2}", "mesh: \"off\"").replace("  fsdp: true\n", ""))
    one[0.0] = entry_run(K, d)
    tmp.cleanup()
    eval_batches = expected_evals(config["max_iters"], config["eval_interval"]) * 2 * 2
    per_eval = dict(fused_qkv_attention=L, short_cross_attention=n_cross * L)
    want = {**dict.fromkeys(K.KERNELS, 0),
            **{name: n_ * config["max_iters"] + per_eval.get(name, 0) * eval_batches
               for name, n_ in step_launches.items()}}
    dp = dp_runs["{data: 2}"]
    failed = []
    for rate in (0.0, 0.2):
        r = fs[rate]
        sums = r["param_checksums"]
        errs_ = {k_: abs(r["losses"][k_] - one[rate]["losses"][k_]) for k_ in ("train", "val")}
        launches = [x["launches_rank"] for x in r["ranks"]]
        coll = {kind: per_step(r["collectives"], kind)
                for kind in ("all_gather", "reduce_scatter", "all_reduce")}
        held_bytes = [tuple(x["train_state_bytes"]) for x in r["ranks"]]
        ok = (len(sums) == DP_RANKS and all(s_ == sums[0] for s_ in sums)
              and all(e <= STEP_TOL["bfloat16"]["loss"] for e in errs_.values())
              and len(r["evals"]) == len(one[rate]["evals"]) > 1
              and all(x == want for x in launches)
              and (rate != 0.2 or launches == [x["launches_rank"] for x in dp["ranks"]])
              and "Parallelism: data x2 (fsdp/zero-3) over 2 devices" in r["console"]
              and "TRAINING COMPLETED SUCCESSFULLY" in r["console"]
              and all(c_[2] == config["max_iters"] for c_ in coll.values())
              and held_bytes == [want_bytes] * DP_RANKS)
        line = {"phase": "fsdp_training", "config": "examples/production_config.yaml",
                "card": card, "changed": {**config, "dropout": rate, "mesh": "{data: 2}",
                                          "fsdp": True},
                "ranks_on_one_card": DP_RANKS, "backend": "gloo through host memory",
                "plan": r["plan"].describe(), "global_batch": B, "evals": r["evals"],
                "evals_one_rank": one[rate]["evals"], "final_eval_losses": r["losses"],
                "final_eval_losses_one_rank": one[rate]["losses"], "abs_err_vs_one_rank": errs_,
                "tol": STEP_TOL["bfloat16"]["loss"], "param_checksums_by_rank": sums,
                "launches_by_rank": [{k_: v_ for k_, v_ in x.items() if v_} for x in launches],
                "expected_launches_per_rank": {k_: v_ for k_, v_ in want.items() if v_},
                "train_state_bytes_by_rank": held_bytes,
                "train_state_bytes_expected": want_bytes,
                "max_memory_allocated_by_rank": [x["max_memory_allocated"] for x in r["ranks"]],
                "steps_per_s_after_first_chunk": r["steps_per_s"],
                "steps_per_s_one_rank": one[rate]["steps_per_s"],
                **{f"{kind}_bytes_per_step": c_[0] for kind, c_ in coll.items()},
                **{f"{kind}_ms_per_step": c_[1] for kind, c_ in coll.items()},
                "collectives_note": "host clock around each staged gloo collective (copy to the "
                                    "host, collective, copy back), the card synchronised before "
                                    "and after", "seconds_with_spawn": r["seconds"]}
        if rate == 0.2:
            ck, ck_dp = r["checkpoint"], dp["checkpoint"]
            same_file = sorted(ck) == sorted(ck_dp) and all(
                np.array_equal(ck[k_], ck_dp[k_]) for k_ in ck)
            differ = sorted(k_ for k_ in ck if k_ in ck_dp and not np.array_equal(ck[k_], ck_dp[k_]))
            sums_r = resumed["param_checksums"]
            resume_ok = ("Model: Loaded successfully" in resumed["console"]
                         and "TRAINING COMPLETED SUCCESSFULLY" in resumed["console"]
                         and all(s_ == sums_r[0] for s_ in sums_r)
                         and all(math.isfinite(v) for v in resumed["losses"].values()))
            ok = ok and same_file and resume_ok
            line.update({
                "data_parallel": {
                    "launches_by_rank_equal": launches == [x["launches_rank"] for x in dp["ranks"]],
                    "max_memory_allocated_by_rank": [x.get("max_memory_allocated")
                                                     for x in dp["ranks"]],
                    "train_state_bytes_by_rank": [tuple(x["train_state_bytes"])
                                                  for x in dp["ranks"]],
                    "steps_per_s_after_first_chunk": dp["steps_per_s"],
                    "all_reduce": per_step(dp["collectives"], "all_reduce")},
                "checkpoint_bit_equal_to_dp_training": same_file, "checkpoint_keys": len(ck),
                "checkpoint_keys_differing": differ[:8],
                "resume": {"loaded": "Model: Loaded successfully" in resumed["console"],
                           "param_checksums_by_rank": sums_r, "final_eval_losses":
                           resumed["losses"], "ok": resume_ok}})
            by_path["fsdp_training"] = launches[0]
        line["ok"] = ok
        emit(line)
        if not ok:
            failed.append(rate)
    if failed:
        raise AssertionError(f"the FSDP training entry failed its checks at dropout {failed}")
    return one, fs2


def tp_rank(rank: int, world: int, job: dict):
    """One rank of ``tp_reference``, in a process of its own (the ranks
    share the one card: gloo through host memory). Rank 0 first takes the
    one-rank step on the card on the global batch (the plain Trainer), in
    bf16 and in f32, and in f32 once more with the output projections'
    second weights (``proj_w2``, ``ffwd.w2``) scaled by 1 + 1e-7 N(0, 1)
    elementwise: how far the step's gradients move under rounding-sized
    changes of its activations. Then every rank takes the tensor-parallel
    step (``{model: world}``: its heads and columns, the Megatron
    collectives, masks keyed by global heads) and an AdamW update, in bf16
    and f32, and in bf16 with two planted faults: rank 1's head offset
    forced to 0, and the first ``copy_to`` of the step without its backward
    all-reduce. Returns per variant the loss, the launches, the checksum of
    the leaves the placement keeps whole (their gradients and updated
    values), whether the rank's parts are its slices of the gathered
    updated tree, its train-state bytes and, on rank 0, the gathered
    gradients' errors against the one-rank step of its dtype."""
    sys.path.insert(0, str(REPO))
    import hashlib

    import torch

    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        map_tree, tree_leaves, tree_paths)
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import (
        make_sharded_trainer, shard_train_state)
    from trade_aid_multimodal_transformer_tpu_torch.train import steps as tsteps
    from trade_aid_multimodal_transformer_tpu_torch.utils.memory import train_state_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfgs = {"bfloat16": job["cfg"],
            "float32": dataclasses.replace(job["cfg"], compute_dtype="float32")}
    mesh = pmesh.make_mesh(model=world, staged=True)
    xb, yb = (t.to(dev) for t in job["batch"])
    names = ["/".join(map(str, path)) for path, _ in tree_paths(job["params"])]
    table = [name.startswith("pre/tok_emb/") for name in names]

    def fresh(scale=None):
        gen = torch.Generator().manual_seed(0)

        def leaf(name, t):
            t = t.detach().clone()
            if scale and name.endswith(("proj_w2", "ffwd/w2")):
                t = t * (1 + scale * torch.randn(t.shape, generator=gen))
            return t.to(dev).requires_grad_()

        leaves = iter(names)
        return map_tree(lambda t: leaf(next(leaves), t), job["params"])

    def optimizer():
        return tsteps.make_optimizer(job["lr"], moment_dtype="bfloat16", nu_dtype="bfloat16")

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().float().cpu().numpy().tobytes())
        return h.hexdigest()

    def errors(grads, ref):
        """Each leaf's L2 error against its own scale, floored at a 1e-4
        share of the whole, the token tables apart (dp_rank's measure)."""
        norms = [r.norm().item() for r in ref]
        floor = 1e-4 * math.sqrt(sum(n_ * n_ for n_ in norms))
        errs_leaf = [(g.float() - r).norm().item() / max(n_, floor)
                     for g, r, n_ in zip(grads, ref, norms)]
        return {"grad_l2_rel_err_max": max(e for e, t in zip(errs_leaf, table) if not t),
                "token_table_grad_l2_rel_err_max": max(e for e, t in zip(errs_leaf, table) if t),
                "worst_leaves": sorted(zip(errs_leaf, names), reverse=True)[:4]}

    refs, out = {}, {}
    if rank == 0:
        for dtype, cfg in cfgs.items():
            loss, grads = tsteps.Trainer(cfg, None, optimizer(), [], 1).loss_and_grads(
                fresh(), [(xb, yb)], [SALTS])
            refs[dtype] = loss.item(), [g.float() for g in grads]
        loss, grads = tsteps.Trainer(cfgs["float32"], None, optimizer(), [], 1).loss_and_grads(
            fresh(1e-7), [(xb, yb)], [SALTS])
        out["one_rank_f32_perturbed"] = {"loss_abs_err": abs(loss.item() - refs["float32"][0]),
                                         **errors(grads, refs["float32"][1])}
    heads, copy_to = mesh.model.heads, mesh.model.copy_to
    for variant, dtype in (("sound", "bfloat16"), ("sound_f32", "float32"),
                           ("head_offset_0", "bfloat16"),
                           ("copy_to_without_all_reduce", "bfloat16")):
        opt = optimizer()
        params, _, placed = shard_train_state(fresh(), None, None, False, mesh.model)
        state = opt.init(params)
        if variant == "head_offset_0" and rank == 1:
            mesh.model.heads = lambda n_head: (0, heads(n_head)[1])
        skipped = []
        if variant == "copy_to_without_all_reduce":
            def first_plain(x):
                if not skipped:
                    skipped.append(tuple(x.shape))
                    return x
                return copy_to(x)
            mesh.model.copy_to = first_plain
        try:
            trainer = make_sharded_trainer(cfgs[dtype], None, opt, [], 1, mesh)
            K.reset_launch_counts()
            loss, grads = trainer.loss_and_grads(params, [(xb, yb)], [SALTS])
            torch.cuda.synchronize()
            counts = K.launch_counts()
        finally:
            mesh.model.__dict__.pop("heads", None)
            mesh.model.__dict__.pop("copy_to", None)
        whole_grads = placed.whole(list(grads), "grads")
        whole_idx = [i for i, s_ in enumerate(placed.specs) if "model" not in s_]
        opt.update_(params, grads, state)
        after = placed.whole(params)
        res = {"dtype": dtype, "loss": loss.item(), "launches": counts,
               "whole_leaf_grads": digest(grads[i] for i in whole_idx),
               "whole_leaf_params": digest(tree_leaves(params)[i] for i in whole_idx),
               "parts_are_slices": all(torch.equal(a, b) for a, b in zip(
                   tree_leaves(params), tree_leaves(placed.shard(after)))),
               "state_bytes": train_state_bytes(params, state, opt, placed.parts()),
               "skipped_copy_to": skipped}
        if rank == 0:
            loss_ref, g_ref = refs[dtype]
            res.update(loss_ref=loss_ref, loss_abs_err=abs(loss.item() - loss_ref),
                       **errors(whole_grads, g_ref))
        out[variant] = res
        del params, state, loss, grads, whole_grads, after, trainer
    return out


def tp_phases(K, card, by_path, one_rank):
    """Tensor parallelism (``mesh: {model: 2}``) on the one card, two ranks
    sharing it (gloo through host memory):
    - ``tp_reference``: one production step (dropout 0.2, batch 32, bf16
      moments) in bf16 and in f32 against the one-rank step of the same
      dtype on the same batch and salts: the loss and every gathered
      gradient leaf within STEP_TOL (the step gate ``train_reference``
      holds the card to: a row-split sum rounds where the one-rank product
      does not, and the step's ReLUs turn rounding-sized changes into
      leaf errors of order the square root of the rounding; the one-rank
      f32 step's own move under 1e-7 weight changes is printed beside it),
      the leaves the placement keeps whole bit-equal across the ranks
      (their gradients and updated values: no collective averages them),
      each rank's parts its slices of the gathered updated tree, exact
      launches per rank (a one-rank step's: every rank runs every kernel on
      its heads), the rank's train-state bytes those ``state_bytes`` gives.
      Two planted faults in bf16 must each exceed the gate: rank 1's head
      offset forced to 0, and one ``copy_to`` without its backward
      all-reduce.
    - ``tp_training``: the entry over the two ranks, 4 steps, at dropout 0
      and 0.2 against the one-rank entry with the same seed (``one_rank``,
      from ``fsdp_phases``): final eval losses within STEP_TOL, every
      rank's checksum of the gathered parameters equal, exact launches per
      rank, every rank's train-state bytes those ``state_bytes`` gives, the
      tensor-parallel all-reduces' bytes, calls and ms a step (TAT_TIMING);
      the checkpoint of the run at 0.2 loading in a one-rank run
      (``create_new_model: 0``, ``mesh: off``) that trains on, and a
      resume from it over the two ranks.
    Adds ``by_path["tp_training"]``; raises on a failed check."""
    import numpy as np
    import torch

    from trade_aid_multimodal_transformer_tpu_torch import generate as entry
    from trade_aid_multimodal_transformer_tpu_torch.models.init import init_params
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d)
        data = entry.load_config_and_data(str(d))
    cfg, sc = data["cfg"], data["sc"]
    L, n_cross = cfg.n_layer, sum(cfg.cross_attention)
    step_launches = dict(fused_qkv_attention=L, fused_qkv_attention_bwd=L,
                         short_cross_attention=n_cross * L, short_cross_attention_bwd=n_cross * L)
    want_step = {**dict.fromkeys(K.KERNELS, 0), **step_launches}
    want_bytes = state_bytes(cfg, model=TP_RANKS)

    # tp_reference
    rng = np.random.default_rng(13)
    B = sc["batch_size"]
    ids = torch.from_numpy(np.stack([rng.integers(0, v, (B, cfg.block_size + 1))
                                     for v in cfg.vocab_sizes]))
    params = init_params(cfg, torch.Generator().manual_seed(1234), "cpu")
    # tp_training's three runs over the two ranks (dropout 0 and 0.2, and a
    # resume from a copy of the 0.2 run's output folder, whose checkpoint a
    # one-rank run then loads) after the reference step, in one start of
    # the rank processes
    tmp = tempfile.TemporaryDirectory()
    dirs = parallel_entry_dirs(Path(tmp.name), "{model: 2}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res, (tp0, tp2, resumed) = entry_runs(
        K, [(dirs[0.0], dirs["text", 0.0], None), (dirs[0.2], dirs["text", 0.2], None),
            (dirs["resume"], dirs["text", "resume"], dirs[0.2])], TP_RANKS,
        before=(tp_rank, (dict(cfg=cfg, params=params, batch=(ids[..., :-1], ids[..., 1:]),
                               lr=sc["learning_rate"]),)))
    sec = time.perf_counter() - t0
    failed = []
    for variant in ("sound", "sound_f32", "head_offset_0", "copy_to_without_all_reduce"):
        rows = [res[r][variant] for r in range(TP_RANKS)]
        r0 = rows[0]
        tol = STEP_TOL[r0["dtype"]]
        within = (r0["loss_abs_err"] <= tol["loss"] and r0["grad_l2_rel_err_max"] <= tol["grad_l2"]
                  and r0["token_table_grad_l2_rel_err_max"] <= tol["grad_l2"])
        whole_equal = all(x["whole_leaf_grads"] == r0["whole_leaf_grads"]
                          and x["whole_leaf_params"] == r0["whole_leaf_params"] for x in rows)
        launches = all(x["launches"] == want_step for x in rows)
        held = all(tuple(x["state_bytes"]) == want_bytes for x in rows)
        parts = all(x["parts_are_slices"] for x in rows)
        planted = not variant.startswith("sound")
        ok = launches and held and parts and (not within if planted else within and whole_equal)
        emit({"phase": "tp_reference", "variant": variant, "card": card,
              "ranks_on_one_card": TP_RANKS, "backend": "gloo through host memory",
              "config": "examples/production_config.yaml", "global_batch": B,
              "block_size": cfg.block_size, "dropout": cfg.dropout, "dtype": r0["dtype"],
              "against": "the one-rank step on the card in the same dtype, same batch and salts",
              "must_fail": planted, "loss_tol": tol["loss"], "grad_l2_rel_tol": tol["grad_l2"],
              **{k_: r0[k_] for k_ in ("loss_ref", "loss_abs_err", "grad_l2_rel_err_max",
                                       "token_table_grad_l2_rel_err_max", "worst_leaves")},
              "one_rank_f32_step_moved_by_1e-7_weights": res[0]["one_rank_f32_perturbed"],
              "losses_by_rank": [x["loss"] for x in rows],
              "whole_leaves_bit_equal_across_ranks": whole_equal,
              "parts_are_slices_of_the_updated_tree": parts,
              "skipped_copy_to_input": r0["skipped_copy_to"],
              "train_state_bytes_by_rank": [tuple(x["state_bytes"]) for x in rows],
              "train_state_bytes_expected": want_bytes,
              "launches_by_rank": [{k_: v_ for k_, v_ in x["launches"].items() if v_}
                                   for x in rows], "launches_exact": launches,
              "seconds_with_spawn": sec, "ok": ok})
        if not ok:
            failed.append(variant)
    if failed:
        raise AssertionError(f"tp_reference failed: {failed}")

    # tp_training: the entry over two ranks at dropout 0 and 0.2 and the
    # resume (run above, seed 5), and a one-rank run from the resume's
    # checkpoint
    config = dict(PARALLEL_ENTRY)
    tp = {0.0: tp0, 0.2: tp2}
    d = dirs["resume"]
    (d / "config.yaml").write_text(
        dirs["text", "resume"].replace("mesh: {model: 2}", "mesh: \"off\""))
    loaded = entry_run(K, d)
    tmp.cleanup()
    eval_batches = expected_evals(config["max_iters"], config["eval_interval"]) * 2 * 2
    per_eval = dict(fused_qkv_attention=L, short_cross_attention=n_cross * L)
    want = {**dict.fromkeys(K.KERNELS, 0),
            **{name: n_ * config["max_iters"] + per_eval.get(name, 0) * eval_batches
               for name, n_ in step_launches.items()}}
    failed = []
    for rate in (0.0, 0.2):
        r = tp[rate]
        sums = r["param_checksums"]
        errs_ = {k_: abs(r["losses"][k_] - one_rank[rate]["losses"][k_]) for k_ in ("train", "val")}
        launches = [x["launches_rank"] for x in r["ranks"]]
        calls = [(k_, n_, t_) for k_, n_, t_ in r["collectives"] or []
                 if k_ in ("tp_all_reduce", "tp_all_reduce_bwd")]
        steps = config["max_iters"]
        held = [tuple(x["train_state_bytes"]) for x in r["ranks"]]
        ok = (len(sums) == TP_RANKS and all(s_ == sums[0] for s_ in sums)
              and all(e <= STEP_TOL["bfloat16"]["loss"] for e in errs_.values())
              and len(r["evals"]) == len(one_rank[rate]["evals"]) > 1
              and all(x == want for x in launches)
              and "Parallelism: tensor x2 over 2 devices" in r["console"]
              and "TRAINING COMPLETED SUCCESSFULLY" in r["console"]
              and held == [want_bytes] * TP_RANKS and bool(calls))
        line = {"phase": "tp_training", "config": "examples/production_config.yaml",
                "card": card, "changed": {**config, "dropout": rate, "mesh": "{model: 2}"},
                "ranks_on_one_card": TP_RANKS, "backend": "gloo through host memory",
                "plan": r["plan"].describe(), "global_batch": sc["batch_size"],
                "evals": r["evals"], "evals_one_rank": one_rank[rate]["evals"],
                "final_eval_losses": r["losses"],
                "final_eval_losses_one_rank": one_rank[rate]["losses"],
                "abs_err_vs_one_rank": errs_, "tol": STEP_TOL["bfloat16"]["loss"],
                "param_checksums_by_rank": sums,
                "launches_by_rank": [{k_: v_ for k_, v_ in x.items() if v_} for x in launches],
                "expected_launches_per_rank": {k_: v_ for k_, v_ in want.items() if v_},
                "train_state_bytes_by_rank": held, "train_state_bytes_expected": want_bytes,
                "max_memory_allocated_by_rank": [x["max_memory_allocated"] for x in r["ranks"]],
                "steps_per_s_after_first_chunk": r["steps_per_s"],
                "steps_per_s_one_rank": one_rank[rate]["steps_per_s"],
                "tp_all_reduce_bytes_per_step": sum(n_ for _, n_, _ in calls) / steps,
                "tp_all_reduce_calls_per_step": len(calls) / steps,
                "tp_all_reduce_ms_per_step": 1e3 * sum(t_ for _, _, t_ in calls) / steps,
                "tp_all_reduce_fwd_bytes_per_step": sum(
                    n_ for k_, n_, _ in calls if k_ == "tp_all_reduce") / steps,
                "collectives_note": "host clock around each staged gloo all-reduce (copy to the "
                                    "host, reduce, copy back), the card synchronised before and "
                                    "after", "seconds_with_spawn": r["seconds"]}
        if rate == 0.2:
            load_ok = ("Model: Loaded successfully" in loaded["console"]
                       and "TRAINING COMPLETED SUCCESSFULLY" in loaded["console"]
                       and loaded["plan"].trivial
                       and all(math.isfinite(v) for v in loaded["losses"].values()))
            sums_r = resumed["param_checksums"]
            resume_ok = ("Model: Loaded successfully" in resumed["console"]
                         and "TRAINING COMPLETED SUCCESSFULLY" in resumed["console"]
                         and all(s_ == sums_r[0] for s_ in sums_r)
                         and all(math.isfinite(v) for v in resumed["losses"].values()))
            ok = ok and load_ok and resume_ok
            line.update({"one_rank_load": {"ok": load_ok, "final_eval_losses": loaded["losses"]},
                         "resume": {"ok": resume_ok, "param_checksums_by_rank": sums_r,
                                    "final_eval_losses": resumed["losses"]}})
            by_path["tp_training"] = launches[0]
        line["ok"] = ok
        emit(line)
        if not ok:
            failed.append(rate)
    if failed:
        raise AssertionError(f"the tensor-parallel training entry failed its checks at "
                             f"dropout {failed}")


def mesh_rank(rank: int, world: int, job: dict):
    """One rank of ``mod_reference``, ``tp_split_reference`` and
    ``tp_seq_reference``, in a process of its own (the ranks share the one
    card: gloo through host memory). Rank 0 first takes the one-rank step
    on the card on the global batch (the plain Trainer) for each (dtype,
    dropout) of ``job["refs"]``. Then every rank takes the step over
    ``make_mesh(**job["mesh"])`` on its parts (``shard_train_state``) and
    an AdamW update, per variant (name, dtype, dropout, fault): fault None,
    "mod_offset_0" (rank 1 keys its masks as modality place 0's: the row
    maps without their modality level, K1f and K1b given offset 0),
    "skip_cross_keys" (no salts drawn for another rank's cross sites) or
    "mod_rows_from_0" (a modality-parallel ring keys its rows from 0, not
    from the rank's first modality in the whole M). With ``job["in_path"]``
    every K7f and K7b call is held in-path against its plain version;
    ``job["given_refs"]`` adds references computed elsewhere ((dtype,
    dropout): (loss, gradients), on the CPU), which rank 0 holds the
    variant of that dtype and dropout against. Returns per variant the loss, the launches, the
    checksums of the leaves the placement keeps whole (their gradients and
    updated values), whether the rank's parts are its slices of the
    gathered updated tree, its train-state bytes, the in-path errors and,
    on rank 0, the gathered gradients' errors against the one-rank step of
    the variant's dtype and dropout."""
    sys.path.insert(0, str(REPO))
    import hashlib

    import torch

    from trade_aid_multimodal_transformer_tpu_torch.models import transformer as ttr
    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        map_tree, tree_leaves, tree_paths)
    from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
    from trade_aid_multimodal_transformer_tpu_torch.ops import layers as tl
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import (
        make_sharded_trainer, shard_train_state)
    from trade_aid_multimodal_transformer_tpu_torch.train import steps as tsteps
    from trade_aid_multimodal_transformer_tpu_torch.utils.memory import train_state_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job.get("device", "cuda"))  # "cpu": a rehearsal of the phase
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = pmesh.make_mesh(**job["mesh"], staged=dev.type == "cuda")
    xb, yb = (t.to(dev) for t in job["batch"])
    names = ["/".join(map(str, path)) for path, _ in tree_paths(job["params"])]
    table = [name.startswith("pre/tok_emb/") for name in names]

    def config(dtype, rate):
        return dataclasses.replace(job["cfg"], compute_dtype=dtype, dropout=rate)

    def fresh():
        return map_tree(lambda t: t.detach().to(dev).clone().requires_grad_(), job["params"])

    def optimizer():
        return tsteps.make_optimizer(job["lr"], moment_dtype="bfloat16", nu_dtype="bfloat16")

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().float().cpu().numpy().tobytes())
        return h.hexdigest()

    def errors(grads, ref):
        """Each leaf's L2 error against its own scale, floored at a 1e-4
        share of the whole, the token tables apart (dp_rank's measure)."""
        norms = [r.norm().item() for r in ref]
        floor = 1e-4 * math.sqrt(sum(n_ * n_ for n_ in norms))
        errs_leaf = [(g.float() - r).norm().item() / max(n_, floor)
                     for g, r, n_ in zip(grads, ref, norms)]
        return {"grad_l2_rel_err_max": max(e for e, t in zip(errs_leaf, table) if not t),
                "token_table_grad_l2_rel_err_max": max(e for e, t in zip(errs_leaf, table) if t),
                "worst_leaves": sorted(zip(errs_leaf, names), reverse=True)[:4]}

    refs, out = {}, {}
    if rank == 0:
        refs.update(job.get("given_refs", {}))
        for dtype, rate in job["refs"]:
            loss, grads = tsteps.Trainer(config(dtype, rate), None, optimizer(), [],
                                         1).loss_and_grads(fresh(), [(xb, yb)], [SALTS])
            refs[dtype, rate] = loss.item(), [g.float() for g in grads]
            del loss, grads
    real_map, real_fqkv, real_sites = tl.batch_row_map, K.fused_qkv_attention, ttr.CROSS_SITES
    real_base = tatt._ring_base
    for name, dtype, rate, fault in job["variants"]:
        opt = optimizer()
        params, _, placed = shard_train_state(fresh(), None, mesh.data, False, mesh.model,
                                              mesh.mod)
        state = opt.init(params)
        if fault == "mod_offset_0" and rank == 1:
            tl.batch_row_map = tatt.batch_row_map = (
                lambda lead, b, h=None, m=None: real_map(lead, b, h, None))
            def offset_0(x, w1, b1, w2, n_head, rate=0.0, salts=None, batch=None,
                         heads=None, mods=None):
                return real_fqkv(x, w1, b1, w2, n_head, rate, salts, batch, heads,
                                 None if mods is None else (0, mods[1]))

            K.fused_qkv_attention = offset_0
        if fault == "skip_cross_keys":
            ttr.CROSS_SITES = 0
        if fault == "mod_rows_from_0":
            tatt._ring_base = lambda q, mod_axis: 0
        worst = {}
        fns = {} if not job.get("in_path") else dict(
            flash_chunk_fwd=checked(K, "flash_chunk_fwd", K.flash_chunk_fwd, worst),
            flash_chunk_bwd=checked(K, "flash_chunk_bwd", K.flash_chunk_bwd, worst))
        try:
            trainer = make_sharded_trainer(config(dtype, rate), None, opt, [], 1, mesh,
                                           fsdp=placed)
            with patched(K, **fns):
                K.reset_launch_counts()
                loss, grads = trainer.loss_and_grads(params, [(xb, yb)], [SALTS])
                sync()
                counts = K.launch_counts()
        finally:
            tl.batch_row_map = tatt.batch_row_map = real_map
            K.fused_qkv_attention = real_fqkv
            ttr.CROSS_SITES = real_sites
            tatt._ring_base = real_base
        whole_grads = placed.whole(list(grads), "grads")
        whole_idx = [i for i, s_ in enumerate(placed.specs)
                     if not {"model", "mod", "data"} & set(s_)]
        opt.update_(params, grads, state)
        after = placed.whole(params)
        res = {"dtype": dtype, "dropout": rate, "loss": loss.item(), "launches": counts,
               "in_path": worst, "whole_leaf_grads": digest(grads[i] for i in whole_idx),
               "whole_leaf_params": digest(tree_leaves(params)[i] for i in whole_idx),
               "parts_are_slices": all(torch.equal(a, b) for a, b in zip(
                   tree_leaves(params), tree_leaves(placed.shard(after)))),
               "state_bytes": train_state_bytes(params, state, opt, placed.parts()),
               "coords": mesh.coords}
        if rank == 0 and (dtype, rate) in refs:
            loss_ref, g_ref = refs[dtype, rate]
            res.update(loss_ref=loss_ref, loss_abs_err=abs(loss.item() - loss_ref),
                       **errors(whole_grads, [g.to(dev) for g in g_ref]))
        out[name] = res
        del params, state, loss, grads, whole_grads, after, trainer
    return out


def mesh_ranks(rank: int, world: int, jobs):
    """Several ``mesh_rank`` jobs in one start of the rank processes, in
    order (each makes its own groups)."""
    return [mesh_rank(rank, world, job) for job in jobs]


def mesh_reference(K, card, specs, entries=None, also=()):
    """Spawn ``mesh_rank`` once for every spec (phase, job, expected bytes,
    expected launches of a rank's coords, gate of a dtype: (loss, leaf,
    token-table) limits, names that must fail, extra fields), all of one
    world size, on the one card; hold each variant: rank 0's loss and
    gathered gradients within the gate of the one-rank step, the whole
    leaves bit-equal across the ranks, each rank's parts its slices, its
    bytes and launches the expected ones and its in-path K7 errors within
    REL_TOL; a variant that must fail must exceed the step gate instead.
    One line per variant; raises on a failure. ``entries``: a plan of
    ``entry_runs`` run after the steps in the same start of the rank
    processes; ``also``: more rank calls (fn, args) run right after the
    steps. Returns the entries' results and, per call of ``also``, its
    per-rank results."""
    import torch

    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh

    worlds = {math.prod(spec[1]["mesh"].values()) for spec in specs}
    if len(worlds) != 1:
        raise ValueError(f"one spawn runs one world size, got {sorted(worlds)}")
    world = worlds.pop()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    before = (rank_calls, ([(mesh_ranks, ([spec[1] for spec in specs],)), *also],))
    if entries:
        got, results = entry_runs(K, entries, world, before)
    else:
        got, results = pmesh.run_ranks(rank_calls, world, ([before],),
                                       timeout=RANK_TIMEOUT * (len(specs) + len(also))), []
        got = [g[0] for g in got]
    also_got = [[g[1 + i] for g in got] for i in range(len(also))]
    got = [g[0] for g in got]
    sec = time.perf_counter() - t0
    failed = []
    for i, (phase, job, want_bytes, want_launches, gate, must_fail, extra) in enumerate(specs):
        res = [g[i] for g in got]
        for name, dtype, rate, fault in job["variants"]:
            rows = [res[r][name] for r in range(world)]
            r0 = rows[0]
            loss_tol, leaf_tol, table_tol = gate(dtype)
            held = "loss_abs_err" in r0
            within = held and (r0["loss_abs_err"] <= loss_tol
                               and r0["grad_l2_rel_err_max"] <= leaf_tol
                               and r0["token_table_grad_l2_rel_err_max"] <= table_tol)
            whole_equal = all(x["whole_leaf_grads"] == r0["whole_leaf_grads"]
                              and x["whole_leaf_params"] == r0["whole_leaf_params"] for x in rows)
            launches = all(x["launches"] == want_launches(x["coords"]) for x in rows)
            state = all(tuple(x["state_bytes"]) == want_bytes for x in rows)
            parts = all(x["parts_are_slices"] for x in rows)
            in_path = {k_: max(x["in_path"].get(k_, 0.0) for x in rows)
                       for k_ in set().union(*(x["in_path"] for x in rows))}
            in_path_ok = all(v_ <= REL_TOL[dtype] for v_ in in_path.values())
            planted = name in must_fail
            step_ok = (not within) if planted else (within or not held)
            ok = (launches and state and parts and in_path_ok and step_ok
                  and (planted or whole_equal))
            emit({"phase": phase, "variant": name, "card": card, "mesh": job["mesh"],
                  "ranks_on_one_card": world, "backend": "gloo through host memory",
                  "config": "examples/production_config.yaml",
                  "batch": int(job["batch"][0].shape[1]), "block_size": job["cfg"].block_size,
                  "n_layer": job["cfg"].n_layer, "dropout": rate, "dtype": dtype,
                  "fault": fault,
                  "against": "the one-rank step on the card, same dtype, dropout, batch and "
                             "salts" if held else "its kernels' plain versions in-path only",
                  "must_fail": planted, "loss_tol": loss_tol, "grad_l2_rel_tol": leaf_tol,
                  "token_table_grad_l2_rel_tol": table_tol,
                  **{k_: r0[k_] for k_ in ("loss_ref", "loss_abs_err", "grad_l2_rel_err_max",
                                           "token_table_grad_l2_rel_err_max", "worst_leaves")
                     if k_ in r0},
                  "losses_by_rank": [x["loss"] for x in rows],
                  "whole_leaves_bit_equal_across_ranks": whole_equal,
                  "parts_are_slices_of_the_updated_tree": parts,
                  "train_state_bytes_by_rank": [tuple(x["state_bytes"]) for x in rows],
                  "train_state_bytes_expected": want_bytes,
                  "in_path_l2_rel": in_path, "in_path_tol": REL_TOL[dtype],
                  "launches_by_rank": [{k_: v_ for k_, v_ in x["launches"].items() if v_}
                                       for x in rows], "launches_exact": launches,
                  **(extra or {}), "seconds_with_spawn_all_jobs": sec, "ok": ok})
            if not ok:
                failed.append(f"{phase} {name}")
    if failed:
        raise AssertionError(f"reference steps failed: {failed}")
    return results, also_got


def production_step_job(cfg, sc, B: int, seed: int, **job):
    """The common part of a ``mesh_rank`` job: the production config's
    weights (seed 1234) and a global batch of B rows drawn from ``seed``."""
    import numpy as np
    import torch

    from trade_aid_multimodal_transformer_tpu_torch.models.init import init_params

    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(np.stack([rng.integers(0, v, (B, cfg.block_size + 1))
                                     for v in cfg.vocab_sizes]))
    return dict(cfg=cfg, params=init_params(cfg, torch.Generator().manual_seed(1234), "cpu"),
                batch=(ids[..., :-1], ids[..., 1:]), lr=sc["learning_rate"], **job)


def mod_launches(K, cfg, mod: int):
    """The kernel launches of one step of a modality place of ``{mod:
    mod}`` (a function of the rank's coordinates): its modalities' fused
    calls, one a layer, and the cross kernels of the cross-attending
    modalities it owns."""
    L = cfg.n_layer
    cross = [i for i in range(cfg.num_modalities) if cfg.cross_attention[i]]

    def want(coords):
        per = cfg.num_modalities // mod
        owned = sum(1 for i in cross if coords["mod"] * per <= i < (coords["mod"] + 1) * per)
        return {**dict.fromkeys(K.KERNELS, 0),
                **dict(fused_qkv_attention=L, fused_qkv_attention_bwd=L,
                       short_cross_attention=owned * L, short_cross_attention_bwd=owned * L)}

    return want


def mod_gate(dtype):
    """``dp_reference``'s gate: (loss, leaf, token-table) limits."""
    return STEP_TOL[dtype]["loss"], REL_TOL[dtype], STEP_TOL[dtype]["grad_l2"]


def step_gate(dtype):
    """The step gate ``train_reference`` holds the card to."""
    return STEP_TOL[dtype]["loss"], STEP_TOL[dtype]["grad_l2"], STEP_TOL[dtype]["grad_l2"]


def mod_phases(K, card, by_path, one_rank, also=(), also_entries=()):
    """Modality parallelism (``mesh: {mod: 2}``) on the one card, two ranks
    sharing it (gloo through host memory):
    - ``mod_reference``: one production step (dropout 0.2, batch 32, bf16
      moments) in bf16 and in f32 against the one-rank step of the same
      dtype on the same batch and salts, at ``dp_reference``'s gates (loss
      STEP_TOL, every gathered gradient leaf REL_TOL, the token tables
      STEP_TOL's leaf limit): a rank computes what the one-rank step
      computes on its modalities, only sums move; the leaves the axis
      keeps whole bit-equal across the ranks, each rank's parts its slices,
      exact launches per rank (its modalities' fused call a layer, the
      cross kernels of the modalities it owns), bytes ``state_bytes(cfg,
      mod=2)``; rank 1's masks keyed as place 0's must exceed the gate. The
      production config's cross-attending modalities 0 and 1 both sit on
      place 0 at ``{mod: 2}``, so a rank that skipped another's cross
      sites would change nothing there: that fault runs over ``{mod: 4}``
      (4 ranks, modality 1's cross sites after modality 0's), beside that
      layout's sound step and bytes, in ``four_rank_references``.
    - ``mod_training``: the entry over the two ranks, 4 steps, at dropout 0
      and 0.2 against the one-rank entry with the same seed (``one_rank``,
      from ``fsdp_phases``): final eval losses within STEP_TOL, every
      rank's checksum of the gathered parameters equal, exact launches per
      rank, every rank's train-state bytes ``state_bytes(cfg, mod=2)``, the
      modality collectives' bytes, calls and ms a step (TAT_TIMING); the
      checkpoint of the run at 0.2 loading in a one-rank run that trains
      on.
    ``also`` (rank calls) and ``also_entries`` (an ``entry_runs`` plan): a
    later phase's work on two ranks, run in the same start of the rank
    processes after this phase's (a start costs 15–20 s); their results are
    returned, per call and per run. Adds ``by_path["mod_training"]``;
    raises on a failed check."""
    from trade_aid_multimodal_transformer_tpu_torch import generate as entry

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d)
        data = entry.load_config_and_data(str(d))
    cfg, sc = data["cfg"], data["sc"]
    want_step = lambda mod: mod_launches(K, cfg, mod)  # noqa: E731

    # mod_reference, then mod_training's runs over the two ranks at dropout
    # 0 and 0.2 (seed 5) in the same start of the rank processes; the run at
    # 0.2 writes its checkpoint, which a one-rank run loads
    config = dict(PARALLEL_ENTRY)
    want_bytes = state_bytes(cfg, mod=MOD_RANKS)
    bf, f32 = "bfloat16", "float32"
    with tempfile.TemporaryDirectory() as tmp:
        dirs = parallel_entry_dirs(Path(tmp), "{mod: 2}")
        results, also_got = mesh_reference(K, card, [("mod_reference", production_step_job(
            cfg, sc, sc["batch_size"], 13, mesh=dict(mod=MOD_RANKS), refs=[(bf, 0.2), (f32, 0.2)],
            variants=[("sound", bf, 0.2, None), ("sound_f32", f32, 0.2, None),
                      ("mod_offset_0", bf, 0.2, "mod_offset_0")]),
            want_bytes, want_step(MOD_RANKS), mod_gate, ("mod_offset_0",), None)],
            [(dirs[rate], dirs["text", rate], None) for rate in (0.0, 0.2)] + list(also_entries),
            also)
        runs = dict(zip((0.0, 0.2), results))
        d = dirs["resume"]  # a one-rank run from the 0.2 run's checkpoint
        shutil.copytree(dirs[0.2] / "output", d / "output")
        (d / "config.yaml").write_text(
            dirs["text", "resume"].replace("mesh: {mod: 2}", "mesh: \"off\""))
        loaded = entry_run(K, d)
    eval_batches = expected_evals(config["max_iters"], config["eval_interval"]) * 2 * 2
    failed = []
    for rate in (0.0, 0.2):
        r = runs[rate]
        sums = r["param_checksums"]
        errs_ = {k_: abs(r["losses"][k_] - one_rank[rate]["losses"][k_]) for k_ in ("train", "val")}
        launches = [x["launches_rank"] for x in r["ranks"]]
        want = []
        for place in range(MOD_RANKS):  # rank r is modality place r
            step = want_step(MOD_RANKS)({"mod": place})
            want.append({name: n_ * config["max_iters"]
                         + (n_ * eval_batches if name in ("fused_qkv_attention",
                                                          "short_cross_attention") else 0)
                         for name, n_ in step.items()})
        steps = config["max_iters"]
        calls = {kind: [(n_, t_) for k_, n_, t_ in r["collectives"] or [] if k_ == kind]
                 for kind in ("mod_all_gather", "mod_reduce_scatter_bwd", "mod_all_reduce")}
        held = [tuple(x["train_state_bytes"]) for x in r["ranks"]]
        ok = (len(sums) == MOD_RANKS and all(s_ == sums[0] for s_ in sums)
              and all(e <= STEP_TOL["bfloat16"]["loss"] for e in errs_.values())
              and len(r["evals"]) == len(one_rank[rate]["evals"]) > 1
              and launches == want
              and "Parallelism: modality x2 over 2 devices" in r["console"]
              and "TRAINING COMPLETED SUCCESSFULLY" in r["console"]
              and held == [want_bytes] * MOD_RANKS and all(calls.values()))
        line = {"phase": "mod_training", "config": "examples/production_config.yaml",
                "card": card, "changed": {**config, "dropout": rate, "mesh": "{mod: 2}"},
                "ranks_on_one_card": MOD_RANKS, "backend": "gloo through host memory",
                "plan": r["plan"].describe(), "global_batch": sc["batch_size"],
                "evals": r["evals"], "evals_one_rank": one_rank[rate]["evals"],
                "final_eval_losses": r["losses"],
                "final_eval_losses_one_rank": one_rank[rate]["losses"],
                "abs_err_vs_one_rank": errs_, "tol": STEP_TOL["bfloat16"]["loss"],
                "param_checksums_by_rank": sums,
                "launches_by_rank": [{k_: v_ for k_, v_ in x.items() if v_} for x in launches],
                "expected_launches_by_rank": [{k_: v_ for k_, v_ in x.items() if v_}
                                              for x in want],
                "train_state_bytes_by_rank": held, "train_state_bytes_expected": want_bytes,
                "max_memory_allocated_by_rank": [x["max_memory_allocated"] for x in r["ranks"]],
                "steps_per_s_after_first_chunk": r["steps_per_s"],
                "steps_per_s_one_rank": one_rank[rate]["steps_per_s"],
                **{f"{kind}_{what}": v_ for kind, c_ in calls.items() for what, v_ in (
                    ("bytes_per_step", sum(n_ for n_, _ in c_) / steps),
                    ("calls_per_step", len(c_) / steps),
                    ("ms_per_step", 1e3 * sum(t_ for _, t_ in c_) / steps))},
                "collectives_note": "over the whole run (eval passes' gathers included), per "
                                    "training step; host clock around each staged gloo call, "
                                    "the card synchronised before and after",
                "seconds_with_spawn": r["seconds"]}
        if rate == 0.2:
            load_ok = ("Model: Loaded successfully" in loaded["console"]
                       and "TRAINING COMPLETED SUCCESSFULLY" in loaded["console"]
                       and loaded["plan"].trivial
                       and all(math.isfinite(v) for v in loaded["losses"].values()))
            ok = ok and load_ok
            line["one_rank_load"] = {"ok": load_ok, "final_eval_losses": loaded["losses"]}
            by_path["mod_training"] = launches[0]
        line["ok"] = ok
        emit(line)
        if not ok:
            failed.append(rate)
    if failed:
        raise AssertionError(f"the modality-parallel training entry failed its checks at "
                             f"dropout {failed}")
    return also_got, results[2:]


PP_RANKS, PP_MU = 2, 4


def pp_rank(rank: int, world: int, job: dict):
    """One rank of ``pp_reference`` (and of ``pp_tp_reference`` and
    ``pp_mod_reference``) in a process of its own (the ranks share the one
    card: gloo through host memory). Rank 0 first takes the one-rank
    pipeline (S = 1, the same µ and keys: ``pipeline_total_loss`` without
    an axis, differentiated, then the AdamW update) at each dropout of
    ``job["variants"]`` above 0 (at every one with ``job["bit_rates"]``),
    and the one-rank sequential step (the plain Trainer) at dropout 0. Then
    every rank takes the step over ``make_mesh(**job["mesh"])`` (default
    ``{pipe: world}``) on its parts (``shard_train_state``: a model or
    modality axis splits leaves, which the step gathers whole) and its
    update, per variant (name, dropout, fault): fault None,
    "stage1_keys_from_0" (stage 1 keys its layers from layer 0's keys, not
    from L / S's), "bwd_handoff_forward_order" (stage 1 sends its input
    gradients back in the forward's microbatch order) or "model_group_sum"
    (the gathered leaves' gradients summed over the model group before the
    rank keeps its slices). The sound variants hold every K1f, K1b, K2f
    and K2b call in-path against its plain version. Returns per variant
    the loss, the launches, the in-path errors, the digests of the updated
    parameters and moments (gathered whole), the rank's train-state bytes,
    the model and modality gathers' bytes and ms of the step and, on rank
    0, whether the loss, every gathered gradient leaf and the updated
    parameters are bit-equal to the one-rank pipeline's, and the
    gradients' errors against it (or at dropout 0 against the sequential
    step)."""
    sys.path.insert(0, str(REPO))
    import hashlib

    import torch

    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        map_tree, tree_leaves, tree_paths)
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
    from trade_aid_multimodal_transformer_tpu_torch.parallel import pipeline as pp
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import (
        make_sharded_trainer, shard_train_state)
    from trade_aid_multimodal_transformer_tpu_torch.train import steps as tsteps
    from trade_aid_multimodal_transformer_tpu_torch.utils.memory import train_state_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job.get("device", "cuda"))  # "cpu": a rehearsal of the phase
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = pmesh.make_mesh(**job.get("mesh", dict(pipe=world)), staged=dev.type == "cuda")
    stages = mesh.pipe.size
    timing = []
    for axis in (mesh.model, mesh.mod):
        if axis is not None:
            axis.timing = timing
    xb, yb = (t.to(dev) for t in job["batch"])
    mu, L = job["mu"], job["cfg"].n_layer
    names = ["/".join(map(str, path)) for path, _ in tree_paths(job["params"])]
    table = [name.startswith("pre/tok_emb/") for name in names]

    def config(rate):
        return dataclasses.replace(job["cfg"], dropout=rate)

    def fresh():
        return map_tree(lambda t: t.detach().to(dev).clone().requires_grad_(), job["params"])

    def optimizer():
        return tsteps.make_optimizer(job["lr"], moment_dtype="bfloat16", nu_dtype="bfloat16")

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().float().cpu().numpy().tobytes())
        return h.hexdigest()

    def errors(grads, ref):
        """Each leaf's L2 error against its own scale, floored at a 1e-4
        share of the whole, the token tables apart (mesh_rank's measure)."""
        norms = [r.norm().item() for r in ref]
        floor = 1e-4 * math.sqrt(sum(n_ * n_ for n_ in norms))
        errs_leaf = [(g.float() - r.float()).norm().item() / max(n_, floor)
                     for g, r, n_ in zip(grads, ref, norms)]
        return {"grad_l2_rel_err_max": max(e for e, t in zip(errs_leaf, table) if not t),
                "token_table_grad_l2_rel_err_max": max(e for e, t in zip(errs_leaf, table) if t),
                "worst_leaves": sorted(zip(errs_leaf, names), reverse=True)[:4]}

    refs = {}
    if rank == 0:
        for rate in sorted({v[1] for v in job["variants"] if v[1] > 0 or job.get("bit_rates")}):
            params, opt = fresh(), optimizer()
            state = opt.init(params)
            loss, _ = pp.pipeline_total_loss(params, config(rate), xb, yb, None, mu, SALTS, True)
            grads = torch.autograd.grad(loss, tree_leaves(params))
            opt.update_(params, grads, state)
            refs["pipe1", rate] = (loss.detach(), [g.detach() for g in grads],
                                   [t.detach() for t in tree_leaves(params)])
            del params, state, loss, grads
        loss, grads = tsteps.Trainer(config(0.0), None, optimizer(), [], 1).loss_and_grads(
            fresh(), [(xb, yb)], [SALTS])
        refs["seq", 0.0] = loss.detach(), [g.detach() for g in grads]
        del loss, grads
    real_keys = pp.pipeline_keys
    out = {}
    for name, rate, fault in job["variants"]:
        opt = optimizer()
        params, _, placed = shard_train_state(fresh(), None, mesh.data, False, mesh.model,
                                              mesh.mod)
        state = opt.init(params)
        whole = (lambda tree, kind="all_gather": tree) if placed is None else placed.whole
        if fault == "model_group_sum":
            real_part = placed.split_part

            def summed(leaves):
                return real_part([mesh.model._sum_flat("fault", [g])[0] if m is not None else g
                                  for g, m in zip(leaves, placed.model_dims)])

            placed.split_part = summed
        if fault == "stage1_keys_from_0" and rank == 1:
            def keys_from_0(*args):
                keys = real_keys(*args)
                per = L // stages
                return keys if keys is None else torch.cat([keys[:per], keys[:per], keys[2 * per:]])

            pp.pipeline_keys = keys_from_0
        if fault == "bwd_handoff_forward_order" and rank == 1:
            pending, real_send = [], mesh.pipe.send

            def forward_order(t, step):
                if step != -1:
                    return real_send(t, step)
                pending.append(t.clone())  # backward: the last microbatch's first
                if len(pending) == mu:
                    for x in reversed(pending):
                        real_send(x, step)
                    pending.clear()

            mesh.pipe.send = forward_order
        worst = {}
        fns = {} if fault else {k_: checked(K, k_, getattr(K, k_), worst) for k_ in (
            "fused_qkv_attention", "fused_qkv_attention_bwd", "short_cross_attention",
            "short_cross_attention_bwd")}
        try:
            trainer = make_sharded_trainer(config(rate), None, opt, [], 1, mesh, fsdp=placed,
                                           pipeline_microbatches=mu)
            with patched(K, **fns):
                K.reset_launch_counts()
                timing.clear()
                loss, grads = trainer.loss_and_grads(params, [(xb, yb)], [SALTS])
                sync()
            counts = K.launch_counts()
            gathers = [(n_, t_) for k_, n_, t_ in timing if k_ == "split_all_gather"]
            for k_, fn in fns.items():  # a wrapper counts on the name it is patched over
                if k_ in counts:
                    counts[k_] += fn.launches
        finally:
            pp.pipeline_keys = real_keys
            mesh.pipe.__dict__.pop("send", None)
        whole_grads = whole(list(grads), "grads")
        opt.update_(params, grads, state)
        leaves = tree_leaves(whole(params))
        res = {"dropout": rate, "loss": loss.item(), "launches": counts, "in_path": worst,
               "params": digest(leaves), "mu": digest(tree_leaves(whole(state["mu"]))),
               "nu": digest(tree_leaves(whole(state["nu"]))),
               "state_bytes": train_state_bytes(params, state, opt,
                                                None if placed is None else placed.parts()),
               "coords": mesh.coords, "gather_bytes": sum(n_ for n_, _ in gathers),
               "gather_ms": 1e3 * sum(t_ for _, t_ in gathers), "gather_calls": len(gathers)}
        grads = whole_grads
        if rank == 0 and ("pipe1", rate) in refs:
            loss1, grads1, after1 = refs["pipe1", rate]
            res.update(loss_ref=loss1.item(), loss_bit_equal=torch.equal(loss, loss1),
                       grad_leaves_bit_equal=sum(torch.equal(a, b) for a, b in zip(grads, grads1)),
                       n_leaves=len(grads1),
                       params_bit_equal=all(torch.equal(a, b) for a, b in zip(leaves, after1)),
                       loss_abs_err=abs(loss.item() - loss1.item()), **errors(grads, grads1))
        if rank == 0 and rate == 0.0:
            loss0, grads0 = refs["seq", 0.0]
            res["vs_sequential"] = {"loss_ref": loss0.item(),
                                    "loss_abs_err": abs(loss.item() - loss0.item()),
                                    **errors(grads, grads0)}
        out[name] = res
        del params, state, loss, grads, whole_grads, trainer
    return out


def hold_pp_reference(card, phase, job, ref_rows, step, want_bytes, extra) -> list:
    """One line per variant of a ``pp_rank`` job (``ref_rows``: every
    rank's results): rank 0's loss, gathered gradients and updated
    parameters bit-equal to the one-rank pipeline's where it holds them
    (the sound variants at dropout 0.2, at every rate with
    ``job["bit_rates"]``) and within ``dp_reference``'s gate of it (of the
    one-rank sequential step at dropout 0), the parameters and moments
    equal on every rank, exact launches ``step`` on every rank, every
    rank's train-state bytes ``want_bytes``, every in-path K1/K2 call
    within REL_TOL; a planted fault must break the bits and exceed the
    gate. Returns the failed variants' names."""
    mesh = job.get("mesh", {"pipe": len(ref_rows)})
    ranks = math.prod(mesh.values())
    bits_always = bool(job.get("bit_rates"))
    failed = []
    loss_tol, leaf_tol, table_tol = mod_gate("bfloat16")
    for name, rate, fault in job["variants"]:
        rows = [ref_rows[r][name] for r in range(ranks)]
        r0 = rows[0]
        bit_equal = (r0.get("loss_bit_equal") and r0.get("params_bit_equal")
                     and r0.get("grad_leaves_bit_equal") == r0.get("n_leaves"))
        gate = r0.get("vs_sequential", r0) if rate == 0.0 else r0
        within = (gate["loss_abs_err"] <= loss_tol and gate["grad_l2_rel_err_max"] <= leaf_tol
                  and gate["token_table_grad_l2_rel_err_max"] <= table_tol)
        ranks_equal = all(x[k_] == r0[k_] for x in rows for k_ in ("params", "mu", "nu"))
        launches = all(x["launches"] == step for x in rows)
        held = all(tuple(x["state_bytes"]) == want_bytes for x in rows)
        in_path = {k_: max(x["in_path"].get(k_, 0.0) for x in rows)
                   for k_ in set().union(*(x["in_path"] for x in rows))}
        in_path_ok = all(v_ <= REL_TOL["bfloat16"] for v_ in in_path.values())
        if fault:
            ok = not bit_equal and not within and launches
        else:
            ok = (ranks_equal and launches and held and in_path_ok and within
                  and (bit_equal or (rate == 0.0 and not bits_always)) and len(in_path) == 9)
        emit({"phase": phase, "variant": name, "card": card, "mesh": mesh,
              "microbatches": job["mu"], "ranks_on_one_card": ranks,
              "backend": "gloo through host memory", "config": "examples/production_config.yaml",
              "batch": int(job["batch"][0].shape[1]), "dropout": rate, "dtype": "bfloat16",
              "fault": fault,
              "against": "the one-rank sequential step (dp_reference's gate)"
              if rate == 0.0 and not bits_always
              else "the one-rank pipeline (S = 1, same µ and keys): bit-equal, and "
                   "dp_reference's gate",
              "loss_tol": loss_tol, "grad_l2_rel_tol": leaf_tol,
              "token_table_grad_l2_rel_tol": table_tol, "bit_equal": bool(bit_equal),
              **{k_: r0[k_] for k_ in ("loss_ref", "loss_bit_equal", "grad_leaves_bit_equal",
                                       "n_leaves", "params_bit_equal", "loss_abs_err",
                                       "grad_l2_rel_err_max", "token_table_grad_l2_rel_err_max",
                                       "worst_leaves", "vs_sequential") if k_ in r0},
              "losses_by_rank": [x["loss"] for x in rows],
              "params_mu_nu_equal_across_ranks": ranks_equal,
              "train_state_bytes_by_rank": [tuple(x["state_bytes"]) for x in rows],
              "train_state_bytes_expected": want_bytes,
              "split_gather_bytes_by_rank": [x["gather_bytes"] for x in rows],
              "split_gather_ms_by_rank": [x["gather_ms"] for x in rows],
              "in_path_l2_rel": in_path, "in_path_tol": REL_TOL["bfloat16"],
              "launches_by_rank": [{k_: v_ for k_, v_ in x["launches"].items() if v_}
                                   for x in rows], "launches_exact": launches,
              **extra, "ok": ok})
        if not ok:
            failed.append(f"{phase} {name}")
    return failed


def pp_phases(K, card, by_path, one_rank, start):
    """Pipeline parallelism (``mesh: {pipe: 2}``, µ = 4, the GPipe schedule
    over the production config's 6 layers: 3 a stage) on the one card, two
    ranks sharing it (gloo through host memory), in the start of the rank
    processes that ``start(calls, plan)`` runs them in (``mod_phases``'s:
    it returns the calls' per-rank results and the plan's entry results):
    - ``pp_reference``: one production step (bf16, dropout 0.2, batch 32,
      bf16 moments): the loss, every gradient leaf and the updated
      parameters bit-equal to the one-rank pipeline's (S = 1, the same µ and
      keys: each stage runs the same kernels on the same microbatch rows,
      the backward visits the microbatches in one order and each leaf's
      gradient comes from the one stage that owns it); the parameters and
      moments equal on both ranks; every K1f, K1b, K2f and K2b call of the
      step at the microbatch shape within REL_TOL of its plain version;
      exact launches per rank (K1f and K1b (L/S) µ = 12, K2f and K2b 24);
      every rank's train-state bytes the whole tree's (``state_bytes``);
      the same step at dropout 0 within ``dp_reference``'s gate of the
      one-rank sequential step. Planted: stage 1 keying its layers from
      layer 0's keys, and stage 1 sending its backward handoffs in the
      forward's microbatch order: each must break the bit-equality and
      exceed ``dp_reference``'s gate against the one-rank pipeline.
    - ``pp_training``: the entry over the two ranks, 4 steps, at dropout 0
      and 0.2 against the one-rank entry with the same seed (``one_rank``):
      final eval losses within STEP_TOL, every rank's checksum equal, exact
      launches per rank (a step's above, 6 K1f and 12 K2f an evaluation
      batch), the handoffs' send and receive bytes, calls and ms a step
      (TAT_TIMING), every rank's bytes the whole tree's; the checkpoint of
      the run at 0.2 loading in a one-rank run that trains on.
    Adds ``by_path["pp_training"]``; raises on a failed check."""
    from trade_aid_multimodal_transformer_tpu_torch import generate as entry

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d)
        data = entry.load_config_and_data(str(d))
    cfg, sc = data["cfg"], data["sc"]
    L, n_cross, S = cfg.n_layer, sum(cfg.cross_attention), PP_RANKS
    step = {**dict.fromkeys(K.KERNELS, 0),
            **dict(fused_qkv_attention=L // S * PP_MU, fused_qkv_attention_bwd=L // S * PP_MU,
                   short_cross_attention=n_cross * L // S * PP_MU,
                   short_cross_attention_bwd=n_cross * L // S * PP_MU)}
    want_bytes = state_bytes(cfg)
    config = dict(PARALLEL_ENTRY)
    job = production_step_job(cfg, sc, sc["batch_size"], 13, mu=PP_MU, variants=[
        ("sound", 0.2, None), ("sound_dropout_0", 0.0, None),
        ("stage1_keys_from_0", 0.2, "stage1_keys_from_0"),
        ("bwd_handoff_forward_order", 0.2, "bwd_handoff_forward_order")])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = parallel_entry_dirs(Path(tmp), "{pipe: 2}")
        # only the run at 0.2 writes checkpoints (the one-rank load reads its last)
        dirs["text", 0.0] = dirs["text", 0.0].replace("save_model: 1", "save_model: 0")
        (ref_rows,), runs = start([(pp_rank, (job,))], [(dirs[rate], dirs["text", rate], None)
                                                         for rate in (0.0, 0.2)])
        runs = dict(zip((0.0, 0.2), runs))
        d = dirs["resume"]  # a one-rank run from the 0.2 run's checkpoint
        shutil.copytree(dirs[0.2] / "output", d / "output")
        (d / "config.yaml").write_text(
            dirs["text", "resume"].replace("mesh: {pipe: 2}", "mesh: \"off\""))
        loaded = entry_run(K, d)
    sec = time.perf_counter() - t0
    failed = hold_pp_reference(card, "pp_reference", job, ref_rows, step, want_bytes,
                               {"seconds_with_mod_phases": sec})
    eval_batches = expected_evals(config["max_iters"], config["eval_interval"]) * 2 * 2
    per_eval = dict(fused_qkv_attention=L, short_cross_attention=n_cross * L)
    want = {k_: n_ * config["max_iters"] + per_eval.get(k_, 0) * eval_batches
            for k_, n_ in step.items()}
    steps = config["max_iters"]
    for rate in (0.0, 0.2):
        r = runs[rate]
        sums = r["param_checksums"]
        errs_ = {k_: abs(r["losses"][k_] - one_rank[rate]["losses"][k_]) for k_ in ("train", "val")}
        launches = [x["launches_rank"] for x in r["ranks"]]
        calls = {kind: [(n_, t_) for k_, n_, t_ in r["collectives"] or [] if k_ == kind]
                 for kind in ("send", "recv", "pipe_broadcast", "pipe_all_reduce")}
        held = [tuple(x["train_state_bytes"]) for x in r["ranks"]]
        ok = (len(sums) == S and all(s_ == sums[0] for s_ in sums)
              and all(e <= STEP_TOL["bfloat16"]["loss"] for e in errs_.values())
              and len(r["evals"]) == len(one_rank[rate]["evals"]) > 1
              and launches == [want] * S
              and "Parallelism: pipeline x2 over 2 devices" in r["console"]
              and "TRAINING COMPLETED SUCCESSFULLY" in r["console"]
              and held == [want_bytes] * S and all(calls.values()))
        line = {"phase": "pp_training", "config": "examples/production_config.yaml",
                "card": card, "changed": {**config, "dropout": rate, "mesh": "{pipe: 2}"},
                "microbatches": PP_MU, "ranks_on_one_card": S,
                "backend": "gloo through host memory", "plan": r["plan"].describe(),
                "global_batch": sc["batch_size"], "evals": r["evals"],
                "evals_one_rank": one_rank[rate]["evals"], "final_eval_losses": r["losses"],
                "final_eval_losses_one_rank": one_rank[rate]["losses"],
                "abs_err_vs_one_rank": errs_, "tol": STEP_TOL["bfloat16"]["loss"],
                "param_checksums_by_rank": sums,
                "launches_by_rank": [{k_: v_ for k_, v_ in x.items() if v_} for x in launches],
                "expected_launches_per_rank": {k_: v_ for k_, v_ in want.items() if v_},
                "train_state_bytes_by_rank": held, "train_state_bytes_expected": want_bytes,
                "max_memory_allocated_by_rank": [x["max_memory_allocated"] for x in r["ranks"]],
                "steps_per_s_after_first_chunk": r["steps_per_s"],
                "steps_per_s_one_rank": one_rank[rate]["steps_per_s"],
                **{f"{kind}_{what}": v_ for kind, c_ in calls.items() for what, v_ in (
                    ("bytes_per_step", sum(n_ for n_, _ in c_) / steps),
                    ("calls_per_step", len(c_) / steps),
                    ("ms_per_step", 1e3 * sum(t_ for _, t_ in c_) / steps))},
                "collectives_note": "rank 0's (stage 0: its sends forward and receives "
                                    "backward), per training step; host clock around each "
                                    "staged gloo call, the card synchronised before and after",
                "seconds_with_spawn": r["seconds"]}
        if rate == 0.2:
            load_ok = ("Model: Loaded successfully" in loaded["console"]
                       and "TRAINING COMPLETED SUCCESSFULLY" in loaded["console"]
                       and loaded["plan"].trivial
                       and all(math.isfinite(v) for v in loaded["losses"].values()))
            ok = ok and load_ok
            line["one_rank_load"] = {"ok": load_ok, "final_eval_losses": loaded["losses"]}
            by_path["pp_training"] = launches[0]
        line["ok"] = ok
        emit(line)
        if not ok:
            failed.append(f"pp_training {rate}")
    if failed:
        raise AssertionError(f"pipeline parallelism failed its checks: {failed}")


def mod_cp_launches(K, cfg, mod: int):
    """The K7 launches of one step of a rank of ``{mod: mod}`` x a sequence
    axis (a function of its coordinates): its modalities' self-attention
    ring and the rings of the cross-attending modalities it owns, one a
    key/value stream, each one causal chunk and one full-mask chunk per
    earlier sequence place, forward and backward."""
    cross = [i for i in range(cfg.num_modalities) if cfg.cross_attention[i]]
    per = cfg.num_modalities // mod

    def want(coords):
        owned = [i for i in cross if coords["mod"] * per <= i < (coords["mod"] + 1) * per]
        rings = cfg.n_layer * (1 + sum(len(cfg.kv_modalities(i)) for i in owned))
        out = dict.fromkeys(K.KERNELS, 0)
        out.update(flash_chunk_fwd_causal=rings, flash_chunk_fwd_full=rings * coords["seq"],
                   flash_chunk_bwd_causal=rings, flash_chunk_bwd_full=rings * coords["seq"])
        return out

    return want


def four_rank_references(K, card, mod_seq_ref):
    """The reference steps over four ranks sharing the one card (gloo
    through host memory), in one start of the rank processes:
    - ``mod_reference`` over ``{mod: 4}``: the sound step (bf16, dropout
      0.2) at ``dp_reference``'s gate, and a rank that draws no salts for
      another rank's cross sites (modality 1's sites after modality 0's),
      which must exceed it; bytes ``state_bytes(cfg, mod=4)``.
    - ``tp_split_reference``: ``{model: 4}`` over the production config's
      6 heads, which 4 does not divide: w1_*, b1_* and proj_w1 split
      through the heads (a head and a half a rank), the per-head leaves
      whole; one production step at dropout 0.2, bf16, against the
      one-rank step (STEP_TOL), the whole leaves bit-equal across the
      ranks, the parts the slices, a one-rank step's launches on every
      rank, bytes ``state_bytes(cfg, model=4)``.
    - ``tp_seq_reference``: ``{model: 2}`` x ``context_parallel: 2`` at
      block_size 1024, depth 2, batch 1: the step at dropout 0 in f32 and
      bf16 against the card's single-rank step (K5/K6; STEP_TOL), and at
      dropout 0.2 in bf16 (the rings keyed by local rows and heads, the
      key folded with the model place: no one-rank counterpart), every K7f
      and K7b call of every variant in-path within REL_TOL of its plain
      version; exact K7 launches per rank; bytes ``state_bytes(cfg,
      model=2)`` at that depth.
    - ``mod_seq_reference``: ``{mod: 2}`` x ``context_parallel: 2`` at the
      same size: at dropout 0 against the card's single-rank step
      (STEP_TOL), at 0.2 against ``mod_seq_ref``, the ring step over 2
      ranks (``context_parallel``; ``dp_reference``'s gate: the same
      masks, the modality rows keyed by their index in the whole M), every
      K7 call in-path; a ring keying its modality rows from 0 must exceed
      that gate; exact K7 launches per rank (``mod_cp_launches``); bytes
      ``state_bytes(cfg, mod=2)``.
    - ``pp_tp_reference`` (``{pipe: 2, model: 2}``) and
      ``pp_mod_reference`` (``{pipe: 2, mod: 2}``): one production step
      (µ 4, bf16, batch 32) at dropout 0.2 and 0, every rank computing its
      stage whole on the gathered tree: the loss, every gathered gradient
      leaf and the update bit-equal to the one-rank pipeline's
      (``hold_pp_reference``), exact launches (K1f and K1b 12 a stage, K2f
      and K2b 24), bytes ``state_bytes(cfg, model=2)`` and ``(cfg,
      mod=2)``, the gather's bytes and ms; a model-group sum of the
      gathered leaves' gradients must break the bits.
    - ``cp_reference`` at P = 4, depth 2 (``cp_reference_job``).
    Raises on a failed check."""
    from trade_aid_multimodal_transformer_tpu_torch import generate as entry

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d)
        data = entry.load_config_and_data(str(d))
        production_config_dir(d, block_size=LONG_BLOCK)
        long = entry.load_config_and_data(str(d))
    cfg, sc = data["cfg"], data["sc"]
    L, n_cross = cfg.n_layer, sum(cfg.cross_attention)
    one_rank_step = {**dict.fromkeys(K.KERNELS, 0),
                     **dict(fused_qkv_attention=L, fused_qkv_attention_bwd=L,
                            short_cross_attention=n_cross * L,
                            short_cross_attention_bwd=n_cross * L)}
    stage_step = {**dict.fromkeys(K.KERNELS, 0),
                  **dict(fused_qkv_attention=L // 2 * PP_MU, fused_qkv_attention_bwd=L // 2 * PP_MU,
                         short_cross_attention=n_cross * L // 2 * PP_MU,
                         short_cross_attention_bwd=n_cross * L // 2 * PP_MU)}
    bf, f32 = "bfloat16", "float32"
    c = dataclasses.replace(long["cfg"], n_layer=2)
    pp_jobs = {name: production_step_job(
        cfg, sc, sc["batch_size"], 13, mu=PP_MU, mesh=dict(pipe=2, **{axis: 2}), bit_rates=True,
        variants=[("sound", 0.2, None), ("sound_dropout_0", 0.0, None)] + (
            [("model_group_sum", 0.2, "model_group_sum")] if axis == "model" else []))
        for name, axis in (("pp_tp_reference", "model"), ("pp_mod_reference", "mod"))}
    cp4_job = cp_reference_job(long["cfg"], 2, 4, *cp_batch(long["cfg"]))
    t0 = time.perf_counter()
    _, (pp_tp_rows, pp_mod_rows, cp4_rows) = mesh_reference(K, card, [
        ("mod_reference", production_step_job(
            cfg, sc, sc["batch_size"], 13, mesh=dict(mod=4), refs=[(bf, 0.2)],
            variants=[("sound_mod4", bf, 0.2, None),
                      ("skip_cross_keys_mod4", bf, 0.2, "skip_cross_keys")]),
         state_bytes(cfg, mod=4), mod_launches(K, cfg, 4), mod_gate,
         ("skip_cross_keys_mod4",), None),
        ("tp_split_reference", production_step_job(
            cfg, sc, sc["batch_size"], 13, mesh=dict(model=4), refs=[(bf, 0.2)],
            variants=[("sound", bf, 0.2, None)]),
         state_bytes(cfg, model=4), lambda coords: one_rank_step, step_gate, (),
         {"heads_per_rank": cfg.n_head / 4}),
        ("tp_seq_reference", production_step_job(
            c, long["sc"], 1, 11, mesh=dict(model=2, seq=2), refs=[(f32, 0.0), (bf, 0.0)],
            in_path=True, variants=[("f32", f32, 0.0, None), ("bf16", bf, 0.0, None),
                                    ("bf16_dropout", bf, 0.2, None)]),
         state_bytes(c, model=2), lambda coords: cp_want(K, c, coords["seq"], "step"),
         step_gate, (), {"context_parallel": 2}),
        ("mod_seq_reference", production_step_job(
            c, long["sc"], 1, 11, mesh=dict(mod=2, seq=2), refs=[(bf, 0.0)], in_path=True,
            variants=[("bf16", bf, 0.0, None)]),
         state_bytes(c, mod=2), mod_cp_launches(K, c, 2), step_gate, (),
         {"context_parallel": 2}),
        ("mod_seq_reference", production_step_job(
            c, long["sc"], 1, 11, mesh=dict(mod=2, seq=2), refs=[],
            given_refs={(bf, 0.2): mod_seq_ref}, in_path=True,
            variants=[("bf16_dropout", bf, 0.2, None),
                      ("rows_from_0", bf, 0.2, "mod_rows_from_0")]),
         state_bytes(c, mod=2), mod_cp_launches(K, c, 2), mod_gate, ("rows_from_0",),
         {"context_parallel": 2, "reference": "the ring step over 2 ranks (context_parallel) "
                                               "at dropout 0.2, bf16, the same batch and salts"})],
        also=[(pp_rank, (pp_jobs["pp_tp_reference"],)), (pp_rank, (pp_jobs["pp_mod_reference"],)),
              (cp_rank, (cp4_job,))])
    sec = time.perf_counter() - t0
    failed = []
    for (name, job), rows in zip(pp_jobs.items(), (pp_tp_rows, pp_mod_rows)):
        axis = "model" if "model" in job["mesh"] else "mod"
        failed += hold_pp_reference(card, name, job, rows, stage_step,
                                    state_bytes(cfg, **{axis: 2}),
                                    {"seconds_with_spawn_all_jobs": sec})
    hold_cp_reference(K, cp4_rows, cp4_job, sec)
    if failed:
        raise AssertionError(f"pipeline parallelism with a model or modality axis failed its "
                             f"checks: {failed}")


def tp_split_seq_reference(K, card):
    """``tp_split_seq_reference``: ``{model: 4}`` x ``context_parallel: 2``
    over the production config's 6 heads (4 does not divide them) at
    block_size 1024, depth 2, batch 1, on eight ranks sharing the one card
    (gloo through host memory), in a start of their own: at dropout 0 in
    bf16 against the card's single-rank step (STEP_TOL); at 0.2 every rank
    rings all 6 heads with the key folded with model place 0 (no one-rank
    counterpart), every K7f and K7b call of both variants in-path within
    REL_TOL of its plain version; exact K7 launches per rank (a ring's, as
    one rank's), the whole leaves bit-equal across the ranks, bytes
    ``state_bytes(cfg, model=4)`` at that depth. Raises on a failed
    check."""
    from trade_aid_multimodal_transformer_tpu_torch import generate as entry

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d, block_size=LONG_BLOCK)
        long = entry.load_config_and_data(str(d))
    bf = "bfloat16"
    c = dataclasses.replace(long["cfg"], n_layer=2)
    mesh_reference(K, card, [
        ("tp_split_seq_reference", production_step_job(
            c, long["sc"], 1, 11, mesh=dict(model=4, seq=2), refs=[(bf, 0.0)], in_path=True,
            variants=[("bf16", bf, 0.0, None), ("bf16_dropout", bf, 0.2, None)]),
         state_bytes(c, model=4), lambda coords: cp_want(K, c, coords["seq"], "step"),
         step_gate, (), {"context_parallel": 2, "heads_per_rank": c.n_head})])


def native_check(card: str) -> None:
    """The ``build`` phase's native part: the port's C++ data transforms
    (runtime/native.py, built with ``g++`` from runtime/transforms.cpp)
    must build, and on the smoke's synthetic CSVs (``write_stock_folder``,
    the production schemas: ranging, percent changes, binning, raw hours)
    each modality's values and types, its token ids and vocabulary, and
    the rounding-only path of ``range_numeric_data`` must be bit-equal with
    the library and without it (its numpy/Python paths), each of its five
    functions called. Raises on a failure."""
    from trade_aid_multimodal_transformer_tpu_torch.config.system import ConfigManager
    from trade_aid_multimodal_transformer_tpu_torch.data import transforms as T
    from trade_aid_multimodal_transformer_tpu_torch.data.ingest import load_and_process_modality
    from trade_aid_multimodal_transformer_tpu_torch.data.vocab import numerical_representation
    from trade_aid_multimodal_transformer_tpu_torch.runtime import native

    t0 = time.perf_counter()
    built = native.available()
    build_s = time.perf_counter() - t0
    names = ("round_decimal", "percent_changes", "range_numeric", "bin_assign", "factorize")
    calls = dict.fromkeys(names, 0)
    real = {n: getattr(native, n) for n in names}

    def counted(name):
        def fn(*args):
            calls[name] += 1
            return real[name](*args)
        return fn

    def transformed(schemas):
        out = []
        with contextlib.redirect_stdout(io.StringIO()):  # the binning breakdown
            for schema in schemas:
                md = load_and_process_modality(schema, quiet=True)
                ids, vocab = numerical_representation(md.data)
                out.append((list(md.data), [type(v) for v in md.data], ids, vocab))
            close = [float(v) for v in out[0][0][:2000]]
            out.append(T.range_numeric_data(close, None, 2))
        return out

    rows, equal, cwd = 0, False, os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        write_stock_folder(Path(tmp) / "your_data" / "stocks", n_files=6, rows=1500, seed=1)
        os.chdir(tmp)
        try:
            manager = ConfigManager()
            manager.load_input_schemas(REPO / "examples" / "production_input_schemas.yaml")
            schemas = list(manager.schema_manager.schemas)
            if built:
                for n in names:
                    setattr(native, n, counted(n))
                try:
                    on = transformed(schemas)
                finally:
                    for n in names:
                        setattr(native, n, real[n])
                load = native._load
                native._load = lambda: None  # every function takes its numpy path
                try:
                    off = transformed(schemas)
                finally:
                    native._load = load
                rows = sum(len(m[0]) for m in on[:-1])
                equal = on[-1] == off[-1] and all(
                    a[0] == b[0] and a[1] == b[1] and a[2].dtype == b[2].dtype
                    and (a[2] == b[2]).all() and a[3] == b[3] for a, b in zip(on[:-1], off[:-1]))
        finally:
            os.chdir(cwd)
    ok = built and equal and all(calls.values())
    emit({"phase": "build", "part": "native", "card": card, "available": built,
          "library": str(native.library_path().relative_to(REPO)) if built else None,
          "build_seconds": build_s, "rows_per_run": rows, "calls": calls,
          "bit_equal_to_numpy_paths": equal, "ok": ok})
    if not ok:
        raise AssertionError(f"the native transforms: built {built}, bit-equal {equal}, "
                             f"calls {calls}")


def multihost_node(rank: int, world: int, d: str) -> dict:
    """One rank of a multi-node launch of the port's entry (``main``) in
    ``d``, in a process that ``run_ranks`` gave the launcher's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT, CUDA_VISIBLE_DEVICES): its console (a node's first rank
    prints) into ``d/rank<rank>.log``; returns the run's final losses and
    plan, the group's backend, this rank's kernel launches, parameter
    checksum and train-state bytes, the steps/s after the first chunk, the
    collectives' (bytes, ms, calls) a step and the seconds."""
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from trade_aid_multimodal_transformer_tpu_torch import main as entry
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
    from trade_aid_multimodal_transformer_tpu_torch.train import runner

    os.chdir(d)
    got, real = {}, entry.run_training
    entry.run_training = lambda **kw: got.setdefault("r", real(**kw))
    t0 = time.perf_counter()
    with open(Path(d) / f"rank{rank}.log", "w") as f, contextlib.redirect_stdout(f):
        code = entry.main()
    r = got["r"]
    return {"code": code, "losses": r["losses"], "plan": r["plan"].describe(),
            "backend": dist.get_backend(), "launches": K.launch_counts(),
            "param_checksum": runner.param_checksum(r["params"]),
            "train_state_bytes": r["train_state_bytes"], "steps_per_s": steps_per_s(r),
            "collectives": {kind: per_step(r["collectives"], kind)
                            for kind in ("all_gather", "reduce_scatter", "all_reduce")},
            "seconds": time.perf_counter() - t0}


def multihost_run(d: Path, nodes: int, per_node: int, cards=None) -> tuple:
    """The entry in ``d`` launched as ``nodes`` nodes of ``per_node`` ranks
    on this machine, torchrun's environment set by hand (node i holds ranks
    i per_node .. (i + 1) per_node - 1, a localhost coordinator, TAT_SEED 5,
    TAT_TIMING on; ``cards[i]``: node i's CUDA_VISIBLE_DEVICES): (per rank
    ``multihost_node``'s result, per rank its console, seconds with the
    start of the processes)."""
    from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh

    world, port = nodes * per_node, pmesh.free_port()
    env = [dict(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r % per_node),
                LOCAL_WORLD_SIZE=str(per_node), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                TAT_SEED="5", TAT_TIMING="1",
                **({"CUDA_VISIBLE_DEVICES": cards[r // per_node]} if cards else {}))
           for r in range(world)]
    t0 = time.perf_counter()
    ranks = pmesh.run_ranks(multihost_node, world, (str(d),), timeout=RANK_TIMEOUT, env=env)
    sec = time.perf_counter() - t0
    return ranks, [(d / f"rank{r}.log").read_text() for r in range(world)], sec


def multihost_phase(card: str, fs2: dict) -> None:
    """``multihost``: the port's entry as two nodes of one rank each on the
    one card (node ranks 0 and 1, LOCAL_RANK 0, LOCAL_WORLD_SIZE 1, a
    localhost coordinator: ``multihost_run``). The ranks share the card, so
    ``multihost.initialize`` takes gloo and the collectives are staged
    through host memory, as in ``fsdp_training``. The production config
    with ``multihost: true``, ``mesh: auto``, ``fsdp: true``, 4 steps at
    dropout 0.2, ``fsdp_training``'s seed: the ``Multi-host: process i/2``
    line on both nodes, ``auto`` planned data x2 (FSDP) over the group,
    every rank's checksum equal, rank 0's launches those of
    ``fsdp_training``'s rank 0 (``fs2``), every rank's train-state bytes
    ``state_bytes(cfg, data=2, fsdp=True)``, and the checkpoint bit-equal
    to ``fsdp_training``'s: the same program over the same gloo
    collectives. Raises on a failed check."""
    import numpy as np

    from trade_aid_multimodal_transformer_tpu_torch import generate as entry
    from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import _read_native

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d, dropout=0.2, tpu={"fsdp": "true", "multihost": "true"},
                              **PARALLEL_ENTRY)
        cfg = entry.load_config_and_data(str(d))["cfg"]
        ranks, consoles, sec = multihost_run(d, DP_RANKS, 1)
        ck = _read_native(str(d / "output" / "model.ckpt"))
    want_bytes = state_bytes(cfg, DP_RANKS, fsdp=True)
    ref = fs2["checkpoint"]
    same_file = sorted(ck) == sorted(ref) and all(np.array_equal(ck[k], ref[k]) for k in ck)
    sums = [r["param_checksum"] for r in ranks]
    lines = [f"Multi-host: process {i + 1}/{DP_RANKS} ({DP_RANKS} ranks)" in c
             for i, c in enumerate(consoles)]
    launches = ranks[0]["launches"] == fs2["ranks"][0]["launches_rank"]
    held = [tuple(r["train_state_bytes"]) for r in ranks]
    plan = [r["plan"] for r in ranks]
    ok = (all(lines) and all(s == sums[0] for s in sums) and launches
          and held == [want_bytes] * DP_RANKS and same_file
          and plan == ["data x2 (fsdp/zero-3)"] * DP_RANKS
          and all(r["backend"] == "gloo" and r["code"] == 0 for r in ranks)
          and all("TRAINING COMPLETED SUCCESSFULLY" in c for c in consoles))
    emit({"phase": "multihost", "card": card, "config": "examples/production_config.yaml",
          "changed": {**PARALLEL_ENTRY, "dropout": 0.2, "mesh": "auto", "fsdp": True,
                      "multihost": True},
          "nodes": DP_RANKS, "ranks_per_node": 1, "ranks_on_one_card": DP_RANKS,
          "backend": [r["backend"] for r in ranks], "plan": plan,
          "multihost_lines": lines, "final_eval_losses": ranks[0]["losses"],
          "final_eval_losses_fsdp_training": fs2["losses"], "param_checksums_by_rank": sums,
          "param_checksums_equal_fsdp_training": sums == fs2["param_checksums"],
          "launches_equal_fsdp_training": launches,
          "launches_rank0": {k: v for k, v in ranks[0]["launches"].items() if v},
          "train_state_bytes_by_rank": held, "train_state_bytes_expected": want_bytes,
          "checkpoint_bit_equal_to_fsdp_training": same_file, "checkpoint_keys": len(ck),
          "steps_per_s_after_first_chunk": ranks[0]["steps_per_s"],
          "collectives_per_step": ranks[0]["collectives"],
          "seconds_by_rank": [r["seconds"] for r in ranks], "seconds_with_spawn": sec, "ok": ok})
    if not ok:
        raise AssertionError("the multihost entry differs from fsdp_training's or failed a check")


def multihost_rows(card: str, failed: list, dp_base: dict) -> None:
    """``multi_card``'s ``multi_card_multihost`` rows on 4 cards: the entry
    as two nodes of two ranks (``multihost_run``: node 0 sees cards 0,1,
    node 1 cards 2,3, so each node's ``device_count`` is 2 while the group
    holds 4 ranks), NCCL (every rank a card of its own), ``multihost:
    true``, ``fsdp: true``, 8 steps (``multi_card``'s runs): ``{data: 4}``
    at dropout 0 and 0.2 and ``mesh: auto`` at 0.2, which must plan data x4
    over the group. Gates (the data rows'): final eval losses within
    STEP_TOL's bf16 loss limit of the one-card runs ``dp_base``, every
    rank's checksum equal, every rank's bytes ``state_bytes(cfg, data=4,
    fsdp=True)``, the ``Multi-host: process 1/2`` and ``2/2`` lines, the
    backend NCCL. A failed run is reported and the other rows still run."""
    from trade_aid_multimodal_transformer_tpu_torch import generate as entry

    for mesh, rate in (("{data: 4}", 0.0), ("{data: 4}", 0.2), ("auto", 0.2)):
        changed = {"dropout": rate, "mesh": mesh, "fsdp": True, "multihost": True}
        try:
            with tempfile.TemporaryDirectory() as tmp:
                d = Path(tmp)
                production_config_dir(d, max_iters=8, eval_interval=4, eval_iters=2,
                                      dropout=rate, tpu={"fsdp": "true", "multihost": "true"})
                text = (d / "config.yaml").read_text().replace("  mesh: auto", f"  mesh: {mesh}")
                (d / "config.yaml").write_text(text)
                cfg = entry.load_config_and_data(str(d))["cfg"]
                ranks, consoles, sec = multihost_run(d, 2, 2, cards=["0,1", "2,3"])
        except Exception as e:  # noqa: BLE001  (reported; the other rows still run)
            emit({"phase": "multi_card_multihost", "changed": changed, "error": repr(e)[-2000:],
                  "ok": False})
            failed.append(f"multihost {changed}: {e!r}"[:300])
            continue
        want = state_bytes(cfg, 4, fsdp=True)
        errs_ = {k: abs(ranks[0]["losses"][k] - dp_base[rate]["losses"][k])
                 for k in ("train", "val")}
        sums = [r["param_checksum"] for r in ranks]
        held = [tuple(r["train_state_bytes"]) for r in ranks]
        lines = ["Multi-host: process 1/2 (4 ranks)" in consoles[0],
                 "Multi-host: process 2/2 (4 ranks)" in consoles[2]]
        ok = (all(e <= STEP_TOL["bfloat16"]["loss"] for e in errs_.values())
              and all(s == sums[0] for s in sums) and held == [want] * 4 and all(lines)
              and all(r["backend"] == "nccl" and r["plan"] == "data x4 (fsdp/zero-3)"
                      for r in ranks))
        emit({"phase": "multi_card_multihost", "card": card,
              "config": "examples/production_config.yaml", "changed": changed, "nodes": 2,
              "ranks_per_node": 2, "cuda_visible_devices_by_node": ["0,1", "2,3"],
              "backend": [r["backend"] for r in ranks], "plan": ranks[0]["plan"],
              "multihost_lines": lines, "final_eval_losses": ranks[0]["losses"],
              "final_eval_losses_one_card": dp_base[rate]["losses"], "abs_err_vs_one_card": errs_,
              "tol": STEP_TOL["bfloat16"]["loss"], "param_checksums_by_rank": sums,
              "train_state_bytes_by_rank": held, "train_state_bytes_expected": want,
              "steps_per_s_after_first_chunk": ranks[0]["steps_per_s"],
              "collectives_per_step": ranks[0]["collectives"],
              "launches_rank0": {k: v for k, v in ranks[0]["launches"].items() if v},
              "seconds_with_spawn": sec, "ok": ok})
        if not ok:
            failed.append(f"multihost {changed}: losses {errs_}, bytes {held}, lines {lines}")


def multi_card(card: str) -> int:
    """``python3 chip_smoke.py --multi-card`` on a machine with 2 or more
    cards: the training entry over NCCL, one card per rank, 8 steps
    (evaluations at steps 0, 4 and 7), against the same run on one card:
    - context parallelism: ``context_parallel`` P = 2 (and 4 where there
      are 4 cards) on the production config at block_size 1024, batch 8
      (``mesh: off``), rank 0's final evaluation losses within STEP_TOL's
      bf16 loss limit of the one-card run's at dropout 0, the ring's kernels
      launched; at 0.2 the ring keys its masks per chunk pair, so only the
      ranks' agreement is held;
    - data parallelism: ``mesh: {data: P}`` (P = 2, and 4 on 4 cards) on the
      production config at block_size 64, global batch 32, whose final
      evaluation losses must be within that limit of the one-card run's at
      dropout 0 and at 0.2 (the masks are the global batch's); ``mesh:
      auto`` over the machine's cards trains data x(cards);
    - on 4 cards, ``{data: 2}`` with ``context_parallel: 2`` at block_size
      1024, batch 8: within the limit of the one-card run at dropout 0; at
      0.2 the rings fold their keys with the data rank as the JAX package
      does, so only the ranks' agreement is held;
    - FSDP (``fsdp: true``) on ``{data: 2}``, ``{data: 4}`` and, on 4 cards,
      ``{data: 2}`` x ``context_parallel: 2``: the gates of the same run
      without it, rank 0's kernel launches equal to that run's, and every
      rank's train-state bytes (total, held) those ``state_bytes``
      gives for the run's config and data axis;
    - tensor parallelism: ``{model: 2}`` at block_size 64 (global batch 32)
      and 1024 (batch 8), and on 4 cards ``{data: 2, model: 2}`` and the
      same with ``fsdp: true`` (block_size 64), at dropout 0 and 0.2: final
      evaluation losses within the limit of the one-card run's at both
      rates (every mask is keyed by global heads and rows), every rank's
      train-state bytes those ``state_bytes`` gives, the tensor-parallel
      all-reduces' bytes, calls and ms a step;
    - on 4 cards (``new_rows``): ``{mod: 2, data: 2}`` (and with ``fsdp:
      true``), ``{mod: 4}``, ``{mod: 2, model: 2}`` and ``{model: 4}`` at
      block_size 64 (global batch 32), and ``{model: 2}`` x
      ``context_parallel: 2`` at block_size 1024 (batch 8), each at dropout
      0 and 0.2 with the tensor-parallel rows' gates (model x sequence at
      0.2: the rings fold their keys with the model place as the JAX
      package does, so only the ranks' agreement is held), and ``{mod: 2}``
      x ``context_parallel: 2`` (at 0.2 against the ``context_parallel: 2``
      run: the same masks), the modality collectives' bytes, calls and ms a
      step;
    - pipeline parallelism (``pipe_rows``): ``{pipe: 2}``, and on 4 cards
      ``{pipe: 2, data: 2}`` (and FSDP), ``{pipe: 2, model: 2}`` and
      ``{pipe: 2, mod: 2}``, the last two's checksums equal to ``{pipe:
      2}``'s;
    - on 4 cards, multi-host training (``multihost_rows``, right after the
      one-card data runs): the entry launched as two nodes of two ranks,
      node 0 seeing cards 0,1 and node 1 cards 2,3, ``multihost: true``,
      FSDP over ``{data: 4}`` at dropout 0 and 0.2 and over ``mesh: auto``
      (which must plan data x4 over the group) at 0.2, with the data rows'
      gates, the bytes ``state_bytes`` gives and each node's
      ``Multi-host: process`` line.
    At every rate every rank's parameter checksum (float64 sum and SHA-256 of
    the bytes) must be equal. Prints each run's steps/s and, under a data
    axis, the bytes and ms a step of the gradient all-reduce and, under
    FSDP, of the all-gather and the reduce-scatter (TAT_TIMING: the card
    synchronised around each)."""
    import torch

    from trade_aid_multimodal_transformer_tpu_torch import generate as entry
    from trade_aid_multimodal_transformer_tpu_torch.config.compat import reset_compatibility_layer
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
    from trade_aid_multimodal_transformer_tpu_torch.train import runner

    n_cards = torch.cuda.device_count()
    emit({"phase": "multi_card", "cards": n_cards, "smi": card, "backend": "nccl"})
    if n_cards < 2:
        print("chip_smoke --multi-card: needs 2 or more cards", file=sys.stderr)
        return 2
    K.build_kernels()
    os.environ["TAT_TIMING"] = "1"  # the ranks time their collectives

    def run(mesh: str, cp: int, fsdp: bool = False, **config) -> dict:
        with tempfile.TemporaryDirectory() as tmp:
            d = Path(tmp)
            production_config_dir(d, max_iters=8, eval_interval=4, eval_iters=2,
                                  tpu={"fsdp": "true"} if fsdp else None, **config)
            text = (d / "config.yaml").read_text()
            text = text.replace("  mesh: auto", f"  mesh: {mesh}")
            text = text.replace("  # context_parallel: 4", f"  context_parallel: {cp}")
            (d / "config.yaml").write_text(text)
            cfg = (entry.load_config_and_data(str(d))["cfg"]
                   if fsdp or any(a_ in mesh for a_ in ("model", "mod", "pipe")) else None)
            cwd = os.getcwd()
            os.chdir(d)
            try:
                reset_compatibility_layer()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    res = runner.run_training(caller_globals={}, seed=5, rank_timeout=RANK_TIMEOUT)
                sec = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
                reset_compatibility_layer()
        later = res["step_timer"].chunks[1:]
        coll = {kind: per_step(res.get("collectives"), kind)
                for kind in ("all_reduce", "all_gather", "reduce_scatter")}
        tp = [(n_, t_) for k_, n_, t_ in res.get("collectives") or []
              if k_ in ("tp_all_reduce", "tp_all_reduce_bwd")]
        if tp:  # the model axis's all-reduces, summed a step (8 steps)
            coll["tp_all_reduce"] = (sum(n_ for n_, _ in tp) / 8, 1e3 * sum(t_ for _, t_ in tp) / 8,
                                     len(tp) / 8)
        for kind in ("tp_all_gather", "mod_all_gather", "mod_reduce_scatter_bwd",
                     "mod_all_reduce", "send", "recv", "pipe_broadcast", "pipe_all_reduce",
                     "split_all_gather"):
            # the model, modality and pipeline axes' other collectives
            calls = [(n_, t_) for k_, n_, t_ in res.get("collectives") or [] if k_ == kind]
            if calls:
                coll[kind] = (sum(n_ for n_, _ in calls) / 8,
                              1e3 * sum(t_ for _, t_ in calls) / 8, len(calls) / 8)
        return {"losses": res["losses"], "seconds": sec,
                **{f"{kind}_bytes_per_step": c_[0] for kind, c_ in coll.items()},
                **{f"{kind}_ms_per_step": c_[1] for kind, c_ in coll.items()},
                "steps_per_s_after_first_chunk": sum(n for n, _ in later)
                / sum(t for _, t in later),
                "plan": res["plan"].describe(), "launches_rank0": res.get("launches"),
                "param_checksums": res.get("param_checksums"), "cfg": cfg,
                "train_state_bytes_by_rank": res.get("train_state_bytes_by_rank")}

    failed = []

    def hold(phase: str, r: dict, base, ranks: int, launched: str, changed: dict, **extra):
        """One run's line: its final eval losses against ``base``'s (None:
        the ranks' agreement only), the ranks' checksums, ``launched``
        launched on rank 0."""
        errs_ = ({k_: abs(r["losses"][k_] - base["losses"][k_]) for k_ in ("train", "val")}
                 if base is not None else None)
        sums = r["param_checksums"]
        ranks_equal = ranks == 1 or (len(sums or []) == ranks and all(c_ == sums[0] for c_ in sums))
        ok = ((errs_ is None or all(e <= STEP_TOL["bfloat16"]["loss"] for e in errs_.values()))
              and all(math.isfinite(v) for v in r["losses"].values())
              and (r["launches_rank0"] or {}).get(launched, 1) > 0 and ranks_equal)
        emit({"phase": phase, "card": card, "config": "examples/production_config.yaml",
              "changed": changed, "plan": r["plan"], "final_eval_losses": r["losses"],
              "abs_err_vs_one_card": errs_, "tol": STEP_TOL["bfloat16"]["loss"],
              "param_checksums_by_rank": sums, "ranks_equal": ranks_equal,
              "steps_per_s_after_first_chunk": r["steps_per_s_after_first_chunk"],
              **{k_: v_ for k_, v_ in r.items() if k_.endswith("_per_step")},
              "train_state_bytes_by_rank": r["train_state_bytes_by_rank"],
              "seconds": r["seconds"], "launches_rank0": {
                  k_: v_ for k_, v_ in (r["launches_rank0"] or {}).items() if v_},
              **extra, "ok": ok})
        if not ok:
            failed.append(f"{phase} {changed}")

    def hold_fsdp(r: dict, dp_run: dict, base, ranks: int, data: int, launched: str,
                  changed: dict, **extra):
        """An FSDP run's line: ``hold``'s gates, rank 0's launches equal to
        the same run's without FSDP (``dp_run``), every rank's train-state
        bytes those ``state_bytes`` gives over ``data`` ranks."""
        same = r["launches_rank0"] == dp_run["launches_rank0"]
        held = [tuple(b_) for b_ in r["train_state_bytes_by_rank"] or []]
        want = state_bytes(r["cfg"], data, fsdp=True)
        split = held == [want] * ranks
        hold("multi_card_fsdp", r, base, ranks, launched, {**changed, "fsdp": True},
             launches_equal_without_fsdp=same, state_split=split,
             train_state_bytes_expected=want,
             steps_per_s_without_fsdp=dp_run["steps_per_s_after_first_chunk"],
             all_reduce_ms_per_step_without_fsdp=dp_run["all_reduce_ms_per_step"], **extra)
        if not (same and split):
            failed.append(f"multi_card_fsdp {changed}: launches {same}, state split {split}")

    long = dict(block_size=LONG_BLOCK, batch_size=8)
    # context parallelism at block_size 1024, batch 8
    runs = {}
    sizes = [2] + ([4] if n_cards >= 4 else [])
    for p_size, rate in [(1, 0.0)] + [(p_, r_) for r_ in (0.0, 0.2) for p_ in sizes]:
        runs[p_size, rate] = run("\"off\"", p_size, dropout=rate, **long)
    # more ranks than cards raises as the JAX package's plan_mesh raises for devices
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d, block_size=LONG_BLOCK)
        text = (d / "config.yaml").read_text().replace(
            "  # context_parallel: 4", f"  context_parallel: {2 * n_cards}")
        (d / "config.yaml").write_text(text)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            reset_compatibility_layer()
            runner.run_training(caller_globals={}, seed=5)
            refused = None
        except ValueError as e:
            refused = str(e)
        finally:
            os.chdir(cwd)
            reset_compatibility_layer()
    emit({"phase": "multi_card_refusal", "context_parallel": 2 * n_cards, "cards": n_cards,
          "error": refused, "ok": refused is not None and "device(s) are available" in refused})
    if refused is None:
        failed.append("refusal")
    base = runs[1, 0.0]
    for (p_size, rate), r in runs.items():
        hold("multi_card_training", r, None if rate else base, p_size,
             "flash_chunk_fwd_causal" if p_size > 1 else "flash_attention",
             {**long, "dropout": rate, "mesh": "off", "context_parallel": p_size},
             context_parallel=p_size)

    # data parallelism at block_size 64 (the production config), global batch 32
    dp_base = {rate: run("\"off\"", 1, dropout=rate) for rate in (0.0, 0.2)}
    for rate, r in dp_base.items():
        hold("multi_card_data_parallel", r, None, 1, "fused_qkv_attention",
             {"dropout": rate, "mesh": "off"}, data=1)
    if n_cards >= 4:
        multihost_rows(card, failed, dp_base)
    for p_size in sizes:
        for rate in (0.0, 0.2):
            r = run(f"{{data: {p_size}}}", 1, dropout=rate)
            hold("multi_card_data_parallel", r, dp_base[rate], p_size, "fused_qkv_attention",
                 {"dropout": rate, "mesh": f"{{data: {p_size}}}"}, data=p_size)
            hold_fsdp(run(f"{{data: {p_size}}}", 1, fsdp=True, dropout=rate), r, dp_base[rate],
                      p_size, p_size, "fused_qkv_attention",
                      {"dropout": rate, "mesh": f"{{data: {p_size}}}"})
    r = run("auto", 1)
    want = f"data x{n_cards}"
    hold("multi_card_data_parallel", r, dp_base[0.2], n_cards, "fused_qkv_attention",
         {"mesh": "auto"}, data=n_cards, plan_expected=want)
    if r["plan"] != want:
        failed.append(f"mesh: auto planned {r['plan']}, not {want}")

    # tensor parallelism: {model: 2} at 64 and 1024; on 4 cards {data: 2,
    # model: 2}, and with FSDP, at 64 (a failed run is reported and the
    # other rows still run)
    long_base = {0.0: base, 0.2: run("\"off\"", 1, dropout=0.2, **long)}
    layouts = [("{model: 2}", 1, 2, False, {})]
    if n_cards >= 4:
        layouts += [("{data: 2, model: 2}", 2, 2, False, {}), ("{data: 2, model: 2}", 2, 2, True, {})]
    layouts.append(("{model: 2}", 1, 2, False, long))
    for mesh, data, model, fsdp, extra in layouts:
        for rate in (0.0, 0.2):
            try:
                r = run(mesh, 1, fsdp=fsdp, dropout=rate, **extra)
            except Exception as e:  # noqa: BLE001  (reported; the other rows still run)
                emit({"phase": "multi_card_tensor_parallel", "mesh": mesh, "fsdp": fsdp,
                      "dropout": rate, **extra, "error": repr(e)[-2000:], "ok": False})
                failed.append(f"tensor parallel {mesh} fsdp {fsdp} {extra}: {e!r}"[:300])
                continue
            want = state_bytes(r["cfg"], data, model, fsdp)
            held = [tuple(b_) for b_ in r["train_state_bytes_by_rank"] or []]
            plan = f"data x{data}{' (fsdp/zero-3)' if fsdp else ''} * " * (data > 1) + f"tensor x{model}"
            hold("multi_card_tensor_parallel", r, (long_base if extra else dp_base)[rate],
                 data * model, "flash_attention" if extra else "fused_qkv_attention",
                 {**extra, "dropout": rate, "mesh": mesh, **({"fsdp": True} if fsdp else {})},
                 data=data, model=model, train_state_bytes_expected=want,
                 state_split=held == [want] * data * model, plan_expected=plan)
            if held != [want] * data * model or r["plan"] != plan:
                failed.append(f"tensor parallel {mesh} fsdp {fsdp} {extra}: bytes {held}, "
                              f"plan {r['plan']}")

    # data x sequence on 4 cards: {data: 2} with context_parallel 2 at 1024
    if n_cards >= 4:
        for rate in (0.0, 0.2):
            r = run("{data: 2}", 2, dropout=rate, **long)
            changed = {**long, "dropout": rate, "mesh": "{data: 2}", "context_parallel": 2}
            hold("multi_card_data_x_seq", r, None if rate else base, 4, "flash_chunk_fwd_causal",
                 changed, plan_expected="data x2 * context x2")
            rf = run("{data: 2}", 2, fsdp=True, dropout=rate, **long)
            hold_fsdp(rf, r, None if rate else base, 4, 2, "flash_chunk_fwd_causal", changed,
                      plan_expected="data x2 (fsdp/zero-3) * context x2")
            for got, want in ((r, "data x2 * context x2"),
                              (rf, "data x2 (fsdp/zero-3) * context x2")):
                if got["plan"] != want:
                    failed.append(f"data x seq planned {got['plan']}")
        new_rows(run, hold, failed, dp_base, base, long, runs[2, 0.2])
    pipe_rows(run, hold, failed, dp_base, n_cards)
    if failed:
        raise AssertionError(f"multi-card training disagrees: {failed}")
    emit(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": n_cards}})
    return 0


def pipe_rows(run, hold, failed, dp_base, n_cards: int) -> None:
    """``multi_card``'s pipeline rows (``run`` and ``hold`` its helpers):
    ``{pipe: 2}`` and, on 4 cards, ``{pipe: 2, data: 2}`` and the same with
    ``fsdp: true``, ``{pipe: 2, model: 2}`` and ``{pipe: 2, mod: 2}``
    (block_size 64, global batch 32, µ = 4), each at dropout 0 and 0.2
    against the one-card runs ``dp_base`` with the tensor rows' gates, the
    exact bytes ``state_bytes`` gives, the plan's line, the handoffs' (and
    the model and modality gathers') bytes, calls and ms a step; the FSDP
    run's parameter checksums equal to the run without it, and those of
    the runs with a model or modality axis equal to ``{pipe: 2}``'s (the
    same seed: bit-equal; every rank of their groups computes the stage
    whole). A failed run is reported and the other rows still run."""
    layouts = [("{pipe: 2}", dict(pipe=2), False, "pipeline x2")]
    if n_cards >= 4:
        layouts += [("{pipe: 2, data: 2}", dict(pipe=2, data=2), False, "pipeline x2 * data x2"),
                    ("{pipe: 2, data: 2}", dict(pipe=2, data=2), True,
                     "pipeline x2 * data x2 (fsdp/zero-3)"),
                    ("{pipe: 2, model: 2}", dict(pipe=2, model=2), False,
                     "pipeline x2 * tensor x2"),
                    ("{pipe: 2, mod: 2}", dict(pipe=2, mod=2), False, "pipeline x2 * modality x2")]
    without_fsdp, alone = {}, {}
    for mesh, axes, fsdp, plan in layouts:
        ranks = math.prod(axes.values())
        for rate in (0.0, 0.2):
            try:
                r = run(mesh, 1, fsdp=fsdp, dropout=rate)
            except Exception as e:  # noqa: BLE001  (reported; the other rows still run)
                emit({"phase": "multi_card_pipeline", "mesh": mesh, "fsdp": fsdp,
                      "dropout": rate, "error": repr(e)[-2000:], "ok": False})
                failed.append(f"{mesh} fsdp {fsdp}: {e!r}"[:300])
                continue
            want = state_bytes(r["cfg"], axes.get("data", 1), axes.get("model", 1), fsdp,
                               axes.get("mod", 1))
            held = [tuple(b_) for b_ in r["train_state_bytes_by_rank"] or []]
            extra = {}
            if axes == dict(pipe=2):
                alone[rate] = r["param_checksums"]
            elif "data" not in axes:
                same = bool(alone.get(rate)) and all(
                    c_ == alone[rate][0] for c_ in r["param_checksums"] or [None])
                extra["checksums_equal_pipe_2"] = same
                if not same:
                    failed.append(f"{mesh} at {rate}: checksums differ from {{pipe: 2}}'s")
            if fsdp:
                same = r["param_checksums"] == without_fsdp.get(rate)
                extra["checksums_equal_without_fsdp"] = same
                if not same:
                    failed.append(f"{mesh} fsdp at {rate}: checksums differ from the run "
                                  f"without FSDP")
            elif "data" in axes:
                without_fsdp[rate] = r["param_checksums"]
            hold("multi_card_pipeline", r, dp_base[rate], ranks, "fused_qkv_attention",
                 {"dropout": rate, "mesh": mesh, **({"fsdp": True} if fsdp else {})},
                 train_state_bytes_expected=want, state_split=held == [want] * ranks,
                 plan_expected=plan, microbatches=PP_MU, **extra)
            if held != [want] * ranks or r["plan"] != plan:
                failed.append(f"{mesh} fsdp {fsdp}: bytes {held}, plan {r['plan']}")


def new_rows(run, hold, failed, dp_base, long_base0, long, cp2_rate02) -> None:
    """``multi_card``'s modality and further tensor rows on 4 cards (``run``
    and ``hold`` its helpers): ``{mod: 2, data: 2}`` (and FSDP), ``{mod:
    4}``, ``{mod: 2, model: 2}``, ``{model: 4}``, ``{model: 2}`` x
    ``context_parallel: 2`` and ``{mod: 2}`` x ``context_parallel: 2``,
    each at dropout 0 and 0.2 against the one-card runs ``dp_base``
    (block_size 64) and ``long_base0`` (block_size 1024, dropout 0), with
    the exact bytes ``state_bytes`` gives and the plan's line; ``{mod: 2}``
    x ``context_parallel: 2`` at 0.2 against ``cp2_rate02``, the
    ``context_parallel: 2`` run at 0.2 (its rings key every modality's
    rows by its index in the whole M: the same masks). A failed run is
    reported and the other rows still run."""
    layouts = [("{mod: 2, data: 2}", dict(data=2, mod=2), False, {}, "modality x2 * data x2"),
               ("{mod: 2, data: 2}", dict(data=2, mod=2), True, {},
                "modality x2 * data x2 (fsdp/zero-3)"),
               ("{mod: 4}", dict(mod=4), False, {}, "modality x4"),
               ("{mod: 2, model: 2}", dict(model=2, mod=2), False, {}, "modality x2 * tensor x2"),
               ("{model: 4}", dict(model=4), False, {}, "tensor x4"),
               ("{model: 2}", dict(model=2), False, dict(long, cp=2), "tensor x2 * context x2"),
               ("{mod: 2}", dict(mod=2), False, dict(long, cp=2), "modality x2 * context x2")]
    for mesh, axes, fsdp, extra, plan in layouts:
        extra = dict(extra)
        cp = extra.pop("cp", 1)
        for rate in (0.0, 0.2):
            try:
                r = run(mesh, cp, fsdp=fsdp, dropout=rate, **extra)
            except Exception as e:  # noqa: BLE001  (reported; the other rows still run)
                emit({"phase": "multi_card_new", "mesh": mesh, "fsdp": fsdp, "dropout": rate,
                      "context_parallel": cp, **extra, "error": repr(e)[-2000:], "ok": False})
                failed.append(f"{mesh} fsdp {fsdp} cp {cp}: {e!r}"[:300])
                continue
            want = state_bytes(r["cfg"], axes.get("data", 1), axes.get("model", 1), fsdp,
                               axes.get("mod", 1))
            held = [tuple(b_) for b_ in r["train_state_bytes_by_rank"] or []]
            base = (long_base0 if not rate else cp2_rate02 if "mod" in axes else None
                    ) if cp > 1 else dp_base[rate]
            hold("multi_card_new", r, base, 4,
                 "flash_chunk_fwd_causal" if cp > 1 else "fused_qkv_attention",
                 {**extra, "dropout": rate, "mesh": mesh, "context_parallel": cp,
                  **({"fsdp": True} if fsdp else {})},
                 train_state_bytes_expected=want, state_split=held == [want] * 4,
                 plan_expected=plan)
            if held != [want] * 4 or r["plan"] != plan:
                failed.append(f"{mesh} fsdp {fsdp} cp {cp}: bytes {held}, plan {r['plan']}")


def short_kernels(K, card, gen, timing, errs, by_path):
    """The kernels that only the port's public ops and tools reach: K3b (the
    backward of the differentiable whole-row ``short_causal_attention``),
    K4f / K4b (``causal_attention_packed``) and K9 (``decode_attention_t``),
    held against their plain versions (K3b and K4b run twice for the same
    bits; K9 reading one column past pos must fail) and timed; the packed op
    and the transposed decode driven through their entries with exact
    launches (``packed_op``, ``decode_t_op``). Adds to ``timing``, ``errs``
    and ``by_path``; raises on a failed check."""
    import torch
    import torch.nn.functional as F

    from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    # kernel_check: K3b at the production rows, at the crossover's rows (4 x 6
    # at each T of the band it sweeps, hs 64) and T 8 / 64 / 512 x hs 16 / 64
    # / 256, from K3f's output
    for shape in ([K3B_PROD] + [(24, t_, 64) for t_ in (64, 128, 256, 512)]
                  + [(3, t_, hs_) for t_ in (8, 64, 512) for hs_ in (16, 64, 256)]):
        q, k, v, do = (randn(*shape) for _ in range(4))
        for dtype in ("float32", "bfloat16"):
            qq, kk, vv, dd = (x.to(getattr(torch, dtype)) for x in (q, k, v, do))
            for rate in (0.0, 0.2):
                salts = SALTS if rate else None
                out = K.short_causal_attention_fwd(qq, kk, vv, rate, salts)
                grads = K.short_causal_attention_bwd(qq, kk, vv, out, dd, rate, salts)
                again = K.short_causal_attention_bwd(qq, kk, vv, out, dd, rate, salts)
                torch.cuda.synchronize()
                same_bits("short_causal_attention_bwd", grads, again, shape)
                ref = K.short_causal_attention_bwd_plain(qq, kk, vv, out, dd, rate, salts)
                errs[("short_causal_attention_bwd", shape, dtype, rate)] = max(
                    check_rel(f"short_causal_attention_bwd.{g}", a, r, dtype, shape, rate)
                    for g, a, r in zip(("dq", "dk", "dv"), grads, ref))

    # K4f and K4b: the production rows packed and B = 1 (nb 4), nb 1 / 3, H 1
    # / 6, T 8 / 512, hs 16 / 24 (the bf16 FMA bodies) / 256, and T 200 x hs
    # 64 (two passes of the mma.sync forward), T 72 x hs 96, T 56 x hs 128,
    # hs 32
    for shape in [K4_PROD, (4, 6, 64, 64), (1, 1, 8, 64), (3, 6, 512, 64), (1, 6, 8, 16),
                  (3, 1, 512, 256), (3, 2, 72, 24), (2, 3, 200, 64), (1, 2, 72, 96),
                  (2, 2, 56, 128), (1, 3, 64, 32)]:
        nb, H, t_, hs_ = shape
        qkv, do = randn(nb, 3 * H, t_, hs_), randn(nb, H, t_, hs_)
        for dtype in ("float32", "bfloat16"):
            x, dd = (a.to(getattr(torch, dtype)) for a in (qkv, do))
            for rate in (0.0, 0.2):
                salts = SALTS if rate else None
                out = K.short_causal_attention_packed_fwd(x, H, rate, salts)
                if mma_forward(dtype, hs_):
                    same_bits("short_causal_attention_packed", (out,),
                              (K.short_causal_attention_packed_fwd(x, H, rate, salts),), shape)
                dqkv = K.short_causal_attention_packed_bwd(x, out, dd, H, rate, salts)
                again = K.short_causal_attention_packed_bwd(x, out, dd, H, rate, salts)
                torch.cuda.synchronize()
                same_bits("short_causal_attention_packed_bwd", (dqkv,), (again,), shape)
                ref = K.short_causal_attention_packed_plain(x, H, rate, salts)
                tag = (dtype, rate) if rate else (dtype,)
                errs[("short_causal_attention_packed", shape) + tag] = (
                    check_rel("short_causal_attention_packed", out, ref, dtype, shape, rate) if rate
                    else check_close("short_causal_attention_packed", out, ref, dtype, shape))
                errs[("short_causal_attention_packed_bwd", shape, dtype, rate)] = check_rel(
                    "short_causal_attention_packed_bwd.dqkv", dqkv,
                    K.short_causal_attention_packed_bwd_plain(x, out, dd, H, rate, salts), dtype,
                    shape, rate)

    # K9 at the long-context serving rows (S 1024) and at S 128, at B = 1 (24
    # rows), at S 8192, hs 256 and S 130 (element loads), pos 0 / 127 / S/2 /
    # S - 1 and the edges of the launcher's chunks (chunk - 1, chunk, 2 chunk
    # - 1) read on the device; every check run twice for the same bits. The
    # planted fault (one column past pos) must fail the same check at the
    # production rows' pos 0 / 127 / S/2 at S 1024 and 128, and wherever one
    # more visible column moves the plain version by more than 1.5 times the
    # limit (in bf16 one column of ~500 at 24 rows can stay within it)
    n9, hs9, S9 = K9_PROD
    for n_, hs_, S in ((n9, hs9, S9), (n9, hs9, 128), (24, hs9, S9), (24, hs9, 8192),
                       (3, 256, 2048), (7, 16, 130)):
        q, kT, vT = randn(n_, 1, hs_), randn(n_, hs_, S), randn(n_, hs_, S)
        for dtype in ("float32", "bfloat16"):
            qq, kk, vv = (x.to(getattr(torch, dtype)) for x in (q, kT, vT))
            plan = K.decode_attention_t_plan(qq, kk, vv)
            ch = plan["chunk"]
            edges = {ch - 1, ch, 2 * ch - 1} if plan["cluster"] > 1 else set()
            for pos in sorted({0, 127, S // 2, S - 1} | {p_ for p_ in edges if p_ < S}):
                shape = (n_, hs_, S, pos)
                pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
                out = K.decode_attention_t(qq, kk, vv, pos_t)
                again = K.decode_attention_t(qq, kk, vv, pos_t)
                torch.cuda.synchronize()
                same_bits("decode_attention_t", (out,), (again,), shape)
                ref = K.decode_attention_t_plain(qq, kk, vv, pos)
                errs[("decode_attention_t", shape, dtype)] = check_close(
                    "decode_attention_t", out, ref, dtype, shape)
                if pos == S - 1:
                    continue
                moved = (K.decode_attention_t_plain(qq, kk, vv, pos + 1).float()
                         - ref.float()).abs().max().item()
                must = (n_ == n9 and S in (S9, 128) and pos in (0, 127, S // 2)
                        or moved > 1.5 * TOL[dtype])
                bad = k9_reading_pos_plus_1(K)(qq, kk, vv, pos_t)
                err = (bad.float() - ref.float()).abs().max().item()
                emit({"phase": "kernel_check", "kernel": "decode_attention_t.planted_pos_plus_1",
                      "shape": list(shape), "dtype": dtype, "plan": plan, "max_abs_err": err,
                      "plain_moves": moved, "tol": TOL[dtype], "must_fail": must,
                      "ok": err > TOL[dtype] or not must})
                if must and err <= TOL[dtype]:
                    raise AssertionError(f"K9 check passed the planted fault at {shape} {dtype}")

    # packed_op: causal_attention_packed at the production rows, bf16,
    # training with dropout 0.2, forward and backward (one K4f, one K4b);
    # against the plain versions and against the split path (the same mask
    # rows b H + h through K3f / K3b)
    nb, H, t_, hs_ = K4_PROD
    x = randn(nb, 3 * H, t_, hs_).bfloat16().requires_grad_()
    do = randn(nb, H, t_, hs_).bfloat16()
    K.reset_launch_counts()
    out = tatt.causal_attention_packed(x, H, 0.2, SALTS, True)
    (dqkv,) = torch.autograd.grad(out, (x,), do)
    torch.cuda.synchronize()
    by_path["packed_op"] = counts = K.launch_counts()
    want = dict.fromkeys(K.KERNELS, 0)
    want.update(short_causal_attention_packed=1, short_causal_attention_packed_bwd=1)
    xs = x.detach().clone().requires_grad_()
    split = tatt.causal_attention(xs[:, :H], xs[:, H:2 * H], xs[:, 2 * H:], "auto", 0.2, SALTS, True)
    (dsplit,) = torch.autograd.grad(split, (xs,), do)
    refs = {"plain": (K.short_causal_attention_packed_plain(x.detach(), H, 0.2, SALTS),
                      K.short_causal_attention_packed_bwd_plain(x.detach(), out.detach(), do, H,
                                                                0.2, SALTS)),
            "split_K3": (split, dsplit)}
    got = {}
    for name, (ro, rd) in refs.items():
        for what, a, b in (("out", out, ro), ("dqkv", dqkv, rd)):
            err = (a.float() - b.float()).abs().max().item()
            got[f"{name}.{what}"] = {"max_abs": err,
                                     "bound": REL_TOL["bfloat16"] * max(1.0, b.float().abs().max().item())}
    ok = (counts == want and all(e["max_abs"] <= e["bound"] for e in got.values())
          and bool(torch.isfinite(out).all()) and tuple(out.shape) == (nb, H, t_, hs_))
    emit({"phase": "packed_op", "what": "causal_attention_packed forward + backward, bf16, "
          "dropout 0.2, vs the plain versions and the split K3f/K3b path",
          "shape": list(K4_PROD), "errs": got, "launches": {k_: v_ for k_, v_ in counts.items() if v_},
          "ok": ok})
    if not ok:
        raise AssertionError("causal_attention_packed on the card failed its checks")

    # decode_t_op: decode_attention_t at the production rows for the last 4
    # positions, pos advanced on the device (as a captured decode loop would)
    qd, kT, vT = randn(n9, 1, hs9).bfloat16(), randn(n9, hs9, S9).bfloat16(), randn(n9, hs9, S9).bfloat16()
    pos_t = torch.full((1,), S9 - 4, dtype=torch.int32, device=dev)
    K.reset_launch_counts()
    outs = []
    for _ in range(4):
        outs.append(K.decode_attention_t(qd, kT, vT, pos_t))
        pos_t += 1
    torch.cuda.synchronize()
    by_path["decode_t_op"] = counts = K.launch_counts()
    want = dict.fromkeys(K.KERNELS, 0)
    want.update(decode_attention_t=4)
    err = max((o.float() - K.decode_attention_t_plain(qd, kT, vT, S9 - 4 + i).float()).abs().max().item()
              for i, o in enumerate(outs))
    ok = counts == want and err <= TOL["bfloat16"] and all(bool(torch.isfinite(o).all()) for o in outs)
    emit({"phase": "decode_t_op", "what": "decode_attention_t, positions S-4..S-1, bf16",
          "shape": list(K9_PROD), "max_abs_err": err, "tol": TOL["bfloat16"],
          "launches": {k_: v_ for k_, v_ in counts.items() if v_}, "ok": ok})
    if not ok:
        raise AssertionError("decode_attention_t on the card failed its checks")

    # kernel_time at the production shapes, bf16 (B = 1: 24 rows for K3b, 4
    # packed rows for K4, 24 for K9). Bounds count the causal half of each
    # product (5 for a backward), every input read once and every output
    # written once; K9 at pos = S - 1 reads the whole cache. Library
    # yardsticks: SDPA (is_causal) for K3f and its backward alone for K3b
    # (forward + backward in library_fwd_bwd_ms), the same over the split
    # views for K4; SDPA over the transposed-back cache with a column mask
    # for K9.
    bf = torch.bfloat16
    n, t_, hs_ = K3B_PROD
    tri = t_ * (t_ + 1) // 2
    q, k, v, do = (randn(n, t_, hs_).to(bf) for _ in range(4))
    out0 = K.short_causal_attention_fwd(q, k, v)
    out1 = K.short_causal_attention_fwd(q, k, v, 0.2, SALTS)
    q1, k1, v1, o1, d1 = (a[:24].contiguous() for a in (q, k, v, out0, do))
    k3_lib = sdpa_backward_ms(lambda a, b, c: F.scaled_dot_product_attention(
        a[None], b[None], c[None], is_causal=True), (q, k, v), do[None])
    k3_lib_3d = sdpa_backward_ms(
        lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True), (q, k, v), do)

    plane = n * t_ * hs_ * 2
    timing["short_causal_attention_bwd"] = dict(
        ms=device_ms(lambda: K.short_causal_attention_bwd(q, k, v, out0, do)),
        ms_dropout=device_ms(lambda: K.short_causal_attention_bwd(q, k, v, out1, do, 0.2, SALTS)),
        ms_b1=device_ms(lambda: K.short_causal_attention_bwd(q1, k1, v1, o1, d1)),
        plain_ms=device_ms(lambda: K.short_causal_attention_bwd_plain(q, k, v, out0, do)),
        library_ms=k3_lib[0],
        library_fwd_bwd_ms=k3_lib[1],
        library_3d_ms=k3_lib_3d[0],
        bound=bound_ms(5 * 2 * n * tri * hs_, 8 * plane, "bfloat16"),
        bound_b1=bound_ms(5 * 2 * 24 * tri * hs_, 8 * plane * 24 // n, "bfloat16"))
    nb, H, t_, hs_ = K4_PROD
    x = randn(nb, 3 * H, t_, hs_).to(bf)
    do = randn(nb, H, t_, hs_).to(bf)
    o4 = K.short_causal_attention_packed_fwd(x, H)
    o4d = K.short_causal_attention_packed_fwd(x, H, 0.2, SALTS)
    x1, o41, d41 = (a[:4].contiguous() for a in (x, o4, do))
    k4_lib = sdpa_backward_ms(lambda a: F.scaled_dot_product_attention(
        a[:, :H], a[:, H:2 * H], a[:, 2 * H:], is_causal=True), (x,), do)

    plane = nb * H * t_ * hs_ * 2
    timing["short_causal_attention_packed"] = dict(
        ms=device_ms(lambda: K.short_causal_attention_packed_fwd(x, H)),
        ms_dropout=device_ms(lambda: K.short_causal_attention_packed_fwd(x, H, 0.2, SALTS)),
        ms_b1=device_ms(lambda: K.short_causal_attention_packed_fwd(x1, H)),
        plain_ms=device_ms(lambda: K.short_causal_attention_packed_plain(x, H)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            x[:, :H], x[:, H:2 * H], x[:, 2 * H:], is_causal=True)),
        bound=bound_ms(2 * 2 * nb * H * tri * hs_, 4 * plane, "bfloat16"),
        bound_b1=bound_ms(2 * 2 * 4 * H * tri * hs_, 4 * plane * 4 // nb, "bfloat16"))
    timing["short_causal_attention_packed_bwd"] = dict(
        ms=device_ms(lambda: K.short_causal_attention_packed_bwd(x, o4, do, H)),
        ms_dropout=device_ms(lambda: K.short_causal_attention_packed_bwd(x, o4d, do, H, 0.2, SALTS)),
        ms_b1=device_ms(lambda: K.short_causal_attention_packed_bwd(x1, o41, d41, H)),
        plain_ms=device_ms(lambda: K.short_causal_attention_packed_bwd_plain(x, o4, do, H)),
        library_ms=k4_lib[0],
        library_fwd_bwd_ms=k4_lib[1],
        # reads qkv, out and dout; writes d(qkv)
        bound=bound_ms(5 * 2 * nb * H * tri * hs_, 8 * plane, "bfloat16"),
        bound_b1=bound_ms(5 * 2 * 4 * H * tri * hs_, 8 * plane * 4 // nb, "bfloat16"))
    posd = torch.tensor([S9 - 1], dtype=torch.int32, device=dev)
    visible = (torch.arange(S9, device=dev) <= S9 - 1)[None, :]
    qd1, kT1, vT1 = (a[:24].contiguous() for a in (qd, kT, vT))
    timing["decode_attention_t"] = dict(
        plan=K.decode_attention_t_plan(qd, kT, vT), plan_b1=K.decode_attention_t_plan(qd1, kT1, vT1),
        ms=device_ms(lambda: K.decode_attention_t(qd, kT, vT, posd)),
        ms_dropout=None,
        ms_b1=device_ms(lambda: K.decode_attention_t(qd1, kT1, vT1, posd)),
        plain_ms=device_ms(lambda: K.decode_attention_t_plain(qd, kT, vT, posd)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qd, kT.transpose(-1, -2), vT.transpose(-1, -2), attn_mask=visible)),
        bound=bound_ms(4 * n9 * S9 * hs9, 2 * n9 * S9 * hs9 * 2 + 2 * n9 * hs9 * 2, "bfloat16"),
        bound_b1=bound_ms(4 * 24 * S9 * hs9, 2 * 24 * S9 * hs9 * 2 + 2 * 24 * hs9 * 2, "bfloat16"))
    for name, shape in (("short_causal_attention_bwd", K3B_PROD),
                        ("short_causal_attention_packed", K4_PROD),
                        ("short_causal_attention_packed_bwd", K4_PROD),
                        ("decode_attention_t", K9_PROD)):
        t = timing[name]
        emit({"phase": "kernel_time", "kernel": name, "card": card, "shape": list(shape),
              "kernel_ms": t["ms"], "kernel_ms_dropout": t["ms_dropout"], "kernel_ms_b1": t["ms_b1"],
              "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
              "library_fwd_bwd_ms": t.get("library_fwd_bwd_ms"),
              "library_3d_ms": t.get("library_3d_ms"), "bound_ms": t["bound"][0],
              "bound_by": t["bound"][1], "bound_ms_b1": t["bound_b1"][0],
              **{k_: t[k_] for k_ in ("plan", "plan_b1") if k_ in t}})


def crossover(K, card, by_path):
    """The port of tools/flash_crossover.py on the card: its sweep (bf16,
    batch 4, 6 heads, hs 64, T 64..8192), each table row printed on its own
    line. Per timed application exactly one K3f and one K3b launch for the
    whole-row core (in the band) and one K5f and one K5b for the flash core
    (where eligible), none for the dense core; per timed forward
    application (the forward alone) one K3f or one K5f; every time finite. At T 256
    and 512, where both kernels run, the whole-row core's q, k, v gradients
    against the flash core's on the same inputs (REL_TOL, bf16); at every T
    of the band one application with K3b held in-path against its plain
    version (L2-relative, REL_TOL). Adds ``by_path["crossover"]``; raises on
    a failed check."""
    import torch

    from trade_aid_multimodal_transformer_tpu_torch import flash_crossover as X

    batch, heads, hs = 4, 6, 64
    for line in X.header(batch, heads, hs, "bfloat16", "cuda").splitlines():
        emit(line)
    rows, failed = [], []
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for t_ in X.T_LIST:
        row = X.crossover_row(t_, batch, heads, hs, torch.bfloat16, "cuda")
        emit(X.format_row(row))
        want = {core: {kn: row["applications"][core] for kn in X.CORE_KERNELS[core]}
                for core in X.cores(t_, hs)}
        want_fwd = {core: {kn: row["fwd_applications"][core] for kn in X.CORE_FWD_KERNELS[core]}
                    for core in X.cores(t_, hs)}
        finite = all(math.isfinite(row[f"{c}_{tag}ms"]) for c in X.CORE_KERNELS
                     for tag in ("", "fwd_") if row[f"{c}_{tag}ms"] is not None)
        if row["launches"] != want or row["fwd_launches"] != want_fwd or not finite:
            failed.append(t_)
        rows.append(row)
    sweep_s = time.perf_counter() - t0
    by_path["crossover"] = counts = K.launch_counts()
    total = dict.fromkeys(K.KERNELS, 0)
    for row in rows:
        for per_core in (*row["launches"].values(), *row["fwd_launches"].values()):
            for kn, c in per_core.items():
                total[kn] += c
    in_path = {}  # one application per T of the band: K3b against its plain version
    band = [t_ for t_ in X.T_LIST if K.in_band(t_, hs)]
    for t_ in band:
        worst = {}
        with patched(K, short_causal_attention_bwd=checked(
                K, "short_causal_attention_bwd", K.short_causal_attention_bwd, worst)):
            X.grads(K.short_causal_attention, *X.inputs(t_, batch, heads, hs, torch.bfloat16, "cuda"))
        in_path.update({f"T{t_}.{k_.split('.')[-1]}": v_ for k_, v_ in worst.items()})
    agree = {}
    for t_ in (256, 512):
        q, k, v = X.inputs(t_, batch, heads, hs, torch.bfloat16, "cuda")
        short_g = X.grads(K.short_causal_attention, q, k, v)
        flash_g = X.grads(K.flash_causal_attention, q, k, v)
        for name, a, b in zip(("dq", "dk", "dv"), short_g, flash_g):
            agree[f"T{t_}.{name}"] = {
                "max_abs": (a.float() - b.float()).abs().max().item(),
                "bound": REL_TOL["bfloat16"] * max(1.0, b.float().abs().max().item())}
    ok = (not failed and counts == total and len(in_path) == 3 * len(band)
          and all(v_ <= REL_TOL["bfloat16"] for v_ in in_path.values())
          and all(e["max_abs"] <= e["bound"] for e in agree.values()))
    emit({"phase": "crossover", "card": card, "tool": f"python -m {PKG}.flash_crossover",
          "shape": [batch, heads, "T", hs], "dtype": "bfloat16", "seconds": sweep_s,
          "rows": [{k_: v_ for k_, v_ in r.items() if k_ not in ("launches", "fwd_launches")}
                   for r in rows],
          "launches": {k_: v_ for k_, v_ in counts.items() if v_}, "launches_exact": not failed,
          "in_path_k3b_l2_rel": in_path, "in_path_tol": REL_TOL["bfloat16"],
          "short_vs_flash_grads": agree, "ok": ok})
    if not ok:
        raise AssertionError(f"the crossover sweep failed its checks (rows {failed})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if not (REPO / PKG / "ops" / "kernels.py").is_file():
        print(f"chip_smoke: the {PKG} package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if sys.argv[1:] == ["--multi-card"]:
        return multi_card(smi())
    if sys.argv[1:] == ["--k1b-split"]:
        from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K

        card = smi()
        emit(card)
        K.build_kernels()
        k1b_split(K, card)
        return 0
    import numpy as np
    import torch.nn.functional as F

    from trade_aid_multimodal_transformer_tpu_torch import generate as entry
    from trade_aid_multimodal_transformer_tpu_torch.models.init import init_params
    from trade_aid_multimodal_transformer_tpu_torch.models.sampler import generate_fast
    from trade_aid_multimodal_transformer_tpu_torch.models.transformer import forward
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
    from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import save_checkpoint

    # 1. device
    card = smi()
    emit(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "smi": card,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False})

    # 2. build
    t0 = time.perf_counter()
    per_source = K.build_kernels()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": per_source})
    native_check(card)
    for name in K._SIGNATURES:
        emit({"phase": "ptxas", "source": name, "functions": ptxas_report(K.build_log(name))})

    # 2b. the training entry's TAT_PROFILE_DIR trace, before any other profile
    profile_trace_check(K, card)

    # 3. each kernel against its plain version
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def fqkv_inputs(M, B, T, C, H, hs):
        hs2 = hs // 2
        return (randn(M, B, T, C), randn(M, C, 3 * H * hs2, scale=0.05),
                randn(M, 3 * H * hs2, scale=0.05), randn(M, 3 * H, hs2, hs, scale=0.2))

    prod_k1 = PROD_K1
    prod_k2 = (3, 6 * 32, 64, 64)
    b1_k1, b1_k2 = (4, 1, 64, 384, 6, 64), (3, 6, 64, 64)  # what a B=1 step gives them
    # edge shapes: T=8 and T=512, hs 32, B=7; T not a multiple of the key
    # tile, hs 96 / 128 / 256 (smaller tiles), C not a multiple of 8; K1f's
    # mma.sync body at T 8 / 72 / 512 x hs 32 / 64 / 128, B odd (one batch
    # row a block) and even (two), every K1f run twice for the same bits; the
    # cross kernels at hs 24 (not a multiple of 16: the bf16 FMA body), at
    # the --serve chunk prefill (T = 56, B = 1 and B = 32), at T 136 x hs
    # 128 (two passes of the mma.sync forward) and at hs 16
    k1_shapes = [prod_k1, b1_k1, (2, 3, 8, 32, 2, 16), (1, 2, 512, 384, 6, 64),
                 (2, 5, 64, 96, 3, 32), (4, 7, 64, 384, 6, 64), (1, 5, 72, 96, 3, 32),
                 (1, 2, 136, 64, 2, 128), (1, 2, 40, 64, 1, 256), (1, 3, 200, 100, 2, 96),
                 (2, 3, 8, 64, 2, 64), (1, 2, 8, 64, 1, 128), (1, 2, 72, 64, 2, 128),
                 (1, 2, 512, 96, 2, 32), (1, 1, 512, 64, 1, 128)]
    k2_shapes = [prod_k2, b1_k2, (3, 6, 56, 64), (3, 6 * 32, 56, 64), (3, 6, 8, 64),
                 (3, 12, 512, 64), (3, 15, 64, 32), (3, 6 * 7, 64, 64), (3, 5, 72, 32),
                 (2, 3, 200, 128), (2, 2, 64, 256), (2, 3, 64, 24), (2, 3, 64, 96),
                 (2, 3, 136, 128), (2, 3, 64, 16)]
    errs = {}
    for shape in k1_shapes:
        x, w1, b1, w2 = fqkv_inputs(*shape)
        for dtype in ("float32", "bfloat16"):
            xx = x.to(getattr(torch, dtype))
            out = K.fused_qkv_attention(xx, w1, b1, w2, shape[4])
            again = K.fused_qkv_attention(xx, w1, b1, w2, shape[4])
            torch.cuda.synchronize()
            same_bits("fused_qkv_attention", (out,), (again,), shape)
            torch.cuda.synchronize()
            ref = K.fused_qkv_attention_plain(xx, w1, b1, w2, shape[4])
            errs[("fused_qkv_attention", shape, dtype)] = check_close(
                "fused_qkv_attention", out, ref, dtype, shape)
    for shape in k2_shapes:
        J, n, T, hs = shape
        q, k, v = randn(n, T, hs), randn(J, n, T, hs), randn(J, n, T, hs)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            out = K.short_cross_attention(q.to(dt), k.to(dt), v.to(dt))
            if mma_forward(dtype, hs):
                again = K.short_cross_attention(q.to(dt), k.to(dt), v.to(dt))
                torch.cuda.synchronize()
                same_bits("short_cross_attention", (out,), (again,), shape)
            torch.cuda.synchronize()
            ref = K.short_cross_attention_plain(q.to(dt), k.to(dt), v.to(dt))
            errs[("short_cross_attention", shape, dtype)] = check_close(
                "short_cross_attention", out, ref, dtype, shape)

    # dropout forwards and backward kernels, dropout off and on; the f32 rows
    # of the production shape run another batch group (gb) than bf16
    for shape in k1_shapes:
        x, w1, b1, w2 = fqkv_inputs(*shape)
        M_, B_, T_, C_, H_, hs_ = shape
        dout = randn(M_, H_, B_, T_, hs_)
        for dtype in ("float32", "bfloat16"):
            xx, do_ = x.to(getattr(torch, dtype)), dout.to(getattr(torch, dtype))
            for rate in (0.0, 0.2):
                salts = SALTS if rate else None
                out = K.fused_qkv_attention_fwd(xx, w1, b1, w2, H_, rate, salts)
                if rate:
                    same_bits("fused_qkv_attention", (out,),
                              (K.fused_qkv_attention_fwd(xx, w1, b1, w2, H_, rate, salts),), shape)
                grads = K.fused_qkv_attention_bwd(xx, w1, b1, w2, out, do_, H_, rate, salts)
                again = K.fused_qkv_attention_bwd(xx, w1, b1, w2, out, do_, H_, rate, salts)
                torch.cuda.synchronize()
                same_bits("fused_qkv_attention_bwd", grads, again, shape)
                if rate:
                    errs[("fused_qkv_attention", shape, dtype, rate)] = check_rel(
                        "fused_qkv_attention", out,
                        K.fused_qkv_attention_plain(xx, w1, b1, w2, H_, rate, salts), dtype, shape, rate)
                ref = K.fused_qkv_attention_bwd_plain(xx, w1, b1, w2, out, do_, H_, rate, salts)
                errs[("fused_qkv_attention_bwd", shape, dtype, rate)] = max(
                    check_rel(f"fused_qkv_attention_bwd.{g}", a, r, dtype, shape, rate)
                    for g, a, r in zip(("dx", "dw1", "db1", "dw2"), grads, ref))
    for shape in k2_shapes:
        J, n, T_, hs_ = shape
        q, k, v, dout = randn(n, T_, hs_), randn(J, n, T_, hs_), randn(J, n, T_, hs_), randn(n, T_, hs_)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            qq, kk, vv, do_ = q.to(dt), k.to(dt), v.to(dt), dout.to(dt)
            for rate in (0.0, 0.2):
                salts = SALTS if rate else None
                out = K.short_cross_attention_fwd(qq, kk, vv, rate, salts)
                if rate and mma_forward(dtype, hs_):
                    same_bits("short_cross_attention", (out,),
                              (K.short_cross_attention_fwd(qq, kk, vv, rate, salts),), shape)
                grads = K.short_cross_attention_bwd(qq, kk, vv, do_, rate, salts)
                again = K.short_cross_attention_bwd(qq, kk, vv, do_, rate, salts)
                torch.cuda.synchronize()
                same_bits("short_cross_attention_bwd", grads, again, shape)
                if rate:
                    errs[("short_cross_attention", shape, dtype, rate)] = check_rel(
                        "short_cross_attention", out,
                        K.short_cross_attention_plain(qq, kk, vv, rate, salts), dtype, shape, rate)
                ref = K.short_cross_attention_bwd_plain(qq, kk, vv, do_, rate, salts)
                errs[("short_cross_attention_bwd", shape, dtype, rate)] = max(
                    check_rel(f"short_cross_attention_bwd.{g}", a, r, dtype, shape, rate)
                    for g, a, r in zip(("dq", "dk", "dv"), grads, ref))

    # the same kernels (and K5f, K5b, K6f-r) on half a batch with the
    # global-row arguments of data parallelism, and on half the heads (and
    # the batch) with those of tensor parallelism
    dp_kernel_check(K, card, gen)
    tp_kernel_check(K, card, gen)
    mod_kernel_check(K, card, gen)

    # K3f: the production prefill (24 B rows, T = 56, hs = 64) at B = 32 and
    # B = 1, T in {8, 64, 512} x hs in {16, 24, 64, 128, 256}, and T 72 x
    # hs 32, T 200 x hs 96 (two passes of the mma.sync forward)
    k3_shapes = [(24 * 32, 56, 64), (24, 56, 64)] + [
        (3, T_, hs_) for T_ in (8, 64, 512) for hs_ in (16, 24, 64, 128, 256)] + [
        (3, 72, 32), (3, 200, 96)]
    for shape in k3_shapes:
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
            for rate in (0.0, 0.2):
                salts = SALTS if rate else None
                out = K.short_causal_attention(qq, kk, vv, rate, salts)
                if mma_forward(dtype, shape[2]):
                    again = K.short_causal_attention(qq, kk, vv, rate, salts)
                    torch.cuda.synchronize()
                    same_bits("short_causal_attention", (out,), (again,), shape)
                torch.cuda.synchronize()
                ref = K.short_causal_attention_plain(qq, kk, vv, rate, salts)
                if rate:
                    errs[("short_causal_attention", shape, dtype, rate)] = check_rel(
                        "short_causal_attention", out, ref, dtype, shape, rate)
                else:
                    errs[("short_causal_attention", shape, dtype)] = check_close(
                        "short_causal_attention", out, ref, dtype, shape)

    # the decode kernels: pos in {0, pack - 1, S/2, S - 1}, pack in {1, 2, 4}
    # (hs = 128 / pack), S in {64, 512, 1024} (a warp a row up to 128
    # positions, several above); the production caches (24 x 32 rows, hs 64:
    # packed by 2 at S = 64, the plain layout at S = 72); rows that do not
    # fill a block (5, 7), and hs 36 (rows not 16-byte aligned: element
    # loads) at S 64 and 200. Every call runs twice for the same bits
    def decode_inputs(n, S_, hs_, pack):
        shape = (n, S_ // pack, pack * hs_)
        k8 = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)
        v8 = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)
        ks, vs = ((torch.rand(shape[:-1], generator=gen) * 3.5 + 0.5).to(dev) for _ in range(2))
        return randn(n, 1, hs_), randn(*shape), randn(*shape), k8, v8, ks, vs

    decode_cases = [(24, S_, 128 // p, p, pos) for S_ in (64, 512, 1024) for p in (1, 2, 4)
                    for pos in sorted({0, p - 1, S_ // 2, S_ - 1})]
    decode_cases += [(24 * 32, 64, 64, 2, 63), (24 * 32, 72, 64, 1, 71), (5, 64, 64, 2, 40),
                     (7, 1024, 64, 2, 700), (3, 64, 36, 1, 63), (3, 200, 36, 1, 150)]
    for n, S_, hs_, pack, pos in decode_cases:
        q, kp, vp, k8, v8, ks, vs = decode_inputs(n, S_, hs_, pack)
        pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
        shape = (n, S_, hs_, pack, pos)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            qq, kk, vv = q.to(dt), kp.to(dt), vp.to(dt)
            runs = {"decode_attention": lambda: K.decode_attention(
                        qq, kk.view(n, S_, hs_), vv.view(n, S_, hs_), pos_t),
                    "decode_attention_packed": lambda: K.decode_attention_packed(qq, kk, vv, pos_t),
                    "decode_attention_packed_q8": lambda: K.decode_attention_packed_q8(
                        qq, k8, v8, ks, vs, pos_t)}
            outs = {name: run() for name, run in runs.items()}
            again = {name: run() for name, run in runs.items()}
            torch.cuda.synchronize()
            for name in outs:
                same_bits(name, (outs[name],), (again[name],), shape)
            refs = {"decode_attention": K.decode_attention_plain(qq, kk.view(n, S_, hs_), vv.view(n, S_, hs_), pos),
                    "decode_attention_packed": K.decode_attention_packed_plain(qq, kk, vv, pos),
                    "decode_attention_packed_q8": K.decode_attention_packed_q8_plain(qq, k8, v8, ks, vs, pos)}
            for name in outs:
                errs[(name, shape, dtype)] = check_close(name, outs[name], refs[name], dtype, shape)

    # times at the production bf16 shapes
    M, B, T, C, H, hs = prod_k1
    hs2, D = hs // 2, H * hs // 2
    x, w1, b1, w2 = fqkv_inputs(*prod_k1)
    x = x.bfloat16()

    def k1_library():  # one projection matmul chain + SDPA, timed only here
        pre = torch.matmul(x, w1.bfloat16()[:, None]) + b1.bfloat16()[:, None, None, :]
        t = torch.tanh(pre).reshape(M, B, T, 3 * H, hs2).permute(0, 3, 1, 2, 4)
        qkv = torch.matmul(t, w2.bfloat16()[:, :, None])  # (M, 3H, B, T, hs)
        q4, k4, v4 = (qkv[:, i * H:(i + 1) * H].reshape(M * H, B, T, hs) for i in range(3))
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    def k1_bound(b_):  # the least time of K1f at batch b_: every weight read once as f32
        flops = 2 * M * b_ * T * (C * 3 * D + 3 * H * hs2 * hs) + 2 * 2 * M * b_ * H * (T * (T + 1) // 2) * hs
        nbytes = 2 * M * b_ * T * C + 4 * (M * C * 3 * D + M * 3 * D + M * 3 * H * hs2 * hs) + 2 * M * H * b_ * T * hs
        return bound_ms(flops, nbytes, "bfloat16")

    x_b1 = x[:, :1].contiguous()  # the shape one B=1 generation step gives the kernel
    timing = {"fused_qkv_attention": dict(
        ms=device_ms(lambda: K.fused_qkv_attention(x, w1, b1, w2, H)),
        ms_dropout=device_ms(lambda: K.fused_qkv_attention(x, w1, b1, w2, H, 0.2, SALTS)),
        ms_b1=device_ms(lambda: K.fused_qkv_attention(x_b1, w1, b1, w2, H)),
        plain_ms=device_ms(lambda: K.fused_qkv_attention_plain(x, w1, b1, w2, H)),
        library_ms=device_ms(k1_library),
        bound=k1_bound(B),
        bound_b1=k1_bound(1),
    )}
    J, n, T2, hs_ = prod_k2
    q, k, v = randn(n, T2, hs_).bfloat16(), randn(J, n, T2, hs_).bfloat16(), randn(J, n, T2, hs_).bfloat16()

    def k2_library():
        return sum(F.scaled_dot_product_attention(q[None], k[j, None], v[j, None], is_causal=True)
                   for j in range(J))

    def k2_bound(n_):
        return bound_ms(J * 2 * 2 * n_ * (T2 * (T2 + 1) // 2) * hs_, 2 * n_ * T2 * hs_ * (1 + 2 * J + 1),
                        "bfloat16")

    q_b1, k_b1, v_b1 = q[:H].contiguous(), k[:, :H].contiguous(), v[:, :H].contiguous()
    timing["short_cross_attention"] = dict(
        ms=device_ms(lambda: K.short_cross_attention(q, k, v)),
        ms_dropout=device_ms(lambda: K.short_cross_attention(q, k, v, 0.2, SALTS)),
        ms_b1=device_ms(lambda: K.short_cross_attention(q_b1, k_b1, v_b1)),
        plain_ms=device_ms(lambda: K.short_cross_attention_plain(q, k, v)),
        library_ms=device_ms(k2_library),
        bound=k2_bound(n),
        bound_b1=k2_bound(H),
    )
    # backward kernels at the production shapes; the library yardsticks are
    # autograd backwards without dropout
    rate = 0.2
    w1g, b1g, w2g = (t.clone().requires_grad_() for t in (w1, b1, w2))
    xg = x.clone().requires_grad_()
    out0 = K.fused_qkv_attention_fwd(x, w1, b1, w2, H)
    out1 = K.fused_qkv_attention_fwd(x, w1, b1, w2, H, rate, SALTS)
    do1 = randn(*out1.shape).bfloat16()
    with torch.enable_grad():
        pre = torch.matmul(xg, w1g.bfloat16()[:, None]) + b1g.bfloat16()[:, None, None, :]
        tt = torch.tanh(pre).reshape(M, B, T, 3 * H, hs2).permute(0, 3, 1, 2, 4)
        qkv = torch.matmul(tt, w2g.bfloat16()[:, :, None])
        q4, k4, v4 = (qkv[:, i * H:(i + 1) * H].reshape(M * H, B, T, hs) for i in range(3))
        lib1 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    tri = T * (T + 1) // 2

    def k1b_bound(b_):
        flops = (2 * M * b_ * T * (C * 3 * D + 3 * H * hs2 * hs)         # recompute the projection
                 + 5 * 2 * M * b_ * H * tri * hs                          # QK^T, dO.V^T, dV, dQ, dK
                 + 2 * 2 * M * b_ * T * 3 * H * hs2 * hs                  # dt3, dw2
                 + 2 * 2 * M * b_ * T * 3 * D * C)                        # dx, dw1
        nbytes = (2 * M * b_ * T * C * 2 + 2 * M * H * b_ * T * hs * 2     # x, dx; o, do
                  + 4 * 2 * (M * C * 3 * D + M * 3 * D + M * 3 * H * hs2 * hs))  # weights, their grads
        return bound_ms(flops, nbytes, "bfloat16")

    o_b1, do_b1 = out0[:, :, :1].contiguous(), do1[:, :, :1].contiguous()
    timing["fused_qkv_attention_bwd"] = dict(
        ms=device_ms(lambda: K.fused_qkv_attention_bwd(x, w1, b1, w2, out0, do1, H)),
        ms_dropout=device_ms(lambda: K.fused_qkv_attention_bwd(x, w1, b1, w2, out1, do1, H, rate, SALTS)),
        ms_b1=device_ms(lambda: K.fused_qkv_attention_bwd(x_b1, w1, b1, w2, o_b1, do_b1, H)),
        plain_ms=device_ms(lambda: K.fused_qkv_attention_bwd_plain(x, w1, b1, w2, out0, do1, H)),
        library_ms=device_ms(lambda: torch.autograd.grad(
            lib1, (xg, w1g, b1g, w2g), do1.reshape(M, H, B, T, hs).reshape(M * H, B, T, hs),
            retain_graph=True)),
        bound=k1b_bound(B),
        bound_b1=k1b_bound(1),
    )
    k1b_split(K, card)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    do2 = randn(n, T2, hs_).bfloat16()
    with torch.enable_grad():
        lib2 = sum(F.scaled_dot_product_attention(qg[None], kg[j, None], vg[j, None], is_causal=True)
                   for j in range(J))[0]
    # read q, do and each stream's k_j, v_j (2 + 2J); write dq and each
    # dk_j, dv_j (1 + 2J)
    def k2b_bound(n_):
        return bound_ms(J * 5 * 2 * n_ * (T2 * (T2 + 1) // 2) * hs_, 2 * n_ * T2 * hs_ * (3 + 4 * J),
                        "bfloat16")

    do2_b1 = do2[:H].contiguous()
    timing["short_cross_attention_bwd"] = dict(
        ms=device_ms(lambda: K.short_cross_attention_bwd(q, k, v, do2)),
        ms_dropout=device_ms(lambda: K.short_cross_attention_bwd(q, k, v, do2, rate, SALTS)),
        ms_b1=device_ms(lambda: K.short_cross_attention_bwd(q_b1, k_b1, v_b1, do2_b1)),
        plain_ms=device_ms(lambda: K.short_cross_attention_bwd_plain(q, k, v, do2)),
        library_ms=device_ms(lambda: torch.autograd.grad(lib2, (qg, kg, vg), do2, retain_graph=True)),
        bound=k2b_bound(n),
        bound_b1=k2b_bound(H),
    )
    # K3f at the production prefill: 24 B rows of T = 56 (B = 32; B = 1)
    n3, T3 = 24 * 32, 56
    q3, k3, v3 = (randn(n3, T3, hs).bfloat16() for _ in range(3))
    q3b, k3b, v3b = q3[:24].contiguous(), k3[:24].contiguous(), v3[:24].contiguous()
    timing["short_causal_attention"] = dict(
        ms=device_ms(lambda: K.short_causal_attention(q3, k3, v3)),
        ms_dropout=device_ms(lambda: K.short_causal_attention(q3, k3, v3, 0.2, SALTS)),
        ms_b1=device_ms(lambda: K.short_causal_attention(q3b, k3b, v3b)),
        plain_ms=device_ms(lambda: K.short_causal_attention_plain(q3, k3, v3)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            q3[None], k3[None], v3[None], is_causal=True)),
        library_3d_ms=device_ms(lambda: F.scaled_dot_product_attention(q3, k3, v3, is_causal=True)),
        bound=bound_ms(2 * 2 * n3 * T3 * T3 * hs / 2, 4 * n3 * T3 * hs * 2, "bfloat16"),
        bound_b1=bound_ms(2 * 2 * 24 * T3 * T3 * hs / 2, 4 * 24 * T3 * hs * 2, "bfloat16"),
    )
    # the decode kernels at the production self-attention cache of B = 32
    # (24 B rows, S = 64, hs = 64, packed by 2) with every column visible
    # (pos = S - 1; the steady decode steps run at pos 56..63), and at B = 1;
    # K8 on the unpacked view of the same cache. The library yardstick is
    # SDPA of q against the first pos + 1 rows; no PyTorch call computes K8q.
    nd, Sd, pack = 24 * 32, 64, 2
    qd = randn(nd, 1, hs).bfloat16()
    kp, vp = (randn(nd, Sd // pack, pack * hs).bfloat16() for _ in range(2))
    kd, vd = kp.view(nd, Sd, hs), vp.view(nd, Sd, hs)
    k8, v8 = (torch.randint(-127, 128, kp.shape, generator=gen, dtype=torch.int8).to(dev) for _ in range(2))
    ks, vs = ((torch.rand(kp.shape[:-1], generator=gen) * 3.5 + 0.5).to(dev) for _ in range(2))
    posd = torch.tensor([Sd - 1], dtype=torch.int32, device=dev)
    b1 = lambda t: t[:24].contiguous()  # noqa: E731
    qd1, kp1, vp1, kd1, vd1, k81, v81, ks1, vs1 = map(b1, (qd, kp, vp, kd, vd, k8, v8, ks, vs))
    def dec_bound(n_, q8=False):  # every visible key and value read once, q read, out written
        kv_bytes = 2 * n_ * Sd * hs + 2 * n_ * (Sd // pack) * 4 if q8 else 2 * n_ * Sd * hs * 2
        return bound_ms(4 * n_ * Sd * hs, kv_bytes + 2 * n_ * hs * 2, "bfloat16")

    timing["decode_attention"] = dict(
        ms=device_ms(lambda: K.decode_attention(qd, kd, vd, posd)),
        ms_dropout=None,
        ms_b1=device_ms(lambda: K.decode_attention(qd1, kd1, vd1, posd)),
        plain_ms=device_ms(lambda: K.decode_attention_plain(qd, kd, vd, posd)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd)),
        bound=dec_bound(nd),
        bound_b1=dec_bound(24),
    )
    timing["decode_attention_packed"] = dict(
        ms=device_ms(lambda: K.decode_attention_packed(qd, kp, vp, posd)),
        ms_dropout=None,
        ms_b1=device_ms(lambda: K.decode_attention_packed(qd1, kp1, vp1, posd)),
        plain_ms=device_ms(lambda: K.decode_attention_packed_plain(qd, kp, vp, posd)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd)),
        bound=dec_bound(nd),
        bound_b1=dec_bound(24),
    )
    timing["decode_attention_packed_q8"] = dict(
        ms=device_ms(lambda: K.decode_attention_packed_q8(qd, k8, v8, ks, vs, posd)),
        ms_dropout=None,
        ms_b1=device_ms(lambda: K.decode_attention_packed_q8(qd1, k81, v81, ks1, vs1, posd)),
        plain_ms=device_ms(lambda: K.decode_attention_packed_q8_plain(qd, k8, v8, ks, vs, posd)),
        library_ms=None,
        bound=dec_bound(nd, q8=True),
        bound_b1=dec_bound(24, q8=True),
    )
    # kernel_ms, kernel_ms_b1 and plain_ms without dropout (as serving runs
    # K1f/K2f); kernel_ms_dropout at 0.2, as the training path runs all four.
    # Every time is device time (device_ms)
    for name, t in timing.items():
        emit({"phase": "kernel_time", "kernel": name, "card": card, "kernel_ms": t["ms"],
              "kernel_ms_dropout": t["ms_dropout"], "kernel_ms_b1": t["ms_b1"],
              "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
              "library_3d_ms": t.get("library_3d_ms"),
              "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
              "bound_ms_b1": t["bound_b1"][0]})

    # 3b. the kernels that only public ops and tools reach: K3b, K4f / K4b, K9
    by_path = {}
    short_kernels(K, card, gen, timing, errs, by_path)

    # 4. the entry point at production width, and a reference check
    tokens = 32
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        shutil.copy(REPO / "examples" / "production_config.yaml", d / "config.yaml")
        shutil.copy(REPO / "examples" / "production_input_schemas.yaml", d / "input_schemas.yaml")
        write_stock_folder(d / "your_data" / "stocks", n_files=6, rows=1500, seed=1)
        data = entry.load_config_and_data(str(d))
        cfg = data["cfg"]
        params = init_params(cfg, torch.Generator().manual_seed(1234), dev)
        save_checkpoint(str(d / data["sc"]["model_file_name"]), params)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = entry.run(str(d), tokens=tokens, modality=0, seed=0)
        entry_s = time.perf_counter() - t0
        launches = K.launch_counts()
    new, vocabs = res["new"], res["vocabs"]
    if str(res["device"]) != "cuda" or not res["model"].startswith("checkpoint"):
        raise AssertionError(f"entry ran on {res['device']} with {res['model']}")
    if new.shape != (cfg.num_modalities, tokens):
        raise AssertionError(f"generated shape {new.shape}")
    if not (0 <= new[0].min() and new[0].max() < len(vocabs[0])):
        raise AssertionError("generated token outside the vocabulary")
    for m in range(1, cfg.num_modalities):
        if not (new[m] == res["last_prompt_tokens"][m]).all():
            raise AssertionError(f"modality {m} did not repeat its last token")
    want = dict.fromkeys(K.KERNELS, 0)
    want.update(fused_qkv_attention=cfg.n_layer * tokens,
                short_cross_attention=2 * cfg.n_layer * tokens)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    emit({"phase": "entry", "config": "examples/production_config.yaml",
          "vocab_sizes": list(cfg.vocab_sizes), "n_embd": cfg.n_embd, "n_head": cfg.n_head,
          "n_layer": cfg.n_layer, "block_size": cfg.block_size, "compute_dtype": cfg.compute_dtype,
          "tokens": tokens, "batch": 1, "seconds": entry_s, "launches": launches,
          "expected_launches": want, "generated": new[0].tolist()})

    # the kernel path on the card against the dense path on the CPU, f32
    rng = np.random.default_rng(5)
    idx = np.stack([rng.integers(0, v, (2, cfg.block_size)) for v in cfg.vocab_sizes])
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu_params = init_params(cfg, torch.Generator().manual_seed(1234), "cpu")
    ref = forward(cpu_params, f32, torch.from_numpy(idx))[0]
    got = forward(params, f32, torch.from_numpy(idx).to(dev))[0]
    bf = forward(params, cfg, torch.from_numpy(idx).to(dev))[0]
    ref_err = max((a.cpu() - b).abs().max().item() for a, b in zip(got, ref))
    bf_err = max((a.cpu() - b).abs().max().item() for a, b in zip(bf, ref))
    finite = all(torch.isfinite(t).all().item() for t in got + bf)
    emit({"phase": "reference", "what": "card kernels vs CPU dense forward, logits",
          "f32_max_abs_err": ref_err, "f32_tol": 1e-4, "bf16_max_abs_err": bf_err,
          "bf16_tol": 5e-2, "finite": finite})
    if not finite or ref_err > 1e-4 or bf_err > 5e-2:
        raise AssertionError("forward on the card disagrees with the CPU reference")

    # 5. batched serving at production width
    served = {}
    for batch, n_tok in ((1, 32), (32, 64)):
        window = torch.from_numpy(
            np.stack([rng.integers(0, v, (batch, cfg.block_size)) for v in cfg.vocab_sizes])
        ).to(dev)
        g = torch.Generator(device=dev).manual_seed(0)
        generate_fast(params, cfg, window, g, 2, 0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate_fast(params, cfg, window, g, n_tok, 0)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if out.shape != (cfg.num_modalities, batch, cfg.block_size + n_tok):
            raise AssertionError(f"serving output shape {tuple(out.shape)}")
        served[batch] = sec / n_tok
        emit({"phase": "serving", "card": card, "batch": batch, "tokens": n_tok,
              "seconds": sec, "tokens_per_s": batch * n_tok / sec, "ms_per_step": 1e3 * sec / n_tok})

    # 6. where the time goes: device time per generated token by kernel
    # (torch.profiler, device-side events only), and its share of the
    # unprofiled time per token of phase 5
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)  # start-up of the profiler, not timed
        torch.cuda.synchronize()
    for batch in (1, 32):
        window = torch.from_numpy(
            np.stack([rng.integers(0, v, (batch, cfg.block_size)) for v in cfg.vocab_sizes])
        ).to(dev)
        g = torch.Generator(device=dev).manual_seed(0)
        generate_fast(params, cfg, window, g, 2, 0)
        torch.cuda.synchronize()
        n_tok = 4
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            generate_fast(params, cfg, window, g, n_tok, 0)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_s = sum(e.self_device_time_total for e in kern) / 1e6 / n_tok
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
        emit({"phase": "profile", "card": card, "batch": batch, "tokens": n_tok,
              "step_ms_unprofiled": 1e3 * served[batch],
              "device_ms_per_token": 1e3 * dev_s if kern else None,
              "device_busy_share": dev_s / served[batch] if kern else None,
              "kernels_per_token": sum(e.count for e in kern) / n_tok,
              "top": [[e.key[:72], e.self_device_time_total / 1e3 / n_tok, e.count / n_tok]
                      for e in top]})

    # 7. the KV-cached serving entry (--serve) on the production config: bf16
    # and int8 caches (packed by 2: K8p / K8q), and a copy of the config with
    # block_size 72, whose cache keeps the plain layout (K8), at refresh 8;
    # each primed with a full window and generating one window of tokens
    from trade_aid_multimodal_transformer_tpu_torch.models import cache as C

    serve_counts = {}
    for label, kv, block, refresh, decode in (
            ("serve", None, None, None, "decode_attention_packed"),
            ("serve_int8", "int8", None, None, "decode_attention_packed_q8"),
            ("serve_plain", None, 72, 8, "decode_attention")):
        with tempfile.TemporaryDirectory() as tmp:
            d = Path(tmp)
            production_config_dir(d, **({"block_size": block} if block else {}))
            data_s = entry.load_config_and_data(str(d))
            cfg_s = data_s["cfg"]
            save_checkpoint(str(d / data_s["sc"]["model_file_name"]),
                            init_params(cfg_s, torch.Generator().manual_seed(1234), dev))
            tokens_s = cfg_s.block_size
            K.reset_launch_counts()
            t0 = time.perf_counter()
            res_s = entry.run(str(d), tokens=tokens_s, modality=0, seed=0, serve=True,
                              refresh=refresh, kv_dtype=kv)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            serve_counts[label] = K.launch_counts()
        S_s = cfg_s.block_size
        want = serve_launches(K, cfg_s, S_s, tokens_s, refresh or S_s // 8, decode)
        new_s = res_s["new"]
        ok = (str(res_s["device"]) == "cuda" and res_s["model"].startswith("checkpoint")
              and new_s.shape == (cfg_s.num_modalities, tokens_s)
              and 0 <= new_s[0].min() and new_s[0].max() < len(res_s["vocabs"][0])
              and all((new_s[m] == res_s["last_prompt_tokens"][m]).all()
                      for m in range(1, cfg_s.num_modalities))
              and serve_counts[label] == want)
        emit({"phase": "serve_entry", "run": label, "kv_dtype": kv, "block_size": S_s,
              "cache_pack": C.cache_pack(cfg_s.head_size, S_s), "refresh": refresh or S_s // 8,
              "tokens": tokens_s, "batch": 1, "seconds": sec, "launches": serve_counts[label],
              "expected_launches": want, "generated": new_s[0].tolist(), "ok": ok})
        if not ok:
            raise AssertionError(f"the --serve entry ({label}) failed its checks")

    # the card's cached logits against the card's full-window forward at the
    # same prefix and the CPU's cached f32 forward (dense cores): in the
    # growing phase (a prefill of 8 tokens, then positions 8..63) and in a
    # steady --serve chunk (a prefill over a window of S - S/8 = 56, then
    # positions 56..63). f32 is held against both at 1e-4 max-abs; bf16 at
    # 2e-2 max-abs, and each K3f, K2f and K8p call of its run against the
    # kernel's plain version on the same inputs (SERVE_BF16_IN_PATH). Both
    # gates must reject K8p reading one column past pos.
    S, B_ref, L, n_cross = cfg.block_size, 2, cfg.n_layer, sum(cfg.cross_attention)
    ids_ref = torch.from_numpy(np.stack([rng.integers(0, v, (B_ref, S)) for v in cfg.vocab_sizes]))
    cases = {"growing": 8, "steady_chunk": S - S // 8}

    failed = serve_reference(K, C, forward, params, cpu_params, cfg, ids_ref, cases, {
        "short_causal_attention": ("short_causal_attention", K.short_causal_attention_plain, L),
        "short_cross_attention": ("short_cross_attention", K.short_cross_attention_plain,
                                  n_cross * L)})
    if failed:
        raise AssertionError(f"cached logits on the card disagree, or the gate passed the "
                             f"planted fault ({', '.join(failed)})")

    # --serve rates: 64 tokens from a full window (8 chunks of 8) at B = 1 and
    # B = 32, bf16 and int8 caches, beside generate_fast's of phase 5, in two
    # rounds one after the other (the spread of host time within one run);
    # then where a served token's time goes (one chunk profiled: a prefill
    # and 8 decode steps, bf16 and int8 caches), against the first round
    cached_s = {}
    for rnd in (0, 1):
        for kv in (None, "int8"):
            for batch in (1, 32):
                window = torch.from_numpy(
                    np.stack([rng.integers(0, v, (batch, S)) for v in cfg.vocab_sizes])).to(dev)
                g = torch.Generator(device=dev).manual_seed(0)
                C.generate_serve(params, cfg, window, g, 9, 0, kv_dtype=kv)  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = C.generate_serve(params, cfg, window, g, 64, 0, kv_dtype=kv)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                if out.shape != (cfg.num_modalities, batch, S + 64):
                    raise AssertionError(f"--serve output shape {tuple(out.shape)}")
                cached_s.setdefault((kv, batch), sec / 64)
                emit({"phase": "serving_cached", "card": card, "round": rnd, "batch": batch,
                      "kv_dtype": kv, "tokens": 64, "refresh": S // 8, "seconds": sec,
                      "ms_per_token": 1e3 * sec / 64, "tokens_per_s": batch * 64 / sec,
                      "generate_fast_ms_per_token": 1e3 * served[batch],
                      "generate_fast_tokens_per_s": batch / served[batch]})
    for kv in (None, "int8"):
        for batch in (1, 32):
            window = torch.from_numpy(
                np.stack([rng.integers(0, v, (batch, S)) for v in cfg.vocab_sizes])).to(dev)
            g = torch.Generator(device=dev).manual_seed(0)
            C.generate_serve(params, cfg, window, g, 9, 0, kv_dtype=kv)
            torch.cuda.synchronize()
            n_tok = S // 8
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                C.generate_serve(params, cfg, window, g, n_tok, 0, kv_dtype=kv)
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            dev_s = sum(e.self_device_time_total for e in kern) / 1e6 / n_tok
            top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
            emit({"phase": "profile", "path": "serve", "card": card, "batch": batch,
                  "kv_dtype": kv, "tokens": n_tok,
                  "step_ms_unprofiled": 1e3 * cached_s[kv, batch],
                  "device_ms_per_token": 1e3 * dev_s if kern else None,
                  "device_busy_share": dev_s / cached_s[kv, batch] if kern else None,
                  "kernels_per_token": sum(e.count for e in kern) / n_tok,
                  "top": [[e.key[:72], e.self_device_time_total / 1e3 / n_tok, e.count / n_tok]
                          for e in top]})

    # 8. one production-width training step on the card (kernels forward and
    # backward) against the CPU's dense step, same params and batch
    B_train = data["sc"]["batch_size"]
    ids = torch.from_numpy(np.stack(
        [rng.integers(0, v, (B_train, cfg.block_size + 1)) for v in cfg.vocab_sizes]))
    # every K1b and K2b call of the step is held in-path against its plain
    # version. Planted faults: K1b's db1 20% too large must fail the step
    # gate; K2b's dk 20% too large must fail the in-path gate. (At these
    # random weights dk moves the cross key/value leaf too little for the
    # step gate: it reaches the parameters only through that projection,
    # whose gradient it shares with dv; its step reading is printed.)
    want_step = dict.fromkeys(K.KERNELS, 0)
    want_step.update(fused_qkv_attention=cfg.n_layer, fused_qkv_attention_bwd=cfg.n_layer,
                     short_cross_attention=2 * cfg.n_layer,
                     short_cross_attention_bwd=2 * cfg.n_layer)
    train_reference(K, cfg, ids, {"K1b_db1_x1.2": (K.FusedQKVAttention, 2)},
                    ("K1b_db1_x1.2", "K2b_dk_x1.2"), want_step,
                    in_path=("fused_qkv_attention_bwd", "short_cross_attention_bwd"),
                    in_path_faults={"K2b_dk_x1.2": {"short_cross_attention_bwd": k2b_dk_x1_2}})

    # 9. the port's training entry on a copy of the production config: only
    # max_iters / eval_interval / eval_iters changed (a step-count cut); 10.
    # where a training step's time goes
    L, n_cross = cfg.n_layer, sum(cfg.cross_attention)
    per_step = dict(fused_qkv_attention=L, fused_qkv_attention_bwd=L,
                    short_cross_attention=n_cross * L, short_cross_attention_bwd=n_cross * L)
    per_eval = dict(fused_qkv_attention=L, short_cross_attention=n_cross * L)
    train_launches, _, train_evals = training_run(
        K, card, "training", per_step, per_eval, max_iters=30, eval_interval=10, eval_iters=4)

    # 10b. the flat-state AdamW (tpu_options.fused_update): the update alone
    # on one step's gradients against the per-leaf update, then the entry
    # against the per-leaf entry above (the same seed: the same batches and
    # salts; the bf16 token-table scatter-adds keep the runs from the same
    # bits, so the final eval losses are held within STEP_TOL)
    flat_update_check(K, card, cfg, ids)
    fused_launches, _, fused_evals = training_run(
        K, card, "training_fused", per_step, per_eval, tpu={"fused_update": "true"},
        max_iters=30, eval_interval=10, eval_iters=4)
    loss_errs = [abs(a - b) for a, b in zip(fused_evals[-1][1:], train_evals[-1][1:])]
    ok = fused_launches == train_launches and max(loss_errs) <= STEP_TOL["bfloat16"]["loss"]
    emit({"phase": "fused_update", "part": "entry", "card": card,
          "launches_equal_per_leaf": fused_launches == train_launches,
          "final_eval": {"per_leaf": train_evals[-1], "fused": fused_evals[-1]},
          "final_eval_abs_err": loss_errs, "tol": STEP_TOL["bfloat16"]["loss"], "ok": ok})
    if not ok:
        raise AssertionError("the fused_update entry's launches or losses differ from the "
                             "per-leaf entry's")

    # 10c. remat at T = 64 and 1024; 10d. the reference model's .pth
    # checkpoints in both entries
    remat_check(K, card, cfg)
    reference_checkpoint(K, card)

    # 10b. data parallelism on the one card: a step against the one-rank
    # step, and the training entry over two ranks; then FSDP over them, and
    # tensor parallelism (the one-rank entries of both rates held again)
    dp_runs = data_parallel(K, card, by_path)
    one_rank, fsdp_run = fsdp_phases(K, card, by_path, dp_runs)
    multihost_phase(card, fsdp_run)
    tp_phases(K, card, by_path, one_rank)
    pp_phases(K, card, by_path, one_rank,
              lambda calls, plan: mod_phases(K, card, by_path, one_rank, calls, plan))

    # 11. long context: the production config at block_size 1024
    by_path.update({"serving": launches, "training": train_launches,
                    "training_fused": fused_launches, **serve_counts})
    long_context(K, card, gen, timing, errs, by_path)

    # 12. context parallelism at block_size 1024; then the reference steps
    # over four ranks (the pipeline with a model or modality axis, modality
    # x sequence held against a ring step of 12) and over eight
    mod_seq_ref = context_parallel(K, card, gen, timing, errs, by_path)
    four_rank_references(K, card, mod_seq_ref)
    tp_split_seq_reference(K, card)

    # 13. the crossover tool (K3f + K3b against K5f + K5b and the dense core)
    crossover(K, card, by_path)

    emit(card)
    prod = {"fused_qkv_attention": ("fused_qkv_attention", prod_k1, "bfloat16"),
            "short_cross_attention": ("short_cross_attention", prod_k2, "bfloat16"),
            "fused_qkv_attention_bwd": ("fused_qkv_attention_bwd", prod_k1, "bfloat16", 0.2),
            "short_cross_attention_bwd": ("short_cross_attention_bwd", prod_k2, "bfloat16", 0.2),
            "short_causal_attention": ("short_causal_attention", (24 * 32, 56, 64), "bfloat16"),
            "short_causal_attention_bwd": ("short_causal_attention_bwd", K3B_PROD, "bfloat16", 0.2),
            "short_causal_attention_packed": ("short_causal_attention_packed", K4_PROD, "bfloat16"),
            "short_causal_attention_packed_bwd": ("short_causal_attention_packed_bwd", K4_PROD,
                                                  "bfloat16", 0.2),
            "decode_attention": ("decode_attention", (24 * 32, 72, 64, 1, 71), "bfloat16"),
            "decode_attention_t": ("decode_attention_t", (*K9_PROD, K9_PROD[2] - 1), "bfloat16"),
            "decode_attention_packed": ("decode_attention_packed", (24 * 32, 64, 64, 2, 63),
                                        "bfloat16"),
            "decode_attention_packed_q8": ("decode_attention_packed_q8", (24 * 32, 64, 64, 2, 63),
                                           "bfloat16"),
            "flash_attention": ("flash_attention", FLASH_PROD, "bfloat16"),
            "flash_attention_bwd": ("flash_attention_bwd", FLASH_PROD, "bfloat16", 0.2),
            "flash_cross_attention": ("flash_cross_attention", FLASH_CROSS_PROD, "bfloat16"),
            "flash_cross_attention_res": ("flash_cross_attention_res", FLASH_CROSS_PROD,
                                          "bfloat16"),
            **{f"flash_chunk_{d}_{m}": (f"flash_chunk_{d}_{m}", CP_SELF, "bfloat16",
                                        *((0.2,) if d == "bwd" else ()))
               for d in ("fwd", "bwd") for m in ("causal", "full")}}
    unlaunched = [name for name in K.KERNELS if not by_path[MAIN_PATH[name]][name]]
    if unlaunched:
        raise AssertionError(f"kernels never launched on their main path: {unlaunched}")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": by_path[MAIN_PATH[name]][name], "main_path": MAIN_PATH[name],
         "max_abs_err": errs[prod[name]],
         "ms": timing[name]["ms"],
         "ms_dropout": timing[name]["ms_dropout"],
         "ms_b1": timing[name]["ms_b1"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound"][0], "bound_by": timing[name]["bound"][1],
         "library_ms": timing[name]["library_ms"],
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()}}
        for name in K.KERNELS
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
