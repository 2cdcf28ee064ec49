#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card (forward and
backward, dropout off and on), drives the port's generation entry point and
its training entry point at the production configuration's full width
(examples/production_config.yaml: 4 modalities, n_embd 384, 6 heads, 6
layers, block_size 64, batch 32, dropout 0.2, bf16) with seeded random
weights on seeded synthetic CSVs, checks that each path went through its
kernels with the expected launch counts and that what comes out is right
(the card's training step against the CPU's dense step, the training loss
falling), and times the kernels, batched serving and training. Each phase
prints one line; any failed check raises and the script exits non-zero. The
last line is ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the port package beside this file; without either it
exits non-zero before printing any result.
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
}


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event samples of the mean time of ``inner``
    back-to-back calls, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


def production_config_dir(d: Path, **training) -> None:
    """examples/production_config.yaml (with the given training_parameters
    changed) + its schemas + the synthetic stock folder, in d."""
    text = (REPO / "examples" / "production_config.yaml").read_text()
    for key, value in training.items():
        text, n = re.subn(rf"(\n  {key}: )\S+", rf"\g<1>{value}", text)
        if n != 1:
            raise AssertionError(f"production config has no single {key}")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if not (REPO / PKG / "ops" / "kernels.py").is_file():
        print(f"chip_smoke: the {PKG} package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
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
    for name in K._SIGNATURES:
        for line in K.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                emit(f"  ptxas {name}: {line.strip()}")

    # 3. each kernel against its plain version
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def fqkv_inputs(M, B, T, C, H, hs):
        hs2 = hs // 2
        return (randn(M, B, T, C), randn(M, C, 3 * H * hs2, scale=0.05),
                randn(M, 3 * H * hs2, scale=0.05), randn(M, 3 * H, hs2, hs, scale=0.2))

    prod_k1 = (4, 32, 64, 384, 6, 64)
    prod_k2 = (3, 6 * 32, 64, 64)
    b1_k1, b1_k2 = (4, 1, 64, 384, 6, 64), (3, 6, 64, 64)  # what a B=1 step gives them
    # edge shapes: T=8 and T=512, hs 32, B=7; T not a multiple of the key
    # tile, hs 96 / 128 / 256 (smaller tiles), C not a multiple of 8; the
    # cross kernels at hs 24 (not a multiple of 16: the bf16 FMA body)
    k1_shapes = [prod_k1, b1_k1, (2, 3, 8, 32, 2, 16), (1, 2, 512, 384, 6, 64),
                 (2, 5, 64, 96, 3, 32), (4, 7, 64, 384, 6, 64), (1, 5, 72, 96, 3, 32),
                 (1, 2, 136, 64, 2, 128), (1, 2, 40, 64, 1, 256), (1, 3, 200, 100, 2, 96)]
    k2_shapes = [prod_k2, b1_k2, (3, 6, 8, 64), (3, 12, 512, 64), (3, 15, 64, 32),
                 (3, 6 * 7, 64, 64), (3, 5, 72, 32), (2, 3, 200, 128), (2, 2, 64, 256),
                 (2, 3, 64, 24), (2, 3, 64, 96)]
    errs = {}
    for shape in k1_shapes:
        x, w1, b1, w2 = fqkv_inputs(*shape)
        for dtype in ("float32", "bfloat16"):
            xx = x.to(getattr(torch, dtype))
            out = K.fused_qkv_attention(xx, w1, b1, w2, shape[4])
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
                grads = K.fused_qkv_attention_bwd(xx, w1, b1, w2, out, do_, H_, rate, salts)
                torch.cuda.synchronize()
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
                grads = K.short_cross_attention_bwd(qq, kk, vv, do_, rate, salts)
                torch.cuda.synchronize()
                if rate:
                    errs[("short_cross_attention", shape, dtype, rate)] = check_rel(
                        "short_cross_attention", out,
                        K.short_cross_attention_plain(qq, kk, vv, rate, salts), dtype, shape, rate)
                ref = K.short_cross_attention_bwd_plain(qq, kk, vv, do_, rate, salts)
                errs[("short_cross_attention_bwd", shape, dtype, rate)] = max(
                    check_rel(f"short_cross_attention_bwd.{g}", a, r, dtype, shape, rate)
                    for g, a, r in zip(("dq", "dk", "dv"), grads, ref))

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

    k1_flops = 2 * M * B * T * (C * 3 * D + 3 * H * hs2 * hs) + 2 * 2 * M * B * H * (T * (T + 1) // 2) * hs
    k1_bytes = 2 * M * B * T * C + 4 * (M * C * 3 * D + M * 3 * D + M * 3 * H * hs2 * hs) + 2 * M * H * B * T * hs
    x_b1 = x[:, :1].contiguous()  # the shape one B=1 generation step gives the kernel
    timing = {"fused_qkv_attention": dict(
        ms=cuda_ms(lambda: K.fused_qkv_attention(x, w1, b1, w2, H)),
        ms_dropout=cuda_ms(lambda: K.fused_qkv_attention(x, w1, b1, w2, H, 0.2, SALTS)),
        ms_b1=cuda_ms(lambda: K.fused_qkv_attention(x_b1, w1, b1, w2, H)),
        plain_ms=cuda_ms(lambda: K.fused_qkv_attention_plain(x, w1, b1, w2, H)),
        library_ms=cuda_ms(k1_library),
        bound=bound_ms(k1_flops, k1_bytes, "bfloat16"),
    )}
    J, n, T2, hs_ = prod_k2
    q, k, v = randn(n, T2, hs_).bfloat16(), randn(J, n, T2, hs_).bfloat16(), randn(J, n, T2, hs_).bfloat16()

    def k2_library():
        return sum(F.scaled_dot_product_attention(q[None], k[j, None], v[j, None], is_causal=True)
                   for j in range(J))

    k2_flops = J * 2 * 2 * n * (T2 * (T2 + 1) // 2) * hs_
    k2_bytes = 2 * n * T2 * hs_ * (1 + 2 * J + 1)
    q_b1, k_b1, v_b1 = q[:H].contiguous(), k[:, :H].contiguous(), v[:, :H].contiguous()
    timing["short_cross_attention"] = dict(
        ms=cuda_ms(lambda: K.short_cross_attention(q, k, v)),
        ms_dropout=cuda_ms(lambda: K.short_cross_attention(q, k, v, 0.2, SALTS)),
        ms_b1=cuda_ms(lambda: K.short_cross_attention(q_b1, k_b1, v_b1)),
        plain_ms=cuda_ms(lambda: K.short_cross_attention_plain(q, k, v)),
        library_ms=cuda_ms(k2_library),
        bound=bound_ms(k2_flops, k2_bytes, "bfloat16"),
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
    k1b_flops = (2 * M * B * T * (C * 3 * D + 3 * H * hs2 * hs)         # recompute the projection
                 + 5 * 2 * M * B * H * tri * hs                          # QK^T, dO.V^T, dV, dQ, dK
                 + 2 * 2 * M * B * T * 3 * H * hs2 * hs                  # dt3, dw2
                 + 2 * 2 * M * B * T * 3 * D * C)                        # dx, dw1
    k1b_bytes = (2 * M * B * T * C * 2 + 2 * M * H * B * T * hs * 2       # x, dx; o, do
                 + 4 * 2 * (M * C * 3 * D + M * 3 * D + M * 3 * H * hs2 * hs))  # weights, their grads
    o_b1, do_b1 = out0[:, :, :1].contiguous(), do1[:, :, :1].contiguous()
    timing["fused_qkv_attention_bwd"] = dict(
        ms=cuda_ms(lambda: K.fused_qkv_attention_bwd(x, w1, b1, w2, out0, do1, H)),
        ms_dropout=cuda_ms(lambda: K.fused_qkv_attention_bwd(x, w1, b1, w2, out1, do1, H, rate, SALTS)),
        ms_b1=cuda_ms(lambda: K.fused_qkv_attention_bwd(x_b1, w1, b1, w2, o_b1, do_b1, H)),
        plain_ms=cuda_ms(lambda: K.fused_qkv_attention_bwd_plain(x, w1, b1, w2, out0, do1, H)),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            lib1, (xg, w1g, b1g, w2g), do1.reshape(M, H, B, T, hs).reshape(M * H, B, T, hs),
            retain_graph=True)),
        bound=bound_ms(k1b_flops, k1b_bytes, "bfloat16"),
    )
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    do2 = randn(n, T2, hs_).bfloat16()
    with torch.enable_grad():
        lib2 = sum(F.scaled_dot_product_attention(qg[None], kg[j, None], vg[j, None], is_causal=True)
                   for j in range(J))[0]
    k2b_flops = J * 5 * 2 * n * (T2 * (T2 + 1) // 2) * hs_
    # read q, do and each stream's k_j, v_j (2 + 2J); write dq and each
    # dk_j, dv_j (1 + 2J)
    k2b_bytes = 2 * n * T2 * hs_ * (3 + 4 * J)
    do2_b1 = do2[:H].contiguous()
    timing["short_cross_attention_bwd"] = dict(
        ms=cuda_ms(lambda: K.short_cross_attention_bwd(q, k, v, do2)),
        ms_dropout=cuda_ms(lambda: K.short_cross_attention_bwd(q, k, v, do2, rate, SALTS)),
        ms_b1=cuda_ms(lambda: K.short_cross_attention_bwd(q_b1, k_b1, v_b1, do2_b1)),
        plain_ms=cuda_ms(lambda: K.short_cross_attention_bwd_plain(q, k, v, do2)),
        library_ms=cuda_ms(lambda: torch.autograd.grad(lib2, (qg, kg, vg), do2, retain_graph=True)),
        bound=bound_ms(k2b_flops, k2b_bytes, "bfloat16"),
    )
    # kernel_ms, kernel_ms_b1 and plain_ms without dropout (as serving runs
    # K1f/K2f); kernel_ms_dropout at 0.2, as the training path runs all four
    for name, t in timing.items():
        emit({"phase": "kernel_time", "kernel": name, "card": card, "kernel_ms": t["ms"],
              "kernel_ms_dropout": t["ms_dropout"], "kernel_ms_b1": t["ms_b1"],
              "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
              "bound_ms": t["bound"][0], "bound_by": t["bound"][1]})

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
    want = {"fused_qkv_attention": cfg.n_layer * tokens, "fused_qkv_attention_bwd": 0,
            "short_cross_attention": 2 * cfg.n_layer * tokens, "short_cross_attention_bwd": 0}
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

    # 7. one production-width training step on the card (kernels forward and
    # backward) against the CPU's dense step, same params and batch
    from trade_aid_multimodal_transformer_tpu_torch.config.compat import reset_compatibility_layer
    from trade_aid_multimodal_transformer_tpu_torch.models.init import (
        map_tree, tree_leaves, tree_paths)
    from trade_aid_multimodal_transformer_tpu_torch.models.transformer import total_loss
    from trade_aid_multimodal_transformer_tpu_torch.train import runner
    from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import (
        load_checkpoint, load_optimizer_state)
    from trade_aid_multimodal_transformer_tpu_torch.train.steps import StepRng

    B_train = data["sc"]["batch_size"]
    ids = torch.from_numpy(np.stack(
        [rng.integers(0, v, (B_train, cfg.block_size + 1)) for v in cfg.vocab_sizes]))
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

    # planted faults: K1b's db1 20% too large must fail the gate. K2b's dk
    # 20% too large is printed, not held: dk reaches the parameters only
    # through the cross key/value projection, whose gradient it shares with
    # dv, and at these random weights it moves that leaf too little for a
    # whole-step gate (the kernel_check phase holds dk itself).
    faults = {"K1b_db1_x1.2": (K.FusedQKVAttention, 2), "K2b_dk_x1.2": (K.ShortCrossAttention, 1)}
    must_fail = ("K1b_db1_x1.2",)
    want_step = {"fused_qkv_attention": cfg.n_layer, "fused_qkv_attention_bwd": cfg.n_layer,
                 "short_cross_attention": 2 * cfg.n_layer, "short_cross_attention_bwd": 2 * cfg.n_layer}
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
        loss_err = abs(loss.item() - loss_ref.item())
        errs_leaf = leaf_errs(g)
        grad_err = max(errs_leaf)
        worst = sorted(zip(errs_leaf, names), reverse=True)[:3]
        # the smallest error that any one leaf 20% too large reads (leaves
        # above the floor: below it no relative error is held)
        one_leaf = min((1.2 * a.float().cpu() - r).norm().item() / n
                       for a, r, n in zip(g, g_ref, ref_norms) if n >= floor)
        planted = {f: max(leaf_errs(step_grads(c, faults[f])[1])) for f in faults}
        tol = STEP_TOL[dtype]
        ok = (loss_err <= tol["loss"] and grad_err <= tol["grad_l2"] and counts == want_step
              and math.isfinite(loss.item()) and one_leaf > tol["grad_l2"]
              and all(planted[f] > tol["grad_l2"] for f in must_fail))
        emit({"phase": "train_reference", "what": "card training step vs CPU dense step, "
              "loss and every gradient leaf (dropout 0, TF32 off)", "dtype": dtype,
              "batch": B_train, "loss_card": loss.item(), "loss_cpu": loss_ref.item(),
              "loss_abs_err": loss_err, "grad_l2_rel_err_max": grad_err, "worst_leaves": worst,
              "leaves": len(g), "card_dense_grad_l2_rel_err_max": dense_err,
              "one_leaf_x1.2_min": one_leaf, "planted": planted, "planted_must_fail": must_fail,
              "tol": tol, "launches": counts, "ok": ok})
        if not ok:
            failed.append(dtype)
    if failed:
        raise AssertionError(f"training step on the card disagrees with the CPU, or the gate "
                             f"passed a planted fault ({', '.join(failed)})")
    del cpu_p, dev_p, g_ref, g

    # 8. the port's training entry on a copy of the production config: only
    # max_iters / eval_interval / eval_iters changed (a step-count cut)
    iters, interval, e_iters = 60, 20, 4
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        production_config_dir(d, max_iters=iters, eval_interval=interval, eval_iters=e_iters)
        cwd, buf = os.getcwd(), io.StringIO()
        os.chdir(d)  # config detection is CWD-relative
        try:
            reset_compatibility_layer()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = runner.run_training(caller_globals={}, seed=7)
            train_s = time.perf_counter() - t0
            train_launches = K.launch_counts()
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
    fwd_batches = iters + n_evals * 2 * e_iters
    want_train = {"fused_qkv_attention": cfg.n_layer * fwd_batches,
                  "fused_qkv_attention_bwd": cfg.n_layer * iters,
                  "short_cross_attention": 2 * cfg.n_layer * fwd_batches,
                  "short_cross_attention_bwd": 2 * cfg.n_layer * iters}
    timer = res["step_timer"]
    later = timer.chunks[1:]
    steps_per_s = sum(n for n, _ in later) / sum(t for _, t in later)
    finite = all(math.isfinite(v) for e in evals for v in e[1:])
    reloaded = (back_step == iters and opt_back is not None and opt_back["count"] == iters
                and all(torch.equal(a.detach().float(), b) for a, b in
                        zip(tree_leaves(res["params"]), tree_leaves(back))))
    ok = (train_launches == want_train and len(evals) == n_evals and finite
          and evals[-1][1] < evals[0][1] and reloaded and "TRAINING COMPLETED SUCCESSFULLY" in console)
    emit({"phase": "training", "config": "examples/production_config.yaml", "card": card,
          "max_iters": iters, "eval_interval": interval, "eval_iters": e_iters,
          "batch": B_train, "dropout": res["cfg"].dropout, "compute_dtype": res["cfg"].compute_dtype,
          "seconds": train_s, "evals": evals, "launches": train_launches,
          "expected_launches": want_train, "steps_per_s_after_first_chunk": steps_per_s,
          "chunks": timer.chunks, "checkpoint_reloaded": reloaded, "ok": ok})
    if not ok:
        raise AssertionError("the training run failed its checks")

    # 9. where a training step's time goes (torch.profiler, device events)
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
    emit({"phase": "profile", "path": "training", "card": card, "batch": B_train,
          "steps": n_prof, "step_ms_unprofiled": 1e3 / steps_per_s,
          "device_ms_per_step": 1e3 * dev_s if kern else None,
          "device_busy_share": dev_s * steps_per_s if kern else None,
          "kernels_per_step": sum(e.count for e in kern) / n_prof,
          "top": [[e.key[:72], e.self_device_time_total / 1e3 / n_prof, e.count / n_prof]
                  for e in top]})

    emit(card)
    prod = {"fused_qkv_attention": ("fused_qkv_attention", prod_k1, "bfloat16"),
            "short_cross_attention": ("short_cross_attention", prod_k2, "bfloat16"),
            "fused_qkv_attention_bwd": ("fused_qkv_attention_bwd", prod_k1, "bfloat16", 0.2),
            "short_cross_attention_bwd": ("short_cross_attention_bwd", prod_k2, "bfloat16", 0.2)}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": train_launches[name], "max_abs_err": errs[prod[name]],
         "ms": timing[name]["ms"], "ms_dropout": timing[name]["ms_dropout"],
         "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound"][0], "bound_by": timing[name]["bound"][1],
         "library_ms": timing[name]["library_ms"],
         "launches_by_path": {"serving": launches[name], "training": train_launches[name]}}
        for name in K.KERNELS
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
