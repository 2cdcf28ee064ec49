#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, drives the port's
generation entry point at the production configuration's full width
(examples/production_config.yaml: 4 modalities, n_embd 384, 6 heads, 6
layers, block_size 64, bf16) with seeded random weights on seeded synthetic
CSVs, checks that the path went through both kernels and that what comes out
is right, and times batched serving. Each phase prints one line; any failed
check raises and the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``.

Needs a CUDA device and the port package beside this file; without either it
exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
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
SOURCES = {
    "fused_qkv_attention": (
        f"{PKG}/ops/csrc/fused_qkv_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:1959",
    ),
    "short_cross_attention": (
        f"{PKG}/ops/csrc/short_cross_attention.cu",
        "trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py:1643",
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
    for name in K.KERNELS:
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
    # tile, hs 96 / 128 / 256 (smaller tiles), C not a multiple of 8; K2f at
    # hs 24 (not a multiple of 16: its bf16 FMA body)
    k1_shapes = [prod_k1, b1_k1, (2, 3, 8, 32, 2, 16), (1, 2, 512, 384, 6, 64),
                 (2, 5, 64, 96, 3, 32), (4, 7, 64, 384, 6, 64), (1, 5, 72, 96, 3, 32),
                 (1, 2, 136, 64, 2, 128), (1, 2, 40, 64, 1, 256), (1, 3, 200, 100, 2, 96)]
    k2_shapes = [prod_k2, b1_k2, (3, 6, 8, 64), (3, 12, 512, 64), (3, 15, 64, 32),
                 (3, 6 * 7, 64, 64), (3, 5, 72, 32), (2, 3, 200, 128), (2, 2, 64, 256),
                 (2, 3, 64, 24)]
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
        ms_b1=cuda_ms(lambda: K.short_cross_attention(q_b1, k_b1, v_b1)),
        plain_ms=cuda_ms(lambda: K.short_cross_attention_plain(q, k, v)),
        library_ms=cuda_ms(k2_library),
        bound=bound_ms(k2_flops, k2_bytes, "bfloat16"),
    )
    for name, t in timing.items():
        emit({"phase": "kernel_time", "kernel": name, "card": card, "kernel_ms": t["ms"],
              "kernel_ms_b1": t["ms_b1"], "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
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
    want = {"fused_qkv_attention": cfg.n_layer * tokens,
            "short_cross_attention": 2 * cfg.n_layer * tokens}
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

    emit(card)
    prod = {"fused_qkv_attention": ("fused_qkv_attention", prod_k1, "bfloat16"),
            "short_cross_attention": ("short_cross_attention", prod_k2, "bfloat16")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": launches[name], "max_abs_err": errs[prod[name]],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound"][0], "bound_by": timing[name]["bound"][1],
         "library_ms": timing[name]["library_ms"]}
        for name in K.KERNELS
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
