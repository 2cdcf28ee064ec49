"""Measure where the flash and whole-row kernels beat the dense core on the
card (port of the JAX package's ``tools/flash_crossover.py``).

The attention dispatch (ops/attention.py) sends self-attention to the
whole-row kernels (K3f forward, K3b backward) for 8 <= T <= 512, to the flash
kernels (K5f, K5b) for T >= 256 with T % 128 == 0, and to the dense core
elsewhere, in the JAX package's order: whole-row first where both are
eligible. That order was chosen on a TPU. This sweeps forward + backward
time for the three cores across sequence lengths at the production head
shape and prints ms and the dense/kernel ratios per T: the data behind
FLASH_MIN_SEQ_LEN and the whole-row band on this card. Beside them it
times the forward alone (what the KV-cache prefill runs), each application
the core's output, normalised, as the next q.

Timing method, as the JAX tool's: each timed unit is ``reps`` forward +
backward applications of ``(core(q, k, v) ** 2).sum()`` chained through q
(the normalised dq is the next q, so no application can be hoisted or
overlapped), reps = max(2, min(32, 40960 // T)); one warm-up unit, then the
best of 3. The JAX tool runs a unit as one dispatch of a ``lax.scan`` because
per-call dispatch compressed every ratio toward 1; an eager chain would carry
the host's dispatch gaps in the same way. So on the card each application
waits in the queue behind a spin kernel (``torch.cuda._sleep``, twice its
host enqueue time at 2 GHz) between CUDA events: the window holds the
application's device work and no host gap, and a unit is the sum of its
windows. On the CPU (``--device cpu``) a unit is the host clock over the
chain.

    python -m trade_aid_multimodal_transformer_tpu_torch.flash_crossover \\
        [--dtype bfloat16] [--batch 4] [--heads 6] [--hs 64] [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict

import torch

from .ops import kernels
from .ops.attention import causal_attention_dense

T_LIST = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
# the kernels each core launches once per forward + backward application,
# and once per forward application
CORE_KERNELS = {"dense": (), "flash": ("flash_attention", "flash_attention_bwd"),
                "short": ("short_causal_attention", "short_causal_attention_bwd")}
CORE_FWD_KERNELS = {"dense": (), "flash": ("flash_attention",),
                    "short": ("short_causal_attention",)}


def reps_for(t: int) -> int:
    """Applications per timed unit: ~10 flash applications of work at
    T = 4096, at least 2 and at most 32."""
    return max(2, min(32, (4096 * 10) // t))


def cores(t: int, hs: int) -> Dict[str, Callable]:
    """The cores eligible at (T, hs): the dense core always, the flash
    kernels where ``flash_eligible``, the whole-row kernels where in the band."""
    out = {"dense": causal_attention_dense}
    if kernels.flash_eligible(t, hs):
        out["flash"] = kernels.flash_causal_attention
    if kernels.in_band(t, hs):
        out["short"] = kernels.short_causal_attention
    return out


def grads(core: Callable, q, k, v):
    """dq, dk, dv of (core(q, k, v) ** 2).sum() (one forward + backward)."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    with torch.enable_grad():
        loss = (core(q, k, v) ** 2).sum().float()
        return torch.autograd.grad(loss, (q, k, v))


def application(core: Callable, q, k, v):
    """One forward + backward application; returns the next q, the
    normalised dq."""
    dq = grads(core, q, k, v)[0]
    return dq * torch.rsqrt(dq.float().pow(2).mean() + 1e-6).to(dq.dtype)


def forward_application(core: Callable, q, k, v):
    """One forward application, without a graph; returns the next q, the
    normalised output."""
    with torch.no_grad():
        o = core(q, k, v)
    return o * torch.rsqrt(o.float().pow(2).mean() + 1e-6).to(o.dtype)


def time_core(core: Callable, q, k, v, reps: int, step: Callable = application):
    """Seconds per application (``step``: forward + backward, or the
    forward alone), the best of 3 units of ``reps`` chained applications
    after a warm-up unit (on the card each timed behind a spin kernel, see
    the module docstring), and the applications run in all."""
    if q.device.type != "cuda":
        for _ in range(reps):
            q = step(core, q, k, v)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                q = step(core, q, k, v)
            best = min(best, (time.perf_counter() - t0) / reps)
        return best, 4 * reps
    q = step(core, q, k, v)  # the first call builds and caches
    enqueue = 0.0  # the longest host enqueue of the rest of the warm-up unit
    for _ in range(reps - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = step(core, q, k, v)
        enqueue = max(enqueue, time.perf_counter() - t0)
    cycles = int(4e9 * enqueue) + 1_000_000
    best, runs = float("inf"), reps
    for _ in range(3):
        ms = 0.0
        for _ in range(reps):
            ms_app, q, tries = _window(core, q, k, v, cycles, step)
            ms, runs = ms + ms_app, runs + tries
        best = min(best, ms / 1e3 / reps)
    return best, runs


def _window(core: Callable, q, k, v, cycles: int, step: Callable = application):
    """Device ms of one application queued behind a spin of ``cycles``, the
    next q and the applications run. Where the spin ended before the host had
    queued the application (the window could hold a host gap), the same
    application again behind a spin twice as long."""
    for tries in range(1, 7):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        a.record()
        nxt = step(core, q, k, v)
        b.record()
        covered = not a.query()
        torch.cuda.synchronize()
        if covered:
            return a.elapsed_time(b), nxt, tries
        cycles *= 2
    raise RuntimeError("flash_crossover: the host could not queue an application within "
                       "its spin; the window would hold host gaps")


def inputs(t: int, batch: int, heads: int, hs: int, dtype: torch.dtype, device, seed: int = 0):
    """q, k, v (batch, heads, T, hs), standard normal from ``seed``."""
    g = torch.Generator().manual_seed(seed + t)
    return tuple(torch.randn((batch, heads, t, hs), generator=g).to(device=device, dtype=dtype)
                 for _ in range(3))


def crossover_row(t: int, batch: int = 4, heads: int = 6, hs: int = 64,
                  dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """One T of the sweep: ms per forward + backward application of each
    eligible core (None where a core is not eligible), the dense/flash and
    dense/short ratios, the applications each core ran (warm-up and timed;
    on the card one more for each window timed again) and the kernel
    launches each core made meanwhile; then the same for the forward alone
    (``*_fwd_ms``, ``fwd_applications``, ``fwd_launches``)."""
    reps = reps_for(t)
    q, k, v = inputs(t, batch, heads, hs, dtype, device)
    row = {"T": t}
    for tag, step in (("", application), ("fwd_", forward_application)):
        ms, runs, launches = {}, {}, {}
        for name, core in cores(t, hs).items():
            before = kernels.launch_counts()
            sec, runs[name] = time_core(core, q, k, v, reps, step)
            ms[name] = 1e3 * sec
            after = kernels.launch_counts()
            launches[name] = {kn: after[kn] - before[kn] for kn in after
                              if after[kn] != before[kn]}
        for name in CORE_KERNELS:
            row[f"{name}_{tag}ms"] = ms.get(name)
        for name in ("flash", "short"):
            row[f"{tag}dense/{name}"] = (
                ms["dense"] / ms[name] if name in ms else None)
        row[f"{tag}applications"] = runs
        row[f"{tag}launches"] = launches
    return row


def header(batch: int, heads: int, hs: int, dtype: str, device) -> str:
    return (f"device={device} shape=(B={batch},H={heads},T,hs={hs}) dtype={dtype} "
            f"(chained, device time per application, best of 3; forward + backward, "
            f"then the forward alone)\n"
            f"{'T':>6} {'dense ms':>10} {'flash ms':>10} {'short ms':>10} "
            f"{'dense/flash':>12} {'dense/short':>12} {'fwd dense':>10} {'fwd flash':>10} "
            f"{'fwd short':>10}")


def format_row(row: dict) -> str:
    def cell(v, width, fmt):
        return f"{v:>{width}{fmt}}" if v is not None else f"{'—':>{width}}"

    return (f"{row['T']:>6} {row['dense_ms']:>10.3f} {cell(row['flash_ms'], 10, '.3f')} "
            f"{cell(row['short_ms'], 10, '.3f')} {cell(row['dense/flash'], 12, '.2f')} "
            f"{cell(row['dense/short'], 12, '.2f')} {row['dense_fwd_ms']:>10.4f} "
            f"{cell(row['flash_fwd_ms'], 10, '.4f')} {cell(row['short_fwd_ms'], 10, '.4f')}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--hs", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("flash_crossover: no CUDA device; pass --device cpu to run on the CPU")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    print(header(args.batch, args.heads, args.hs, args.dtype, device), flush=True)
    for t in T_LIST:
        row = crossover_row(t, args.batch, args.heads, args.hs, getattr(torch, args.dtype), device)
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
