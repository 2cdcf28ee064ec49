"""The per-layer metrics' arithmetic, one function a quantity; each file
in ``metrics/`` binds one of these as its ``read``, so that a quantity
read in training and in forecasting (``mfu.train``, ``mfu.forecast``)
has one reader.

A reader is given the run's context (the loop's ``ctx``): ``loop``
(``train`` or ``forecast``), ``spec``, ``batch``, ``T``, ``chips``,
``untraced`` (``units``, the steps or requests of the window, and its
``seconds``; the forecast loop adds ``service``, each request's seconds
once started) and, in a ``--trace 1`` run, ``slice`` (``units`` traced)
and ``trace`` (``yardstick/trace.py``'s summary). It raises where the
context lacks what it reads (a loop it does not know, a run without a
trace), and returns None only where the trace holds nothing of what it
measures; the harness then refuses the run of a cell that lists it.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, Optional

from . import flops

Ctx = Dict[str, Any]


def _training(ctx: Ctx) -> bool:
    if ctx["loop"] not in ("train", "forecast"):
        raise ValueError(f"no reader for the loop {ctx['loop']!r}")
    return ctx["loop"] == "train"


def _model_flops(ctx: Ctx) -> float:
    """Model FLOPs of one step or request of the cell."""
    if _training(ctx):
        return flops.training_flops_per_step(ctx["spec"], ctx["batch"])
    return flops.forecast_flops(ctx["spec"], ctx["batch"], ctx["T"])


def mfu(ctx: Ctx) -> float:
    """Model FLOPs of the window's steps or requests over its seconds, the
    chips and the bf16 peak, in %, over the untraced window (the
    profiler's overhead does not lower it)."""
    u = ctx["untraced"]
    return 100.0 * _model_flops(ctx) * u["units"] / (
        u["seconds"] * ctx["chips"] * flops.PEAK_FLOPS_BF16)


def attention_roofline(ctx: Ctx) -> Optional[float]:
    """The least time of the traced slice's attention work over the device
    time of the program's attention kernels in it, in %; None where the
    trace holds none of those kernels."""
    t = ctx["trace"]
    least = sum(flops.attention_least_seconds(ctx["spec"], ctx["batch"], ctx["T"],
                                              _training(ctx)).values())
    if not t["attention_s"]:
        return None
    return 100.0 * least * ctx["slice"]["units"] / t["attention_s"]


def launches(ctx: Ctx) -> float:
    """CUDA kernel launches a step or request in the traced slice."""
    return ctx["trace"]["launches"] / ctx["slice"]["units"]


def device_idle(ctx: Ctx) -> float:
    """1 - the union of kernel, copy and memset intervals over the traced
    slice's length, in %."""
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def device_ms(ctx: Ctx) -> float:
    """The union of device intervals in the traced slice a step or
    request, in ms."""
    return ctx["trace"]["busy_s"] * 1e3 / ctx["slice"]["units"]


def service_ms_median(ctx: Ctx) -> float:
    """The median seconds a request takes once started (host clock, the
    untraced window; a training loop has none), in ms."""
    return statistics.median(ctx["untraced"]["service"]) * 1e3
