"""Reduction of a ``torch.profiler`` chrome trace to the numbers the
per-layer metrics read: kernel launches, device busy time (the union of
kernel, copy and memset intervals), idle gaps labelled by what the host
was doing, time by kernel, and the time of the program's own attention
kernels.

The program's attention kernels are matched by what built them: every
``__global__`` function defined in the program's CUDA sources
(``ops/csrc``), all of which compute attention (a projection fused with
it in the whole-row self-attention kernels). A kernel a later change adds
to those sources is matched without an edit here.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def source_kernel_names(csrc: Path) -> List[str]:
    """Names of the ``__global__`` functions defined in the sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        text = path.read_text()
        for m in re.finditer(r"__global__", text):
            for call in re.finditer(r"(\w+)\s*\(", text[m.end():m.end() + 400]):
                if call.group(1) != "__launch_bounds__":
                    names.add(call.group(1))
                    break
    return sorted(names)


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class HostOps:
    """The host's operations on the thread of the traced window, to name
    what the host was doing at a moment: the innermost operation open then."""

    def __init__(self, events: List[dict]):
        ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                     for e in events)
        self.starts = [o[0] for o in ops]
        self.ops = ops

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - 2000), -1):
            a, b, name = self.ops[j]
            if b >= t:
                return name
        return "host between operations"


def summarize(path: Path, window: str, attention_names: List[str]) -> Dict[str, object]:
    """The numbers of the traced window: the span named ``window`` that
    the benchmark recorded around its traced slice."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == window and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"the trace holds no span {window!r}")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    tid = spans[0].get("tid")
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) < w1]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    busy = _union((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev)
    busy_us = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = defaultdict(float)
    for e in kernels:
        by_name[e["name"][:160]] += float(e.get("dur", 0)) * 1e-6
    pattern = re.compile(r"\b(" + "|".join(map(re.escape, attention_names)) + r")\b") \
        if attention_names else None
    attention_s = sum(float(e.get("dur", 0)) for e in kernels
                      if pattern is not None and pattern.search(e["name"])) * 1e-6

    host = HostOps([e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")
                    and e.get("tid") == tid and w0 <= float(e["ts"]) <= w1])
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[host.at((a + b) / 2)] += (b - a) * 1e-6

    def top(d: Dict[str, float]) -> List[list]:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6, "launches": len(kernels),
            "attention_s": attention_s, "device_ops": top(by_name), "idle_gaps": top(gaps)}


def profile_to(path: Path):
    """A ``torch.profiler`` session of CPU and CUDA activity that writes
    its chrome trace to ``path`` when it ends."""
    from torch.profiler import ProfilerActivity, profile

    def done(prof):
        prof.export_chrome_trace(str(path))

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], on_trace_ready=done)


WINDOW = "perfbench.traced_window"


def traced(work, device) -> Dict[str, object]:
    """The summary of ``work`` (which leaves its kernels queued) run under
    the profiler, the device synchronised inside the traced window."""
    import tempfile

    from torch.profiler import record_function

    from .. import harness

    with tempfile.TemporaryDirectory(dir=harness.scratch_dir()) as d:
        path = Path(d) / "trace.json"
        # a first profiler session in a process can miss kernels: open and
        # drop one before the session that counts
        with profile_to(Path(d) / "first.json"):
            harness.sync(device)
        with profile_to(path):
            with record_function(WINDOW):
                work()
                harness.sync(device)
        names = source_kernel_names(harness.ROOT / harness.PROGRAM / "ops" / "csrc")
        return summarize(path, WINDOW, names)
