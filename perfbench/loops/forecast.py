"""The forecast loop: next-bar forecasts of a universe of instruments
through the program's ``generate_fast``, open loop at the mix's fixed
``rate_per_s``.

A request is the newest window of ``block_size`` bars of every instrument
(M modalities, B instruments); it asks for one new token of the forecast
modality and ends when that column is back on the host. The next request's
windows have advanced by one observed bar. Requests fall due on a fixed
schedule (a bar closing); one runs at a time, and a request's latency
counts from when it fell due. Every request's sampling generator is
seeded from the run's seed and the request's index, so the reference can
draw the same noise.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Any, Dict, List

import torch

from .. import harness, inputs
from ..reference import model as ref_model
from ..reference import params as ref_params
from ..yardstick import compare, trace

WARMUP = 2
TRACED_REQUESTS = 16
SAMPLED = 8
FAULTS = ("token", "stale")


def request_seed(seed: int, r: int) -> int:
    return inputs.sub_seed(inputs.sub_seed(seed, inputs.REQUESTS), r)


@contextlib.contextmanager
def planted(fault: str):
    """The program with one of ``FAULTS`` planted in it, while open: one
    served token of every request altered where it is produced, or every
    served token the last observed one (the request's state returned
    unchanged)."""
    from trade_aid_multimodal_transformer_tpu_torch.models import sampler

    right = sampler.generate_fast

    def broken(params, cfg, idx, generator, max_new_tokens=1, modality_to_generate=0):
        out = right(params, cfg, idx, generator, max_new_tokens, modality_to_generate).clone()
        m = modality_to_generate
        if fault == "token":
            out[m, 0, -1] = (out[m, 0, -1] + 1) % cfg.vocab_sizes[m]
        else:
            out[m, :, -1] = out[m, :, -2]
        return out

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    sampler.generate_fast = broken
    try:
        yield
    finally:
        sampler.generate_fast = right


class Program:
    """The program serving forecasts for one seed."""

    def __init__(self, cell, seed: int, device):
        from trade_aid_multimodal_transformer_tpu_torch.models import sampler

        self.cell, self.seed = cell, seed
        self.spec = ref_model.ModelSpec.from_config(cell.conf)
        self.cfg = harness.model_config(cell.conf)
        self.B = int(cell.traffic["instruments"])
        self.T = self.cfg.block_size
        self.modality = int(cell.traffic["modality"])
        self.horizon = int(cell.traffic["horizon_bars"])
        self.bars = inputs.token_series(self.spec, self.T + self.horizon, seed, device,
                                        rows=self.B)
        self.params = ref_params.make_weights(self.spec, inputs.sub_seed(seed, inputs.WEIGHTS),
                                              device)
        self.gen = torch.Generator(device=device)
        self.sampler = sampler

    def window(self, r: int) -> torch.Tensor:
        s = r % self.horizon
        return self.bars[:, :, s:s + self.T]

    def request(self, r: int) -> torch.Tensor:
        """Request r: the forecast column, on the host."""
        self.gen.manual_seed(request_seed(self.seed, r))
        out = self.sampler.generate_fast(self.params, self.cfg, self.window(r), self.gen, 1,
                                         self.modality)
        return out[self.modality, :, -1].cpu()

    def free(self) -> None:
        self.params = self.bars = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def noise(seed: int, r: int, B: int, V: int, device) -> torch.Tensor:
    """The Exp(1) draws of request r's one-sample ``torch.multinomial``."""
    gen = torch.Generator(device=device).manual_seed(request_seed(seed, r))
    return torch.empty((B, V), device=device).exponential_(generator=gen)


def check_draw(seed: int, device) -> None:
    """That a one-sample ``torch.multinomial`` is argmax(p / q) with q the
    generator's Exp(1) draws, as the comparison assumes."""
    gen = torch.Generator(device=device).manual_seed(request_seed(seed, -1))
    p = torch.softmax(torch.randn(64, 500, device=device, generator=gen), dim=-1)
    gen.manual_seed(request_seed(seed, -2))
    drawn = torch.multinomial(p, 1, generator=gen)[:, 0]
    want = (p / noise(seed, -2, 64, 500, device)).argmax(dim=-1)
    if not torch.equal(drawn, want):
        raise RuntimeError("torch.multinomial no longer draws argmax(p / q), q ~ Exp(1): "
                           "the forecast comparison cannot reproduce its draws")


def gaps(cell, seed: int, served: Dict[int, torch.Tensor], device, fp8: bool = False
         ) -> float:
    """The widest token gap over the served requests ``served`` (index ->
    forecast column); with ``fp8`` the gap of the control's own tokens."""
    spec = ref_model.ModelSpec.from_config(cell.conf)
    B, T = int(cell.traffic["instruments"]), spec.block_size
    modality, horizon = int(cell.traffic["modality"]), int(cell.traffic["horizon_bars"])
    bars = inputs.token_series(spec, T + horizon, seed, device, rows=B)
    params = ref_params.make_weights(spec, inputs.sub_seed(seed, inputs.WEIGHTS), device)
    V = spec.vocab_sizes[modality]
    widest = 0.0
    for r, col in served.items():
        s = r % horizon
        prompt = bars[:, :, s:s + T]
        q = noise(seed, r, B, V, device)
        ref = ref_model.last_logits(spec, ref_model.Matmul(), params, prompt, modality)
        tokens = col.to(device)
        if fp8:
            ctrl = ref_model.last_logits(spec, ref_model.Matmul(True), params, prompt, modality)
            tokens = (ctrl - torch.log(q)).argmax(dim=-1)
        widest = max(widest, float(compare.token_gaps(ref, q, tokens).max()))
    return widest


def p95(xs: List[float]) -> float:
    """The 95th percentile of every request's latency."""
    return statistics.quantiles(xs, n=100)[94] if len(xs) > 1 else xs[0]


def sample(seed: int, done: int) -> List[int]:
    """The requests compared: the last one and others drawn from the seed."""
    gen = torch.Generator().manual_seed(inputs.sub_seed(seed, inputs.SAMPLE))
    pick = torch.randperm(done, generator=gen)[:SAMPLED - 1].tolist()
    return sorted(set(pick) | {done - 1})


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Dict[str, Any]:
    harness.build_kernels(device)
    prog = Program(cell, seed, device)
    for r in range(WARMUP):
        prog.request(-1 - r)
    harness.sync(device)
    setup_s = time.perf_counter() - t_start

    # open loop: request r is due at t0 + r / rate; one request runs at a
    # time, so a request due while another runs waits, and its latency
    # counts from when it was due
    gap = 1.0 / float(cell.traffic["rate_per_s"])
    latencies: List[float] = []
    service: List[float] = []
    served: Dict[int, torch.Tensor] = {}
    t0 = time.perf_counter()
    r = 0
    while r * gap < seconds and time.perf_counter() - t0 < seconds:
        due = t0 + r * gap
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        a = time.perf_counter()
        served[r] = prog.request(r)
        done = time.perf_counter()
        latencies.append(done - due)
        service.append(done - a)
        r += 1
    window_s = time.perf_counter() - t0
    ctx: Dict[str, Any] = {"loop": "forecast", "spec": prog.spec, "batch": prog.B, "T": prog.T,
                           "chips": cell.chips,
                           "untraced": {"units": r, "seconds": window_s, "service": service}}
    if traced:
        start = r
        ctx["slice"] = {"units": TRACED_REQUESTS}
        ctx["trace"] = trace.traced(
            lambda: [prog.request(start + i) for i in range(TRACED_REQUESTS)], device)
    peak = harness.memory_peak(device)
    prog.free()

    check_draw(seed, device)
    picked = {i: served[i] for i in sample(seed, r)}
    checks = compare.held({"token_gap": gaps(cell, seed, picked, device)}, cell.limits)
    metrics = {"forecast_tokens_per_s": r * prog.B / window_s,
               "forecast_ms_p95": p95(latencies) * 1e3,
               "setup_s": setup_s}
    return {"ctx": ctx, "metrics": metrics, "checks": checks, "attempted": r, "failed": 0,
            "peak": peak}
