"""The comparison that decides ``correct``, driven through the cells' own
loops at a size a CPU test run holds: the harness's look for a card is
skipped, the kernels take their plain versions on the CPU with the card's
dispatch (so the dropout masks are the card's), and the cell's own limits
hold. A sound run comes out correct; the control (the reference in float8
in the program's place) and every planted fault come out not correct."""

import copy
import time

import pytest
import torch

from perfbench import harness
from perfbench.loops import forecast, train
from perfbench.yardstick import compare

SEED = 2**31 + 977
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def card_dispatch(monkeypatch):
    import trade_aid_multimodal_transformer_tpu_torch.ops.attention as attention

    monkeypatch.setattr(attention, "_kernel_device", lambda device, impl: impl != "jnp")


def small(name, T, B, C=64, H=2, L=2):
    """The cell at n_embd C (H heads), L layers, block T and B rows, with
    its own limits."""
    cell = copy.copy(harness.Cell(name))
    cell.conf = dict(cell.conf, n_embd=C, n_head=H, n_layer=L, block_size=T)
    if cell.traffic["loop"] == "train":
        cell.traffic = dict(cell.traffic, tokens_per_step=B * T * 4, files=8,
                            rows_per_file=4 * T, validation_files=1)
    else:
        cell.traffic = dict(cell.traffic, instruments=B, horizon_bars=32, rate_per_s=1000.0)
    return cell


TRAIN = [("production.train", 16, 16), ("long1024.train", 640, 1)]
# the forecast at its published width and heads, one layer: at n_embd 64
# the float8 control's logits stray too little for a widest gap to show
FORECAST = [("production.forecast", 64, 256)]
WIDE = dict(C=384, H=6, L=1)


def run(cell):
    out = harness.loop(cell.traffic["loop"]).run(cell, SEED, 0.2, False, CPU, time.perf_counter())
    return compare.passed(out["checks"]), out["checks"]


@pytest.mark.parametrize("name,T,B", TRAIN)
def test_sound_training_run_is_correct(name, T, B):
    ok, checks = run(small(name, T, B))
    assert ok, checks


@pytest.mark.parametrize("name,T,B", FORECAST)
def test_sound_forecast_run_is_correct(name, T, B):
    ok, checks = run(small(name, T, B, **WIDE))
    assert ok, checks


@pytest.mark.parametrize("name,T,B", TRAIN[:1])
@pytest.mark.parametrize("fault", train.FAULTS)
def test_training_fault_is_not_correct(name, T, B, fault):
    with train.planted(fault):
        ok, checks = run(small(name, T, B))
    assert not ok, checks


@pytest.mark.parametrize("name,T,B", FORECAST)
@pytest.mark.parametrize("fault", forecast.FAULTS)
def test_forecast_fault_is_not_correct(name, T, B, fault):
    with forecast.planted(fault):
        ok, checks = run(small(name, T, B, **WIDE))
    assert not ok, checks


@pytest.mark.parametrize("name,T,B", TRAIN[:1])
def test_training_control_is_not_correct(name, T, B):
    cell = small(name, T, B)
    ref = train.reference_readings(cell, SEED, CPU)
    ctrl = train.reference_readings(cell, SEED, CPU, fp8=True)
    checks = compare.held(compare.training_numbers(ctrl, ref), cell.limits)
    assert not compare.passed(checks), checks


@pytest.mark.parametrize("name,T,B", FORECAST)
def test_forecast_control_is_not_correct(name, T, B):
    cell = small(name, T, B, **WIDE)
    prog = forecast.Program(cell, SEED, CPU)
    served = {r: prog.request(r) for r in range(8)}
    checks = compare.held({"token_gap": forecast.gaps(cell, SEED, served, CPU, fp8=True)},
                          cell.limits)
    assert not compare.passed(checks), checks


# A --trace 1 run of each cell through run.py. The CPU has no device, so
# the profiler's trace of the traced slice gets device events added: one
# kernel of the program's attention kernels (by its name in ops/csrc),
# one other kernel and one copy, inside the traced window.

CELLS = [("production.train", 16, 16, {}), ("long1024.train", 640, 1, {}),
         ("production.forecast", 64, 256, WIDE), ("production.forecast_peak", 64, 256, WIDE)]


def with_device_events(attention: bool):
    from perfbench.yardstick import trace

    real = trace.summarize

    def summarize(path, window, names):
        import json
        from pathlib import Path

        doc = json.loads(Path(path).read_text())
        span = next(e for e in doc["traceEvents"]
                    if e.get("name") == window and e.get("cat") == "user_annotation")
        t0, dur = float(span["ts"]), float(span["dur"])
        kernels = [("kernel", "elementwise_kernel<int64>", 0.5, 0.1),
                   ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 0.7, 0.05)]
        if attention:
            kernels.append(("kernel", f"void {names[0]}<64>(float*, int)", 0.1, 0.2))
        doc["traceEvents"] += [{"ph": "X", "cat": cat, "name": name, "ts": t0 + a * dur,
                                "dur": d * dur, "pid": 0, "tid": 7} for cat, name, a, d in kernels]
        Path(path).write_text(json.dumps(doc))
        return real(path, window, names)

    return summarize


def traced_run(monkeypatch, capsys, name, T, B, wide, attention=True):
    import json

    from perfbench import run as run_py
    from perfbench.yardstick import trace

    cell = small(name, T, B, **wide)
    monkeypatch.setattr(harness, "Cell", lambda _name: cell)
    monkeypatch.setattr(harness, "require_cards", lambda n: CPU)
    monkeypatch.setattr(harness, "device_info", lambda chips, peak: {
        "platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak})
    monkeypatch.setattr(trace, "summarize", with_device_events(attention))
    rc = run_py.main(["--workload", name, "--seed", str(SEED), "--seconds", "0.2",
                      "--trace", "1"])
    out, err = capsys.readouterr()
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    return rc, lines, err, cell


@pytest.mark.parametrize("name,T,B,wide", CELLS)
def test_traced_run_reports_every_listed_metric(monkeypatch, capsys, name, T, B, wide):
    rc, lines, err, cell = traced_run(monkeypatch, capsys, name, T, B, wide)
    assert rc == 0, err
    result = lines[-1]
    assert result["correct"], result["checks"]
    listed = {m["name"]: m["unit"] for m in cell.per_layer}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == listed
    for k, v in result["metrics"].items():
        assert isinstance(v["value"], float) and v["value"] > 0, (k, v)
        if v["unit"] == "%":
            assert v["value"] <= 100, (k, v)
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"] and result["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("name,T,B,wide", CELLS[:1] + CELLS[3:])
def test_traced_run_without_attention_kernels_is_refused(monkeypatch, capsys, name, T, B, wide):
    rc, lines, err, _ = traced_run(monkeypatch, capsys, name, T, B, wide, attention=False)
    assert rc != 0 and not lines
    assert "attention_roofline" in err
