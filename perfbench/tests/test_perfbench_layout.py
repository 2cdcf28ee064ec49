"""BENCHMARK.json against its format and its files: every cell resolves
by name to its configuration, traffic, limits and metric readers; names,
units and keys are within the characters and sizes the format allows."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert 1 <= len(BENCH["paths"]) <= 16 and BENCH["paths"] == ["perfbench"]
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == CONFIG_KEYS
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == CELL_KEYS and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    from perfbench import harness

    c = harness.Cell(cell, BENCH)
    assert (HERE / "loops" / f"{c.traffic['loop']}.py").is_file()
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e  # a cell that reports a metric reports what it moves


def test_every_config_is_used_and_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(files) == len(set(files))
    assert all(f.startswith("perfbench/") and (ROOT / f).is_file() for f in files)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_within_the_share():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)
