"""The measurements behind the benchmark's choices, run on the card; the
benchmark's own runs do not run them.

    python3 perfbench/calibrate.py readings --workload <cell> --seeds 1,2,... \
        [--control 1,2,3] [--faults 1,2,3] [--out FILE]

prints, for each seed, the numbers the comparison reads for the program
(its first steps, or forecasts), for the control (the plain reference in
float8 in the program's place) and for each planted fault, one JSON line
each: the readings that the limits in ``limits/`` were set from.

    python3 perfbench/calibrate.py sweep --workload <cell> --batches 128,256,...

times the cell's loop at other batch sizes: wall and device ms a step or
request, the device's idle share and the peak of allocated memory.

    python3 perfbench/calibrate.py limits --workload <cell> --out FILE READINGS...

sets the cell's limits from readings (no card needed): lower = the
largest reading of the program; upper = the least of the control's
readings (where 3x lower or more) and of the faults' (10x lower or more
in training, 3x in forecasts; a state left unchanged reads 1 on the
update gap); limit = lower^(1/3) upper^(2/3), cut to two digits.
"""

import argparse
import collections
import contextlib
import copy
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.loops import forecast, train  # noqa: E402
from perfbench.yardstick import compare, trace  # noqa: E402

FORECAST_REQUESTS = 40


def emit(obj, out) -> None:
    line = json.dumps(harness.clean(obj))
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def train_readings(cell, seed, device, fault=None):
    with train.planted(fault) if fault else contextlib.nullcontext():
        prog = train.Program(cell, seed, device)
        got = prog.first_steps()
    prog.free()
    return got


def forecast_served(cell, seed, device, fault=None):
    with forecast.planted(fault) if fault else contextlib.nullcontext():
        prog = forecast.Program(cell, seed, device)
        served = {r: prog.request(r) for r in range(FORECAST_REQUESTS)}
    prog.free()
    return {i: served[i] for i in forecast.sample(seed, FORECAST_REQUESTS)}


def readings(cell, args, device) -> None:
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control.split(",")} if args.control else set()
    faults = {int(s) for s in args.faults.split(",")} if args.faults else set()
    harness.build_kernels(device)
    is_train = cell.traffic["loop"] == "train"
    for seed in seeds:
        t = time.perf_counter()
        if is_train:
            ref = train.reference_readings(cell, seed, device)
            rows = [("program", train_readings(cell, seed, device))]
            if seed in control:
                rows.append(("control", train.reference_readings(cell, seed, device, fp8=True)))
            if seed in faults:
                rows += [(f, train_readings(cell, seed, device, f)) for f in train.FAULTS
                         if f != "unchanged"]
            for kind, got in rows:
                emit({"cell": cell.name, "seed": seed, "kind": kind,
                      "numbers": compare.training_numbers(got, ref),
                      "losses": got["losses"], "ref_losses": ref["losses"]}, args.out)
        else:
            forecast.check_draw(seed, device)
            served = forecast_served(cell, seed, device)
            rows = [("program", forecast.gaps(cell, seed, served, device))]
            if seed in control:
                rows.append(("control", forecast.gaps(cell, seed, served, device, fp8=True)))
            if seed in faults:
                rows += [(f, forecast.gaps(cell, seed, forecast_served(cell, seed, device, f),
                                           device)) for f in forecast.FAULTS]
            for kind, gap in rows:
                emit({"cell": cell.name, "seed": seed, "kind": kind,
                      "numbers": {"token_gap": gap}}, args.out)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)


def sweep(cell, args, device) -> None:
    harness.build_kernels(device)
    for b in [int(x) for x in args.batches.split(",")]:
        try:
            sweep_one(cell, b, device, args.out)
        except torch.cuda.OutOfMemoryError as e:
            emit({"cell": cell.name, "batch": b, "error": str(e).splitlines()[0]}, args.out)
        torch.cuda.empty_cache()


def sweep_one(cell, b, device, out) -> None:
    c = copy.copy(cell)
    torch.cuda.reset_peak_memory_stats()
    if cell.traffic["loop"] == "train":
        c.traffic = dict(cell.traffic, tokens_per_step=b * int(cell.conf["block_size"])
                         * len(cell.conf["modalities"]))
        prog = train.Program(c, 1, device)
        prog.steps(3)
        unit = "step"

        def work(n):
            for _ in range(n):
                prog.steps(1)
    else:
        c.traffic = dict(cell.traffic, instruments=b)
        prog = forecast.Program(c, 1, device)
        prog.request(0)
        unit = "request"

        def work(n):
            for r in range(n):
                prog.request(r)
    harness.sync(device)
    n = 5
    t = time.perf_counter()
    work(n)
    harness.sync(device)
    wall = (time.perf_counter() - t) / n
    tr = trace.traced(lambda: work(2), device)
    emit({"cell": cell.name, "batch": b, f"wall_ms_per_{unit}": wall * 1e3,
          f"device_ms_per_{unit}": tr["busy_s"] / 2 * 1e3,
          "idle_pct": 100 * (1 - tr["busy_s"] / tr["window_s"]),
          "launches": tr["launches"] / 2, "memory_peak_bytes": torch.cuda.max_memory_allocated(),
          "device_ops": tr["device_ops"][:5]}, out)
    prog.free()


def limits(cell_name: str, out: str, files) -> dict:
    rows = [json.loads(line) for f in files for line in open(f) if line.startswith("{")]
    by = collections.defaultdict(lambda: collections.defaultdict(list))
    for r in rows:
        if r["cell"] == cell_name:
            for k, v in r["numbers"].items():
                by[k][r["kind"]].append(v)
    training = "loss_gap" in by
    result = {"limits": {}, "readings": {}}
    for k, kinds in by.items():
        lower = max(kinds["program"])
        uppers = {}
        for kind, vals in kinds.items():
            least = min(vals)
            if kind == "control" and least >= 3 * lower:
                uppers[kind] = least
            elif kind not in ("program", "control") and least >= (10 if training else 3) * lower:
                uppers[kind] = least
        if k == "update_norm_gap":
            uppers["unchanged"] = 1.0
        upper = min(uppers.values())
        limit = math.exp((math.log(lower) + 2 * math.log(upper)) / 3)
        step = 10 ** (math.floor(math.log10(limit)) - 1)
        result["limits"][k] = float(f"{math.floor(limit / step) * step:.2g}")
        result["readings"][k] = {"lower": lower, "seeds": len(kinds["program"]), "upper": upper,
                                 "upper_from": min(uppers, key=uppers.get),
                                 "least": {kind: min(v) for kind, v in kinds.items()
                                           if kind != "program"}}
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("readings", "sweep", "limits"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--batches", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("files", nargs="*", help="readings files (limits)")
    args = ap.parse_args()
    if args.what == "limits":
        print(limits(args.workload, args.out, args.files)["limits"])
        return 0
    cell = harness.Cell(args.workload)
    device = harness.require_cards(cell.chips)
    harness.fix_numerics()
    (readings if args.what == "readings" else sweep)(cell, args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
