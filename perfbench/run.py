"""Run one benchmark cell once on the card and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels' build where this checkout has none, the inputs and
weights made from the seed, the program's first steps or requests) counts
as ``setup_s``; then the cell's loop runs for ``--seconds``. ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
from a traced slice after the window. Every run ends with the comparison
against the plain reference that decides ``correct``; its numbers and
limits are the last lines on stderr and the last key of the result. A
``--trace 1`` run in which a per-layer metric that BENCHMARK.json lists
for the cell reads nothing exits with code 5 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402
from perfbench.yardstick import compare  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.Cell(args.workload)
    device = harness.require_cards(cell.chips)
    harness.fix_numerics()
    out = harness.loop(cell.traffic["loop"]).run(cell, args.seed, args.seconds,
                                                 bool(args.trace), device, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4

    if args.trace:
        metrics = {m["name"]: {"value": harness.read_metric(m["name"], out["ctx"]),
                               "unit": m["unit"]} for m in cell.per_layer}
        silent = [k for k, v in metrics.items() if v["value"] is None]
        if silent:
            print(f"perfbench: {', '.join(silent)} read nothing in this run, though "
                  f"BENCHMARK.json lists them for {cell.name}", file=sys.stderr)
            return 5
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out["metrics"].items()
                   if k in units}
    device_info = harness.device_info(cell.chips, out["peak"])
    result = {"correct": compare.passed(out["checks"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device_info}
    if args.trace:
        tr = out["ctx"]["trace"]
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = out["checks"]
    harness.report(out["checks"])
    print(json.dumps(harness.clean(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
