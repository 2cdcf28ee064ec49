"""What every cell shares: finding a cell's files by name, the program's
configuration, the card, the metric readers, the guard against JAX in the
process, and the result line.

A cell (``workloads`` in BENCHMARK.json) names a configuration
(``configs/<file>``), a traffic mix (``traffic/<mix>.json``, whose
``loop`` names the loop in ``loops/`` that drives it) and its
correctness limits (``limits/<cell>.json``). A per-layer metric is read
by ``metrics/<metric>.py``, whose ``read(ctx)`` returns a number or None.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "trade_aid_multimodal_transformer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "trade_aid_multimodal_transformer_tpu")


class Cell:
    def __init__(self, name: str, benchmark: Optional[Dict[str, Any]] = None):
        bench = benchmark or json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.conf = json.loads((ROOT / configs[self.workload["config"]]["file"]).read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{self.workload['traffic']}.json").read_text())
        limits = HERE / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text())["limits"] if limits.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]


def model_config(conf: Dict[str, Any]):
    """The program's ModelConfig of a configuration file."""
    from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig

    mods = conf["modalities"]
    return ModelConfig(
        vocab_sizes=tuple(m["vocab_size"] for m in mods),
        cross_attention=tuple(m["cross_attention"] for m in mods),
        n_embd=conf["n_embd"], n_head=conf["n_head"], n_layer=conf["n_layer"],
        block_size=conf["block_size"], dropout=conf["dropout"],
        attn_impl=conf["attn_impl"], compute_dtype=conf["compute_dtype"],
        remat=conf["remat"])


def require_cards(n: int):
    """The first card; exits without a result where fewer than ``n`` cards
    are visible (the benchmark measures the card and nothing else)."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: this cell needs {n} CUDA device(s), found {have}", file=sys.stderr)
        raise SystemExit(3)
    return torch.device("cuda", 0)


def fix_numerics() -> None:
    """Float32 products in float32 (TF32 off) for the reference."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metric(name: str, ctx: Dict[str, Any]) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def loop(name: str):
    return importlib.import_module(f"perfbench.loops.{name}")


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def build_kernels(device) -> None:
    """The program's kernels, built into its build directory inside the
    checkout unless a build of the same sources is there already."""
    if device.type == "cuda":
        from trade_aid_multimodal_transformer_tpu_torch.ops import kernels

        kernels.build_kernels()


def device_info(chips: int, peak: int) -> Dict[str, Any]:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def clean(x):
    """JSON-safe: a non-finite float becomes its name."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [clean(v) for v in x]
    return x


def report(checks: Dict[str, Dict[str, float]]) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)


def scratch_dir() -> Path:
    """Where a run writes its trace before reading it: the run's TMPDIR,
    else a directory inside the checkout."""
    d = Path(os.environ["TMPDIR"]) if os.environ.get("TMPDIR") else ROOT / ".perfbench_tmp"
    d.mkdir(parents=True, exist_ok=True)
    return d
