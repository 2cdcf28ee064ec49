"""What the benchmark's sources import and compute: no JAX and no JAX
package anywhere under perfbench/ (top-level module names compared
whole: the port's name begins with the JAX package's), nothing of the
program in the reference, the frozen FLOP arithmetic, the reference's
parameter tree equal to the program's, and no run without a card."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
PORT = "trade_aid_multimodal_transformer_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "trade_aid_multimodal_transformer_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax_imports(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "math", "dataclasses", "typing", "torch"}


def _spec(name):
    from perfbench.reference.model import ModelSpec

    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return ModelSpec.from_config(conf)


def test_training_flops():
    from perfbench.yardstick import flops

    assert round(flops.training_flops_per_step(_spec("production"), 512) / 1e12, 2) == 10.90
    assert round(flops.training_flops_per_step(_spec("long1024"), 32) / 1e12, 2) == 19.59


@pytest.mark.parametrize("name,batch", [("production", 512), ("long1024", 32)])
def test_flops_copy_equals_the_program(name, batch):
    from trade_aid_multimodal_transformer_tpu_torch.models.param_count import (
        training_flops_per_step)

    from perfbench import harness
    from perfbench.yardstick import flops

    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    assert flops.training_flops_per_step(_spec(name), batch) == training_flops_per_step(
        harness.model_config(conf), batch)


@pytest.mark.parametrize("name", ["production", "long1024"])
def test_parameter_tree_equals_the_program(name):
    from trade_aid_multimodal_transformer_tpu_torch.models.init import param_shapes

    from perfbench import harness
    from perfbench.reference import params

    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    assert params.param_shapes(_spec(name)) == param_shapes(harness.model_config(conf))


def test_attention_least_time_is_positive_for_every_kind():
    from perfbench.yardstick import flops

    for name, b, t in (("production", 512, 64), ("long1024", 32, 1024)):
        least = flops.attention_least_seconds(_spec(name), b, t, True)
        assert set(least) == {"self_fwd", "self_bwd", "cross_fwd", "cross_bwd"}
        assert all(v > 0 for v in least.values())


def test_kernel_names_found_in_the_program_sources():
    from perfbench.yardstick import trace

    names = trace.source_kernel_names(ROOT / PORT / "ops" / "csrc")
    assert {"fqkv_fwd_mma_kernel", "flash_fwd_mma_kernel", "attn_bwd_row_kernel"} <= set(names)


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "production.train",
                        "--seed", "1", "--seconds", "1"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "correct" not in p.stdout


PER_LAYER = sorted({m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]})


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_raises_on_a_context_it_cannot_read(name):
    """A loop whose arithmetic no reader knows, and no trace: every reader
    raises rather than returning nothing."""
    from perfbench import harness

    ctx = {"loop": "serve", "spec": _spec("production"), "batch": 1, "T": 64, "chips": 1,
           "untraced": {"units": 1, "seconds": 1.0}}
    with pytest.raises((KeyError, ValueError)):
        harness.read_metric(name, ctx)
