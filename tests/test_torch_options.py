"""The port's training options held against the JAX package on the CPU: the
flat-state AdamW (``tpu_options.fused_update``), ``remat`` and the
``TAT_PROFILE_DIR`` trace.

Tolerances:
- the flat-state update against the JAX package's ``_train_chunk_fused``
  given the same gradients: exact (params, mu, nu, count). JAX's body runs
  op by op (``jax.disable_jit``: under ``jit`` XLA keeps bf16 intermediates
  in f32 and fuses the elementwise chain);
- the flat-state steps against the port's per-leaf steps, and ``remat``
  against none: bit for bit (the same operations on the same values; the
  backward of one split is one concatenation of the same leaf gradients);
- ``remat`` against JAX's ``remat=True`` gradients: ``_leaf_errs`` at
  tests/test_torch_train.py's limits (f32 1e-5, bf16 0.1), loss f32 1e-5,
  bf16 2e-2 relative to max(1, |loss|).
"""

import dataclasses
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trade_aid_multimodal_transformer_tpu.config import compat as jax_compat
from trade_aid_multimodal_transformer_tpu.config.accessors import reset_config_cache
from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.transformer import total_loss as jax_total_loss
from trade_aid_multimodal_transformer_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from trade_aid_multimodal_transformer_tpu.train.steps import Trainer as JaxTrainer
from trade_aid_multimodal_transformer_tpu.train.steps import make_optimizer as jax_make_optimizer
from trade_aid_multimodal_transformer_tpu_torch.config import compat as port_compat
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import init_params, map_tree, tree_leaves
from trade_aid_multimodal_transformer_tpu_torch.models.transformer import total_loss
from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
from trade_aid_multimodal_transformer_tpu_torch.parallel.mesh import RankMesh
from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import make_sharded_trainer
from trade_aid_multimodal_transformer_tpu_torch.train import runner
from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_optimizer_state,
    save_checkpoint,
)
from trade_aid_multimodal_transformer_tpu_torch.train.steps import Trainer, make_optimizer

from test_torch_train import GRAD_TOL, TOL, _leaf_errs  # noqa: E402  (tests/ is on the path)

REPO = Path(__file__).resolve().parent.parent
# one layer, two modalities, hs 16 (the JAX fused chunk, run op by op, takes
# one modality's tree)
SMALL = dict(vocab_sizes=(9, 7), cross_attention=(True, False), n_embd=32, n_head=2, n_layer=1,
             block_size=16)
COSINE = {"type": "cosine", "warmup_steps": 2, "decay_steps": 6, "min_lr_ratio": 0.1}
OPT = {
    "f32_f32": dict(),
    "bf16_f32": dict(moment_dtype="bfloat16"),
    "bf16_bf16": dict(moment_dtype="bfloat16", nu_dtype="bfloat16"),
    "cosine": dict(lr_schedule=COSINE),
}


def _setup(compute_dtype="float32", dropout=0.2, seed=0, **kw):
    """Both configs and the JAX package's tree of the port's seeded
    initial parameters (the same layout; no JAX draws to compile)."""
    cfg_kw = dict(SMALL, compute_dtype=compute_dtype, dropout=dropout, **kw)
    tcfg = ModelConfig(**cfg_kw)
    tree = map_tree(lambda t: t.numpy(), init_params(tcfg, torch.Generator().manual_seed(seed), "cpu"))
    return JaxConfig(**cfg_kw), tcfg, jax.tree.map(jnp.asarray, tree)


def _fresh(jparams):
    return map_tree(lambda t: t.requires_grad_(),
                    params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))


def _draws(cfg, n, accum=1, seed=10, B=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batches = []
        for _ in range(accum):
            ids = np.stack([rng.integers(0, v, (B, cfg.block_size + 1)) for v in cfg.vocab_sizes])
            batches.append((torch.from_numpy(ids[..., :-1].astype(np.int32)),
                            torch.from_numpy(ids[..., 1:].astype(np.int32))))
        salts = [(int(a), int(b)) for a, b in rng.integers(0, 2**32, (accum, 2), dtype=np.uint64)]
        out.append((batches, salts))
    return out


def _flat_views(tree) -> bool:
    """Whether every leaf of tree is a view into one flat buffer."""
    bases = {id(t._base) for t in tree_leaves(tree)}
    return len(bases) == 1 and tree_leaves(tree)[0]._base is not None


def _assert_trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype
        assert torch.equal(x.detach(), y.detach())


# ------------------------------------------------------------ flat-state AdamW


@pytest.mark.parametrize("case", sorted(OPT))
def test_flat_update_equals_jax_fused_chunk(case, monkeypatch):
    """Three fused steps of the port and of the JAX package's
    ``_train_chunk_fused`` (its ``_loss_and_grads`` patched on the instance
    to return the port's gradients of each step): params, mu, nu and the
    counts exact."""
    kw = OPT[case]
    jcfg, tcfg, jparams = _setup(vocab_sizes=(9,), cross_attention=(False,))
    opt = make_optimizer(1e-2, **kw)
    grads = []
    real = opt.update_flat_
    monkeypatch.setattr(opt, "update_flat_", lambda t, g, m, v, s: (
        grads.append(g.numpy().copy()), real(t, g, m, v, s)))
    params = _fresh(jparams)
    params, state, _ = Trainer(tcfg, None, opt, [], 1, fused_update=True).run_steps(
        params, opt.init(params), _draws(tcfg, 3))
    assert _flat_views(params) and len(grads) == 3

    jopt, spec = jax_make_optimizer(1e-2, with_spec=True, **kw)
    jtrainer = JaxTrainer(jcfg, None, jopt, [], 1, adamw_spec=spec)
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    offsets = np.cumsum([0] + [x.size for x in leaves])
    trees = iter([jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(g[o:e].reshape(x.shape)) for o, e, x in zip(offsets, offsets[1:], leaves)])
        for g in grads])
    jtrainer._loss_and_grads = lambda p, k: (jnp.asarray(0.0), next(trees))
    with jax.disable_jit():
        jp, js, _ = jtrainer._train_chunk_impl(jparams, jopt.init(jparams), jax.random.PRNGKey(0), 3)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    adam = js if opt.lowmem else js[0]
    assert int(adam.count) == state["count"] == 3
    if opt.schedule_count:
        assert int(js[2].count) == 3  # the schedule's count advances with the flat state
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(adam, name)), tree_leaves(state[name]),
                        strict=True):
            np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b.float().numpy())


FLAT_VS_LEAF = {
    "f32": (dict(compute_dtype="float32"), dict(), 1),
    "bf16_lowmem": (dict(compute_dtype="bfloat16"),
                    dict(moment_dtype="bfloat16", nu_dtype="bfloat16"), 1),
    "accum2_cosine": (dict(compute_dtype="float32"), dict(lr_schedule=COSINE), 2),
}


@pytest.mark.parametrize("case", sorted(FLAT_VS_LEAF))
def test_flat_steps_equal_per_leaf_steps(case):
    """A 5-step trajectory at dropout 0.2 on the same batches and salts:
    losses, parameters, moments and count bit-equal."""
    model_kw, opt_kw, accum = FLAT_VS_LEAF[case]
    _, tcfg, jparams = _setup(seed=4, **model_kw)
    draws = _draws(tcfg, 5, accum)
    runs = []
    for fused in (False, True):
        opt = make_optimizer(1e-3, **opt_kw)
        trainer = Trainer(tcfg, None, opt, [], 1, grad_accum=accum, fused_update=fused)
        params = _fresh(jparams)
        runs.append(trainer.run_steps(params, opt.init(params), draws))
    (p0, s0, l0), (p1, s1, l1) = runs
    assert _flat_views(p1) and not _flat_views(p0)
    assert torch.equal(l0, l1)
    _assert_trees_equal(p0, p1)
    assert s0["count"] == s1["count"] == 5
    for name in ("mu", "nu"):
        _assert_trees_equal(s0[name], s1[name])


def test_flat_checkpoint_resumes_in_both_packages(tmp_path):
    """A fused run's checkpoint (optax AdamW with a cosine schedule, so the
    schedule keeps a count of its own) loads in the JAX package with both
    counts at 5, and resumed in the port with fused off it continues as an
    unbroken run."""
    jcfg, tcfg, jparams = _setup(seed=2)
    draws = _draws(tcfg, 8)
    opt = make_optimizer(1e-3, lr_schedule=COSINE)
    params = _fresh(jparams)
    params, state, _ = Trainer(tcfg, None, opt, [], 1, fused_update=True).run_steps(
        params, opt.init(params), draws[:5])
    path = str(tmp_path / "fused.ckpt")
    save_checkpoint(path, params, step=5, opt_state=state, optimizer=opt)

    jopt = jax_make_optimizer(1e-3, lr_schedule=COSINE)
    jp, jo, jstep, _ = jax_load_checkpoint(path, jparams, jopt.init(jparams))
    assert jstep == 5 and int(jo[0].count) == 5 and int(jo[2].count) == 5
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())

    resumed, _ = load_checkpoint(path, tcfg, "cpu")
    resumed = map_tree(lambda t: t.requires_grad_(), resumed)
    rstate = load_optimizer_state(path, resumed, opt)
    Trainer(tcfg, None, opt, [], 1).run_steps(resumed, rstate, draws[5:])
    whole = _fresh(jparams)
    wstate = opt.init(whole)
    Trainer(tcfg, None, opt, [], 1).run_steps(whole, wstate, draws)
    _assert_trees_equal(resumed, whole)
    assert rstate["count"] == wstate["count"] == 8
    for name in ("mu", "nu"):
        _assert_trees_equal(rstate[name], wstate[name])


def test_flat_update_dispatch_follows_jax(monkeypatch):
    """The flat state is taken only with ``fused_update`` on a one-rank
    trainer whose leaves share one dtype; the sharded trainers never take
    it; bf16 master parameters raise a TypeError in both packages."""
    jcfg, tcfg, jparams = _setup(dropout=0.0)
    draws = _draws(tcfg, 1)
    opt = make_optimizer(1e-3)
    params = _fresh(jparams)
    got, _, _ = Trainer(tcfg, None, opt, [], 1, fused_update=True).run_steps(
        params, opt.init(params), draws)
    assert _flat_views(got)
    # one leaf of another dtype: the per-leaf update, in place
    mixed = _fresh(jparams)
    mixed["pre"]["pos_emb"] = mixed["pre"]["pos_emb"].detach().bfloat16().requires_grad_()
    got, _, _ = Trainer(tcfg, None, opt, [], 1, fused_update=True).run_steps(
        mixed, opt.init(mixed), draws)
    assert got is mixed and not _flat_views(got)
    # the data and sequence axes' trainers carry per-leaf state
    assert not make_sharded_trainer(tcfg, None, opt, [], 1, RankMesh({}, {}, None, None)).fused_update
    # bf16 master parameters
    bopt = make_optimizer(1e-3, moment_dtype="bfloat16", params_dtype="bfloat16")
    bparams = map_tree(lambda t: t.detach().bfloat16().requires_grad_(), _fresh(jparams))
    with pytest.raises(TypeError, match="float32"):
        Trainer(tcfg, None, bopt, [], 1, fused_update=True).run_steps(
            bparams, bopt.init(bparams), draws)
    jopt, spec = jax_make_optimizer(1e-3, moment_dtype="bfloat16", params_dtype="bfloat16",
                                    with_spec=True)
    jb = jax.tree.map(lambda a: jnp.asarray(np.asarray(a).astype(jnp.bfloat16)), jparams)
    jtrainer = JaxTrainer(jcfg, None, jopt, [], 1, adamw_spec=spec)
    jtrainer._loss_and_grads = lambda p, k: (jnp.asarray(0.0), p)
    with pytest.raises(TypeError, match="carry"):  # raised while tracing the chunk
        jtrainer.train_chunk(jb, jax.jit(jopt.init)(jb), jax.random.PRNGKey(0), 1)


def _demo_dir(tmp_path: Path, extra: str = "", max_iters: int = 4) -> Path:
    """The demo config on the CPU, a few steps in two or more chunks, one
    modality file; ``extra`` lines go under ``tpu_options``."""
    text = (REPO / "examples" / "demo_config.yaml").read_text()
    text = text.replace("max_iters: 50", f"max_iters: {max_iters}")
    text = text.replace("eval_interval: 25", "eval_interval: 2\n  eval_iters: 2")
    text = text.replace("device: auto", "device: cpu")
    text = text.replace("tpu_options:\n", "tpu_options:\n  mesh: \"off\"\n" + extra)
    (tmp_path / "config.yaml").write_text(text)
    shutil.copy(REPO / "examples" / "demo_input_schemas.yaml", tmp_path / "input_schemas.yaml")
    (tmp_path / "examples" / "demo_data").mkdir(parents=True)
    shutil.copy(REPO / "examples" / "demo_data" / "demo_stock.csv",
                tmp_path / "examples" / "demo_data" / "demo_stock.csv")
    return tmp_path


@pytest.fixture
def reset_configs():
    yield
    jax_compat.reset_compatibility_layer()
    reset_config_cache()
    port_compat.reset_compatibility_layer()


def test_run_training_fused_update_console_equals_jax(tmp_path, monkeypatch, capsys,
                                                      reset_configs):
    """``fused_update: true`` through the entry on the demo config: the flat
    state trains and the console equals the JAX runner's line for line once
    numbers are masked; ``auto`` resolves to off."""
    from trade_aid_multimodal_transformer_tpu.train.runner import run_training as jax_run

    monkeypatch.chdir(_demo_dir(tmp_path, "  fused_update: true\n", max_iters=2))
    outs = []
    jax_compat.reset_compatibility_layer()
    reset_config_cache()
    jres = jax_run(caller_globals={}, seed=0)
    outs.append(capsys.readouterr().out)
    port_compat.reset_compatibility_layer()
    res = runner.run_training(caller_globals={}, seed=0)
    outs.append(capsys.readouterr().out)
    assert res["trainer"].fused_update and jres["trainer"].adamw_spec is not None
    assert _flat_views(res["params"]) and res["opt_state"]["count"] == 2
    masked = [[re.sub(r"\d+(\.\d+)?", "#", line) for line in out.splitlines()] for out in outs]
    assert masked[0] == masked[1]
    # fused_update: auto trains per leaf
    (tmp_path / "config.yaml").write_text(
        (tmp_path / "config.yaml").read_text().replace("fused_update: true", "fused_update: auto"))
    port_compat.reset_compatibility_layer()
    res = runner.run_training(caller_globals={}, seed=0)
    assert not res["trainer"].fused_update and not _flat_views(res["params"])


# ------------------------------------------------------------------ remat


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_changes_no_value(compute_dtype, monkeypatch):
    """One training step at dropout 0.2 with ``remat`` and without: the loss
    and every gradient leaf bit-equal, on the dense cores and on the card's
    dispatch with the kernels' plain versions (the fused QKV and cross
    kernels' autograd Functions inside the recompute); on the dense cores
    within the step tolerances of JAX's ``remat=True`` ``value_and_grad``."""
    jcfg, tcfg, jparams = _setup(compute_dtype)
    (xb, yb), = _draws(tcfg, 1, B=3)[0][0]
    key = (123456789, 3141592653)
    got = {}
    for dispatch in ("dense", "kernels"):
        if dispatch == "kernels":
            monkeypatch.setattr(tatt, "_kernel_device", lambda device, impl: impl != "jnp")
        for remat in (False, True):
            cfg = dataclasses.replace(tcfg, attn_impl="pallas" if dispatch == "kernels" else "auto",
                                      remat=remat)
            params = _fresh(jparams)
            loss, _ = total_loss(params, cfg, xb, yb, key, True)
            got[dispatch, remat] = (loss, torch.autograd.grad(loss, tree_leaves(params)))
        (l0, g0), (l1, g1) = got[dispatch, False], got[dispatch, True]
        assert torch.equal(l0, l1), dispatch
        for a, b in zip(g0, g1, strict=True):
            assert torch.equal(a, b), dispatch
    jr = dataclasses.replace(jcfg, remat=True)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, x, y, k: jax_total_loss(p, jr, x, y, k, True), has_aux=True))(
        jparams, jnp.asarray(xb.numpy()), jnp.asarray(yb.numpy()), jnp.asarray(key, jnp.uint32))
    loss, grads = got["dense", True]  # JAX's dense cores draw the dense masks
    tol = TOL[compute_dtype]
    assert abs(loss.item() - float(jloss)) <= tol * max(1.0, abs(float(jloss)))
    assert max(_leaf_errs([g.numpy() for g in grads],
                          jax.tree_util.tree_leaves(jgrads))) <= GRAD_TOL[compute_dtype]


# ------------------------------------------------------------------ trace


@pytest.mark.parametrize("traced", [True, False])
def test_profile_dir_traces_the_second_chunk(tmp_path, monkeypatch, capsys, traced, reset_configs):
    """``TAT_PROFILE_DIR`` on the demo config writes one trace of the second
    training chunk (its ``train_chunk`` region and the step's operators);
    without the variable the run writes none."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    _demo_dir(run_dir)
    prof = tmp_path / "prof"
    if traced:
        monkeypatch.setenv("TAT_PROFILE_DIR", str(prof))
    else:
        monkeypatch.delenv("TAT_PROFILE_DIR", raising=False)
    monkeypatch.chdir(run_dir)
    port_compat.reset_compatibility_layer()
    res = runner.run_training(caller_globals={}, seed=0)
    assert len(res["step_timer"].chunks) >= 2
    traces = sorted(tmp_path.rglob("*.pt.trace.json"))
    if not traced:
        assert traces == [] and not prof.exists()
        return
    assert [t.parent for t in traces] == [prof]
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert sum(e.get("name") == "train_chunk" for e in events) == 1
    assert "aten::mm" in names or "aten::bmm" in names


# ------------------------------------------------------------------ rng_impl


def test_rng_impl_values_train_the_same_bits(tmp_path, monkeypatch, capsys, reset_configs):
    """``tpu_options.rng_impl`` is a no-op in the port (train/steps.py): each
    of its four values loads and trains 2 CPU steps of the demo config
    (dropout 0.1) to parameters, Adam moments and losses bit-identical to the
    run without the key."""
    runs = {}
    for value in (None, "auto", "threefry2x32", "rbg", "unsafe_rbg"):
        d = tmp_path / str(value)
        d.mkdir()
        _demo_dir(d, f"  rng_impl: {value}\n" if value else "", max_iters=2)
        monkeypatch.chdir(d)
        port_compat.reset_compatibility_layer()
        res = runner.run_training(caller_globals={}, seed=0)
        capsys.readouterr()
        assert port_compat.get_system_configuration()["rng_impl"] == (value or "auto")
        runs[value] = res
    base = runs.pop(None)
    assert base["cfg"].dropout > 0 and base["opt_state"]["count"] == 2
    for value, res in runs.items():
        assert res["losses"] == base["losses"], value
        for tree in ("params", "mu", "nu"):
            got = res["params"] if tree == "params" else res["opt_state"][tree]
            want = base["params"] if tree == "params" else base["opt_state"][tree]
            for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
                assert torch.equal(a, b), (value, tree)
