"""The port's FSDP / ZeRO-3 (``tpu_options.fsdp`` over the data axis) held
against the JAX package on the CPU.

Under FSDP a rank keeps, of every leaf that ``param_pspecs`` places on
'data', its slice of the parameters and of both Adam moments (the slice
that device r holds after the JAX package's ``shard_params(...,
fsdp=True)``), every other leaf whole; a step gathers the whole tree,
takes the data-parallel step's gradients and reduces them back to the
slices. The ranks are spawned gloo processes (tests/torch_rank_bodies.py
``fsdp_cases``, which imports no JAX), one spawn per rank count, joined
under a time limit, one thread per rank; each also runs the same steps
without FSDP. Tolerances:
- placements and shards: equal (specs leaf for leaf, shards bit for bit);
- steps against JAX's ``total_loss`` under ``jax.value_and_grad`` on the
  global batches (f32, dropout 0.2, the dense cores on both sides): those
  of tests/test_torch_dp.py (loss 1e-5 relative, every gradient leaf 1e-5
  and every parameter change 1e-4 by its L2 error against its own scale);
- against the port's data-parallel run: bit-equal at P = 2, where a
  reduce-scatter and an all-reduce add the same two addends; at P = 4 gloo
  may add four in another order, so P = 4 is held to the JAX gates;
- evaluation: wins and losses exactly the one-rank pass's, the means 1e-6;
- train-state bytes: equal to the JAX package's.
"""

import re

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as PS

from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.init import init_params as jax_init
from trade_aid_multimodal_transformer_tpu.models.transformer import total_loss as jax_loss
from trade_aid_multimodal_transformer_tpu.parallel import make_mesh as jax_make_mesh
from trade_aid_multimodal_transformer_tpu.parallel.mesh import param_pspecs as jax_pspecs
from trade_aid_multimodal_transformer_tpu.parallel.mesh import shard_params as jax_shard_params
from trade_aid_multimodal_transformer_tpu.parallel.trainer import (
    shard_train_state as jax_shard_train_state,
)
from trade_aid_multimodal_transformer_tpu.train.steps import make_optimizer as jax_make_optimizer
from trade_aid_multimodal_transformer_tpu.utils.memory import train_state_bytes as jax_state_bytes
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import map_tree, param_shapes, tree_leaves
from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import Fsdp
from trade_aid_multimodal_transformer_tpu_torch.train import runner
from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import _read_native
from trade_aid_multimodal_transformer_tpu_torch.train.steps import StepRng, Trainer, make_optimizer
from trade_aid_multimodal_transformer_tpu_torch.utils.memory import train_state_bytes

import torch_rank_bodies  # noqa: E402  (tests/ is on the path)
from test_torch_dp import (  # noqa: E402,F401
    DP_MODEL, DXS_MODEL, GLOBAL_B, RANK_TIMEOUT, _dp_batches, _dp_feed_args, _feed_and_specs,
    _mesh_config, _run_entries, one_thread,
)
from test_torch_ring import _demo_dir  # noqa: E402
from test_torch_train import _leaf_errs  # noqa: E402

SIZES = (2, 4)
STEPS = 3
# the FSDP model: DP_MODEL on the dense cores (the kernels' plain versions
# under data parallelism are tests/test_torch_dp.py's)
FSDP_MODEL = dict(DP_MODEL, attn_impl="jnp")
# the trees of the placement cases: tests/test_parallel.py's _cfg, the
# production shapes (tests/test_parallel.py:450) and its (48, 11) vocabularies
TREES = {
    "test_parallel": dict(vocab_sizes=(48, 12), cross_attention=(True, False), n_embd=32,
                          n_head=4, n_layer=2, block_size=8),
    "production": dict(vocab_sizes=(500, 120, 24, 48),
                       cross_attention=(True, True, False, False), n_embd=384, n_head=6,
                       n_layer=6, block_size=64),
    "vocab_48_11": dict(vocab_sizes=(48, 11), cross_attention=(True, False), n_embd=32,
                        n_head=4, n_layer=2, block_size=8),
}
PLACEMENTS = {"fsdp2": dict(fsdp_size=2), "fsdp4": dict(fsdp_size=4), "fsdp8": dict(fsdp_size=8),
              "model2_fsdp4": dict(model_axis=True, model_size=2, fsdp_size=4),
              "mod2": dict(mod_axis=True, mod_size=2)}


_INITS = {}


def _init(seed: int, jcfg):
    """The JAX package's init under one ``jit`` (eager, each op compiles
    on its own), once per seed and config."""
    key = (seed, repr(jcfg))
    if key not in _INITS:
        _INITS[key] = jax.jit(lambda k: jax_init(k, jcfg))(jax.random.PRNGKey(seed))
    return _INITS[key]


def _jax_specs(tree, n_head, **kw):
    """JAX's placement per leaf (``tree_leaves`` order) as tuples."""
    specs = jax_pspecs(tree, n_head, **kw)
    return [tuple(s) for s in jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, PS))]


# ------------------------------------------------------------ placements


@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_param_pspecs_equal_jax(tree, placement):
    """``param_pspecs`` leaf for leaf as the JAX package's on the same tree
    (JAX's from ``jax.eval_shape`` of its init, the port's from
    ``param_shapes``): 'data' on the same dimension, 'model' and 'mod'
    where JAX puts them."""
    kw = {"model_axis": False, **PLACEMENTS[placement]}
    jcfg = JaxConfig(**TREES[tree], dropout=0.0, attn_impl="jnp")
    shapes = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    want = _jax_specs(shapes, jcfg.n_head, **kw)
    got = pmesh.param_pspecs(param_shapes(ModelConfig(**TREES[tree])), jcfg.n_head, **kw)
    assert got == want
    assert any("data" in s for s in got) == (kw.get("fsdp_size", 1) > 1)


UNKNOWN = {"sa": ("blocks", 0, "sa", "w9_q"), "ffwd": ("blocks", 0, "ffwd", "w3"),
           "cross": ("blocks", 0, "cross", "0", "k_w"), "heads": ("post", "heads", 0, "w3")}


@pytest.mark.parametrize("family", sorted(UNKNOWN))
def test_param_pspecs_unknown_leaf_raises_as_jax(family):
    """A leaf name the table does not know under sa, ffwd, cross or heads
    raises the JAX package's ``ValueError``, with its message."""
    path = UNKNOWN[family]

    def nest(leaf):
        tree = leaf
        for k in reversed(path):
            tree = [tree] if isinstance(k, int) else {k: tree}
        return tree

    with pytest.raises(ValueError) as jerr:
        jax_pspecs(nest(np.zeros((2, 4), np.float32)), 2, fsdp_size=2)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        pmesh.param_pspecs(nest(torch.zeros(2, 4)), 2, fsdp_size=2)


@pytest.mark.parametrize("p_size", (2, 4, 8))
def test_shards_equal_jax_shard_params(p_size):
    """``shard_of`` every leaf, and ``Fsdp.shard`` of the tree, for every
    rank equal device r's shard of the JAX package's ``shard_params(...,
    fsdp=True)`` on the virtual CPU mesh, bit for bit; the leaves JAX keeps
    whole stay whole."""
    jcfg = JaxConfig(**TREES["test_parallel"], dropout=0.0, attn_impl="jnp")
    jparams = _init(3, jcfg)
    devices = jax.devices()[:p_size]
    placed = jax_shard_params(jparams, jax_make_mesh(p_size, 1, devices), jcfg.n_head,
                              model_axis=False, fsdp=True)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    specs = pmesh.param_pspecs(tparams, jcfg.n_head, model_axis=False, fsdp_size=p_size)
    leaves, full = jax.tree.leaves(placed), tree_leaves(tparams)
    assert sum(pmesh.shard_dim(s) is not None for s in specs) > len(specs) // 2
    for r in range(p_size):
        mine = tree_leaves(Fsdp(specs, pmesh.DataAxis(r, p_size)).shard(tparams))
        for leaf, t, spec, part in zip(leaves, full, specs, mine):
            (want,) = [np.asarray(s.data) for s in leaf.addressable_shards
                       if s.device == devices[r]]
            np.testing.assert_array_equal(pmesh.shard_of(t, spec, r, p_size).numpy(), want)
            np.testing.assert_array_equal(part.detach().numpy(), want)
            assert part.is_contiguous() and (pmesh.shard_dim(spec) is None
                                              or part.untyped_storage().nbytes()
                                              == part.numel() * 4)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("p_size", (2, 4, 8))
def test_train_state_bytes_equal_jax(p_size, moments):
    """The per-device train-state bytes of a rank's FSDP state (its parts,
    the whole leaves, the count) and the total equal the JAX package's
    ``train_state_bytes`` after its ``shard_train_state(fsdp=True)``, f32
    and bf16 (lowmem) moments; without FSDP the figure is the total."""
    opt_kw = dict(moment_dtype=moments, nu_dtype=moments)
    jcfg = JaxConfig(**TREES["vocab_48_11"], dropout=0.0, attn_impl="jnp")
    jparams = _init(0, jcfg)
    jopt = jax_make_optimizer(1e-3, **opt_kw)
    p_fs, o_fs = jax_shard_train_state(jparams, jopt, jax_make_mesh(p_size, 1, jax.devices()[:p_size]),
                                       jcfg.n_head, model_axis=False, fsdp=True)
    want = jax_state_bytes(p_fs, o_fs)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    opt = make_optimizer(1e-3, **opt_kw)
    placed = Fsdp(pmesh.param_pspecs(tparams, 4, model_axis=False, fsdp_size=p_size),
                  pmesh.DataAxis(1, p_size))
    state = opt.init(tparams)
    mine = placed.shard(tparams), {"count": 0, "mu": placed.shard(state["mu"]),
                                   "nu": placed.shard(state["nu"])}
    assert train_state_bytes(*mine, opt, placed.parts()) == want
    assert want[1] < want[0]
    total = train_state_bytes(tparams, state, opt)
    assert total == (want[0], want[0])


# ------------------------------------------------------------ the ranks


def _jax_trajectory(jcfg, jparams, batches, salts):
    """JAX's first step (loss, gradients) and its parameters after one
    step per batch, then one step of the first two batches as
    microbatches (the mean of their losses and gradients)."""
    opt = jax_make_optimizer(1e-3)
    vg = jax.jit(jax.value_and_grad(lambda p, x, y, k: jax_loss(p, jcfg, x, y, k, True),
                                    has_aux=True))

    @jax.jit
    def update(g, state, p):
        u, state = opt.update(g, state, p)
        return optax.apply_updates(p, u), state

    def grads(p, i):
        (loss, _), g = vg(p, jnp.asarray(batches[i][0]), jnp.asarray(batches[i][1]),
                          jnp.asarray(salts[i], jnp.uint32))
        return float(loss), g

    state, p, losses, first = opt.init(jparams), jparams, [], None
    for i in range(len(batches)):
        loss, g = grads(p, i)
        first = first or (loss, jax.tree_util.tree_leaves(g))
        p, state = update(g, state, p)
        losses.append(loss)
    (l0, g0), (l1, g1) = grads(p, 0), grads(p, 1)
    p, state = update(jax.tree.map(lambda a, b: (a + b) / 2, g0, g1), state, p)
    losses.append((l0 + l1) / 2)
    return first, losses, p


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    """JAX's trajectory on the global batches and the port's FSDP and
    data-parallel ranks for P = 2 (which also writes both checkpoints and
    resumes the FSDP one) and P = 4."""
    jcfg = JaxConfig(**FSDP_MODEL)
    jparams = _init(5, jcfg)
    batches = _dp_batches(FSDP_MODEL, STEPS, GLOBAL_B, 6)
    salts = [(int(a), int(b)) for a, b in
             np.random.default_rng(7).integers(0, 2**32, (STEPS, 2), dtype=np.uint64)]
    first, losses, p = _jax_trajectory(jcfg, jparams, batches, salts)
    init = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(jparams)]
    out = {"jax_step": first, "jax_losses": losses, "init": init,
           "jax_delta": [np.asarray(a, np.float32) - b
                         for a, b in zip(jax.tree_util.tree_leaves(p), init)],
           "tparams": params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
           "jax_specs": {n: _jax_specs(jparams, jcfg.n_head, model_axis=False, fsdp_size=n)
                         for n in SIZES},
           "ckpt": tmp_path_factory.mktemp("fsdp_ckpt")}
    for p_size in SIZES:
        out[p_size] = pmesh.run_ranks(torch_rank_bodies.fsdp_cases, p_size, (dict(
            cfg=FSDP_MODEL, params=out["tparams"], batches=batches, salts=salts, accum=True,
            batch=GLOBAL_B, feed=_dp_feed_args(FSDP_MODEL, 8), seed=11, eval_iters=2,
            ckpt=str(out["ckpt"]) if p_size == 2 else None),), timeout=RANK_TIMEOUT)
    return out


def _whole(parts_by_rank, specs):
    """A leaf list reassembled from every rank's parts along each leaf's
    'data' dimension (whole leaves: rank 0's)."""
    return [part[0] if pmesh.shard_dim(s) is None
            else np.concatenate(part, axis=pmesh.shard_dim(s))
            for part, s in zip(zip(*parts_by_rank), specs)]


@pytest.mark.parametrize("p_size", SIZES)
def test_fsdp_steps_match_jax_on_the_global_batches(fsdp_runs, p_size):
    """Three FSDP steps and one of two microbatches (``grad_accum``) over P
    gloo ranks against JAX's on the same global batches: the first step's
    loss and gradients (the ranks' parts reassembled), the losses and every
    parameter's change; every rank's gathered parameters and moments
    equal."""
    runs = [r["fsdp"] for r in fsdp_runs[p_size]]
    jloss, jgrads = fsdp_runs["jax_step"]
    specs = runs[0]["specs"]
    assert abs(runs[0]["loss"] - jloss) <= 1e-5 * max(1.0, abs(jloss))
    assert max(_leaf_errs(_whole([r["grads"] for r in runs], specs), jgrads)) <= 1e-5
    np.testing.assert_allclose(runs[0]["losses"], fsdp_runs["jax_losses"],
                               atol=1e-5 * max(1.0, max(fsdp_runs["jax_losses"])), rtol=0)
    delta = [a - b for a, b in zip(runs[0]["whole"][0], fsdp_runs["init"])]
    assert max(_leaf_errs(delta, fsdp_runs["jax_delta"])) <= 1e-4
    for other in runs[1:]:
        assert other["losses"] == runs[0]["losses"]
        for a, b in zip(other["whole"], runs[0]["whole"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_fsdp_is_bit_equal_to_data_parallel_at_two_ranks(fsdp_runs):
    """At P = 2 the FSDP run and the data-parallel run of the same steps
    agree bit for bit: the first step's loss and gradients, every loss, the
    gathered parameters, mu and nu, and the count."""
    for rank in fsdp_runs[2]:
        fs, dp = rank["fsdp"], rank["dp"]
        assert fs["loss"] == dp["loss"] and fs["losses"] == dp["losses"]
        assert fs["count"] == dp["count"] == STEPS + 1
        grads = _whole([r["fsdp"]["grads"] for r in fsdp_runs[2]], fs["specs"])
        for a, b in zip(grads, dp["grads"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(fs["whole"], dp["whole"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("p_size", SIZES)
def test_fsdp_state_is_held_one_part_per_rank(fsdp_runs, p_size):
    """Each rank's params, mu and nu hold 1/P of every leaf that JAX places
    on 'data' (the port's specs are JAX's) and the whole of every other,
    before and after the steps; its parts are its slices of the gathered
    tree (``shard_of``); the data-parallel run's ranks hold everything."""
    want_specs = fsdp_runs["jax_specs"][p_size]
    full = [a.size for a in fsdp_runs["init"]]
    want = [n // p_size if pmesh.shard_dim(s) is not None else n for n, s in zip(full, want_specs)]
    for r, rank in enumerate(fsdp_runs[p_size]):
        fs = rank["fsdp"]
        assert fs["specs"] == want_specs
        assert fs["held_before"] == fs["held_after"] == [want] * 3
        assert rank["dp"]["held_after"] == [full] * 3
        for parts, whole in zip(fs["parts"], fs["whole"]):
            for part, leaf, s in zip(parts, whole, want_specs):
                np.testing.assert_array_equal(
                    part, pmesh.shard_of(torch.from_numpy(leaf), s, r, p_size).numpy())
    assert sum(want) < 0.6 * sum(full)


@pytest.mark.parametrize("p_size", SIZES)
def test_fsdp_eval_pass_equals_the_one_rank_pass(fsdp_runs, p_size, one_thread):
    """The evaluation pass on the ranks' parts (gathered once) against the
    one-rank pass on the global batches: wins and losses exactly, mean
    losses and certainty to 1e-6."""
    feed, specs = _feed_and_specs(8)
    params = map_tree(lambda t: t.detach().clone(), fsdp_runs["tparams"])
    ref = Trainer(ModelConfig(**FSDP_MODEL), feed, make_optimizer(1e-3), specs, 2).eval_pass(
        params, StepRng(11, "cpu"), "val")
    for got in (r["fsdp"]["eval"] for r in fsdp_runs[p_size]):
        np.testing.assert_array_equal(got["wins"], ref.wins.numpy())
        np.testing.assert_array_equal(got["losses"], ref.losses.numpy())
        for name in ("mean_loss", "mean_losses", "certainty"):
            ref_v = getattr(ref, name).numpy()
            assert np.abs(got[name] - ref_v).max() <= 1e-6 * max(1.0, np.abs(ref_v).max()), name


def test_fsdp_checkpoint_equals_data_parallel_and_resumes_sharded(fsdp_runs):
    """The checkpoint rank 0 writes of the FSDP run at P = 2 (gathered from
    both ranks' parts) holds the data-parallel run's arrays, key for key,
    bit for bit; read back whole on every rank and re-sharded, each rank
    holds the parts (params, mu, nu) and the count it had."""
    fs, dp = (_read_native(str(fsdp_runs["ckpt"] / f"{v}.npz")) for v in ("fsdp", "dp"))
    assert sorted(fs) == sorted(dp) and any(k.startswith("opt") for k in fs)
    for k in fs:
        np.testing.assert_array_equal(fs[k], dp[k])
    for rank in fsdp_runs[2]:
        got = rank["fsdp"]
        assert got["resumed_count"] == got["count"]
        for a, b in zip(got["resumed_parts"], got["parts"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_data_x_seq_fsdp_step_is_bit_equal_to_data_x_seq(tmp_path):
    """{data: 2} x seq 2 (4 ranks) at block_size 512, dropout 0.2, bf16
    moments: one step with FSDP on the data groups against the same step
    without it: the loss, the gathered parameters, mu and nu bit-equal on
    every rank, the parts 1/2 where the specs say."""
    jcfg = JaxConfig(**DXS_MODEL)
    jparams = _init(2, jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    ranks = pmesh.run_ranks(torch_rank_bodies.fsdp_cases, 4, (dict(
        cfg=DXS_MODEL, params=tparams, batches=_dp_batches(DXS_MODEL, 1, 2, 3),
        salts=[(123456789, 3141592653)], seq=2, grads=False,
        opt=dict(moment_dtype="bfloat16", nu_dtype="bfloat16")),), timeout=RANK_TIMEOUT)
    specs = ranks[0]["fsdp"]["specs"]
    assert specs == _jax_specs(jparams, jcfg.n_head, model_axis=False, fsdp_size=2)
    for rank in ranks:
        fs, dp = rank["fsdp"], rank["dp"]
        assert fs["losses"] == dp["losses"] and np.isfinite(fs["losses"][0])
        for a, b in zip(fs["whole"], dp["whole"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        full = dp["held_after"][0]
        assert fs["held_after"][0] == [n // 2 if pmesh.shard_dim(s) is not None else n
                                       for n, s in zip(full, specs)]


# ------------------------------------------------------------ the entry


def _fsdp_config(tmp_path, mesh: str, rate: float, fsdp: bool, save: bool = False):
    """The data-parallel entry case of tests/test_torch_dp.py in tmp_path,
    with ``fsdp: true`` and ``save_model: 1`` where asked."""
    tmp_path.mkdir()
    d = _mesh_config(_demo_dir(tmp_path), mesh, 1, rate)
    text = (d / "config.yaml").read_text()
    if fsdp:
        text = text.replace("tpu_options:\n", "tpu_options:\n  fsdp: true\n")
    if save:
        text = text.replace("save_model: 0", "save_model: 1")
    (d / "config.yaml").write_text(text)
    return d


def test_run_training_fsdp_matches_jax_entry_and_data_parallel(tmp_path, monkeypatch, capfd):
    """``mesh: {data: 2}`` with ``fsdp: true`` through the port's entry on
    the CPU, dropout 0.2: rank 0's console equal to the JAX runner's (on
    the virtual mesh) once numbers are masked, its two ``Parallelism:``
    lines unmasked (the plan and the per-device train state), every rank's
    checksum of the gathered parameters equal; the final losses within
    1e-5 of the port's data-parallel entry with the same seed (which
    tests/test_torch_dp.py holds to the one-rank entry)."""
    d = _fsdp_config(tmp_path / "fsdp", "{data: 2}", 0.2, True)
    monkeypatch.chdir(d)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res, outs = _run_entries(d, capfd, jax_too=True)
    par = [[x for x in out if x.startswith("Parallelism:")] for out in outs]
    assert par[0] == par[1] and par[0][0] == "Parallelism: data x2 (fsdp/zero-3) over 2 devices"
    assert re.fullmatch(r"Parallelism: train state: [\d.]+ MB \([\d.]+ MB/device\)", par[0][1])
    masked = [[re.sub(r"\d+(\.\d+)?", "#", x) for x in out] for out in outs]
    assert masked[0] == masked[1]
    sums = res["param_checksums"]
    assert len(sums) == 2 and all(s == sums[0] for s in sums), sums
    assert sums[0] == runner.param_checksum(res["params"])
    total, per_dev = res["train_state_bytes"]
    assert [tuple(b) for b in res["train_state_bytes_by_rank"]] == [(total, per_dev)] * 2
    assert per_dev < 0.6 * total
    d = _fsdp_config(tmp_path / "dp", "{data: 2}", 0.2, False)
    monkeypatch.chdir(d)
    dp, _ = _run_entries(d, capfd, jax_too=False)
    for k in ("train", "val"):
        assert abs(res["losses"][k] - dp["losses"][k]) <= 1e-5, (k, res["losses"], dp["losses"])


def test_run_training_fsdp_checkpoint_and_resume(tmp_path, monkeypatch, capfd):
    """The entry with ``fsdp: true`` and ``save_model: 1`` writes the
    arrays the data-parallel entry writes (the same seed, dropout 0: every
    key bit-equal, the whole tree); resumed from that file
    (``create_new_model: 0``) it loads, re-shards and trains on, every
    rank's parameters equal."""
    files = {}
    for name, fsdp in (("fsdp", True), ("dp", False)):
        d = _fsdp_config(tmp_path / name, "{data: 2}", 0.0, fsdp, save=True)
        monkeypatch.chdir(d)
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        _run_entries(d, capfd, jax_too=False, seed=3)
        files[name] = _read_native(str(d / "output" / "demo_model.ckpt"))
    assert sorted(files["fsdp"]) == sorted(files["dp"])
    for k in files["fsdp"]:
        np.testing.assert_array_equal(files["fsdp"][k], files["dp"][k])
    d = tmp_path / "fsdp"
    text = (d / "config.yaml").read_text().replace("create_new_model: 1", "create_new_model: 0")
    (d / "config.yaml").write_text(text)
    monkeypatch.chdir(d)
    res, (out,) = _run_entries(d, capfd, jax_too=False, seed=4)
    assert "Model: Loaded successfully" in out and "TRAINING COMPLETED SUCCESSFULLY" in out
    sums = res["param_checksums"]
    assert len(sums) == 2 and all(s == sums[0] for s in sums)
