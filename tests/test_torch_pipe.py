"""The port's pipeline parallelism (``tpu_options.mesh`` pipe axis: alone, x
data and x data with FSDP) held against the JAX package on the CPU.

A GPipe schedule over S stages and µ microbatches (parallel/pipeline.py):
stage s runs layers [s L / S, (s + 1) L / S) of every microbatch, layer l of
microbatch i with the key ``keys[l, i]`` of ``jax.random.split`` of the
step's threefry key (folded with the data place under a data axis), so the
dropout masks are JAX's own (``utils/threefry.py``). The model is the JAX
package's pipeline tests' (tests/test_pipeline_parallel.py): vocab (19, 7),
cross (True, False), n_embd 16, 2 heads, 4 layers, T 8, B 8, f32, the dense
cores. The ranks are spawned gloo processes (tests/torch_rank_bodies.py
``pipe_cases``, which imports no JAX), started once per world size, one
thread per rank. Tolerances:
- ``threefry_split`` / ``threefry_fold_in``: bit for bit against
  ``jax.random`` under the installed ``jax_threefry_partitionable``;
- stack/unstack: exact;
- the loss at train=False: rtol 1e-6 of JAX's ``pipeline_total_loss`` on a
  pipe mesh of the same S (its own tests' bound against the sequential
  loss); at dropout 0.1 with one raw key 1e-5;
- every gradient leaf at dropout 0.1: rtol 1e-4, atol 1e-6 of ``jax.grad``
  of a sequential JAX reference built from the JAX package's ``embed``,
  ``block_forward`` (key ``keys[l, i]`` per microbatch, folded with the
  data place on that place's rows), ``logits_heads`` and
  ``cross_entropy`` (JAX's own bounds for its pipeline's gradients; its
  ``shard_map`` schedule is not differentiated here: its own test of that
  is marked slow);
- the contiguous-rows fault under a data axis: some leaf moves past 1e-3 by
  its L2 error against its own scale;
- a 3-step AdamW trajectory at dropout 0 against the port's one-rank
  trainer: losses rtol 1e-5, parameters rtol 1e-4 atol 1e-6 (the JAX
  package's pipeline trajectory bounds); parameters and moments bit-equal
  across the ranks; FSDP x pipe x data bit-equal to pipe x data;
- the entry: JAX's ``Parallelism:`` line, within 0.15 of ln 57 + ln 3 (the
  JAX package's own bound for its pipelined entry), and at dropout 0 within
  1e-5 of the port's one-rank entry with the same seed.
"""

import math
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.init import init_params as jax_init
from trade_aid_multimodal_transformer_tpu.models.transformer import (
    block_forward as jax_block, cross_entropy as jax_ce, embed as jax_embed,
    logits_heads as jax_heads)
from trade_aid_multimodal_transformer_tpu.parallel.pipeline import (
    pipeline_total_loss as jax_pipeline_loss, stack_blocks as jax_stack_blocks)
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import map_tree, tree_leaves
from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
from trade_aid_multimodal_transformer_tpu_torch.parallel import pipeline as pp
from trade_aid_multimodal_transformer_tpu_torch.train.steps import Trainer, make_optimizer
from trade_aid_multimodal_transformer_tpu_torch.utils.threefry import (
    threefry_fold_in, threefry_split)

import torch_rank_bodies  # noqa: E402  (tests/ is on the path)
from test_torch_dp import RANK_TIMEOUT, _mesh_config, _run_entries, one_thread  # noqa: E402,F401
from test_torch_ring import _demo_dir  # noqa: E402
from test_torch_train import _leaf_errs  # noqa: E402

TINY = dict(vocab_sizes=(19, 7), cross_attention=(True, False), n_embd=16, n_head=2, n_layer=4,
            block_size=8, dropout=0.1, attn_impl="jnp")
B = 8
KEY = (2718281828, 3141592653)
# (S, µ) of the loss and gradient cases; the data case is {pipe: 2, data: 2}, µ 2
CASES = ((1, 2), (2, 4), (4, 8))
DATA_MU = 2


def _jax_cfg(rate=0.1):
    return JaxConfig(**dict(TINY, dropout=rate))


@pytest.fixture(scope="module")
def ref():
    """The JAX tree (seeded numpy draws in its shapes), the port's copy and
    one global batch."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), _jax_cfg()))
    jparams = jax.tree.map(
        lambda s: jnp.asarray((rng.standard_normal(s.shape) * 0.3).astype(np.float32)), shapes)
    batch = tuple(np.stack([rng.integers(0, v, (B, TINY["block_size"]))
                            for v in TINY["vocab_sizes"]]).astype(np.int32) for _ in range(2))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"), batch


def _raw_key():
    return jnp.asarray(KEY, jnp.uint32)


def _jax_loss(ref, S, mu, train, data=1):
    """JAX's ``pipeline_total_loss`` on a (pipe[, data]) CPU mesh, jitted."""
    jparams, _, (idx, tgt) = ref
    devs = np.asarray(jax.devices()[:S * data])
    mesh = Mesh(devs.reshape(S, data), ("pipe", "data")) if data > 1 else Mesh(devs, ("pipe",))
    fn = jax.jit(lambda p, i, t, k: jax_pipeline_loss(
        p, _jax_cfg(), i, t, mesh, mu, rng=k, train=train,
        data_axis="data" if data > 1 else None)[0])
    return float(fn(jparams, jnp.asarray(idx), jnp.asarray(tgt), _raw_key()))


def _jax_grads(ref, mu, data=1):
    """``jax.grad`` of the sequential reference of the pipelined loss at
    dropout 0.1, jitted: microbatch i's rows (data place d's b / D of them)
    through every layer l with ``keys[l, i]`` (folded with d), the outputs
    in the batch's order, the heads and the unpadded CE. The JAX package's
    ``block_forward`` runs once a layer over every (microbatch, place),
    vmapped, with a key each, under a scan over the stacked layers (one
    small program to compile)."""
    jparams, _, (idx, tgt) = ref
    cfg = _jax_cfg()
    L = cfg.n_layer
    keys = jax.random.split(_raw_key(), L * mu).reshape(L, mu, 1, 2)
    if data > 1:
        keys = jnp.concatenate([jax.vmap(jax.vmap(lambda k, d=d: jax.random.fold_in(k, d)))(
            keys[:, :, 0]) [:, :, None] for d in range(data)], axis=2)

    def loss(p):
        x = jax_embed(p, cfg, jnp.asarray(idx))
        M, Bg, T, C = x.shape
        per = Bg // mu // data
        xs = x.reshape(M, mu, data, per, T, C).transpose(1, 2, 0, 3, 4, 5)

        def layer(h, blk_keys):
            blk, k = blk_keys
            return jax.vmap(jax.vmap(lambda hh, kk: jax_block(hh, blk, kk, cfg, True)))(h, k), None

        y, _ = jax.lax.scan(layer, xs, (jax_stack_blocks(p["blocks"]), keys))
        logits = jax_heads(p, cfg, y.transpose(2, 0, 1, 3, 4, 5).reshape(M, Bg, T, C))
        return sum(jax_ce(logits[m], jnp.asarray(tgt)[m]) for m in range(cfg.num_modalities))

    return [np.asarray(g) for g in jax.tree.leaves(jax.jit(jax.grad(loss))(jparams))]


def _task(ref, S, mu, rate=0.1, **what):
    _, tparams, batch = ref
    return dict(pipe=S, mu=mu, cfg=dict(TINY, dropout=rate), params=tparams, batch=batch,
                key=KEY, **what)


def _port_ranks(ref):
    """The port's ranks: 2 (``{pipe: 2}``: the loss cases at µ 4 and the
    3-step trajectory at dropout 0) and 4 (``{pipe: 4}`` at µ 8, ``{pipe:
    2, data: 2}`` at µ 2 with FSDP, and the contiguous-rows fault), one
    start of the rank processes each."""
    two = pmesh.run_ranks(torch_rank_bodies.pipe_cases, 2, ([
        _task(ref, 2, 4, eval=True, grads=True), _task(ref, 2, 4, rate=0.0, steps=3)],),
        timeout=RANK_TIMEOUT)
    four = pmesh.run_ranks(torch_rank_bodies.pipe_cases, 4, ([
        _task(ref, 4, 8, eval=True, grads=True),
        _task(ref, 2, DATA_MU, eval=True, grads=True, fsdp=True),
        _task(ref, 2, DATA_MU, grads=True, contiguous_rows=True)],), timeout=RANK_TIMEOUT)
    return {2: two, 4: four}


@pytest.fixture(scope="module")
def runs(ref):
    """The port's ranks (``_port_ranks``) and the JAX references, computed
    at once (the ranks are processes of their own, the JAX programs compile
    in threads): ``runs["jax"]`` maps ("loss", S, µ, train, D) and
    ("grads", µ, D) to JAX's values."""
    jobs = {("loss", S, mu, train, 1): (_jax_loss, (ref, S, mu, train))
            for S, mu in CASES for train in (False, True)}
    jobs["loss", 2, DATA_MU, True, 2] = (_jax_loss, (ref, 2, DATA_MU, True, 2))
    jobs.update({("grads", mu, 1): (_jax_grads, (ref, mu)) for _, mu in CASES[1:]})
    jobs["grads", DATA_MU, 2] = (_jax_grads, (ref, DATA_MU, 2))
    with ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(_port_ranks, ref)
        done = {k: pool.submit(fn, *args) for k, (fn, args) in jobs.items()}
        out = ranks.result()
        out["jax"] = {k: f.result() for k, f in done.items()}
    return out


def _one_stage(ref, mu, train):
    """The port's pipeline on one stage (S = 1): the loss and, in training,
    the gradients."""
    _, tparams, (idx, tgt) = ref
    params = map_tree(lambda t: t.detach().clone().requires_grad_(), tparams)
    loss, _ = pp.pipeline_total_loss(params, ModelConfig(**TINY), torch.from_numpy(idx),
                                     torch.from_numpy(tgt), None, mu, KEY if train else None,
                                     train)
    if not train:
        return loss.item(), None
    return loss.item(), [g.numpy() for g in torch.autograd.grad(loss, tree_leaves(params))]


def _port_case(ref, runs, S, mu):
    """(eval loss, train loss, gradients) of the case, every rank's."""
    if S == 1:
        (ev, _), (loss, grads) = _one_stage(ref, mu, False), _one_stage(ref, mu, True)
        return [(ev, loss, grads)]
    return [(r[0]["eval_loss"], r[0]["loss"], r[0]["grads"]) for r in runs[S]]


# ------------------------------------------------------------------ keys


def test_threefry_split_and_fold_in_equal_jax_random():
    """``threefry_split`` (n 2 and L µ = 32) and ``threefry_fold_in`` (data
    0-3 and 2^32 - 1, one key and the split's keys at once) of 64 seeded
    raw keys bit for bit against ``jax.random.split`` and ``fold_in`` of
    ``wrap_key_data(k, impl="threefry2x32")``, under the installed JAX's
    ``jax_threefry_partitionable`` setting (the form the port computes)."""
    assert jax.config.jax_threefry_partitionable
    keys = np.random.default_rng(1).integers(0, 2**32, (64, 2), dtype=np.uint64)
    for k in keys.astype(np.uint32):
        jk = jax.random.wrap_key_data(k, impl="threefry2x32")
        for n in (2, 32):
            split = jax.random.split(jk, n)
            got = threefry_split(k.tolist(), n)
            np.testing.assert_array_equal(got.numpy(), jax.random.key_data(split))
        for d in (0, 1, 3, 2**32 - 1):
            np.testing.assert_array_equal(
                threefry_fold_in(k.tolist(), d).numpy(),
                jax.random.key_data(jax.random.fold_in(jk, d)))
        np.testing.assert_array_equal(
            threefry_fold_in(got, 3).numpy(),
            jax.random.key_data(jax.vmap(lambda x: jax.random.fold_in(x, 3))(split)))


def test_pipeline_keys_are_jax_pipeline_keys():
    """``pipeline_keys``: (L, µ, 2), layer-major, JAX's
    ``split(rng, L µ).reshape(L, µ)`` words; None without dropout or
    outside training."""
    cfg = ModelConfig(**TINY)
    got = pp.pipeline_keys(KEY, cfg, 4, True)
    want = jax.random.key_data(jax.random.split(
        jax.random.wrap_key_data(_raw_key(), impl="threefry2x32"), 16)).reshape(4, 4, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pp.pipeline_keys(KEY, cfg, 4, False) is None
    assert pp.pipeline_keys(None, cfg, 4, True) is None
    assert pp.pipeline_keys(KEY, ModelConfig(**dict(TINY, dropout=0.0)), 4, True) is None


# ------------------------------------------------------------------ stacking


def test_stack_unstack_round_trip_equals_jax(ref):
    """``stack_blocks`` leaf for leaf as JAX's (blocks with cross leaves and
    an L axis in front), ``unstack_blocks`` its exact inverse."""
    jparams, tparams, _ = ref
    stacked = pp.stack_blocks(tparams["blocks"])
    for a, b in zip(tree_leaves(stacked), jax.tree.leaves(jax_stack_blocks(jparams["blocks"]))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for orig, back in zip(tparams["blocks"], pp.unstack_blocks(stacked, TINY["n_layer"])):
        for a, b in zip(tree_leaves(orig), tree_leaves(back)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_pipeline_errors_are_jax_errors(ref):
    """JAX's messages for a layer count the stages do not divide and a
    batch the microbatches do not divide."""
    _, tparams, (idx, tgt) = ref
    cfg = ModelConfig(**TINY)
    with pytest.raises(ValueError, match="microbatches"):
        pp.pipeline_total_loss(tparams, cfg, torch.from_numpy(idx[:, :6]),
                               torch.from_numpy(tgt[:, :6]), None, 4, None, False)

    class Stages:
        size, rank = 3, 0

    x = torch.zeros(2, B, 8, 16)
    with pytest.raises(ValueError, match="pipe"):
        pp.pipeline_apply(tparams["blocks"], x, None, cfg, False, Stages(), 4)
    with pytest.raises(ValueError, match="pipeline_microbatches"):
        pp.pipeline_rows(8, 3, 0, 2)


def test_pipeline_rows_are_jax_data_shards():
    """Data rank d's rows under a pipeline axis: its b / D rows of every
    microbatch (JAX's ``P(None, None, 'data')`` on the (µ, M, b) split), not
    the contiguous block ``batch_rows`` gives."""
    assert pp.pipeline_rows(8, 2, 0, 2).tolist() == [0, 1, 4, 5]
    assert pp.pipeline_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    assert pp.pipeline_rows(16, 4, 1, 2).tolist() == [2, 3, 6, 7, 10, 11, 14, 15]
    assert pmesh.batch_rows(8, 1, 2) == (4, 8)


@pytest.mark.parametrize("S", (1, 2, 4))
def test_stage_owners_are_the_stages_that_compute_each_leaf(ref, S):
    """Each leaf's owning stage: a block's its stage (layers [s L / S, (s +
    1) L / S)), the embedding's the first, the vocabulary heads' the
    last."""
    _, tparams, _ = ref
    from trade_aid_multimodal_transformer_tpu_torch.models.init import tree_paths

    owners = pp.stage_owners(tparams, TINY["n_layer"], S)
    for (path, _), o in zip(tree_paths(tparams), owners):
        want = {"pre": 0, "post": S - 1}.get(path[0])
        assert o == (path[1] * S // TINY["n_layer"] if want is None else want), path
    assert sorted(set(owners)) == list(range(S))


@pytest.mark.parametrize("axis", ("model", "mod", "seq"))
def test_pipe_with_model_or_mod_trains_and_with_seq_is_refused(ref, axis):
    """``make_sharded_trainer`` builds a pipelined trainer with a model or a
    modality axis on the placement ``shard_train_state`` gives (each rank
    computes the stage whole on the gathered tree, tests/test_torch_combos.py),
    refuses one without it, and refuses a pipeline axis with a sequence
    axis with the ValueError of ``plan_mesh`` (the JAX package's trainer
    cannot run that plan)."""
    from trade_aid_multimodal_transformer_tpu_torch.parallel.resolve import PIPE_SEQ
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import (
        make_sharded_trainer, shard_train_state)

    other = {"model": pmesh.ModelAxis(0, 2), "mod": pmesh.ModAxis(0, 2),
             "seq": pmesh.SeqMesh(0, 2)}[axis]
    mesh = pmesh.RankMesh({"pipe": 2, axis: 2}, {"pipe": 0, axis: 0}, None,
                          other if axis == "seq" else None,
                          other if axis == "model" else None, other if axis == "mod" else None,
                          pmesh.PipeAxis(0, 2))
    cfg, opt = ModelConfig(**TINY), make_optimizer(1e-3)
    if axis == "seq":
        with pytest.raises(ValueError, match=re.escape(PIPE_SEQ)):
            make_sharded_trainer(cfg, None, opt, [], 1, mesh)
        return
    with pytest.raises(ValueError, match="placement"):
        make_sharded_trainer(cfg, None, opt, [], 1, mesh)
    _, _, placed = shard_train_state(ref[1], None, None, False, mesh.model, mesh.mod)
    trainer = make_sharded_trainer(cfg, None, opt, [], 1, mesh, fsdp=placed)
    assert trainer.pipe is mesh.pipe and trainer.split is placed and trainer.mod is None


# ------------------------------------------------------------------ losses and gradients


@pytest.mark.parametrize("S,mu", CASES)
def test_pipeline_loss_equals_jax_pipeline_total_loss(ref, runs, S, mu):
    """The loss at train=False (rtol 1e-6) and at dropout 0.1 with the raw
    key (1e-5) on every stage against JAX's ``pipeline_total_loss`` on a
    pipe mesh of S CPU devices."""
    want_eval, want_train = (runs["jax"]["loss", S, mu, train, 1] for train in (False, True))
    for ev, loss, _ in _port_case(ref, runs, S, mu):
        np.testing.assert_allclose(ev, want_eval, rtol=1e-6)
        np.testing.assert_allclose(loss, want_train, rtol=1e-5)
    assert want_eval != want_train


@pytest.mark.parametrize("S,mu", CASES[1:])
def test_pipeline_grads_equal_jax_sequential_reference(ref, runs, S, mu):
    """Every gradient leaf at dropout 0.1 (each from the stage that owns it,
    the same on every stage) against ``jax.grad`` of the sequential JAX
    reference with the per-(layer, microbatch) keys; the same bits on
    every stage."""
    want = runs["jax"]["grads", mu, 1]
    got = _port_case(ref, runs, S, mu)
    for _, _, grads in got:
        assert len(grads) == len(want)
        for a, b in zip(grads, want):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    for _, _, grads in got[1:]:
        for a, b in zip(grads, got[0][2]):
            np.testing.assert_array_equal(a, b)


def test_pipe_x_data_equals_jax_with_its_rows_and_folded_keys(ref, runs):
    """``{pipe: 2, data: 2}`` at µ 2 on 4 ranks: the loss at dropout 0.1
    within 1e-5 of JAX's ``pipeline_total_loss(data_axis="data")`` on a
    (2, 2) CPU mesh, the eval loss 1e-6 of the sequential one, every
    gradient leaf as the sequential JAX reference's with each data place's
    rows and folded keys; a data rank that takes a contiguous block of the
    batch moves some leaf past 1e-3."""
    want = runs["jax"]["grads", DATA_MU, 2]
    np.testing.assert_allclose(runs[4][0][1]["loss"], runs["jax"]["loss", 2, DATA_MU, True, 2],
                               rtol=1e-5)
    np.testing.assert_allclose(runs[4][0][1]["eval_loss"], runs["jax"]["loss", 1, 2, False, 1],
                               rtol=1e-6)
    for rank, r in enumerate(runs[4]):
        assert r[1]["coords"]["pipe"] * 2 + r[1]["coords"]["data"] == rank
        for a, b in zip(r[1]["grads"], want):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert max(_leaf_errs(runs[4][0][2]["grads"], want)) > 1e-3


def test_pipeline_trajectory_equals_the_one_rank_trainer(ref, runs, one_thread):
    """3 AdamW steps (lr 1e-2) at dropout 0 over ``{pipe: 2}``, µ 4, and one
    of two microbatch draws (``grad_accum``) against the port's one-rank
    trainer on the same batches: losses rtol 1e-5, parameters rtol 1e-4
    atol 1e-6; every rank's parameters and moments bit-equal."""
    _, tparams, (idx, tgt) = ref
    params = map_tree(lambda t: t.detach().clone().requires_grad_(), tparams)
    opt = make_optimizer(1e-2)
    state = opt.init(params)
    trainer = Trainer(ModelConfig(**dict(TINY, dropout=0.0)), None, opt, [], 1)
    batch = [(torch.from_numpy(idx), torch.from_numpy(tgt))]
    losses = [trainer.step(params, state, batch, [KEY]).item() for _ in range(3)]
    flipped = (batch[0][0].flip(1), batch[0][1].flip(1))
    losses.append(trainer.step(params, state, batch + [flipped], [KEY, KEY[::-1]]).item())
    got = [r[1]["steps"] for r in runs[2]]
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    for a, b in zip(got[0]["whole"][0], tree_leaves(params)):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-4, atol=1e-6)
    assert got[1]["losses"] == got[0]["losses"] and got[0]["count"] == 4
    for tree_a, tree_b in zip(got[1]["whole"], got[0]["whole"]):
        for a, b in zip(tree_a, tree_b):
            np.testing.assert_array_equal(a, b)


def test_fsdp_pipe_data_is_bit_equal_to_pipe_data(runs):
    """One step with FSDP on the data axis of ``{pipe: 2, data: 2}``: the
    loss and the gathered parameters, mu and nu bit-equal to the step
    without FSDP, on every rank."""
    for r in runs[4]:
        a, b = r[1]["pipe"], r[1]["fsdp"]
        assert a["losses"] == b["losses"] and a["count"] == b["count"] == 1
        for tree_a, tree_b in zip(a["whole"], b["whole"]):
            for x, y in zip(tree_a, tree_b):
                np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ the entry


def test_run_training_pipe_x_data_entry(tmp_path, monkeypatch, capfd):
    """``mesh: {pipe: 2, data: 2}`` with ``pipeline_microbatches: 2``
    through the port's entry on the demo workdir (4 gloo ranks): JAX's
    ``Parallelism:`` line, the final train loss within 0.15 of ln 57 + ln 3
    (the JAX package's bound for its pipelined entry), every rank's
    checksum equal; at dropout 0 the final losses within 1e-5 of the
    port's one-rank entry with the same seed."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    results = {}
    for rate in (0.1, 0.0):
        d = tmp_path / f"pipe_{rate}"
        d.mkdir()
        d = _mesh_config(_demo_dir(d), "{pipe: 2, data: 2}", 1, rate)
        text = (d / "config.yaml").read_text()
        (d / "config.yaml").write_text(text.replace(
            "  mesh: {pipe: 2, data: 2}\n", "  mesh: {pipe: 2, data: 2}\n"
            "  pipeline_microbatches: 2\n"))
        monkeypatch.chdir(d)
        res, (out,) = _run_entries(d, capfd, jax_too=False)
        assert "Parallelism: pipeline x2 * data x2 over 4 devices" in out
        sums = res["param_checksums"]
        assert len(sums) == 4 and all(s == sums[0] for s in sums), sums
        results[rate] = res
    anchor = math.log(57) + math.log(3)
    assert results[0.1]["losses"]["train"] == pytest.approx(anchor, abs=0.15)
    text = (d / "config.yaml").read_text().replace("mesh: {pipe: 2, data: 2}", "mesh: \"off\"")
    (d / "config.yaml").write_text(text)
    one, _ = _run_entries(d, capfd, jax_too=False)
    assert one["plan"].trivial
    for k in ("train", "val"):
        assert abs(results[0.0]["losses"][k] - one["losses"][k]) <= 1e-5, (k, results, one)
