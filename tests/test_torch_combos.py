"""The port's last mesh plans held against the JAX package's sharded trainer
on the CPU: a pipeline axis with a model axis and with a modality axis
(alone, x data, and x data with FSDP), a modality axis with a sequence axis
(context parallelism; x data too), a model axis that does not divide
``n_head`` with a sequence axis, and the one plan the JAX package's trainer
cannot run (a pipeline axis with a sequence axis), which the port refuses.

The JAX references are its own trainer's step: ``make_mesh`` and
``shard_train_state`` on the conftest's CPU devices, ``make_sharded_trainer``,
and its ``loss_fn`` under ``jax.value_and_grad`` inside the trainer's scope
with its batch constraint, jitted, on the same global batch and raw key,
the gradients placed as the parameters. Each port rank is held to the JAX
device at its place of the mesh (the JAX package's device order, pipe
outer, seq inner, is the port's rank order): its loss and its parts of
every gradient leaf against that device's shards (tests/jax_mesh_steps.py).
The JAX steps run in four spawned processes (their context-parallel scope
is a module global, so a process traces one at a time), compiled with
XLA's LLVM passes cut; the port's ranks are spawned gloo
processes (tests/torch_rank_bodies.py ``combo_cases``, which imports no
JAX), one start per world size (2, 4 and 8), one thread per rank. The
model: two modalities, the first cross-attending, n_embd 16, 2 heads, 2
layers, block_size 8, batch 4, 2 microbatches, f32, the dense cores (for
the model axis that does not divide the heads n_embd 24 and 3 heads).
Tolerances:
- pipe x model, pipe x mod (dropout 0 and 0.1), pipe x model x data: the
  loss rtol 1e-5, every gradient part rtol 1e-4 atol 1e-6 (the pipeline's
  bounds, tests/test_torch_pipe.py); the loss, every gradient part and the
  updated parameters and moments bit-equal to the port's ``{pipe: 2}``
  step's (every rank of a group computes the stage whole on the gathered
  tree), pipe x mod x data with FSDP bit-equal to ``{pipe: 2, data: 2}``;
  each rank's parts bit-equal to JAX's shards and its train-state bytes
  JAX's ``train_state_bytes``;
- mod x seq (dropout 0.1): the loss 1e-5, the parts rtol 2e-4 atol 1e-5
  (the modality axis's bounds, tests/test_torch_mod.py) against JAX's step;
  with and without a data axis, gathered, against the port's
  context-parallel step (data x seq for the data case);
- a model axis of 2 over 3 heads x seq: at dropout 0 against JAX's step at
  the pipeline's bounds. At dropout 0.1 the JAX ring folds each device's
  model place into its key over heads the axis does not split, and what
  its devices report is not one function: every device's loss is place
  0's forward, its replicated gradients differ by device. The port folds
  place 0 on every rank: its loss equal to JAX's on every device (rtol
  1e-6), its gradients at the pipeline's bounds against JAX's step with
  the model place read as 0 on every device (the exact gradient of that
  loss), bit-equal across the ranks; JAX's own replicated gradients are
  pinned as device-dependent;
- the ring chunk's row base (K7's plain versions and the dense chunk core,
  forward and backward): bit-equal to the rows from the base of the call
  on the whole M;
- planted faults, each of which must move some leaf past 1e-3 by its L2
  error against its own scale (``_leaf_errs``): a model-group sum of the
  gathered leaves' gradients under pipe x model, and a modality-parallel
  ring keying its rows from 0;
- pipe x seq: JAX's trainer raises ``ValueError`` at trace (pinned, so that
  a JAX that runs it shows up), the port's ``plan_mesh`` and
  ``make_sharded_trainer`` raise theirs;
- the entry ``{pipe: 2, model: 2}`` on 4 ranks: the final losses within
  1e-5 of the ``{pipe: 2}`` entry's with the same seed, every rank's
  checksum equal.
"""

import math
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest

import jax
import torch

from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
from trade_aid_multimodal_transformer_tpu_torch.parallel.resolve import PIPE_SEQ, plan_mesh
from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import make_sharded_trainer
from trade_aid_multimodal_transformer_tpu_torch.train.steps import make_optimizer

import jax_mesh_steps as jms  # noqa: E402  (tests/ is on the path)
import torch_rank_bodies  # noqa: E402
from jax_mesh_steps import KEY, MU  # noqa: E402
from test_torch_dp import RANK_TIMEOUT, _mesh_config, _run_entries  # noqa: E402
from test_torch_ring import _demo_dir  # noqa: E402
from test_torch_train import _leaf_errs  # noqa: E402

MODEL = dict(vocab_sizes=(19, 7), cross_attention=(True, False), n_embd=16, n_head=2, n_layer=2,
             block_size=8, attn_impl="jnp")
SPLIT_MODEL = dict(MODEL, n_embd=24, n_head=3)  # a model axis of 2 does not divide 3 heads
RATE = 0.1
# name: (model, dropout, mesh, fsdp, planted fault); one start of the ranks per world size
CASES = {
    "pipe2": (MODEL, 0.0, dict(pipe=2), False, None),
    "pipe2_dropout": (MODEL, RATE, dict(pipe=2), False, None),
    "seq2_dropout": (MODEL, RATE, dict(seq=2), False, None),
    "pipe2_model2": (MODEL, 0.0, dict(pipe=2, model=2), False, None),
    "pipe2_model2_dropout": (MODEL, RATE, dict(pipe=2, model=2), False, None),
    "pipe2_mod2": (MODEL, 0.0, dict(pipe=2, mod=2), False, None),
    "pipe2_mod2_dropout": (MODEL, RATE, dict(pipe=2, mod=2), False, None),
    "pipe2_model2_group_sum": (MODEL, RATE, dict(pipe=2, model=2), False, "model_group_sum"),
    "pipe2_data2_dropout": (MODEL, RATE, dict(pipe=2, data=2), False, None),
    "mod2_seq2_dropout": (MODEL, RATE, dict(mod=2, seq=2), False, None),
    "mod2_seq2_rows_from_0": (MODEL, RATE, dict(mod=2, seq=2), False, "mod_rows_from_0"),
    "data2_seq2_dropout": (MODEL, RATE, dict(data=2, seq=2), False, None),
    "model2_split_seq2": (SPLIT_MODEL, 0.0, dict(model=2, seq=2), False, None),
    "model2_split_seq2_dropout": (SPLIT_MODEL, RATE, dict(model=2, seq=2), False, None),
    "pipe2_model2_data2_dropout": (MODEL, RATE, dict(pipe=2, model=2, data=2), False, None),
    "pipe2_mod2_data2_fsdp_dropout": (MODEL, RATE, dict(pipe=2, mod=2, data=2), True, None),
    "mod2_data2_seq2_dropout": (MODEL, RATE, dict(mod=2, data=2, seq=2), False, None),
}
# the port's step each pipe x model / mod case equals bit for bit (at the same pipe and data place)
PIPE_TWIN = {"pipe2_model2": "pipe2", "pipe2_model2_dropout": "pipe2_dropout",
             "pipe2_mod2": "pipe2", "pipe2_mod2_dropout": "pipe2_dropout",
             "pipe2_mod2_data2_fsdp_dropout": "pipe2_data2_dropout"}
# the cases held against JAX at the pipeline's bounds and at the modality axis's
PIPE_BOUNDS = ("pipe2_model2", "pipe2_model2_dropout", "pipe2_mod2", "pipe2_mod2_dropout",
               "pipe2_model2_data2_dropout", "model2_split_seq2", "model2_split_seq2_dropout")
MOD_BOUNDS = {"mod2_seq2_dropout": "seq2_dropout", "mod2_data2_seq2_dropout": "data2_seq2_dropout"}
# JAX's steps: the held cases (the split-head case at dropout with the model place read as 0
# on every device) and that case as JAX's devices compute it
PLACE0 = "model2_split_seq2_dropout"
JAX_CASES = [(name, name == PLACE0) for name in (*PIPE_BOUNDS, "mod2_seq2_dropout")] + [
    (PLACE0, False)]


def _world(name) -> int:
    return math.prod(CASES[name][2].values())


def _trees():
    """Per head count: the JAX tree (its init) and the port's copy; the
    global batch."""
    out = {}
    for model in (MODEL, SPLIT_MODEL):
        jparams = jms.init(model)
        out[model["n_head"]] = jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return out, jms.batch(MODEL)


def _jax_job(trees, name, place0):
    """(``jax_mesh_steps.case``, its arguments) of a case of ``CASES``."""
    by_n, _ = trees
    model, rate, mesh, fsdp, _ = CASES[name]
    params = jax.tree.map(np.asarray, by_n[model["n_head"]][0])
    return jms.case, (params, model, rate, mesh, fsdp, place0)


def _port_ranks(trees):
    """The port's ranks: one start per world size, every case of it."""
    by_n, batch = trees
    out = {}
    for world in (2, 4, 8):
        names = [k for k in CASES if _world(k) == world]
        jobs = []
        for name in names:
            model, rate, mesh, fsdp, fault = CASES[name]
            jobs.append(dict(mesh=mesh, cfg=dict(model, dropout=rate),
                             params=by_n[model["n_head"]][1], batch=batch, key=KEY, mu=MU,
                             fsdp=fsdp, fault=fault))
        got = pmesh.run_ranks(torch_rank_bodies.combo_cases, world, (jobs,),
                              timeout=RANK_TIMEOUT)
        out.update({name: [g[i] for g in got] for i, name in enumerate(names)})
    return out


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.fixture(scope="module")
def runs(trees):
    """The port's ranks (``_port_ranks``, in a thread) and JAX's steps of
    ``JAX_CASES`` (in four spawned processes, compiling with
    ``jax_mesh_steps.FAST_COMPILE``), computed at once: (port results by
    case, JAX results by (case, place0))."""
    spawn = multiprocessing.get_context("spawn")
    with ThreadPoolExecutor(1) as thread, ProcessPoolExecutor(
            4, mp_context=spawn, initializer=jms.fast_compile) as procs:
        ranks = thread.submit(_port_ranks, trees)
        ref = {case: procs.submit(fn, *args) for case, fn, args in
               ((case, *_jax_job(trees, *case)) for case in JAX_CASES)}
        return ranks.result(), {k: f.result() for k, f in ref.items()}


def _hold(port_ranks, ref, loss_rtol, rtol, atol):
    """Each rank's loss and gradient parts against its device's."""
    for r, res in enumerate(port_ranks):
        np.testing.assert_allclose(res["loss"], ref["loss"][r], rtol=loss_rtol)
        assert len(res["grads"]) == len(ref["grads"])
        for got, want in zip(res["grads"], ref["grads"]):
            np.testing.assert_allclose(got, want[r], rtol=rtol, atol=atol)


def _twin(ranks, coords, axes=("pipe", "data")):
    """The rank of ``ranks`` at the places of ``coords`` on ``axes``."""
    (twin,) = [r for r in ranks if all(r["coords"][a] == coords[a] for a in axes)]
    return twin


# ------------------------------------------------------------------ steps


@pytest.mark.parametrize("name", PIPE_BOUNDS)
def test_step_equals_jax_sharded_trainer_step(runs, name):
    """Pipe x model, pipe x mod (alone and x data) and a model axis of 2
    over 3 heads x seq: every rank's loss (rtol 1e-5) and gradient parts
    (rtol 1e-4, atol 1e-6) against its JAX device's (the split-head case at
    dropout against JAX's step with the model place read as 0), its parts
    of the initial parameters bit-equal to JAX's shards and its train-state
    bytes JAX's."""
    port, jax_ref = runs
    ref = jax_ref[name, name == PLACE0]
    _hold(port[name], ref, 1e-5, 1e-4, 1e-6)
    for r, res in enumerate(port[name]):
        for got, want in zip(res["parts_before"], ref["parts"]):
            np.testing.assert_array_equal(got, want[r])
        assert tuple(res["state_bytes"]) == tuple(ref["bytes"])


def test_split_heads_seq_jax_devices_disagree_the_port_computes_their_loss(runs):
    """A model axis of 2 over 3 heads x seq at dropout 0.1: JAX's devices
    report one loss, which the port's ranks equal (rtol 1e-6), but their
    replicated gradients differ by device (the ring's key folded with each
    device's own place over heads the axis does not split); the port's
    ranks' gathered gradients and updated trees are bit-equal."""
    port, jax_ref = runs
    ref = jax_ref[PLACE0, False]
    ranks = port[PLACE0]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["loss"], ref["loss"][r], rtol=1e-6)
    spread = max(float(np.abs(g[0] - g[d]).max()) for g, rep in zip(ref["grads"], ref["replicated"])
                 if rep for d in range(len(ranks)))
    assert spread > 0.0
    for res in ranks[1:]:
        for a, b in zip(res["whole_grads"] + res["whole_after"][0],
                        ranks[0]["whole_grads"] + ranks[0]["whole_after"][0]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(PIPE_TWIN))
def test_pipe_with_model_or_mod_is_bit_equal_to_pipe(runs, name):
    """Every rank of ``{pipe: 2, model: 2}`` and ``{pipe: 2, mod: 2}`` (and
    of ``{pipe: 2, mod: 2, data: 2}`` with FSDP) computes its stage on the
    whole gathered tree: its loss, gathered gradients and updated
    parameters and moments bit-equal to the port's ``{pipe: 2}`` (``{pipe:
    2, data: 2}``) step's at its stage and data place; its gradient parts
    its slices of them; a model or modality split leaf really split."""
    port, _ = runs
    for res in port[name]:
        base = _twin(port[PIPE_TWIN[name]], res["coords"])
        assert res["loss"] == base["loss"]
        for a, b in zip(res["whole_grads"], base["whole_grads"]):
            np.testing.assert_array_equal(a, b)
        for tree_a, tree_b in zip(res["whole_after"], base["whole_after"]):
            for a, b in zip(tree_a, tree_b):
                np.testing.assert_array_equal(a, b)
        assert any(p > 1 for p in res["parts_held"])
        for g, w, parts in zip(res["grads"], res["whole_grads"], res["parts_held"]):
            assert (g.size * parts, g.shape == w.shape) == (w.size, parts == 1)


@pytest.mark.parametrize("name", sorted(MOD_BOUNDS))
def test_mod_seq_equals_jax_and_the_context_parallel_step(runs, name):
    """``{mod: 2}`` x ``context_parallel: 2`` (and x data) at dropout 0.1:
    every rank's loss (1e-5) and gradient parts (rtol 2e-4, atol 1e-5)
    against its JAX device's (without the data axis); the gathered
    gradients the same against the port's context-parallel step without
    the modality axis (the ring keys every modality's rows by its index in
    the whole M, as JAX's ring, which sees all of them)."""
    port, jax_ref = runs
    if (name, False) in jax_ref:
        _hold(port[name], jax_ref[name, False], 1e-5, 2e-4, 1e-5)
    for res in port[name]:
        cp = _twin(port[MOD_BOUNDS[name]], res["coords"], ("data", "seq"))
        np.testing.assert_allclose(res["loss"], cp["loss"], rtol=1e-5)
        for a, b in zip(res["whole_grads"], cp["whole_grads"]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("fault,held", [("pipe2_model2_group_sum", "pipe2_model2_dropout"),
                                        ("mod2_seq2_rows_from_0", "mod2_seq2_dropout")])
def test_planted_faults_fail_the_gate(runs, fault, held):
    """A model-group sum of the gathered leaves' gradients (each counted
    twice) and a modality-parallel ring keying its rows from 0 (modality
    1's masks those of modality 0): some rank's gradient part moves past
    1e-3 against its JAX device's; the sound case stays under it."""
    port, jax_ref = runs
    ref = jax_ref[held, False]

    def worst(ranks):
        return max(max(_leaf_errs(r["grads"], [w[i] for w in ref["grads"]]))
                   for i, r in enumerate(ranks))

    assert worst(port[held]) < 1e-3
    assert worst(port[fault]) > 1e-3


@pytest.mark.parametrize("causal", (True, False))
def test_ring_chunk_row_base_keys_the_rows_of_the_whole_m(causal):
    """A modality-parallel rank's ring chunk with the row base m0 B H (K7's
    plain versions, which run for CPU tensors, and the dense chunk core,
    forward and backward, dropout 0.2) equals, bit for bit, its rows of the
    call on every modality's rows (rows from the base), as JAX's ring keys
    them; from base 0 it does not."""
    from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
    from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(3)
    M, Bh, t, hs = 4, 6, 128, 16  # 4 modalities of B H = 6 rows, t_q = t_k = 128
    q, k, v, do = (torch.randn(M * Bh, t, hs, generator=g) for _ in range(4))
    base, mine = 2 * Bh, slice(2 * Bh, 4 * Bh)  # modality place 1 of 2
    for fwd, bwd in ((K.flash_chunk_fwd, K.flash_chunk_bwd),
                     (tatt.chunk_fwd_dense, tatt.chunk_bwd_dense)):
        out, lse = fwd(q, k, v, causal, 77, 0.2)
        whole = bwd(q, k, v, out, lse, do, causal, 77, 0.2)
        part = [x[mine] for x in (q, k, v, out, lse, do)]
        got, got_lse = fwd(*part[:3], causal, 77, 0.2, base)
        np.testing.assert_array_equal(got.numpy(), out[mine].numpy())
        np.testing.assert_array_equal(got_lse.numpy(), lse[mine].numpy())
        for a, b in zip(bwd(*part, causal, 77, 0.2, base), whole):
            np.testing.assert_array_equal(a.numpy(), b[mine].numpy())
        assert not torch.equal(fwd(*part[:3], causal, 77, 0.2)[0], out[mine])


# ------------------------------------------------------------------ pipe x seq


def test_jax_trainer_cannot_run_pipe_with_seq(trees):
    """JAX's trainer on a ``{pipe: 2}`` x ``seq: 2`` mesh fails at trace:
    its ring's ``shard_map`` nests inside the pipeline's. Pinned, so that
    a JAX that runs this plan shows up (the port refuses it on this
    ground)."""
    by_n, batch = trees
    with pytest.raises(ValueError, match="shard_map"):
        jms.step(by_n[2][0], MODEL, 0.0, dict(pipe=2, seq=2), False, batch)


def test_port_refuses_pipe_with_seq():
    """``plan_mesh`` (after every JAX check) and ``make_sharded_trainer``
    raise the ValueError that names the JAX failure."""
    kw = dict(batch_size=8, block_size=8, n_head=2, num_modalities=2, n_layer=2)
    with pytest.raises(ValueError, match="parallel/pipeline.py") as e:
        plan_mesh({"pipe": 2}, 2, n_devices=4, **kw)
    assert PIPE_SEQ in str(e.value) and "nested shard_map" in str(e.value)
    mesh = pmesh.RankMesh({"pipe": 2, "seq": 2}, {"pipe": 0, "seq": 0}, None,
                          pmesh.SeqMesh(0, 2), pipe=pmesh.PipeAxis(0, 2))
    with pytest.raises(ValueError, match="nested shard_map"):
        make_sharded_trainer(ModelConfig(**MODEL), None, make_optimizer(1e-3), [], 1, mesh)


# ------------------------------------------------------------------ the entry


def test_run_training_pipe_x_model_entry_equals_pipe_entry(tmp_path, monkeypatch, capfd):
    """``mesh: {pipe: 2, model: 2}`` through the port's entry on the demo
    workdir (4 gloo ranks) at dropout 0.1: its ``Parallelism:`` line, every
    rank's checksum equal, the final losses within 1e-5 of the ``{pipe:
    2}`` entry's with the same seed."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    results = {}
    for mesh, line in (("{pipe: 2, model: 2}", "pipeline x2 * tensor x2 over 4 devices"),
                       ("{pipe: 2}", "pipeline x2 over 2 devices")):
        d = tmp_path / mesh.replace(" ", "").strip("{}").replace(":", "").replace(",", "_")
        d.mkdir()
        d = _mesh_config(_demo_dir(d), mesh, 1, RATE)
        monkeypatch.chdir(d)
        res, (out,) = _run_entries(d, capfd, jax_too=False)
        assert f"Parallelism: {line}" in out
        sums = res["param_checksums"]
        assert all(s == sums[0] for s in sums), sums
        results[mesh] = res
    a, b = (results[m]["losses"] for m in ("{pipe: 2, model: 2}", "{pipe: 2}"))
    for k in ("train", "val"):
        assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)
