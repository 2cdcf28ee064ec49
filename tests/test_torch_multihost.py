"""The port's multi-host training (``parallel/multihost.py``,
``tpu_options.multihost``) held against the JAX package on the CPU: the
counterpart of tests/test_multihost.py and of tests/test_config_mesh.py's
``test_multihost_flag_single_process_graceful``.

Two nodes of two ranks each are four spawned gloo processes with node
environments (LOCAL_RANK, LOCAL_WORLD_SIZE), joined through
``multihost.initialize`` from the torchrun environment and then from
coordinator arguments (tests/torch_rank_bodies.py ``multihost_cases``), one
thread per rank, each join under ``RANK_TIMEOUT``. On the JAX test's model
(vocabularies (48, 12), n_embd 32, 4 heads, 2 layers, T 8, dropout 0.1,
B 16) they train 3 FSDP steps over ``{data: 4}`` on batches drawn by the
JAX package's feed, held with tests/test_torch_dp.py's gates against JAX's
``total_loss`` under ``value_and_grad`` with the same salts (the masks are
the same integer hash): the first loss 1e-5 relative, every gradient leaf
1e-5 and every parameter change 1e-4 by its L2 error against its own
scale; the checkpoint rank 0 writes within 2e-4 relative / 1e-5 absolute of
JAX's parameters after the steps (tests/test_multihost.py's bound). The
port's entry as two nodes of one rank is held bit for bit against
``run_training`` over ``{data: 2}``: the same program over the same gloo
collectives.
"""

import math
import re
import types

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.transformer import total_loss as jax_loss
from trade_aid_multimodal_transformer_tpu.sampling.feed import BatchFeed as JaxFeed
from trade_aid_multimodal_transformer_tpu.train.checkpoint import load_checkpoint as jax_load
from trade_aid_multimodal_transformer_tpu.train.steps import make_optimizer as jax_make_optimizer
from trade_aid_multimodal_transformer_tpu_torch.config import compat as port_compat
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
from trade_aid_multimodal_transformer_tpu_torch.parallel import multihost
from trade_aid_multimodal_transformer_tpu_torch.train import runner
from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import _read_native

import torch_rank_bodies  # noqa: E402  (tests/ is on the path)
from test_torch_dp import RANK_TIMEOUT, _mesh_config  # noqa: E402
from test_torch_fsdp import _init, _jax_specs, _whole  # noqa: E402
from test_torch_options import _demo_dir as _options_demo_dir  # noqa: E402
from test_torch_ring import _demo_dir  # noqa: E402
from test_torch_train import _leaf_errs  # noqa: E402

NODES, PER_NODE, STEPS, B = 2, 2, 3, 16
WORLD = NODES * PER_NODE
# tests/test_multihost.py's model and data
MODEL = dict(vocab_sizes=(48, 12), cross_attention=(True, False), n_embd=32, n_head=4, n_layer=2,
             block_size=8, dropout=0.1, attn_impl="jnp")


def _ports(n: int):
    ports = set()
    while len(ports) < n:
        ports.add(pmesh.free_port())
    return sorted(ports)


def _jax_batches():
    """STEPS training batches (x, y), (M, B, T) int32, drawn by the JAX
    package's feed on tests/test_multihost.py's data, and a salt pair per
    step."""
    rng = np.random.default_rng(0)
    n = 512
    train = [rng.integers(0, v, n - 64).astype(np.int32) for v in MODEL["vocab_sizes"]]
    val = [rng.integers(0, v, 64).astype(np.int32) for v in MODEL["vocab_sizes"]]
    feed = JaxFeed(train, val, [n], MODEL["block_size"], B, is_percents=False,
                   rand_sizes=[1, None], vocab_sizes=list(MODEL["vocab_sizes"]))
    keys = jax.random.split(jax.random.PRNGKey(1), STEPS)
    batches = [tuple(np.asarray(a, np.int32) for a in feed.get_batch(k, "train", True))
               for k in keys]
    salts = [(int(a), int(b)) for a, b in
             np.random.default_rng(7).integers(0, 2**32, (STEPS, 2), dtype=np.uint64)]
    return batches, salts


def _jax_steps(jcfg, jparams, batches, salts):
    """JAX's first step (loss, gradient leaves), its losses, and its
    parameters after one AdamW step per batch."""
    opt = jax_make_optimizer(1e-3)
    vg = jax.jit(jax.value_and_grad(lambda p, x, y, k: jax_loss(p, jcfg, x, y, k, True),
                                    has_aux=True))

    @jax.jit
    def update(g, state, p):
        u, state = opt.update(g, state, p)
        return optax.apply_updates(p, u), state

    state, p, losses, first = opt.init(jparams), jparams, [], None
    for (x, y), s in zip(batches, salts):
        (loss, _), g = vg(p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s, jnp.uint32))
        first = first or (float(loss), jax.tree_util.tree_leaves(g))
        p, state = update(g, state, p)
        losses.append(float(loss))
    return first, losses, p


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory):
    """JAX's steps, and the four ranks' results of both joins."""
    jcfg = JaxConfig(**MODEL)
    jparams = _init(0, jcfg)
    batches, salts = _jax_batches()
    first, losses, p = _jax_steps(jcfg, jparams, batches, salts)
    init = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(jparams)]
    ckpt = tmp_path_factory.mktemp("multihost_ckpt")
    (ckpt / "env").mkdir()
    (ckpt / "coordinator").mkdir()
    job = dict(per_node=PER_NODE, ports=_ports(2), fsdp=dict(
        cfg=MODEL, params=params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        batches=batches, salts=salts, batch=B, ckpt=str(ckpt)))
    # an environment (the body sets its own) and no join: the ranks join themselves
    ranks = pmesh.run_ranks(torch_rank_bodies.multihost_cases, WORLD, (job,),
                            timeout=2 * RANK_TIMEOUT, env=[{}] * WORLD)
    return {"ranks": ranks, "jax_step": first, "jax_losses": losses, "jax_params": p,
            "init": init, "ckpt": ckpt,
            "jax_delta": [np.asarray(a, np.float32) - b
                          for a, b in zip(jax.tree_util.tree_leaves(p), init)],
            "specs": _jax_specs(jparams, jcfg.n_head, model_axis=False, fsdp_size=WORLD)}


JOINS = ("env", "coordinator")


@pytest.mark.parametrize("how", JOINS)
def test_two_nodes_join_one_group(two_nodes, how):
    """Both joins make one gloo group of four ranks over two nodes: each
    rank reads its node and the node count, the group spans processes, a
    second ``initialize`` leaves it alone, and ``auto`` and ``{data: 4}``
    plan data x4 (FSDP) over the group's ranks."""
    for rank, got in enumerate(r[how] for r in two_nodes["ranks"]):
        assert got["backend"] == "gloo" and got["left_alone"]
        assert (got["node"], got["nodes"], got["multiprocess"]) == (rank // PER_NODE, NODES, True)
        assert got["devices"] == WORLD
        assert set(got["plans"].values()) == {"data x4 (fsdp/zero-3)"}


@pytest.mark.parametrize("how", JOINS)
def test_two_node_fsdp_steps_match_jax(two_nodes, how):
    """Three FSDP steps over the two nodes against JAX's on the same
    batches and salts: the first loss and gradients (the ranks' parts
    reassembled), every loss, every parameter's change; every rank's
    gathered parameters and moments equal."""
    runs = [r[how] for r in two_nodes["ranks"]]
    jloss, jgrads = two_nodes["jax_step"]
    specs = runs[0]["specs"]
    assert specs == two_nodes["specs"]
    assert abs(runs[0]["loss"] - jloss) <= 1e-5 * max(1.0, abs(jloss))
    assert max(_leaf_errs(_whole([r["grads"] for r in runs], specs), jgrads)) <= 1e-5
    np.testing.assert_allclose(runs[0]["losses"], two_nodes["jax_losses"],
                               atol=1e-5 * max(1.0, max(two_nodes["jax_losses"])), rtol=0)
    delta = [a - b for a, b in zip(runs[0]["whole"][0], two_nodes["init"])]
    assert max(_leaf_errs(delta, two_nodes["jax_delta"])) <= 1e-4
    for other in runs[1:]:
        assert other["losses"] == runs[0]["losses"]
        for a, b in zip(other["whole"], runs[0]["whole"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("how", JOINS)
def test_each_node_holds_half_of_every_fsdp_leaf(two_nodes, how):
    """The JAX test's assertion (tests/test_multihost.py:70-72): each node's
    ranks hold half of every leaf placed on 'data' between them (a quarter
    each) and every other leaf whole, before and after the steps; the
    whole tree comes back on the host through ``gather_to_host``."""
    full = [a.size for a in two_nodes["init"]]
    split = [pmesh.shard_dim(s) is not None for s in two_nodes["specs"]]
    assert sum(split) > len(split) // 2
    ranks = [r[how] for r in two_nodes["ranks"]]
    for node in range(NODES):
        mine = ranks[node * PER_NODE:(node + 1) * PER_NODE]
        for when in ("held_before", "held_after"):
            for tree in range(3):  # params, mu, nu
                held = [sum(r[when][tree][i] for r in mine) for i in range(len(full))]
                assert held == [n // 2 if s else n * PER_NODE for n, s in zip(full, split)]
    assert all(r["gathered_whole"] for r in ranks)


@pytest.mark.parametrize("how", JOINS)
def test_process_0_checkpoint_holds_the_full_arrays(two_nodes, how):
    """The checkpoint that global rank 0 writes (every rank gathers and
    calls ``save_checkpoint``) holds the full arrays, within 2e-4 / 1e-5 of
    JAX's parameters after the steps, read by the JAX package's loader;
    every rank returns the file's size."""
    path = two_nodes["ckpt"] / how / "fsdp.npz"
    loaded, _, step, _ = jax_load(str(path), two_nodes["jax_params"])
    assert step == STEPS
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(two_nodes["jax_params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-5)
    sizes = [r[how]["ckpt_size"] for r in two_nodes["ranks"]]
    assert sizes == [path.stat().st_size] * WORLD


# ------------------------------------------------------------ the entry


@pytest.fixture(scope="module")
def entry_runs(tmp_path_factory):
    """The port's entry as two nodes of one rank (``multihost: true``,
    ``mesh: auto``, 2 steps, dropout 0.1, saving) and ``run_training`` over
    ``{data: 2}`` at the same ``TAT_SEED``."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    mp.setenv("TAT_SEED", "3")
    dirs = {}
    for name, mesh in (("multihost", "auto"), ("data2", "{data: 2}")):
        d = tmp_path_factory.mktemp(name)
        _mesh_config(_demo_dir(d), mesh, 1, 0.1)
        text = (d / "config.yaml").read_text().replace("save_model: 0", "save_model: 1")
        if name == "multihost":
            text = text.replace("tpu_options:\n", "tpu_options:\n  multihost: true\n")
        (d / "config.yaml").write_text(text)
        dirs[name] = d
    try:
        port = _ports(1)[0]
        env = [dict(RANK=str(r), WORLD_SIZE=str(NODES), LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                    MASTER_ADDR="localhost", MASTER_PORT=str(port)) for r in range(NODES)]
        nodes = pmesh.run_ranks(torch_rank_bodies.multihost_entry, NODES,
                                (dict(dir=str(dirs["multihost"])),), timeout=RANK_TIMEOUT,
                                env=env)
        mp.chdir(dirs["data2"])
        port_compat.reset_compatibility_layer()
        data2 = runner.run_training(caller_globals={}, rank_timeout=RANK_TIMEOUT)
    finally:
        port_compat.reset_compatibility_layer()
        mp.undo()
    ckpt = {k: _read_native(str(d / "output" / "demo_model.ckpt")) for k, d in dirs.items()}
    return {"nodes": nodes, "data2": data2, "ckpt": ckpt}


def test_entry_as_two_nodes_equals_data_parallel_run(entry_runs):
    """The entry on two nodes of one rank, ``multihost: true``: each node
    prints its ``Multi-host: process i/2`` line and the plan data x2 over 2
    devices (``mesh: auto`` over the group), and the final losses, every
    rank's checksum and the checkpoint equal ``run_training`` over ``{data:
    2}`` bit for bit."""
    nodes, data2 = entry_runs["nodes"], entry_runs["data2"]
    for i, node in enumerate(nodes):
        assert f"Multi-host: process {i + 1}/2 (2 ranks)" in node["console"]
        assert "Parallelism: data x2 over 2 devices" in node["console"]
        assert "TRAINING COMPLETED SUCCESSFULLY" in node["console"]
        assert node["losses"] == data2["losses"] and node["plan"] == "data x2"
    assert [n["checksum"] for n in nodes] == data2["param_checksums"]
    got, want = entry_runs["ckpt"]["multihost"], entry_runs["ckpt"]["data2"]
    assert sorted(got) == sorted(want) and any(k.startswith("opt") for k in got)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def _sc(device: str, mesh) -> dict:
    return dict(device=device, context_parallel=1, mesh=mesh, fsdp=False, batch_size=16,
                block_size=8, n_head=4, n_layer=2)


@pytest.mark.parametrize("mesh", ["auto", {"data": 4}])
def test_plan_counts_the_group_not_the_local_cards(entry_runs, monkeypatch, mesh):
    """Inside a group the plan's devices are its ranks: the CPU group of 2
    nodes (``entry_runs``) planned ``auto`` over 2; a group of 4 ranks on
    nodes of 2 cards (``device_count`` 2, the world 4, mocked) plans
    ``auto`` and ``{data: 4}`` over 4, where counting the local cards
    planned 2 and refused ``{data: 4}``."""
    assert [n["devices"] for n in entry_runs["nodes"]] == [2, 2]
    assert {n["backend"] for n in entry_runs["nodes"]} == {"gloo"}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    plan = runner._plan(_sc("cuda", mesh), num_modalities=2)
    assert (plan.data, plan.n_devices) == (4, 4)


def test_multihost_flag_without_a_group_trains_single_process(tmp_path, monkeypatch, capsys):
    """``multihost: true`` with no launcher's environment and no group (the
    JAX test :274): the ``Multi-host:`` line says initialization is
    unavailable, training runs in one process, and the step-0 loss is the
    demo golden ln 57 + ln 3 within 0.15."""
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(_options_demo_dir(tmp_path, "  multihost: true\n", max_iters=2))
    port_compat.reset_compatibility_layer()
    try:
        res = runner.run_training(caller_globals={}, seed=0)
    finally:
        port_compat.reset_compatibility_layer()
    out = capsys.readouterr().out
    assert "Multi-host: initialization unavailable (no process group to join" in out
    assert not dist.is_initialized() and res["plan"].trivial
    step0 = float(re.search(r"LOSS METRICS: Step 0/2 \| Train: ([\d.]+)", out).group(1))
    assert abs(step0 - (math.log(57) + math.log(3))) <= 0.15


# ------------------------------------------------------------ backend, no processes


@pytest.mark.parametrize("cards, want", [
    (["GPU-a", "GPU-b", "GPU-c", "GPU-d"], "nccl"),
    (["GPU-a", "GPU-a"], "gloo"),        # two ranks on one card: gloo, staged
    (["GPU-a", "GPU-b", "GPU-a", "GPU-b"], "gloo"),
    (["", ""], "gloo"),                  # the CPU
    (["GPU-a", ""], "gloo"),
])
def test_backend_for_cards(cards, want):
    assert multihost.backend_for(cards) == want


class _Calls:
    """The joining calls ``initialize`` makes, mocked: a rendezvous on an
    in-process store where the other ranks' cards are already published."""

    def __init__(self, monkeypatch, rank, others, uuid, cuda, env=False):
        self.store = dist.HashStore()
        cards = dist.PrefixStore("tat_card", self.store)
        for r, card in others.items():
            cards.set(str(r), card)
        self.rendezvous, self.init, self.device = [], [], []
        world = len(others) + 1

        def rendezvous(url, r, w, timeout=None):
            self.rendezvous.append((url, r, w))
            return iter([(self.store, r, w)])

        monkeypatch.setattr(dist, "is_initialized", lambda: False)
        monkeypatch.setattr(dist, "rendezvous", rendezvous)
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: self.init.append((backend, kw["rank"],
                                                                    kw["world_size"])))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2 if cuda else 0)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: types.SimpleNamespace(uuid=f"{uuid}{i}"))
        monkeypatch.setattr(torch.cuda, "set_device", self.device.append)
        monkeypatch.setenv("LOCAL_RANK", str(rank % 2))
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        for k in multihost.TORCHRUN_ENV:
            monkeypatch.delenv(k, raising=False)
        if env:
            monkeypatch.setenv("RANK", str(rank))
            monkeypatch.setenv("WORLD_SIZE", str(world))
            monkeypatch.setenv("MASTER_ADDR", "node0")
            monkeypatch.setenv("MASTER_PORT", "29500")


@pytest.mark.parametrize("case", ["nccl", "gloo_staged", "gloo_cpu", "env"])
def test_initialize_picks_the_backend(monkeypatch, case):
    """``initialize`` publishes this rank's card and picks NCCL where every
    rank's card is its own (rank 2 of two nodes of two cards), gloo where
    ranks share a card (staged collectives) and on the CPU; it takes the
    card ``LOCAL_RANK`` and joins from coordinator arguments or from the
    torchrun environment."""
    others = {"nccl": {0: "n0-0", 1: "n0-1", 3: "n1-1"},
              "gloo_staged": {0: "n1-0", 1: "n0-1", 3: "n1-1"},
              "gloo_cpu": {0: "", 1: "", 3: ""},
              "env": {0: "n0-0", 1: "n0-1", 3: "n1-1"}}[case]
    calls = _Calls(monkeypatch, 2, others, "n1-", cuda=case != "gloo_cpu", env=case == "env")
    if case == "env":
        multihost.initialize()
        assert calls.rendezvous == [("env://", 2, 4)]
    else:
        multihost.initialize("node0:29500", 4, 2)
        assert calls.rendezvous == [("tcp://node0:29500", 2, 4)]
    want = {"nccl": "nccl", "env": "nccl"}.get(case, "gloo")
    assert calls.init == [(want, 2, 4)]
    assert calls.device == ([] if case == "gloo_cpu" else [0])
    assert dist.PrefixStore("tat_card", calls.store).get("2").decode() == (
        "" if case == "gloo_cpu" else "n1-0")


def test_initialize_is_idempotent_and_needs_a_group_to_join(monkeypatch):
    """A group already initialised is left alone (no rendezvous, no
    second group); without one, no coordinator address and no torchrun
    environment it raises, naming what is missing."""
    monkeypatch.setattr(dist, "rendezvous", lambda *a, **k: pytest.fail("joined twice"))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    multihost.initialize()
    multihost.initialize("node0:29500", 4, 2)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT"):
        multihost.initialize()
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("node0:29500")
