"""The port's context-parallel path held against the JAX package on the CPU:
the ring's chunk kernels' plain versions (K7f ``flash_chunk_fwd_plain``, K7b
``flash_chunk_bwd_plain``) against the Pallas chunk kernels in interpret
mode, the dense chunk core against ``chunk_fwd_jnp`` / ``chunk_bwd_jnp``,
ring attention over 2 and 4 gloo ranks against ``ring_causal_attention_local``
under ``shard_map`` on 2 and 4 of the tests' 8 CPU devices, a context-parallel
training step and 5-step trajectory against the JAX package's loss under
its context-parallel scope on a sequence mesh of 2, and ``run_training``
with ``context_parallel: 2`` against the JAX runner.

Inputs are made with numpy and handed to both packages. The port's ranks are
spawned processes (tests/torch_rank_bodies.py, which imports no JAX), each
joined under a time limit. Tolerances:
- dropout keep-masks: bit for bit (the same integer hash on the same blocks);
- chunk kernels, dense cores and the ring: max-abs error <= tol *
  max(1, max|ref|), f32 1e-5 (the same arithmetic, another summation
  order), bf16 2e-2 (a different summation order can flip a bf16 rounding
  of an intermediate); lse 1e-5;
- the model (f32): loss 1e-5 relative, every gradient leaf by its L2 error
  against its own scale 1e-5, the trajectory's losses 1e-5 and parameter
  changes 1e-4 (``_leaf_errs`` of tests/test_torch_train.py).
"""

import functools
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as PS

from trade_aid_multimodal_transformer_tpu.config import compat as jax_compat
from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.init import init_params as jax_init
from trade_aid_multimodal_transformer_tpu.ops import attention as jatt
from trade_aid_multimodal_transformer_tpu.ops import pallas_attention as jpa
from trade_aid_multimodal_transformer_tpu.parallel import make_mesh
from trade_aid_multimodal_transformer_tpu.parallel.ring_attention import (
    ring_causal_attention_local as jax_ring_local,
)
from trade_aid_multimodal_transformer_tpu.train.steps import make_optimizer as jax_make_optimizer
from trade_aid_multimodal_transformer_tpu_torch.config import compat as port_compat
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.models.init import map_tree
from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
from trade_aid_multimodal_transformer_tpu_torch.train import runner

import torch_rank_bodies  # noqa: E402  (tests/ is on the path)
from test_torch_train import _jax_trajectory, _leaf_errs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SALTS = np.array([123456789, 3141592653], np.uint32)
RANK_TIMEOUT = 240.0


def _err(got, ref):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _normal(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(shape, dtype, rng):
    a = _normal(shape, rng)
    return jnp.asarray(a).astype(getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.fixture
def jax_chunks_interpret(monkeypatch):
    """The JAX package's chunk dispatch reaches its Pallas chunk kernels in
    interpret mode, as tests/test_kernels.py runs them on the CPU."""
    for name in ("flash_chunk_fwd", "flash_chunk_bwd"):
        monkeypatch.setattr(jpa, name, functools.partial(getattr(jpa, name), interpret=True))


# ------------------------------------------------------------------ K7 plain


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("tq,tk", [(256, 256), (128, 384), (640, 1024)])
def test_chunk_keep_mask_is_bit_equal_to_jax(tq, tk, rate):
    """K7's mask of block (iq, jk) on JAX's query blocks of t_q and key
    blocks of t_k (which differ where t_q != t_k) against the interpret-mode
    ``_keep_mask`` of the Pallas kernels."""
    bq, bk = K.flash_pick_block(tq), K.flash_pick_block(tk)
    assert (bq, bk) == (jpa._pick_block(tq, jpa.DEFAULT_BQ), jpa._pick_block(tk, jpa.DEFAULT_BK))
    seed = jpa.seed_from_key(jnp.asarray(SALTS))[0] + 5  # a ring pair's seed
    for iq, jk in ((0, 0), (tq // bq - 1, 0), (0, tk // bk - 1)):
        got = K._flash_keep(int(seed) & 0xFFFFFFFF, 2, iq, jk, bq, bk, rate, None)
        for n in range(2):
            ref = jpa._keep_mask(seed, n, iq, jk, (bq, bk), rate, True)
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(ref))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(256, 256), (128, 384), (640, 256)])
def test_chunk_plain_matches_jax_interpret(tq, tk, causal, dtype, rate):
    """K7f's out and lse and K7b's dq, dk, dv against ``flash_chunk_fwd`` /
    ``flash_chunk_bwd`` in interpret mode, the backward given a logsumexp
    and output merged over two chunks (the ring's), as both take them."""
    rng = np.random.default_rng(tq + tk + causal)
    hs = 16
    (jq, tq_), (jg, tg) = (_pair((2, 3, tq, hs), dtype, rng) for _ in range(2))
    (jk, tk_), (jv, tv), (jk2, tk2), (jv2, tv2) = (_pair((2, 3, tk, hs), dtype, rng)
                                                    for _ in range(4))
    jseed = jpa.seed_from_key(jnp.asarray(SALTS)) + 7
    seed = int(jseed[0]) if rate else None
    tol = TOL[dtype]

    jout, jlse = jpa.flash_chunk_fwd(jq, jk, jv, causal, jseed, rate, interpret=True)
    out, lse = K.flash_chunk_fwd_plain(tq_, tk_, tv, causal, seed, rate)
    assert out.dtype == tq_.dtype and tuple(lse.shape) == (2, 3, tq)
    assert _err(out, jout) <= tol and _err(lse, jlse) <= 1e-5

    jout2, jlse2 = jpa.flash_chunk_fwd(jq, jk2, jv2, False, jseed + 1, rate, interpret=True)
    jm = jnp.logaddexp(jlse, jlse2)
    jo = (jout.astype(jnp.float32) * jnp.exp(jlse - jm)[..., None]
          + jout2.astype(jnp.float32) * jnp.exp(jlse2 - jm)[..., None]).astype(jq.dtype)
    m = torch.from_numpy(np.asarray(jm))
    o = torch.from_numpy(np.asarray(jo.astype(jnp.float32))).to(tq_.dtype)
    jgrads = jpa.flash_chunk_bwd(jq, jk, jv, jo, jm, jg, causal, jseed, rate, interpret=True)
    grads = K.flash_chunk_bwd_plain(tq_, tk_, tv, o, m, tg, causal, seed, rate)
    for g, r in zip(grads, jgrads):
        assert g.dtype == tq_.dtype and _err(g, r) <= tol


def test_chunk_wrappers_check_shapes_and_count_no_cpu_launch():
    q = torch.zeros(2, 256, 8)
    k = torch.zeros(2, 384, 8)
    K.reset_launch_counts()
    K.flash_chunk_fwd(q, k, k, True)
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
    with pytest.raises(ValueError, match="leading axes"):
        K.flash_chunk_fwd(q, k[:1], k[:1], False)
    with pytest.raises(ValueError, match="seed"):
        K.flash_chunk_fwd(q, k, k, False, None, 0.2)
    with pytest.raises(ValueError, match="lse"):
        K.flash_chunk_bwd(q, k, k, q, torch.zeros(2, 1, 256), q, True)
    assert K.flash_chunk_eligible(256, 384, 64) and not K.flash_chunk_eligible(200, 256, 64)
    assert not K.flash_chunk_eligible(256, 256, 320)


# ------------------------------------------------------------------ dense core


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(24, 24), (40, 16), (256, 256)])
def test_dense_chunk_core_matches_jax(tq, tk, causal, rate):
    """``chunk_fwd_dense`` / ``chunk_bwd_dense`` against ``chunk_fwd_jnp`` /
    ``chunk_bwd_jnp`` (f32): the chunk-level mask keyed by the linearised
    leading index, iq = jk = 0."""
    rng = np.random.default_rng(tq * tk)
    (jq, q), (jg, g) = (_pair((2, 3, tq, 8), "float32", rng) for _ in range(2))
    (jk, k), (jv, v) = (_pair((2, 3, tk, 8), "float32", rng) for _ in range(2))
    seed = 987654321 if rate else None
    jseed = jnp.asarray(987654321, jnp.int32) if rate else None
    jout, jlse = jatt.chunk_fwd_jnp(jq, jk, jv, causal, jseed, rate)
    out, lse = tatt.chunk_fwd_dense(q, k, v, causal, seed, rate)
    assert _err(out, jout) <= 1e-5 and _err(lse, jlse) <= 1e-5
    jgrads = jatt.chunk_bwd_jnp(jq, jk, jv, jout, jlse, jg, causal, jseed, rate)
    grads = tatt.chunk_bwd_dense(q, k, v, out, lse, g, causal, seed, rate)
    for a, r in zip(grads, jgrads):
        assert _err(a, r) <= 1e-5


@pytest.mark.parametrize("t", [256, 512, 1024])
def test_dense_and_kernel_chunk_masks_agree_up_to_one_block(t):
    """The dense mirror keys its mask per chunk, the kernels per JAX block of
    at most 512: for chunks of one block (t <= 512) the two masks, and so
    the outputs, are the same; for longer chunks they are not."""
    rng = np.random.default_rng(t)
    q, k, v = (torch.from_numpy(_normal((2, t, 8), rng)) for _ in range(3))
    dense = tatt.chunk_fwd_dense(q, k, v, False, 42, 0.3)[0]
    plain = K.flash_chunk_fwd_plain(q, k, v, False, 42, 0.3)[0]
    same = bool(torch.allclose(dense, plain, atol=1e-5))
    assert same == (t <= K.FLASH_BLOCK)


def test_chunk_dispatch_follows_the_jax_rules():
    q = torch.zeros(2, 256, 8)
    assert not tatt._chunk_use_kernel(q, q, "jnp")
    assert not tatt._chunk_use_kernel(q, q, "auto")  # the card only
    assert tatt._chunk_use_kernel(q, q, "pallas")  # on the CPU: K7's plain version
    assert not tatt._chunk_use_kernel(torch.zeros(2, 200, 8), q, "pallas")
    with pytest.raises(ValueError, match="impl"):
        tatt._chunk_use_kernel(q, q, "bogus")


def test_fold_key_equals_jax():
    for key in ((1, 2), (4294967295, 123456789)):
        for i in (0, 1, 2, 77):
            ref = jatt.fold_key(jnp.asarray(key, jnp.uint32), i)
            assert tatt.fold_key(key, i) == tuple(int(x) for x in np.asarray(ref))


# ------------------------------------------------------------------ the ring


def _jax_ring(q, k, v, g, p_size, impl, rate):
    mesh = Mesh(np.array(jax.devices()[:p_size]), ("seq",))
    spec = PS(None, None, "seq", None)
    key = jnp.asarray(SALTS)

    def body(q, k, v, key):
        return jax_ring_local(q, k, v, "seq", impl, rate, key if rate else None, train=rate > 0)

    f = shard_map(body, mesh=mesh, in_specs=(spec, spec, spec, PS()), out_specs=spec,
                  check_rep=False)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: f(q, k, v, key), q, k, v)
        return (out,) + vjp(g)

    return run(q, k, v, g)


@pytest.mark.parametrize("p_size,t", [(2, 512), (4, 1024)])
def test_ring_on_gloo_ranks_matches_jax_ring(p_size, t, jax_chunks_interpret):
    """Ring attention over P gloo ranks (values and q/k/v gradients) against
    the JAX ring under shard_map on P CPU devices: dense chunks (``jnp``)
    and the chunk kernels (``pallas``: K7's plain versions here, the Pallas
    chunk kernels in interpret mode there; chunks of 256), dropout 0 and
    0.3. Every rank returns the same whole output and gradients."""
    rng = np.random.default_rng(p_size)
    shape = (2, 3, t, 16) if p_size == 2 else (1, 2, t, 16)
    arrays = [_normal(shape, rng) for _ in range(4)]
    cases = [(impl, rate) for impl in ("jnp", "pallas") for rate in (0.0, 0.3)]
    port = pmesh.run_ranks(
        torch_rank_bodies.ring_cases, p_size,
        ([tuple(torch.from_numpy(a) for a in arrays) + (impl, rate, tuple(int(s) for s in SALTS))
          for impl, rate in cases],), timeout=RANK_TIMEOUT)
    for (impl, rate), got in zip(cases, port[0]):
        ref = _jax_ring(*(jnp.asarray(a) for a in arrays), p_size, impl, rate)
        for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
            assert _err(a, r) <= 1e-5, (impl, rate, name)
    for other in port[1:]:
        for a, b in zip(other, port[0]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ training


CP_MODEL = dict(vocab_sizes=(13, 7, 9), cross_attention=(True, False, True), n_embd=32,
                n_head=2, n_layer=2, block_size=512, attn_impl="pallas", dropout=0.2)


def test_cp_training_step_and_trajectory_match_jax(jax_chunks_interpret):
    """One context-parallel training step (loss and every gradient leaf) and
    a 5-step trajectory (losses, every parameter's change) of the port's
    sequence-parallel Trainer over 2 gloo ranks against the JAX package's
    loss under its context-parallel scope on a sequence mesh of 2 (what its
    ``make_sharded_trainer`` traces), with optax AdamW on the same batches
    and salts. Block size 512 gives chunks of 256, so every ring runs K7's
    plain versions (the Pallas chunk kernels in interpret mode there), with
    dropout 0.2. Both ranks end with the same gradients and parameters, with
    no all-reduce. The step with ``remat`` gives the same bits."""
    jcfg = JaxConfig(**CP_MODEL)
    jparams = jax_init(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(3)
    steps = 5
    batches = []
    for _ in range(steps):
        ids = np.stack([rng.integers(0, v, (1, 513)) for v in CP_MODEL["vocab_sizes"]])
        batches.append((ids[..., :-1].astype(np.int32), ids[..., 1:].astype(np.int32)))
    salts = [(int(a), int(b)) for a, b in rng.integers(0, 2**32, (steps, 2), dtype=np.uint64)]

    mesh = make_mesh(1, 1, jax.devices()[:2], seq=2)
    with jatt.context_parallel_scope(mesh, "seq"):
        from trade_aid_multimodal_transformer_tpu.models.transformer import total_loss as jax_loss

        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p, x, y, k: jax_loss(p, jcfg, x, y, k, True), has_aux=True))(
            jparams, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]),
            jnp.asarray(salts[0], jnp.uint32))
        jp, jlosses = _jax_trajectory(jcfg, jparams, jax_make_optimizer(1e-3), batches, salts, 1)

    tparams = map_tree(lambda t: t.requires_grad_(),
                       params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))
    port = pmesh.run_ranks(torch_rank_bodies.cp_training, 2,
                           (CP_MODEL, tparams, batches, salts, {}), timeout=RANK_TIMEOUT)
    loss, grads, losses, final, (rloss, rgrads) = port[0]
    # remat recomputes each block under the ring's scope: the same bits
    assert rloss == loss
    for a, b in zip(rgrads, grads, strict=True):
        np.testing.assert_array_equal(a, b)
    assert abs(loss - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    assert max(_leaf_errs(grads, jleaves)) <= 1e-5
    np.testing.assert_allclose(losses, jlosses, atol=1e-5 * max(1.0, max(jlosses)), rtol=0)
    init = jax.tree_util.tree_leaves(jparams)
    jdelta = [np.asarray(a, np.float32) - np.asarray(b, np.float32)
              for a, b in zip(jax.tree_util.tree_leaves(jp), init)]
    tdelta = [f - np.asarray(b, np.float32) for f, b in zip(final, init)]
    assert max(_leaf_errs(tdelta, jdelta)) <= 1e-4
    # the same gradients and parameters on both ranks
    assert port[1][0] == loss and port[1][2] == losses
    for a, b in zip(port[1][1] + port[1][3], grads + final):
        np.testing.assert_array_equal(a, b)


def _demo_dir(tmp_path: Path) -> Path:
    """The JAX package's context-parallel entry case (tests/
    test_context_parallel.py): the demo config with 2 steps, 2 eval
    iterations and ``context_parallel: 2``, here on the CPU and with
    ``mesh: off`` so that the JAX runner plans the same 2 devices as the
    port (its 8 test devices would add data parallelism)."""
    text = (REPO / "examples" / "demo_config.yaml").read_text()
    text = text.replace("max_iters: 50", "max_iters: 2")
    text = text.replace("eval_interval: 25", "eval_interval: 25\n  eval_iters: 2")
    text = text.replace("device: auto", "device: cpu")
    text = text.replace("tpu_options:\n", "tpu_options:\n  context_parallel: 2\n  mesh: \"off\"\n")
    (tmp_path / "config.yaml").write_text(text)
    shutil.copy(REPO / "examples" / "demo_input_schemas.yaml", tmp_path / "input_schemas.yaml")
    (tmp_path / "examples" / "demo_data").mkdir(parents=True)
    shutil.copy(REPO / "examples" / "demo_data" / "demo_stock.csv",
                tmp_path / "examples" / "demo_data" / "demo_stock.csv")
    return tmp_path


def test_run_training_with_context_parallel_matches_jax_entry(tmp_path, monkeypatch, capfd):
    """``tpu_options.context_parallel: 2`` through the port's entry: two
    gloo rank processes, rank 0's console equal to the JAX runner's line for
    line once numbers are masked, the same two ``Parallelism:`` lines
    unmasked (the plan and the train state's size), the demo goldens."""
    from trade_aid_multimodal_transformer_tpu.config.accessors import reset_config_cache
    from trade_aid_multimodal_transformer_tpu.train.runner import run_training as jax_run

    monkeypatch.chdir(_demo_dir(tmp_path))
    outs = []
    try:
        jax_compat.reset_compatibility_layer()
        reset_config_cache()
        jres = jax_run(caller_globals={}, seed=0)
        outs.append(capfd.readouterr().out.splitlines())
        port_compat.reset_compatibility_layer()
        res = runner.run_training(caller_globals={}, seed=0, rank_timeout=RANK_TIMEOUT)
        outs.append(capfd.readouterr().out.splitlines())
    finally:
        jax_compat.reset_compatibility_layer()
        reset_config_cache()
        port_compat.reset_compatibility_layer()
    par = [[line for line in out if line.startswith("Parallelism:")] for out in outs]
    assert par[0] == par[1] == ["Parallelism: context x2 over 2 devices", par[0][1]]
    assert par[0][1].startswith("Parallelism: train state:")
    masked = [[re.sub(r"\d+(\.\d+)?", "#", line) for line in out] for out in outs]
    assert masked[0] == masked[1]
    assert res["vocabularies"][1] == jres["vocabularies"][1] == [-3, 0, 2]
    assert np.isfinite(res["losses"]["train"]) and res["plan"].seq == 2
    assert isinstance(res["params"]["pre"]["pos_emb"], torch.Tensor)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_run_training_ranks_end_with_equal_parameters(tmp_path, monkeypatch, capfd, rate):
    """The context-parallel entry keeps every rank's parameters equal with
    no all-reduce: each of the 2 gloo ranks returns its parameters' checksum
    (float64 sum and SHA-256 of the bytes), which must be equal, at dropout 0
    and 0.2. One thread per rank (a thread split that varies with the load
    changes last bits between ranks on the CPU)."""
    d = _demo_dir(tmp_path)
    text = (d / "config.yaml").read_text()
    assert text.count("dropout: 0.1") == 1
    (d / "config.yaml").write_text(text.replace("dropout: 0.1", f"dropout: {rate}"))
    monkeypatch.chdir(d)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    try:
        port_compat.reset_compatibility_layer()
        res = runner.run_training(caller_globals={}, seed=3, rank_timeout=RANK_TIMEOUT)
    finally:
        port_compat.reset_compatibility_layer()
    capfd.readouterr()
    sums = res["param_checksums"]
    assert len(sums) == 2 and sums[0] == sums[1], sums
    assert sums[0] == runner.param_checksum(res["params"])
    assert np.isfinite(sums[0]["sum"]) and np.isfinite(res["losses"]["train"])
