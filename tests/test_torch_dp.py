"""The port's data parallelism (``tpu_options.mesh`` data axis, and data x
sequence) held against the JAX package on the CPU.

A data-parallel step must compute what the one-rank step computes on the
global batch: every rank keeps its rows of the global batch, and every
dropout mask is keyed by global batch rows (``layers.batch_slice_scope``),
in ``hash_keep_mask_nd`` and in the plain versions of K1f, K1b, K2f, K2b,
K5f, K5b and K6f-r, whose global calls tests/test_torch_kernels.py,
test_torch_flash.py and test_torch_ring.py hold against the Pallas kernels
in interpret mode. The ranks are spawned gloo processes
(tests/torch_rank_bodies.py, which imports no JAX), each spawn joined under
a time limit, one thread per rank. Tolerances:
- masks: bit for bit (the same integer hash at the same global rows);
- a rank's kernel outputs against the global plain call's rows: max-abs
  1e-6 * max(1, max|ref|) in f32 (the same arithmetic; weight gradients
  summed over the ranks in another order);
- one step against JAX's ``total_loss`` under ``jax.value_and_grad`` on the
  global batch (f32, dropout 0.2): loss 1e-5 * max(1, |loss|), every
  gradient leaf 1e-5 by its L2 error against its own scale; a 5-step AdamW
  trajectory's parameter changes 1e-4 (``_leaf_errs`` of
  tests/test_torch_train.py), every rank's parameters bit-equal;
- evaluation: wins and losses exactly the one-rank pass's.
"""

import functools
import re
from pathlib import Path

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from trade_aid_multimodal_transformer_tpu.config import compat as jax_compat
from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.init import init_params as jax_init
from trade_aid_multimodal_transformer_tpu.models.transformer import total_loss as jax_loss
from trade_aid_multimodal_transformer_tpu.ops import attention as jatt
from trade_aid_multimodal_transformer_tpu.ops import layers as jl
from trade_aid_multimodal_transformer_tpu.ops import pallas_attention as jpa
from trade_aid_multimodal_transformer_tpu.parallel import make_mesh as jax_make_mesh
from trade_aid_multimodal_transformer_tpu.train.steps import make_optimizer as jax_make_optimizer
from trade_aid_multimodal_transformer_tpu_torch.config import compat as port_compat
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import map_tree, tree_leaves
from trade_aid_multimodal_transformer_tpu_torch.models.transformer import total_loss
from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
from trade_aid_multimodal_transformer_tpu_torch.ops import layers as tl
from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import rank_seed
from trade_aid_multimodal_transformer_tpu_torch.sampling.feed import BatchFeed
from trade_aid_multimodal_transformer_tpu_torch.train import runner
from trade_aid_multimodal_transformer_tpu_torch.train.metrics import build_metric_specs
from trade_aid_multimodal_transformer_tpu_torch.train.steps import StepRng, Trainer, make_optimizer

import torch_rank_bodies  # noqa: E402  (tests/ is on the path)
from test_torch_ring import CP_MODEL, _demo_dir, jax_chunks_interpret  # noqa: E402,F401
from test_torch_train import _leaf_errs  # noqa: E402

RANK_TIMEOUT = 240.0
SALTS = (123456789, 3141592653)
RATE = 0.2
SIZES = (2, 4)
# the model of the steps: four modalities (M > 1), two cross-attending to
# J = 3 streams, at block_size 64 (the whole-row band: with the card's
# dispatch the fused K1 and the cross K2 run, here their plain versions)
DP_MODEL = dict(vocab_sizes=(13, 7, 9, 11), cross_attention=(True, False, True, False),
                n_embd=32, n_head=2, n_layer=1, block_size=64, attn_impl="pallas", dropout=RATE)
# data x seq: the context-parallel tests' model (block_size 512, chunks of
# 256: K7's plain versions in the rings) at one layer
DXS_MODEL = dict(CP_MODEL, n_layer=1)
GLOBAL_B, STEPS = 8, 5


def _err(got, ref) -> float:
    got, ref = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float64)
                for x in (got, ref))
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _normal(shape, rng):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# ------------------------------------------------------------------ masks


# (global shape, batch axis): the sites' layouts (M, B, T, C), the dense
# cross core's (J, B, H, T, T) affinity, a cross output (B, T, C)
ND_CASES = {"MBTC": ((3, 8, 5, 16), 1), "JBHTT": ((3, 8, 2, 6, 6), 1), "BTC": ((8, 5, 16), 0)}


@pytest.mark.parametrize("case", sorted(ND_CASES))
@pytest.mark.parametrize("p_size", SIZES)
def test_hash_keep_mask_nd_keyed_by_global_rows_equals_jax(p_size, case):
    """Each rank's ``hash_keep_mask_nd`` (and ``dropout``) inside its batch
    slice scope is bit-equal to its rows of JAX's mask on the global shape."""
    shape, axis = ND_CASES[case]
    ref = np.asarray(jl.hash_keep_mask_nd(jnp.uint32(SALTS[0]), jnp.uint32(SALTS[1]), shape, RATE))
    per = shape[axis] // p_size
    local = shape[:axis] + (per,) + shape[axis + 1:]
    for r in range(p_size):
        want = np.take(ref, range(r * per, (r + 1) * per), axis=axis)
        with tl.batch_slice_scope(r * per, shape[axis]):
            rows = tl.batch_row_map(local[:-2], axis)
            got = tl.hash_keep_mask_nd(*SALTS, local, RATE, rows=rows)
            dropped = tl.dropout(torch.ones(local), RATE, SALTS, True, batch_axis=axis)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(dropped.numpy() != 0, want)
    # outside the scope (or without a batch axis) the one-rank mask
    assert tl.batch_row_map(local[:-2], axis) is None
    np.testing.assert_array_equal(tl.hash_keep_mask_nd(*SALTS, shape, RATE).numpy(), ref)


# ------------------------------------------------------------------ kernels


def _k1(p_size, rng):
    """K1f / K1b: x (M, B, T, C) with the global batch's gb > a rank's B."""
    M, B, T, C, H, hs = 2, GLOBAL_B, 16, 32, 2, 16
    x = _normal((M, B, T, C), rng)
    w1, b1 = _normal((M, C, 3 * H * hs // 2), rng) * 0.1, _normal((M, 3 * H * hs // 2), rng) * 0.1
    w2 = _normal((M, 3 * H, hs // 2, hs), rng) * 0.2
    gb = K.fqkv_pick_gb(B, H, T, hs, C, 4)
    assert gb > B // p_size  # the mask's batch group spans ranks
    dout = _normal((M, H, B, T, hs), rng)
    ref_keep = K._fqkv_mask(x, w2, H, RATE, SALTS)
    ref_out = K.fused_qkv_attention_plain(x, w1, b1, w2, H, RATE, SALTS)
    ref_grads = K.fused_qkv_attention_bwd_plain(x, w1, b1, w2, ref_out, dout, H, RATE, SALTS)
    per, sums = B // p_size, None
    for r in range(p_size):
        sl = slice(r * per, (r + 1) * per)
        xl, dl, batch = x[:, sl].contiguous(), dout[:, :, sl].contiguous(), (r * per, B)
        np.testing.assert_array_equal(K._fqkv_mask(xl, w2, H, RATE, SALTS, batch).numpy(),
                                      ref_keep[:, :, sl].numpy())
        xg = xl.clone().requires_grad_()
        out = K.fused_qkv_attention(xg, w1, b1, w2, H, RATE, SALTS, batch)
        assert _err(out, ref_out[:, :, sl]) <= 1e-6
        dx, dw1, db1, dw2 = K.fused_qkv_attention_bwd_plain(xl, w1, b1, w2, out.detach(), dl, H,
                                                            RATE, SALTS, batch)
        (dxa,) = torch.autograd.grad(out, xg, dl)  # the wrapper's backward
        np.testing.assert_array_equal(dxa.numpy(), dx.numpy())
        assert _err(dx, ref_grads[0][:, sl]) <= 1e-6
        sums = [dw1, db1, dw2] if sums is None else [a + b for a, b in zip(sums, (dw1, db1, dw2))]
    assert max(_err(a, b) for a, b in zip(sums, ref_grads[1:])) <= 1e-6


def _k2(p_size, rng):
    """K2f / K2b: head-major q (H, B, T, hs), k, v (J, H, B, T, hs)."""
    J, H, B, T, hs = 3, 2, GLOBAL_B, 16, 16
    q, dout = _normal((H, B, T, hs), rng), _normal((H, B, T, hs), rng)
    k, v = _normal((J, H, B, T, hs), rng), _normal((J, H, B, T, hs), rng)
    ref_keep = K._cross_mask(q, J, RATE, SALTS)
    ref_out = K.short_cross_attention_plain(q, k, v, RATE, SALTS)
    ref_grads = K.short_cross_attention_bwd_plain(q, k, v, dout, RATE, SALTS)
    per = B // p_size
    for r in range(p_size):
        sl = slice(r * per, (r + 1) * per)
        ql, kl, vl, dl = (t[..., sl, :, :].contiguous() for t in (q, k, v, dout))
        with tl.batch_slice_scope(r * per, B):
            rows = tl.batch_row_map(ql.shape[:-2], 1)
        np.testing.assert_array_equal(K._cross_mask(ql, J, RATE, SALTS, rows).numpy(),
                                      ref_keep[:, :, sl].numpy())
        qg, kg, vg = (t.clone().requires_grad_() for t in (ql, kl, vl))
        out = K.short_cross_attention(qg, kg, vg, RATE, SALTS, rows)
        assert _err(out, ref_out[:, sl]) <= 1e-6
        grads = torch.autograd.grad(out, (qg, kg, vg), dl)
        for g, ref in zip(grads, ref_grads):
            assert _err(g, ref[..., sl, :, :]) <= 1e-6


def _k5(p_size, rng):
    """K5f / K5b: self-attention rows (M, B, H) collapsed, T 256 (one
    flash block); a rank's rows are not contiguous in the global call's."""
    M, B, H, T, hs = 2, GLOBAL_B, 2, 256, 16
    q, k, v, dout = (_normal((M, B, H, T, hs), rng) for _ in range(4))
    seed = K._flash_seed(RATE, SALTS, None)
    n = M * B * H
    ref_keep = K._flash_keep(seed, n, 0, 0, T, T, RATE, None)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    ref_out = K.flash_causal_attention(qg, kg, vg, RATE, SALTS)
    ref_grads = torch.autograd.grad(ref_out, (qg, kg, vg), dout)
    per = B // p_size
    for r in range(p_size):
        sl = slice(r * per, (r + 1) * per)
        ql, kl, vl, dl = (t[:, sl].contiguous() for t in (q, k, v, dout))
        with tl.batch_slice_scope(r * per, B):
            rows = tl.batch_row_map(ql.shape[:-2], 1)
        n_l = M * per * H
        idx = tl.map_rows(torch.arange(n_l), rows)
        np.testing.assert_array_equal(K._flash_keep(seed, n_l, 0, 0, T, T, RATE, None, rows).numpy(),
                                      ref_keep[idx].numpy())
        qg, kg, vg = (t.clone().requires_grad_() for t in (ql, kl, vl))
        out = K.flash_causal_attention(qg, kg, vg, RATE, SALTS, rows)
        assert _err(out, ref_out[:, sl]) <= 1e-6
        grads = torch.autograd.grad(out, (qg, kg, vg), dl)
        for g, ref in zip(grads, ref_grads):
            assert _err(g, ref[:, sl]) <= 1e-6


def _k6(p_size, rng):
    """K6f-r forward (each stream's output and lse) and K5b per stream with
    its stream seed: q (B, H, T, hs), k, v (J, B, H, T, hs), JAX's order."""
    J, B, H, T, hs = 2, GLOBAL_B, 2, 256, 16
    q, dout = _normal((B, H, T, hs), rng), _normal((B, H, T, hs), rng)
    k, v = _normal((J, B, H, T, hs), rng), _normal((J, B, H, T, hs), rng)
    flat = lambda t, lead: t.reshape(*lead, T, hs)  # noqa: E731
    ref = K.flash_cross_attention_res(flat(q, (-1,)), flat(k, (J, -1)), flat(v, (J, -1)),
                                      RATE, SALTS)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    ref_grads = torch.autograd.grad(K.flash_cross_attention(qg, kg, vg, RATE, SALTS),
                                    (qg, kg, vg), dout)
    per = B // p_size
    for r in range(p_size):
        sl = slice(r * per, (r + 1) * per)
        ql, dl = q[sl].contiguous(), dout[sl].contiguous()
        kl, vl = k[:, sl].contiguous(), v[:, sl].contiguous()
        with tl.batch_slice_scope(r * per, B):
            rows = tl.batch_row_map(ql.shape[:-2], 0)
        got = K.flash_cross_attention_res(flat(ql, (-1,)), flat(kl, (J, -1)), flat(vl, (J, -1)),
                                          RATE, SALTS, rows)
        rs = slice(r * per * H, (r + 1) * per * H)  # a rank's rows are contiguous here
        assert _err(got[0], ref[0][rs]) <= 1e-6
        assert _err(got[1], ref[1][:, rs]) <= 1e-6 and _err(got[2], ref[2][:, rs]) <= 1e-6
        qg, kg, vg = (t.clone().requires_grad_() for t in (ql, kl, vl))
        grads = torch.autograd.grad(K.flash_cross_attention(qg, kg, vg, RATE, SALTS, rows),
                                    (qg, kg, vg), dl)
        for g, rg, lead in zip(grads, ref_grads, (0, 1, 1)):
            assert _err(g, rg[sl] if lead == 0 else rg[:, sl]) <= 1e-6


@pytest.mark.parametrize("kernel", ["K1", "K2", "K5", "K6"])
@pytest.mark.parametrize("p_size", SIZES)
def test_kernel_plain_versions_key_global_rows(p_size, kernel):
    """The plain versions of K1f and K1b (with the global batch's gb), K2f
    and K2b, K5f and K5b, and K6f-r with K5b per stream, on each rank's rows
    of a global batch at dropout 0.2: masks bit-equal to the global call's
    rows, outputs and gradients within 1e-6 of its rows (weight gradients:
    of its sums over the ranks)."""
    {"K1": _k1, "K2": _k2, "K5": _k5, "K6": _k6}[kernel](p_size, np.random.default_rng(p_size))


def test_row_map_is_the_identity_outside_a_batch_slice():
    """Without a data axis the row arguments change nothing: the identity
    map, and K1's batch of its own rows, give the one-rank bits."""
    rng = np.random.default_rng(0)
    q, k, v = _normal((2, 3, 16, 8), rng), _normal((3, 2, 3, 16, 8), rng), _normal((3, 2, 3, 16, 8), rng)
    assert tl.batch_row_map(q.shape[:-2], 1) is None
    assert torch.equal(K.short_cross_attention(q, k, v, RATE, SALTS, K.IDENTITY_ROWS),
                       K.short_cross_attention(q, k, v, RATE, SALTS))
    x = _normal((2, 4, 8, 16), rng)
    w1, b1, w2 = _normal((2, 16, 24), rng), _normal((2, 24), rng), _normal((2, 6, 4, 8), rng)
    assert torch.equal(K.fused_qkv_attention(x, w1, b1, w2, 2, RATE, SALTS, (0, 4)),
                       K.fused_qkv_attention(x, w1, b1, w2, 2, RATE, SALTS))
    with pytest.raises(ValueError, match="outside a batch"):
        K.fused_qkv_attention(x, w1, b1, w2, 2, RATE, SALTS, (2, 4))


# ------------------------------------------------------------------ steps


def _jax_dispatch(mp):
    """The JAX model's TPU dispatch on the CPU: its fused and transposed
    cross kernels in interpret mode (so both sides run the whole-row band's
    kernels, here and there their mask streams)."""
    mp.setattr(jatt, "_on_tpu", lambda: True)
    for name in ("fused_qkv_attention", "short_cross_attention_t"):
        mp.setattr(jpa, name, functools.partial(getattr(jpa, name), interpret=True))


def _dp_batches(cfg_kw, n, B, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = np.stack([rng.integers(0, v, (B, cfg_kw["block_size"] + 1))
                        for v in cfg_kw["vocab_sizes"]])
        out.append((ids[..., :-1].astype(np.int32), ids[..., 1:].astype(np.int32)))
    return out


def _dp_feed_args(cfg_kw, seed):
    """A small numeric series per modality for the feed, and its vocabularies."""
    rng = np.random.default_rng(seed)
    V = cfg_kw["vocab_sizes"]
    return {"train": [rng.integers(0, v, 400) for v in V], "val": [rng.integers(0, v, 200) for v in V],
            "file_lengths": [600], "rand_sizes": [1, None, 2, None],
            "vocabs": [list(np.linspace(-1.0, 1.0, v)) for v in V]}


@pytest.fixture(scope="module")
def dp_runs():
    """JAX's step and trajectory on the global batch, its batch constrained
    inside ``jax.jit`` to a data mesh of 4 CPU devices, the finest split
    here (the sharding changes no value: one compile of the interpret-mode
    kernels under GSPMD, ~40 s, serves both P), and the port's
    data-parallel ranks for P = 2 and 4."""
    jcfg = JaxConfig(**DP_MODEL)
    jparams = jax_init(jax.random.PRNGKey(5), jcfg)
    batches = _dp_batches(DP_MODEL, STEPS, GLOBAL_B, 6)
    salts = [(int(a), int(b)) for a, b in
             np.random.default_rng(7).integers(0, 2**32, (STEPS, 2), dtype=np.uint64)]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    opt = jax_make_optimizer(1e-3)
    shard = NamedSharding(Mesh(np.asarray(jax.devices()[:max(SIZES)]), ("data",)),
                          PS(None, "data", None))
    with pytest.MonkeyPatch.context() as mp:
        _jax_dispatch(mp)
        vg = jax.jit(jax.value_and_grad(
            lambda p, x, y, k: jax_loss(p, jcfg, jax.lax.with_sharding_constraint(x, shard),
                                        jax.lax.with_sharding_constraint(y, shard), k, True),
            has_aux=True))
        state, p, losses, first = opt.init(jparams), jparams, [], None
        for (xb, yb), key in zip(batches, salts):
            (loss, _), g = vg(p, jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(key, jnp.uint32))
            first = first or (float(loss), jax.tree_util.tree_leaves(g))
            u, state = opt.update(g, state, p)
            p = optax.apply_updates(p, u)
            losses.append(float(loss))
    out = {"jax_step": first, "jax_losses": losses,
           "jax_delta": [np.asarray(a, np.float32) - np.asarray(b, np.float32)
                         for a, b in zip(jax.tree_util.tree_leaves(p),
                                         jax.tree_util.tree_leaves(jparams))],
           "init": [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(jparams)],
           "tparams": tparams}
    for p_size in SIZES:
        out[p_size] = pmesh.run_ranks(torch_rank_bodies.dp_cases, p_size, (dict(
            cfg=DP_MODEL, params=tparams, batches=batches, salts=salts, steps=STEPS,
            kernel_dispatch=True, batch=GLOBAL_B, feed=_dp_feed_args(DP_MODEL, 8), seed=11,
            eval_iters=2),), timeout=RANK_TIMEOUT)
    return out


@pytest.mark.parametrize("p_size", SIZES)
def test_data_parallel_step_matches_jax_on_the_global_batch(dp_runs, p_size):
    """One step of the data-parallel Trainer over P gloo ranks (dropout 0.2,
    the whole-row band's fused and cross kernels' plain versions) against
    JAX's ``total_loss`` under ``value_and_grad`` on the global batch (its
    Pallas kernels in interpret mode): loss and every all-reduced gradient
    leaf, the same on every rank."""
    jloss, jgrads = dp_runs["jax_step"]
    got = dp_runs[p_size][0]
    assert abs(got["loss"] - jloss) <= 1e-5 * max(1.0, abs(jloss))
    assert len(jgrads) == len(got["grads"])
    assert max(_leaf_errs(got["grads"], jgrads)) <= 1e-5
    for other in dp_runs[p_size][1:]:
        assert other["loss"] == got["loss"]
        for a, b in zip(other["grads"], got["grads"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p_size", SIZES)
def test_data_parallel_trajectory_matches_jax_and_keeps_ranks_equal(dp_runs, p_size):
    """Five AdamW steps over P ranks against JAX's on the global batches:
    the losses, every parameter's change within 1e-4, and every rank's
    parameters bit-equal."""
    got = dp_runs[p_size][0]
    np.testing.assert_allclose(got["losses"], dp_runs["jax_losses"],
                               atol=1e-5 * max(1.0, max(dp_runs["jax_losses"])), rtol=0)
    delta = [a - b for a, b in zip(got["params"], dp_runs["init"])]
    assert max(_leaf_errs(delta, dp_runs["jax_delta"])) <= 1e-4
    for other in dp_runs[p_size][1:]:
        for a, b in zip(other["params"], got["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture
def one_thread():
    """One thread for a test's single-process reference, as every rank runs
    (a thread split that varies with the load moves last bits), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feed_and_specs(seed):
    f = _dp_feed_args(DP_MODEL, seed)
    feed = BatchFeed(f["train"], f["val"], f["file_lengths"], DP_MODEL["block_size"], GLOBAL_B,
                     False, f["rand_sizes"], list(DP_MODEL["vocab_sizes"]))
    return feed, build_metric_specs(f["vocabs"], [False] * 4, DP_MODEL["block_size"])


@pytest.mark.parametrize("p_size", SIZES)
def test_data_parallel_eval_pass_equals_the_one_rank_pass(dp_runs, p_size, monkeypatch,
                                                         one_thread):
    """The evaluation pass over P ranks (each its rows of the global
    batches, the sums all-reduced) against the one-rank pass on the global
    batches: wins and losses exactly, mean losses and certainty to 1e-6."""
    monkeypatch.setattr(tatt, "_kernel_device", lambda device, impl: impl != "jnp")
    feed, specs = _feed_and_specs(8)
    params = map_tree(lambda t: t.detach().clone(), dp_runs["tparams"])
    ref = Trainer(ModelConfig(**DP_MODEL), feed, make_optimizer(1e-3), specs, 2).eval_pass(
        params, StepRng(11, "cpu"), "val")
    assert int(ref.wins.sum()) + int(ref.losses.sum()) == 4 * 2 * GLOBAL_B  # every modality
    for got in (r["eval"] for r in dp_runs[p_size]):
        np.testing.assert_array_equal(got["wins"], ref.wins.numpy())
        np.testing.assert_array_equal(got["losses"], ref.losses.numpy())
        for name in ("mean_loss", "mean_losses", "certainty"):
            assert _err(got[name], getattr(ref, name)) <= 1e-6, name


@pytest.mark.parametrize("p_size", SIZES)
def test_shard_map_dp_step_equals_per_rank_replay(dp_runs, p_size, monkeypatch, one_thread):
    """``make_shard_map_dp_step`` over P ranks (each draws its own B / P
    rows from ``rank_seed(seed, rank)``) against a replay of every rank's
    draw on one process with the gradients averaged, as the JAX package's
    ``TestShardMapDP`` holds its step."""
    monkeypatch.setattr(tatt, "_kernel_device", lambda device, impl: impl != "jnp")
    feed, _ = _feed_and_specs(8)
    cfg = ModelConfig(**DP_MODEL)
    params = map_tree(lambda t: t.detach().clone().requires_grad_(), dp_runs["tparams"])
    opt = make_optimizer(1e-3)
    state = opt.init(params)
    loss_sum, grad_sum = 0.0, None
    for r in range(p_size):
        rng = StepRng(rank_seed(11, r), "cpu")
        xb, yb = feed.sample(rng.batch, "train", augment=True, batch_size=GLOBAL_B // p_size)
        loss, _ = total_loss(params, cfg, xb, yb, rng.salts(), True)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        loss_sum += loss.item() / p_size
        grad_sum = [g / p_size for g in grads] if grad_sum is None else [
            a + g / p_size for a, g in zip(grad_sum, grads)]
    opt.update_(params, grad_sum, state)
    assert len({rank_seed(11, r) for r in range(p_size)}) == p_size
    for got in dp_runs[p_size]:
        assert abs(got["dp_step_loss"] - loss_sum) <= 1e-5
        for a, b in zip(got["dp_step_params"], tree_leaves(params)):
            np.testing.assert_allclose(a, b.detach().numpy(), atol=1e-5, rtol=0)


def test_data_x_seq_step_matches_jax_folded_keys(jax_chunks_interpret):
    """{data: 2} x seq 2 (4 ranks, global rank d * 2 + s) at block_size
    512, dropout 0.2, global batch 2: one step against JAX's ``total_loss``
    under its context-parallel scope on ``make_mesh(2, 1, devices[:4],
    seq=2)``, whose rings key their masks by local rows with the key folded
    with the data rank, every other site by global rows. The ranks of a
    sequence group return the same gradients, every rank the same mean."""
    jcfg = JaxConfig(**DXS_MODEL)
    jparams = jax_init(jax.random.PRNGKey(2), jcfg)
    batches = _dp_batches(DXS_MODEL, 1, 2, 3)
    mesh = jax_make_mesh(2, 1, jax.devices()[:4], seq=2)
    with jatt.context_parallel_scope(mesh, "seq"):
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p, x, y, k: jax_loss(p, jcfg, x, y, k, True), has_aux=True))(
            jparams, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]),
            jnp.asarray(SALTS, jnp.uint32))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    ranks = pmesh.run_ranks(torch_rank_bodies.dp_cases, 4, (dict(
        cfg=DXS_MODEL, params=tparams, batches=batches, salts=[SALTS], seq=2),),
        timeout=RANK_TIMEOUT)
    got = ranks[0]
    assert abs(got["loss"] - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    assert max(_leaf_errs(got["grads"], jax.tree_util.tree_leaves(jgrads))) <= 1e-5
    for other in ranks[1:]:
        for a, b in zip(other["grads"], got["grads"]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ the entry


def _mesh_config(d: Path, mesh: str, cp: int, rate: float) -> Path:
    """The demo entry case of tests/test_torch_ring.py with ``mesh`` and
    ``context_parallel`` of our own and dropout ``rate``."""
    text = (d / "config.yaml").read_text()
    text = text.replace("  context_parallel: 2\n  mesh: \"off\"\n",
                        f"  context_parallel: {cp}\n  mesh: {mesh}\n")
    assert text.count("dropout: 0.1") == 1
    (d / "config.yaml").write_text(text.replace("dropout: 0.1", f"dropout: {rate}"))
    return d


def _run_entries(d: Path, capfd, jax_too: bool, seed: int = 0):
    """(port result, rank 0's console[, JAX console]) of the entry in d."""
    from trade_aid_multimodal_transformer_tpu.config.accessors import reset_config_cache
    from trade_aid_multimodal_transformer_tpu.train.runner import run_training as jax_run

    outs = []
    try:
        if jax_too:
            jax_compat.reset_compatibility_layer()
            reset_config_cache()
            jax_run(caller_globals={}, seed=seed)
            outs.append(capfd.readouterr().out.splitlines())
        port_compat.reset_compatibility_layer()
        res = runner.run_training(caller_globals={}, seed=seed, rank_timeout=RANK_TIMEOUT)
        outs.append(capfd.readouterr().out.splitlines())
    finally:
        jax_compat.reset_compatibility_layer()
        reset_config_cache()
        port_compat.reset_compatibility_layer()
    return res, outs


ENTRY_CASES = {"data2": ("{data: 2}", 1, "Parallelism: data x2 over 2 devices"),
               "data2_seq2": ("{data: 2}", 2, "Parallelism: data x2 * context x2 over 4 devices")}


@pytest.mark.parametrize("case", sorted(ENTRY_CASES))
def test_run_training_data_parallel_matches_jax_entry(tmp_path, monkeypatch, capfd, case):
    """``tpu_options.mesh: {data: 2}`` (and with ``context_parallel: 2``)
    through the port's entry on the CPU, dropout 0.2: rank 0's console equal
    to the JAX runner's once numbers are masked, the ``Parallelism:`` lines
    unmasked, every rank's parameter checksum equal; with {data: 2} alone
    the final losses within 1e-5 of the port's own ``mesh: off`` run with
    the same seed."""
    mesh, cp, line = ENTRY_CASES[case]
    d = _mesh_config(_demo_dir(tmp_path), mesh, cp, 0.2)
    monkeypatch.chdir(d)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res, outs = _run_entries(d, capfd, jax_too=True)
    par = [[x for x in out if x.startswith("Parallelism:")] for out in outs]
    assert par[0] == par[1] and par[0][0] == line, par
    masked = [[re.sub(r"\d+(\.\d+)?", "#", x) for x in out] for out in outs]
    assert masked[0] == masked[1]
    assert res["plan"].describe() == line[len("Parallelism: "):].split(" over")[0]
    sums = res["param_checksums"]
    assert len(sums) == 2 * cp and all(s == sums[0] for s in sums), sums
    assert sums[0] == runner.param_checksum(res["params"])
    if cp == 1:
        text =(d / "config.yaml").read_text().replace("mesh: {data: 2}", "mesh: \"off\"")
        (d / "config.yaml").write_text(text)
        one, _ = _run_entries(d, capfd, jax_too=False)
        assert "param_checksums" not in one and one["plan"].trivial
        for k in ("train", "val"):
            assert abs(res["losses"][k] - one["losses"][k]) <= 1e-5, (k, res["losses"], one["losses"])


@pytest.mark.parametrize("case", sorted(ENTRY_CASES))
def test_run_training_data_parallel_ranks_end_equal_without_dropout(tmp_path, monkeypatch,
                                                                    capfd, case):
    """The same entries at dropout 0: every rank's parameter checksum
    (float64 sum and SHA-256 of the bytes) equal after training."""
    mesh, cp, _ = ENTRY_CASES[case]
    d = _mesh_config(_demo_dir(tmp_path), mesh, cp, 0.0)
    monkeypatch.chdir(d)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res, _ = _run_entries(d, capfd, jax_too=False, seed=3)
    sums = res["param_checksums"]
    assert len(sums) == 2 * cp and all(s == sums[0] for s in sums), sums
    assert np.isfinite(sums[0]["sum"]) and np.isfinite(res["losses"]["train"])
