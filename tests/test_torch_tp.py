"""The port's tensor parallelism (``tpu_options.mesh`` model axis, alone, x
data and x FSDP) held against the JAX package on the CPU.

On a model axis of N ranks (N divides n_head) a rank keeps, of every leaf
that ``param_pspecs`` places on 'model', its slice (the block that device
(d, t) holds after the JAX package's ``shard_train_state(model_axis=True)``)
and runs the Megatron form of the one-rank step: its heads and columns,
``copy_to`` / ``reduce_from`` around the split products, every dropout mask
keyed by global heads (and rows). Where N does not divide n_head (three
heads over two ranks, the split of 6 heads over 4) the JAX placement keeps
the per-head leaves whole and splits the heads' columns: the attention
layers gather their split leaves and run whole on every rank. The JAX
package lets GSPMD partition the
unsharded step, so its contract is that step; the port is held to it. The
ranks are spawned gloo processes (tests/torch_rank_bodies.py ``mesh_cases``,
which imports no JAX), one spawn per layout, joined under a time limit,
one thread per rank. Tolerances:
- placements, parts and train-state bytes: equal (specs leaf for leaf,
  parts bit for bit, bytes to the byte);
- masks and the kernels' plain versions on a rank's heads: bit for bit
  against the global call's rows, values within 1e-6 * max(1, max|ref|)
  (tests/test_torch_dp.py's);
- one step against JAX's ``total_loss`` under ``jax.value_and_grad`` and
  its AdamW on the same global batch and salts (f32, dropout 0.2): the
  loss and the updated parameters within JAX's own tolerances for its
  sharded trainer against the unsharded one (tests/test_parallel.py
  ``test_train_chunk_matches_unsharded``: loss rtol 1e-5 atol 1e-6,
  parameters rtol 2e-4 atol 1e-5), every gradient leaf 1e-5 by its L2
  error against its own scale (``_leaf_errs``); every leaf the placement
  keeps whole bit-equal on every rank, before and after the update;
- evaluation: wins and losses exactly the one-rank pass's, the means 1e-6.
"""

import functools
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
from trade_aid_multimodal_transformer_tpu.ops import pallas_attention as jpa
from trade_aid_multimodal_transformer_tpu.parallel import make_mesh as jax_make_mesh
from trade_aid_multimodal_transformer_tpu.parallel.trainer import (
    shard_train_state as jax_shard_train_state,
)
from trade_aid_multimodal_transformer_tpu.train.steps import make_optimizer as jax_make_optimizer
from trade_aid_multimodal_transformer_tpu.utils.memory import train_state_bytes as jax_state_bytes
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax, shard_params
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import (
    map_tree, param_shapes, tree_leaves, tree_paths)
from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
from trade_aid_multimodal_transformer_tpu_torch.ops import layers as tl
from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import shard_train_state
from trade_aid_multimodal_transformer_tpu_torch.train import runner
from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import load_checkpoint
from trade_aid_multimodal_transformer_tpu_torch.train.steps import StepRng, Trainer, make_optimizer
from trade_aid_multimodal_transformer_tpu_torch.utils.memory import train_state_bytes

import torch_rank_bodies  # noqa: E402  (tests/ is on the path)
from test_torch_dp import (  # noqa: E402,F401
    RANK_TIMEOUT, SALTS, _dp_batches, _dp_feed_args, _err, _mesh_config, _normal, _run_entries,
    one_thread,
)
from test_torch_fsdp import TREES, _init, _jax_specs  # noqa: E402
from test_torch_ring import _demo_dir  # noqa: E402
from test_torch_train import _leaf_errs  # noqa: E402

RATE = 0.2
# the step model: four modalities, two cross-attending to J = 3 streams, 6
# heads of 8 (model 2: three a rank; model 3: two), the dense cores at
# block_size 64. Mixed placements at both sizes: tok_emb[0] (13 rows) stays
# whole, and heads[3] (V // 2 = 3 columns) at model 2, heads[2] (4) at 3
TP_MODEL = dict(vocab_sizes=(13, 12, 9, 6), cross_attention=(True, False, True, False),
                n_embd=48, n_head=6, n_layer=1, block_size=64, attn_impl="jnp", dropout=RATE)
# the flash band (T > 512, T % 128 == 0): the card's dispatch, K5f/K5b and
# K6f-r/K5b through their plain versions, JAX's flash kernels in interpret
# mode; two heads, one a rank
FLASH_MODEL = dict(TP_MODEL, vocab_sizes=(13, 8, 9), cross_attention=(True, False, True),
                   n_embd=32, n_head=2, block_size=640, attn_impl="pallas")
# three heads of 16 over two ranks: the model axis does not divide the
# heads, and splits w1_* / b1_* in columns of 12 and proj_w1 in rows of 24
# (a head and a half a rank), the placement of 6 heads over {model: 4}
SPLIT_MODEL = dict(TP_MODEL, n_head=3)
GLOBAL_B = 4
# (model config, data, model, fsdp, steps, global batch, kernel dispatch)
LAYOUTS = {"model2": (TP_MODEL, 1, 2, False, 2, GLOBAL_B, False),
           "split_heads_model2": (SPLIT_MODEL, 1, 2, False, 2, GLOBAL_B, False),
           "data2_model2_fsdp": (TP_MODEL, 2, 2, True, 2, GLOBAL_B, False),
           "mixed_model3": (TP_MODEL, 1, 3, False, 2, GLOBAL_B, False),
           "flash_model2": (FLASH_MODEL, 1, 2, False, 1, 2, True),
           "flash_data2_model2": (FLASH_MODEL, 2, 2, False, 1, 2, True)}


# ------------------------------------------------------------ placements


@pytest.mark.parametrize("model", (2, 3, 6))
def test_param_pspecs_model_axis_equal_jax_on_the_production_tree(model):
    """``param_pspecs(model_axis=True)`` leaf for leaf as the JAX package's
    on the production tree at model 2, 3 and 6; at 2 the placements that
    tests/test_parallel.py ``TestProductionTPCoverage`` pins, and more than
    90% of the bytes split."""
    jcfg = JaxConfig(**TREES["production"], dropout=0.0, attn_impl="jnp")
    jshapes = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    kw = dict(model_axis=True, model_size=model)
    want = _jax_specs(jshapes, jcfg.n_head, **kw)
    tshapes = param_shapes(ModelConfig(**TREES["production"]))
    got = pmesh.param_pspecs(tshapes, jcfg.n_head, **kw)
    assert got == want
    paths = ["/".join(map(str, p)) for p, _ in tree_paths(tshapes)]
    spec = dict(zip(paths, got))
    if model != 2:
        # 500 rows and 250 columns do not split in 3 or 6: that table and
        # its head stay whole, beside split ones (mixed placements)
        assert spec["pre/tok_emb/0"] == spec["post/heads/0/w1"] == ()
        assert spec["pre/tok_emb/1"] == ("model", None)
        return
    assert spec["blocks/0/ffwd/w1"] == (None, None, "model")
    assert spec["blocks/0/ffwd/w2"] == (None, "model", None)
    assert spec["blocks/0/sa/w1_q"] == (None, None, "model")
    assert spec["blocks/0/sa/w2_q"] == (None, "model", None, None)
    assert spec["blocks/0/sa/proj_w1"] == (None, "model", None)
    assert spec["blocks/0/cross/0/q_w"] == ("model", None, None)
    assert spec["blocks/0/cross/0/kv_w"] == (None, "model", None, None)
    assert spec["post/heads/0/w1"] == (None, "model")
    assert spec["post/heads/0/w2"] == ("model", None)
    assert spec["pre/tok_emb/0"] == ("model", None)
    sizes = [int(np.prod(s)) for _, s in tree_leaves(tshapes)]
    split = sum(n for n, s in zip(sizes, got) if "model" in s)
    assert split > 0.90 * sum(sizes)


def test_param_pspecs_model4_splits_the_production_heads_in_columns():
    """``{model: 4}`` on the production tree's 6 heads of 64 (hs/2 = 32), as
    the JAX package places it: w1_* and b1_* in columns of 48 (a head and a
    half a rank), sa.proj_w1 and cross.proj_w1 in rows of 96, the per-head
    leaves sa.w2_*, cross.q_w and cross.kv_w whole (4 does not divide 6)."""
    jcfg = JaxConfig(**TREES["production"], dropout=0.0, attn_impl="jnp")
    jshapes = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    want = _jax_specs(jshapes, jcfg.n_head, model_axis=True, model_size=4)
    tshapes = param_shapes(ModelConfig(**TREES["production"]))
    got = pmesh.param_pspecs(tshapes, jcfg.n_head, model_axis=True, model_size=4)
    assert got == want
    spec = dict(zip(["/".join(map(str, p)) for p, _ in tree_paths(tshapes)], got))
    shape = dict((("/".join(map(str, p)), tuple(s)) for p, (_, s) in tree_paths(tshapes)))
    assert spec["blocks/0/sa/w1_q"] == (None, None, "model") and shape["blocks/0/sa/w1_q"][-1] == 192
    assert spec["blocks/0/sa/b1_k"] == (None, "model")
    assert spec["blocks/0/sa/proj_w1"] == (None, "model", None)
    assert shape["blocks/0/sa/proj_w1"][1] == 384
    assert spec["blocks/0/cross/0/proj_w1"] == ("model", None)
    for leaf in ("blocks/0/sa/w2_q", "blocks/0/cross/0/q_w", "blocks/0/cross/0/kv_w"):
        assert spec[leaf] == (), leaf


# (data, model, fsdp) of the shard and byte cases
SHARD_CASES = {"model2": (1, 2, False), "data2_model2_fsdp": (2, 2, True)}
_SHARDED = {}


def _jax_sharded(case):
    """(mesh, whole params, JAX's ``shard_train_state(model_axis=True)``)
    of tests/test_parallel.py's tree (vocabularies 48 and 12, 4 heads), once
    per case."""
    if case not in _SHARDED:
        data, model, fsdp = SHARD_CASES[case]
        jcfg = JaxConfig(**TREES["test_parallel"], dropout=0.0, attn_impl="jnp")
        jparams = _init(3, jcfg)
        jmesh = jax_make_mesh(data, model, jax.devices()[:data * model])
        _SHARDED[case] = jmesh, jparams, jax_shard_train_state(
            jparams, jax_make_optimizer(1e-3), jmesh, jcfg.n_head, model_axis=True, fsdp=fsdp)
    return _SHARDED[case]


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_parts_equal_jax_shard_train_state(case):
    """Every rank's parts (``shard_train_state`` over a model axis, and a
    data axis with FSDP) equal device (d, t)'s shards of the JAX package's
    ``shard_train_state(model_axis=True)`` on the virtual CPU mesh, bit for
    bit, as does ``convert.shard_params``; mu and nu take the parameters'
    shapes; the leaves JAX keeps whole stay whole."""
    data, model, fsdp = SHARD_CASES[case]
    jmesh, jparams, (placed, _) = _jax_sharded(case)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    opt = make_optimizer(1e-3)
    leaves = jax.tree.leaves(placed)
    n_split = 0
    for d in range(data):
        for t in range(model):
            device = np.asarray(jmesh.devices)[d, t]
            parts, state, where = shard_train_state(tparams, opt.init(tparams),
                                                    pmesh.DataAxis(d, data), fsdp,
                                                    pmesh.ModelAxis(t, model))
            converted = shard_params(tparams, t, model, d, data, fsdp)
            for leaf, part, conv, mu, nu, full in zip(
                    leaves, tree_leaves(parts), tree_leaves(converted),
                    tree_leaves(state["mu"]), tree_leaves(state["nu"]), tree_leaves(tparams)):
                (want,) = [np.asarray(s.data) for s in leaf.addressable_shards
                           if s.device == device]
                np.testing.assert_array_equal(part.detach().numpy(), want)
                np.testing.assert_array_equal(conv.detach().numpy(), want)
                assert mu.shape == nu.shape == part.shape
                n_split += part.shape != full.shape
            assert where.parts() == [int(np.prod(f.shape)) // int(np.prod(p.shape))
                                     for f, p in zip(tree_leaves(tparams), tree_leaves(parts))]
    assert n_split > len(leaves) * data * model // 2


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_train_state_bytes_equal_jax(case):
    """A rank's (total, per-device) train-state bytes (its parts, the whole
    leaves, the count) equal the JAX package's ``train_state_bytes`` after
    its ``shard_train_state(model_axis=True)`` (and FSDP) on the same tree."""
    data, model, fsdp = SHARD_CASES[case]
    _, jparams, (p_sh, o_sh) = _jax_sharded(case)
    want = jax_state_bytes(p_sh, o_sh)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    opt = make_optimizer(1e-3)
    parts, state, placed = shard_train_state(tparams, opt.init(tparams), pmesh.DataAxis(1, data),
                                             fsdp, pmesh.ModelAxis(1, model))
    assert train_state_bytes(parts, state, opt, placed.parts()) == want
    assert want[1] < 0.6 * want[0]


# ------------------------------------------------------------ kernels


def _heads(w, h0, per, H, dim, width):
    """Heads [h0, h0 + per) of each q/k/v group of a fused weight."""
    return torch.cat([w.narrow(dim, (g * H + h0) * width, per * width) for g in range(3)], dim)


def test_fused_kernel_keys_global_heads():
    """K1f and K1b's plain versions on rank t's heads (``heads`` = (h0, H))
    of a global call, alone and on the second half of the batch as well
    (data x model, gb from the global batch and heads): the mask bit-equal
    to the global call's heads, outputs and the rank's weight-gradient
    columns within 1e-6 of the global call's, dx summed over the ranks;
    the head offset forced to 0 differs."""
    rng = np.random.default_rng(0)
    M, B, T, C, H, hs = 2, 4, 16, 32, 4, 16
    N, per, hs2 = 2, 2, 8
    x = _normal((M, B, T, C), rng)
    w1, b1 = _normal((M, C, 3 * H * hs2), rng) * 0.1, _normal((M, 3 * H * hs2), rng) * 0.1
    w2 = _normal((M, 3 * H, hs2, hs), rng) * 0.2
    dout = _normal((M, H, B, T, hs), rng)
    ref_keep = K._fqkv_mask(x, w2, H, RATE, SALTS)
    ref_out = K.fused_qkv_attention_plain(x, w1, b1, w2, H, RATE, SALTS)
    ref = K.fused_qkv_attention_bwd_plain(x, w1, b1, w2, ref_out, dout, H, RATE, SALTS)
    for start, nb in ((0, B), (B // 2, B // 2)):
        rows = slice(start, start + nb)
        xl = x[:, rows].contiguous()
        batch = (start, B) if nb < B else None
        dx_sum = 0
        for t in range(N):
            h0, heads = t * per, (t * per, H)
            w1l, b1l, w2l = _heads(w1, h0, per, H, 2, hs2), _heads(b1, h0, per, H, 1, hs2), \
                _heads(w2, h0, per, H, 1, 1)
            dl = dout[:, h0:h0 + per, rows].contiguous()
            np.testing.assert_array_equal(
                K._fqkv_mask(xl, w2l, per, RATE, SALTS, batch, heads).numpy(),
                ref_keep[:, h0:h0 + per, rows].numpy())
            xg = xl.clone().requires_grad_()
            out = K.fused_qkv_attention(xg, w1l, b1l, w2l, per, RATE, SALTS, batch, heads)
            assert _err(out, ref_out[:, h0:h0 + per, rows]) <= 1e-6
            dx, dw1, db1, dw2 = K.fused_qkv_attention_bwd_plain(xl, w1l, b1l, w2l, out.detach(),
                                                                dl, per, RATE, SALTS, batch,
                                                                heads)
            (dxa,) = torch.autograd.grad(out, xg, dl)
            np.testing.assert_array_equal(dxa.numpy(), dx.numpy())
            dx_sum = dx_sum + dx
            if nb == B:
                for got, full, dim, width in ((dw1, ref[1], 2, hs2), (db1, ref[2], 1, hs2),
                                              (dw2, ref[3], 1, 1)):
                    assert _err(got, _heads(full, h0, per, H, dim, width)) <= 1e-6
            if t == 1:
                bad = K.fused_qkv_attention(xl, w1l, b1l, w2l, per, RATE, SALTS, batch, (0, H))
                assert _err(bad, ref_out[:, h0:h0 + per, rows]) > 1e-2
        assert _err(dx_sum, ref[0][:, rows]) <= 1e-6
    with pytest.raises(ValueError, match="outside the model's"):
        K.fused_qkv_attention(x, w1, b1, w2, H, RATE, SALTS, None, (2, H))


def _scoped_rows(lead, batch_axis, head_axis, start, total, h0, n_head):
    with tl.batch_slice_scope(start, total), tl.head_slice_scope(h0, lead[head_axis], n_head):
        return tl.batch_row_map(lead, batch_axis, head_axis)


# (global shape of q's leading axes, batch axis, head axis, kernel): the
# whole-row cross rows (H, B) head-major, the flash self rows (M, B, H) and
# cross rows (B, H) in JAX's order
ROW_CASES = {"K2_HB": ((4, 4), 1, 0), "K5_MBH": ((2, 4, 4), 1, 2), "K6_BH": ((4, 4), 0, 1)}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_row_maps_key_global_heads_and_rows(case):
    """Each kernel's plain version on rank (d, t)'s rows of ``{data: 2,
    model: 2}`` (and of ``{model: 2}``) with the scopes' row map (two levels
    where both split the flash rows): masks bit-equal to the global call's
    rows, outputs and gradients within 1e-6; the head offset forced to 0
    differs. K2 takes a map of one level only."""
    lead, b_ax, h_ax = ROW_CASES[case]
    rng = np.random.default_rng(1)
    T, hs, J = (16, 8, 2) if case == "K2_HB" else (256, 8, 2)
    shape = lead + (T, hs)
    q, dout = _normal(shape, rng), _normal(shape, rng)
    k, v = _normal((J,) + shape, rng), _normal((J,) + shape, rng)
    if case == "K2_HB":
        ref = K.short_cross_attention_plain(q, k, v, RATE, SALTS)
        call = lambda q_, k_, v_, rows: K.short_cross_attention(q_, k_, v_, RATE, SALTS, rows)  # noqa: E731
    elif case == "K5_MBH":
        k, v = k[0], v[0]
        ref = K.flash_causal_attention(q, k, v, RATE, SALTS)
        call = lambda q_, k_, v_, rows: K.flash_causal_attention(q_, k_, v_, RATE, SALTS, rows)  # noqa: E731
    else:
        ref = K.flash_cross_attention(q, k, v, RATE, SALTS)
        call = lambda q_, k_, v_, rows: K.flash_cross_attention(q_, k_, v_, RATE, SALTS, rows)  # noqa: E731
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    ref_grads = torch.autograd.grad(call(qg, kg, vg, None), (qg, kg, vg), dout)
    Bg, Hg = lead[b_ax], lead[h_ax]
    two_levels = 0
    for data in (1, 2):
        for d in range(data):
            for t in range(2):
                sl = [slice(None)] * len(lead)
                sl[b_ax] = slice(d * Bg // data, (d + 1) * Bg // data)
                sl[h_ax] = slice(t * Hg // 2, (t + 1) * Hg // 2)
                sl = tuple(sl)
                ksl = (slice(None),) + sl if k.ndim > q.ndim else sl
                ql, dl = q[sl].contiguous(), dout[sl].contiguous()
                kl, vl = k[ksl].contiguous(), v[ksl].contiguous()
                rows = _scoped_rows(ql.shape[:-2], b_ax if data > 1 else None, h_ax,
                                    d * Bg // data, Bg, t * Hg // 2, Hg)
                two_levels += len(rows) > 3
                qg, kg, vg = (x.clone().requires_grad_() for x in (ql, kl, vl))
                out = call(qg, kg, vg, rows)
                assert _err(out, ref[sl]) <= 1e-6
                for g, rg, s in zip(torch.autograd.grad(out, (qg, kg, vg), dl), ref_grads,
                                    (sl, ksl, ksl)):
                    assert _err(g, rg[s]) <= 1e-6
                if t == 1:
                    bad = call(ql, kl, vl, tuple(rows[:2]) + (rows[2] - Hg // 2 * (
                        Bg if case == "K2_HB" else 1),) + tuple(rows[3:]))
                    assert _err(bad, ref[sl]) > 1e-2
    assert two_levels == (4 if case == "K5_MBH" else 0)  # every rank of data x model
    if case == "K2_HB":
        with pytest.raises(ValueError, match="one level"):
            K.short_cross_attention(q, k, v, RATE, SALTS, (4, 4, 0, 2, 2))


# ------------------------------------------------------------ steps


def _jax_steps(jcfg, jparams, batches, salts, interpret: bool):
    """JAX's first step (loss, gradients), its losses and parameters after
    one AdamW step per batch, on the global batches (its flash kernels in
    interpret mode where asked)."""
    opt = jax_make_optimizer(1e-3)
    with pytest.MonkeyPatch.context() as mp:
        if interpret:
            for name in ("flash_causal_attention", "flash_cross_attention"):
                mp.setattr(jpa, name, functools.partial(getattr(jpa, name), interpret=True))
        vg = jax.jit(jax.value_and_grad(lambda p, x, y, k: jax_loss(p, jcfg, x, y, k, True),
                                        has_aux=True))

        @jax.jit
        def update(g, state, p):
            u, state = opt.update(g, state, p)
            return optax.apply_updates(p, u), state

        state, p, losses, first = opt.init(jparams), jparams, [], None
        for (xb, yb), key in zip(batches, salts):
            (loss, _), g = vg(p, jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(key, jnp.uint32))
            first = first or (float(loss), jax.tree_util.tree_leaves(g))
            p, state = update(g, state, p)
            losses.append(float(loss))
    return first, losses, [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(p)]


_RUNS, _JAX_STEPS = {}, {}


def _layout_run(name):
    """JAX's steps and the port's ranks of one layout (once a module)."""
    if name in _RUNS:
        return _RUNS[name]
    cfg_kw, data, model, fsdp, steps, B, dispatch = LAYOUTS[name]
    jcfg = JaxConfig(**cfg_kw)
    jparams = _init(5, jcfg)
    batches = _dp_batches(cfg_kw, steps, B, 6)
    salts = [(int(a), int(b)) for a, b in
             np.random.default_rng(7).integers(0, 2**32, (steps, 2), dtype=np.uint64)]
    key = (repr(cfg_kw), steps, B, dispatch)  # layouts of one model share JAX's steps
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _jax_steps(jcfg, jparams, batches, salts, dispatch)
    ref = _JAX_STEPS[key]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    job = dict(cfg=cfg_kw, params=tparams, batches=batches, salts=salts,
               mesh=dict(data=data, model=model), fsdp=fsdp, kernel_dispatch=dispatch, batch=B)
    if name == "model2":
        job.update(feed=_dp_feed_args(cfg_kw, 8), seed=11, eval_iters=2, remat=True)
    ranks = pmesh.run_ranks(torch_rank_bodies.mesh_cases, data * model, (job,),
                            timeout=RANK_TIMEOUT)
    _RUNS[name] = (ref, ranks, tparams, job)
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_tp_step_matches_jax_unsharded_step(name):
    """One step (and a second where the layout has two batches) over the
    layout's ranks against JAX's unsharded step on the same global batches
    and salts at dropout 0.2: the loss, every gradient leaf (the ranks'
    parts gathered) and the updated parameters within JAX's tolerances for
    its sharded trainer; every rank's gathered tree bit-equal; every leaf
    the placement keeps whole bit-equal across the ranks, its gradient and
    its value after the update (no averaging hides a difference)."""
    (jloss, jgrads), jlosses, jparams_after = _layout_run(name)[0]
    ranks = _layout_run(name)[1]
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5, atol=1e-6)
    assert max(_leaf_errs(got["whole_grads"], jgrads)) <= 1e-5
    for a, b in zip(got["whole"][0], jparams_after):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)
    specs = got["specs"]
    assert any("model" in s for s in specs)
    if LAYOUTS[name][0] is SPLIT_MODEL:  # the heads' columns split, the per-head leaves whole
        spec = dict(zip(["/".join(map(str, p)) for p, _ in tree_paths(_layout_run(name)[2])],
                        specs))
        assert spec["blocks/0/sa/w1_q"][-1] == "model" and spec["blocks/0/sa/w2_q"] == ()
        assert spec["blocks/0/cross/0/proj_w1"][0] == "model"
        assert spec["blocks/0/cross/0/q_w"] == ()
    if LAYOUTS[name][0] is TP_MODEL:  # mixed placements: whole and split vocabulary leaves
        spec = dict(zip(["/".join(map(str, p)) for p, _ in tree_paths(_layout_run(name)[2])],
                        specs))
        assert "model" not in spec["pre/tok_emb/0"] and spec["pre/tok_emb/1"][0] == "model"
        assert "model" not in spec[f"post/heads/{2 if LAYOUTS[name][2] == 3 else 3}/w1"]
        assert spec["post/heads/1/w1"][1] == "model"
    for other in ranks[1:]:
        assert other["losses"] == got["losses"]
        for tree_a, tree_b in zip(other["whole"], got["whole"]):
            for a, b in zip(tree_a, tree_b):
                np.testing.assert_array_equal(a, b)
        for i, s in enumerate(specs):
            if "model" not in s and "data" not in s:
                np.testing.assert_array_equal(other["grads"][i], got["grads"][i])
                np.testing.assert_array_equal(other["after_parts"][i], got["after_parts"][i])


def test_tp_remat_step_is_bit_equal():
    """``remat`` under ``{model: 2}``: each block recomputed in the backward
    (its forward all-reduces issued again, in one order on both ranks)
    gives the step's loss and gradients bit for bit."""
    for got in _layout_run("model2")[1]:
        rloss, rgrads = got["remat"]
        assert rloss == got["loss"]
        for a, b in zip(rgrads, got["grads"]):
            np.testing.assert_array_equal(a, b)


def test_tp_head_offset_0_breaks_the_step():
    """The planted fault: every rank's heads keyed from 0 (rank 1 drawing
    rank 0's masks) moves the gradients past the step's gate (the loss of
    this near-uniform model moves by ~1e-7 only)."""
    (_, jgrads), _, _ = _layout_run("model2")[0]
    job = {k: v for k, v in _layout_run("model2")[3].items()
           if k not in ("feed", "seed", "eval_iters", "remat")}
    bad = pmesh.run_ranks(torch_rank_bodies.mesh_cases, 2, (dict(
        job, batches=job["batches"][:1], salts=job["salts"][:1], head_offset_0=True),),
        timeout=RANK_TIMEOUT)
    assert max(_leaf_errs(bad[0]["whole_grads"], jgrads)) > 1e-3


def test_tp_eval_pass_equals_the_one_rank_pass(one_thread):
    """The evaluation pass over ``{model: 2}`` (replicated over the model
    group) against the one-rank pass on the same global batches: wins and
    losses exactly, mean losses and certainty to 1e-6."""
    from trade_aid_multimodal_transformer_tpu_torch.sampling.feed import BatchFeed
    from trade_aid_multimodal_transformer_tpu_torch.train.metrics import build_metric_specs

    _, ranks, tparams, job = _layout_run("model2")
    f = job["feed"]
    feed = BatchFeed(f["train"], f["val"], f["file_lengths"], TP_MODEL["block_size"], GLOBAL_B,
                     False, f["rand_sizes"], list(TP_MODEL["vocab_sizes"]))
    specs = build_metric_specs(f["vocabs"], [False] * 4, TP_MODEL["block_size"])
    params = map_tree(lambda t: t.detach().clone(), tparams)
    ref = Trainer(ModelConfig(**TP_MODEL), feed, make_optimizer(1e-3), specs, 2).eval_pass(
        params, StepRng(11, "cpu"), "val")
    assert int(ref.wins.sum()) + int(ref.losses.sum()) > 0
    for got in (r["eval"] for r in ranks):
        np.testing.assert_array_equal(got["wins"], ref.wins.numpy())
        np.testing.assert_array_equal(got["losses"], ref.losses.numpy())
        for name in ("mean_loss", "mean_losses", "certainty"):
            assert _err(got[name], getattr(ref, name)) <= 1e-6, name


def test_tp_parts_are_the_placement_and_fsdp_splits_the_model_slices():
    """Each rank holds its ``shard_of`` block of every leaf (the model
    slice, and under FSDP that slice's data slice), before and after the
    step; under ``{data: 2, model: 2}`` + FSDP a rank holds about a quarter
    of the state."""
    for name in ("model2", "data2_model2_fsdp"):
        cfg_kw, data, model, fsdp, *_ = LAYOUTS[name]
        _, ranks, tparams, _ = _layout_run(name)
        full = [t.numpy() for t in tree_leaves(tparams)]
        for r, got in enumerate(ranks):
            d, t = divmod(r, model)
            for part, leaf, s in zip(got["parts"][0], full, got["specs"]):
                want = pmesh.shard_of(torch.from_numpy(leaf), s, t, model, "model")
                want = pmesh.shard_of(want, s, d, data, "data") if fsdp else want
                np.testing.assert_array_equal(part, want.numpy())
            after = [pmesh.shard_of(pmesh.shard_of(torch.from_numpy(w), s, t, model, "model"),
                                    s, d, data, "data") if fsdp else
                     pmesh.shard_of(torch.from_numpy(w), s, t, model, "model")
                     for w, s in zip(got["whole"][0], got["specs"])]
            for a, b in zip(got["after_parts"], after):
                np.testing.assert_array_equal(a, b.numpy())
        held = sum(a.size for a in ranks[0]["parts"][0])
        assert held < (0.3 if fsdp else 0.6) * sum(a.size for a in full)


# ------------------------------------------------------------ the entry


def _tp_config(tmp_path, mesh: str, rate: float, save: bool = False):
    """The demo entry case with ``mesh`` (2 gloo ranks) and ``save_model``."""
    tmp_path.mkdir()
    d = _mesh_config(_demo_dir(tmp_path), mesh, 1, rate)
    if save:
        text = (d / "config.yaml").read_text().replace("save_model: 0", "save_model: 1")
        (d / "config.yaml").write_text(text)
    return d


def test_run_training_tp_matches_jax_entry_checkpoint_and_one_rank_load(tmp_path, monkeypatch,
                                                                      capfd):
    """``mesh: {model: 2}`` through the port's entry on the CPU, dropout
    0.2, ``save_model: 1``: rank 0's console equal to the JAX runner's (on
    the virtual mesh) once numbers are masked, its two ``Parallelism:``
    lines unmasked, every rank's checksum of the gathered parameters equal,
    the final losses within 1e-5 of the port's one-rank entry with the same
    seed; the ``.npz`` it wrote (the whole tree) loads in a one-rank run
    (``mesh: off``, ``create_new_model: 0``), which trains on."""
    d = _tp_config(tmp_path / "tp", "{model: 2}", 0.2, save=True)
    monkeypatch.chdir(d)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res, outs = _run_entries(d, capfd, jax_too=True)
    par = [[x for x in out if x.startswith("Parallelism:")] for out in outs]
    assert par[0] == par[1] and par[0][0] == "Parallelism: tensor x2 over 2 devices", par
    assert re.fullmatch(r"Parallelism: train state: [\d.]+ MB \([\d.]+ MB/device\)", par[0][1])
    masked = [[re.sub(r"\d+(\.\d+)?", "#", x) for x in out] for out in outs]
    assert masked[0] == masked[1]
    sums = res["param_checksums"]
    assert len(sums) == 2 and all(s == sums[0] for s in sums), sums
    assert sums[0] == runner.param_checksum(res["params"])
    total, per_dev = res["train_state_bytes"]
    assert [tuple(b) for b in res["train_state_bytes_by_rank"]] == [(total, per_dev)] * 2
    assert per_dev < total
    saved = load_checkpoint(str(d / "output" / "demo_model.ckpt"), res["cfg"], "cpu")[0]
    for a, b in zip(tree_leaves(saved), tree_leaves(res["params"])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    text = (d / "config.yaml").read_text().replace("mesh: {model: 2}", "mesh: \"off\"")
    (d / "config.yaml").write_text(text)
    one, _ = _run_entries(d, capfd, jax_too=False)
    for k in ("train", "val"):
        assert abs(res["losses"][k] - one["losses"][k]) <= 1e-5, (k, res["losses"], one["losses"])
    text = text.replace("create_new_model: 1", "create_new_model: 0")
    (d / "config.yaml").write_text(text)
    loaded, (out,) = _run_entries(d, capfd, jax_too=False, seed=4)
    assert "Model: Loaded successfully" in out and "TRAINING COMPLETED SUCCESSFULLY" in out
    assert loaded["plan"].trivial and np.isfinite(loaded["losses"]["train"])
