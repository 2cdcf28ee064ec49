"""The port's modality parallelism (``tpu_options.mesh`` mod axis: alone, x
data with FSDP, x model) held against the JAX package on the CPU.

On a modality axis of P ranks (P divides the modality count) a rank keeps,
of every M-stacked leaf (sa, ffwd, ln1, ln2, the post norm), the slice of
its modalities (the block that device (m, d, t) holds after the JAX
package's ``shard_train_state`` on a mesh with a 'mod' axis) and the other
leaves whole; it runs the one-rank step on its modalities, gathers the
activations over the axis before each block's cross-attention and sums the
loss and the whole leaves' gradients over the axis. The JAX package lets
GSPMD partition the unsharded step, so its contract is that step (its
tests/test_parallel.py ``TestModalityParallel``); the port is held to it.
The ranks are spawned gloo processes (tests/torch_rank_bodies.py
``mesh_cases``, which imports no JAX), one spawn per layout, joined under a
time limit, one thread per rank. Tolerances:
- placements, parts and train-state bytes: equal (specs leaf for leaf,
  parts bit for bit, bytes to the byte);
- masks and the kernels' plain versions on a rank's modalities: bit for
  bit against the global call's rows, values within 1e-6 * max(1,
  max|ref|) (tests/test_torch_dp.py's);
- one step and a second against JAX's ``total_loss`` under
  ``jax.value_and_grad`` and its AdamW on the same global batches and
  salts (f32, dropout 0.2): ``TestModalityParallel``'s tolerances (losses
  rtol 1e-5 atol 1e-6, parameters rtol 2e-4 atol 1e-5), every gradient
  leaf 1e-5 by its L2 error against its own scale (``_leaf_errs``); every
  leaf the placement keeps whole bit-equal on every rank, its gradient and
  its value after the update;
- evaluation: wins and losses exactly the one-rank pass's, the means 1e-6;
- the planted faults (a rank that draws no salts for another rank's cross
  sites, rank 1's masks keyed at modality place 0): some gradient leaf
  moves past 1e-3;
- the entry: the final losses within 1e-5 of the port's one-rank entry
  (the same batches and salts), within 2e-2 of the JAX runner's (the port
  draws its initial weights, batches and salts from torch generators, the
  JAX runner from its keys: over seeds 0-3 of the demo entry the two
  runners' final losses differ by up to 0.0072, so the bound is about
  three times that), and both within 0.15 of the analytic anchor
  (tests/test_config_mesh.py's tolerance where the key schedules differ).
"""

import math
import re

import numpy as np
import pytest

import jax
import torch

from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.init import init_params as jax_init
from trade_aid_multimodal_transformer_tpu.ops import layers as jl
from trade_aid_multimodal_transformer_tpu.parallel import make_mesh as jax_make_mesh
from trade_aid_multimodal_transformer_tpu.parallel.trainer import (
    shard_train_state as jax_shard_train_state,
)
from trade_aid_multimodal_transformer_tpu.train.steps import make_optimizer as jax_make_optimizer
from trade_aid_multimodal_transformer_tpu.utils.memory import train_state_bytes as jax_state_bytes
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax, shard_params
from trade_aid_multimodal_transformer_tpu_torch.models import transformer as ttr
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import (
    map_tree, param_shapes, tree_leaves, tree_paths)
from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K
from trade_aid_multimodal_transformer_tpu_torch.ops import layers as tl
from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import shard_train_state
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
from test_torch_tp import TP_MODEL, _jax_steps  # noqa: E402
from test_torch_train import _leaf_errs  # noqa: E402

RATE = 0.2
# the step model: four modalities, two cross-attending (modality 0 on
# modality place 0, modality 2 on place 1 at mod 2), 6 heads of 8, the
# dense cores at block_size 64
MOD_MODEL = TP_MODEL
GLOBAL_B = 4
# (mesh, fsdp) of each step layout
LAYOUTS = {"mod2": (dict(mod=2), False),
           "mod2_data2_fsdp": (dict(mod=2, data=2), True),
           "mod2_model2": (dict(mod=2, model=2), False)}


# ------------------------------------------------------------ placements


# (placement keywords) on the production tree
PSPEC_CASES = {"mod2": dict(mod_axis=True, mod_size=2), "mod4": dict(mod_axis=True, mod_size=4),
               "mod2_fsdp2": dict(mod_axis=True, mod_size=2, fsdp_size=2),
               "mod2_model2": dict(mod_axis=True, mod_size=2, model_axis=True, model_size=2)}


@pytest.mark.parametrize("case", sorted(PSPEC_CASES))
def test_param_pspecs_mod_axis_equal_jax_on_the_production_tree(case):
    """``param_pspecs(mod_axis=True)`` leaf for leaf as the JAX package's on
    the production tree: every M-stacked leaf 'mod' on its leading
    dimension, the per-modality leaves (token tables, vocabulary heads,
    cross-attention) and the positional table without it."""
    kw = PSPEC_CASES[case]
    jcfg = JaxConfig(**TREES["production"], dropout=0.0, attn_impl="jnp")
    jshapes = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    want = _jax_specs(jshapes, jcfg.n_head, **{"model_axis": False, **kw})
    tshapes = param_shapes(ModelConfig(**TREES["production"]))
    got = pmesh.param_pspecs(tshapes, jcfg.n_head, **{"model_axis": False, **kw})
    assert got == want
    spec = dict(zip(["/".join(map(str, p)) for p, _ in tree_paths(tshapes)], got))
    for path in ("blocks/0/sa/w1_q", "blocks/0/ffwd/w1", "blocks/0/ln1/scale", "post/ln_scale"):
        assert spec[path][0] == "mod", path
    for path in ("pre/tok_emb/0", "pre/pos_emb", "post/heads/0/w1", "blocks/0/cross/0/q_w"):
        assert "mod" not in spec[path], path


# (mesh keywords of the JAX package's make_mesh, fsdp) of the shard and byte cases
SHARD_CASES = {"mod2": (dict(mod=2), False), "mod4": (dict(mod=4), False),
               "mod2_data2_fsdp": (dict(mod=2, data=2), True),
               "mod2_model2": (dict(mod=2, model=2), False)}
_SHARDED = {}


def _jax_sharded(case):
    """(mesh, whole params, JAX's ``shard_train_state``) of the step model's
    tree on a mesh with a 'mod' axis, once per case."""
    if case not in _SHARDED:
        kw, fsdp = SHARD_CASES[case]
        jcfg = JaxConfig(**MOD_MODEL)
        jparams = _init(3, jcfg)
        n = kw.get("mod", 1) * kw.get("data", 1) * kw.get("model", 1)
        jmesh = jax_make_mesh(kw.get("data", 1), kw.get("model", 1), jax.devices()[:n],
                              mod=kw["mod"])
        _SHARDED[case] = jmesh, jparams, jax_shard_train_state(
            jparams, jax_make_optimizer(1e-3), jmesh, jcfg.n_head,
            model_axis=kw.get("model", 1) > 1, fsdp=fsdp)
    return _SHARDED[case]


def _axes(kw, m, d, t):
    return (pmesh.DataAxis(d, kw.get("data", 1)), pmesh.ModelAxis(t, kw.get("model", 1)),
            pmesh.ModAxis(m, kw["mod"]))


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_parts_equal_jax_shard_train_state(case):
    """Every rank's parts (``shard_train_state`` over the modality axis, and
    the data axis with FSDP, and the model axis) equal device (m, d, t)'s
    shards of the JAX package's ``shard_train_state`` on the virtual CPU
    mesh, bit for bit, as do ``convert.shard_params``'s; mu and nu take the
    parameters' shapes; the leaves JAX keeps whole stay whole."""
    kw, fsdp = SHARD_CASES[case]
    jmesh, jparams, (placed, _) = _jax_sharded(case)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    opt = make_optimizer(1e-3)
    leaves = jax.tree.leaves(placed)
    devices = np.asarray(jmesh.devices).reshape(kw["mod"], kw.get("data", 1), kw.get("model", 1))
    n_split = 0
    for (m, d, t), device in np.ndenumerate(devices):
        data, model, mod = _axes(kw, m, d, t)
        parts, state, where = shard_train_state(tparams, opt.init(tparams), data, fsdp, model,
                                                mod)
        converted = shard_params(tparams, t, model.size, d, data.size, fsdp, m, mod.size)
        for leaf, part, conv, mu, nu, full in zip(
                leaves, tree_leaves(parts), tree_leaves(converted), tree_leaves(state["mu"]),
                tree_leaves(state["nu"]), tree_leaves(tparams)):
            (want,) = [np.asarray(s.data) for s in leaf.addressable_shards if s.device == device]
            np.testing.assert_array_equal(part.detach().numpy(), want)
            np.testing.assert_array_equal(conv.detach().numpy(), want)
            assert mu.shape == nu.shape == part.shape
            n_split += part.shape != full.shape
        assert where.parts() == [int(np.prod(f.shape)) // int(np.prod(p.shape))
                                 for f, p in zip(tree_leaves(tparams), tree_leaves(parts))]
    assert n_split > 0


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_train_state_bytes_equal_jax(case):
    """A rank's (total, per-device) train-state bytes equal the JAX
    package's ``train_state_bytes`` after its ``shard_train_state`` on the
    mesh with a 'mod' axis; the per-device figure falls as the axis grows."""
    kw, fsdp = SHARD_CASES[case]
    _, jparams, (p_sh, o_sh) = _jax_sharded(case)
    want = jax_state_bytes(p_sh, o_sh)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    opt = make_optimizer(1e-3)
    data, model, mod = _axes(kw, kw["mod"] - 1, kw.get("data", 1) - 1, kw.get("model", 1) - 1)
    parts, state, placed = shard_train_state(tparams, opt.init(tparams), data, fsdp, model, mod)
    assert train_state_bytes(parts, state, opt, placed.parts()) == want
    assert want[1] < want[0]


# ------------------------------------------------------------ masks and kernels


def test_fused_kernel_keys_global_modalities():
    """K1f and K1b's plain versions on modality place 1's modalities of a
    global call (``mods`` = (m0, M)), alone and on the second half of the
    batch (mod x data: gb from the global batch): the mask bit-equal to the
    global call's, outputs and the weight gradients within 1e-6, dx equal;
    the modality offset forced to 0 differs."""
    rng = np.random.default_rng(0)
    M, B, T, C, H, hs, hs2 = 4, 4, 16, 32, 2, 16, 8
    x = _normal((M, B, T, C), rng)
    w1, b1 = _normal((M, C, 3 * H * hs2), rng) * 0.1, _normal((M, 3 * H * hs2), rng) * 0.1
    w2 = _normal((M, 3 * H, hs2, hs), rng) * 0.2
    dout = _normal((M, H, B, T, hs), rng)
    ref_keep = K._fqkv_mask(x, w2, H, RATE, SALTS)
    ref_out = K.fused_qkv_attention_plain(x, w1, b1, w2, H, RATE, SALTS)
    ref = K.fused_qkv_attention_bwd_plain(x, w1, b1, w2, ref_out, dout, H, RATE, SALTS)
    m0, per = 2, 2
    mods = slice(m0, m0 + per)
    for start, nb in ((0, B), (B // 2, B // 2)):
        rows = slice(start, start + nb)
        xl = x[mods, rows].contiguous()
        batch = (start, B) if nb < B else None
        w1l, b1l, w2l = w1[mods], b1[mods], w2[mods]
        dl = dout[mods, :, rows].contiguous()
        np.testing.assert_array_equal(
            K._fqkv_mask(xl, w2l, H, RATE, SALTS, batch, None, (m0, M)).numpy(),
            ref_keep[mods, :, rows].numpy())
        xg = xl.clone().requires_grad_()
        out = K.fused_qkv_attention(xg, w1l, b1l, w2l, H, RATE, SALTS, batch, None, (m0, M))
        assert _err(out, ref_out[mods, :, rows]) <= 1e-6
        dx, dw1, db1, dw2 = K.fused_qkv_attention_bwd_plain(xl, w1l, b1l, w2l, out.detach(), dl,
                                                            H, RATE, SALTS, batch, None, (m0, M))
        (dxa,) = torch.autograd.grad(out, xg, dl)
        np.testing.assert_array_equal(dxa.numpy(), dx.numpy())
        assert _err(dx, ref[0][mods, rows]) <= 1e-6
        if nb == B:
            for got, full in ((dw1, ref[1]), (db1, ref[2]), (dw2, ref[3])):
                assert _err(got, full[mods]) <= 1e-6
        bad = K.fused_qkv_attention(xl, w1l, b1l, w2l, H, RATE, SALTS, batch, None, (0, M))
        assert _err(bad, ref_out[mods, :, rows]) > 1e-2
    with pytest.raises(ValueError, match="outside the model's"):
        K.fused_qkv_attention(x[:2], w1[:2], b1[:2], w2[:2], H, RATE, SALTS, None, None, (3, M))


# (global shape, batch axis, head axis): the dropout sites' (M, B, T, C)
# and the flash self-attention rows (M, B, H) of the flash kernels
ND_CASES = {"MBTC": ((4, 4, 6, 8), 1, None), "MBHTT": ((4, 4, 2, 6, 6), 1, 2)}


@pytest.mark.parametrize("case", sorted(ND_CASES))
def test_hash_keep_mask_nd_keyed_by_global_modalities_equals_jax(case):
    """Each modality place's ``hash_keep_mask_nd`` (and ``dropout``) inside
    its modality scope (and a data rank's batch scope, and a model rank's
    head scope where the site has heads) is bit-equal to its block of JAX's
    mask on the global shape; the scope's offset forced to 0 differs."""
    shape, b_ax, h_ax = ND_CASES[case]
    ref = np.asarray(jl.hash_keep_mask_nd(jax.numpy.uint32(SALTS[0]),
                                          jax.numpy.uint32(SALTS[1]), shape, RATE))
    for split_b in (False, True):
        for m in range(2):
            for d in range(2 if split_b else 1):
                for t in range(2 if h_ax is not None else 1):
                    sl = [slice(None)] * len(shape)
                    sl[0] = slice(2 * m, 2 * m + 2)
                    if split_b:
                        sl[b_ax] = slice(2 * d, 2 * d + 2)
                    if h_ax is not None:
                        sl[h_ax] = slice(t, t + 1)
                    want = ref[tuple(sl)]
                    local = want.shape

                    def keyed(m0):
                        with tl.mod_slice_scope(m0, 2, 4), \
                                tl.batch_slice_scope(2 * d if split_b else 0, shape[b_ax]), \
                                tl.head_slice_scope(t if h_ax is not None else 0,
                                                    local[h_ax] if h_ax is not None else 1,
                                                    shape[h_ax] if h_ax is not None else 1):
                            rows = tl.batch_row_map(local[:-2], b_ax, h_ax, 0)
                            got = tl.hash_keep_mask_nd(*SALTS, local, RATE, rows=rows)
                            dropped = tl.dropout(torch.ones(local), RATE, SALTS, True,
                                                 batch_axis=b_ax, head_axis=h_ax, mod_axis=0)
                        return got.numpy(), dropped.numpy() != 0

                    got, dropped = keyed(2 * m)
                    np.testing.assert_array_equal(got, want)
                    np.testing.assert_array_equal(dropped, want)
                    if m == 1:
                        assert (keyed(0)[0] != want).any()


def test_flash_rows_key_global_modalities():
    """K5f/K5b's plain versions on modality place 1's rows of a global flash
    call over (M, B, H) rows, alone and with a data rank's rows and a model
    rank's heads (the modality level in the map's base): outputs and
    gradients within 1e-6 of the global call's rows; offset 0 differs."""
    rng = np.random.default_rng(1)
    lead, T, hs = (4, 2, 2), 256, 8
    q, k, v, dout = (_normal(lead + (T, hs), rng) for _ in range(4))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    ref = K.flash_causal_attention(qg, kg, vg, RATE, SALTS)
    ref_grads = torch.autograd.grad(ref, (qg, kg, vg), dout)
    for d, t in ((None, None), (1, None), (1, 1)):
        sl = (slice(2, 4), slice(d, d + 1) if d is not None else slice(None),
              slice(t, t + 1) if t is not None else slice(None))

        def run(m0):
            with tl.mod_slice_scope(m0, 2, 4), tl.batch_slice_scope(d or 0, 2), \
                    tl.head_slice_scope(t or 0, 1 if t is not None else 2, 2):
                rows = tl.batch_row_map(q[sl].shape[:-2], 1 if d is not None else None,
                                        2 if t is not None else None, 0)
            ql, kl, vl = (x[sl].clone().requires_grad_() for x in (q, k, v))
            out = K.flash_causal_attention(ql, kl, vl, RATE, SALTS, rows)
            return out, torch.autograd.grad(out, (ql, kl, vl), dout[sl].contiguous())

        out, grads = run(2)
        assert _err(out, ref[sl]) <= 1e-6
        for g, r in zip(grads, ref_grads):
            assert _err(g, r[sl]) <= 1e-6
        assert _err(run(0)[0], ref[sl]) > 1e-2


def test_cross_cores_take_no_modality_level():
    """The cross-attention cores (K2 on the whole-row band, K6/K5b on the
    flash band) run once per querying modality on (H, B) or (B, H) rows: a
    modality scope adds no level to their row maps, and the model's
    cross-attention of a modality inside the scope is bit-equal to the
    one-rank call (the card's dispatch, the kernels' plain versions)."""
    for lead, b_ax, h_ax in (((2, 4), 1, 0), ((4, 2), 0, 1)):
        with tl.mod_slice_scope(2, 2, 4):
            assert tl.batch_row_map(lead, b_ax, h_ax) is None
    cfg = ModelConfig(**dict(MOD_MODEL, block_size=16))
    from trade_aid_multimodal_transformer_tpu_torch.models.init import init_params

    params = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    cp = params["blocks"][0]["cross"]["2"]
    rng = np.random.default_rng(2)
    q, kv = _normal((GLOBAL_B, 16, cfg.n_embd), rng), _normal((3, GLOBAL_B, 16, cfg.n_embd), rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tatt, "_kernel_device", lambda device, impl: impl != "jnp")
        cfgp = ModelConfig(**dict(MOD_MODEL, block_size=16, attn_impl="pallas"))
        ref = ttr.cross_attention(q, kv, cp, cfgp, tl.KeyGen((5, 6)), True)
        with tl.mod_slice_scope(2, 2, 4):
            got = ttr.cross_attention(q, kv, cp, cfgp, tl.KeyGen((5, 6)), True)
    np.testing.assert_array_equal(got.detach().numpy(), ref.detach().numpy())


# ------------------------------------------------------------ steps


_RUNS = {}


def _jax_reference():
    """JAX's first step and two-step trajectory on the global batches (once)."""
    if "jax" not in _RUNS:
        jcfg = JaxConfig(**MOD_MODEL)
        jparams = _init(5, jcfg)
        batches = _dp_batches(MOD_MODEL, 2, GLOBAL_B, 6)
        salts = [(int(a), int(b)) for a, b in
                 np.random.default_rng(7).integers(0, 2**32, (2, 2), dtype=np.uint64)]
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        _RUNS["jax"] = (_jax_steps(jcfg, jparams, batches, salts, False), tparams, batches, salts)
    return _RUNS["jax"]


def _job(mesh_kw, fsdp, **extra):
    _, tparams, batches, salts = _jax_reference()
    return dict(cfg=MOD_MODEL, params=tparams, batches=batches, salts=salts, mesh=mesh_kw,
                fsdp=fsdp, batch=GLOBAL_B, **extra)


def _layout_run(name):
    """The port's ranks of one layout (once a module)."""
    if name not in _RUNS:
        mesh_kw, fsdp = LAYOUTS[name]
        extra = dict(feed=_dp_feed_args(MOD_MODEL, 8), seed=11, eval_iters=2) \
            if name == "mod2" else {}
        world = int(np.prod(list(mesh_kw.values())))
        _RUNS[name] = pmesh.run_ranks(torch_rank_bodies.mesh_cases, world,
                                      (_job(mesh_kw, fsdp, **extra),), timeout=RANK_TIMEOUT)
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_mod_step_matches_jax_unsharded_step(name):
    """Two steps over the layout's ranks against JAX's unsharded steps on the
    same global batches and salts at dropout 0.2: the first loss, every
    gradient leaf (the ranks' parts gathered) and the losses and
    parameters after both updates within ``TestModalityParallel``'s
    tolerances; every rank's gathered tree bit-equal; every leaf the
    placement keeps whole bit-equal across the ranks, its gradient and its
    value after the update (no averaging hides a difference)."""
    (jloss, jgrads), jlosses, jparams_after = _jax_reference()[0]
    ranks = _layout_run(name)
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5, atol=1e-6)
    assert max(_leaf_errs(got["whole_grads"], jgrads)) <= 1e-5
    for a, b in zip(got["whole"][0], jparams_after):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)
    specs = got["specs"]
    assert any(s and s[0] == "mod" for s in specs)
    for other in ranks[1:]:
        assert other["losses"] == got["losses"]
        for tree_a, tree_b in zip(other["whole"], got["whole"]):
            for a, b in zip(tree_a, tree_b):
                np.testing.assert_array_equal(a, b)
        for i, s in enumerate(specs):
            if not {"mod", "model", "data"} & set(s):
                np.testing.assert_array_equal(other["grads"][i], got["grads"][i])
                np.testing.assert_array_equal(other["after_parts"][i], got["after_parts"][i])


def test_mod_parts_are_the_placement():
    """Each rank holds its ``shard_of`` block of every leaf (its modality
    slice, and under FSDP that slice's data slice), before and after the
    steps; under ``{mod: 2, data: 2}`` + FSDP about a third of the state."""
    # copies: a spawn moves the tree's storage into shared memory
    full = [t.numpy().copy() for t in tree_leaves(_jax_reference()[1])]
    for name in ("mod2", "mod2_data2_fsdp"):
        mesh_kw, fsdp = LAYOUTS[name]
        ranks = _layout_run(name)
        for got in ranks:
            m, d = got["coords"]["mod"], got["coords"]["data"]

            def part(w, s):
                out = pmesh.shard_of(torch.from_numpy(w), s, m, mesh_kw["mod"], "mod")
                return pmesh.shard_of(out, s, d, mesh_kw.get("data", 1), "data") if fsdp else out

            for a, w, s in zip(got["parts"][0], full, got["specs"]):
                np.testing.assert_array_equal(a, part(w, s).numpy())
            for a, w, s in zip(got["after_parts"], got["whole"][0], got["specs"]):
                np.testing.assert_array_equal(a, part(w, s).numpy())
        held = sum(a.size for a in ranks[0]["parts"][0])
        assert held < (0.35 if fsdp else 0.75) * sum(a.size for a in full)


def test_mod_eval_pass_equals_the_one_rank_pass(one_thread):
    """The evaluation pass over ``{mod: 2}`` (each rank its modalities, the
    per-modality statistics summed over the axis) against the one-rank pass
    on the same global batches: wins and losses exactly, mean losses and
    certainty to 1e-6."""
    from trade_aid_multimodal_transformer_tpu_torch.sampling.feed import BatchFeed
    from trade_aid_multimodal_transformer_tpu_torch.train.metrics import build_metric_specs

    f = _dp_feed_args(MOD_MODEL, 8)
    feed = BatchFeed(f["train"], f["val"], f["file_lengths"], MOD_MODEL["block_size"], GLOBAL_B,
                     False, f["rand_sizes"], list(MOD_MODEL["vocab_sizes"]))
    specs = build_metric_specs(f["vocabs"], [False] * 4, MOD_MODEL["block_size"])
    params = map_tree(lambda t: t.detach().clone(), _jax_reference()[1])
    ref = Trainer(ModelConfig(**MOD_MODEL), feed, make_optimizer(1e-3), specs, 2).eval_pass(
        params, StepRng(11, "cpu"), "val")
    assert int(ref.wins.sum()) + int(ref.losses.sum()) > 0
    for got in (r["eval"] for r in _layout_run("mod2")):
        np.testing.assert_array_equal(got["wins"], ref.wins.numpy())
        np.testing.assert_array_equal(got["losses"], ref.losses.numpy())
        for name in ("mean_loss", "mean_losses", "certainty"):
            assert _err(got[name], getattr(ref, name)) <= 1e-6, name


@pytest.mark.parametrize("fault", ("skip_cross_keys", "mod_offset_0"))
def test_mod_planted_faults_break_the_step(fault):
    """The planted faults over ``{mod: 2}``: a rank that draws no salts for
    the cross sites of another rank's modalities (modality 2's cross masks
    drawn from modality 0's salts), and rank 1's masks keyed as modality
    place 0's: each moves some gradient leaf past the step's gate."""
    (_, jgrads), _, _ = _jax_reference()[0]
    job = _job(dict(mod=2), False, **{fault: True})
    job.update(batches=job["batches"][:1], salts=job["salts"][:1])
    bad = pmesh.run_ranks(torch_rank_bodies.mesh_cases, 2, (job,), timeout=RANK_TIMEOUT)
    assert max(_leaf_errs(bad[0]["whole_grads"], jgrads)) > 1e-3


# ------------------------------------------------------------ the entry


def test_run_training_mod_model_matches_jax_entry_and_loads_on_one_rank(tmp_path, monkeypatch,
                                                                        capfd):
    """``mesh: {mod: 2, model: 2}`` through the port's entry on the CPU (4
    gloo ranks), dropout 0.1, ``save_model: 1``: rank 0's ``Parallelism:``
    plan line and its masked console equal to the JAX runner's on the same
    config (on the virtual mesh), the port's final losses within 2e-2 of
    the JAX runner's, both near the analytic anchor ln 57 + ln 3, the
    port's within 1e-5 of its one-rank
    entry with the same seed, every rank's checksum of the gathered
    parameters equal; the ``.npz`` it wrote (the whole tree) loads in a
    one-rank run (``mesh: off``, ``create_new_model: 0``), which trains
    on."""
    (tmp_path / "mod").mkdir()
    d = _mesh_config(_demo_dir(tmp_path / "mod"), "{mod: 2, model: 2}", 1, 0.1)
    text = (d / "config.yaml").read_text().replace("save_model: 0", "save_model: 1")
    (d / "config.yaml").write_text(text)
    monkeypatch.chdir(d)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res, outs = _run_entries(d, capfd, jax_too=True)
    par = [[x for x in out if x.startswith("Parallelism:")] for out in outs]
    assert par[0][0] == par[1][0] == "Parallelism: modality x2 * tensor x2 over 4 devices", par
    assert re.fullmatch(r"Parallelism: train state: [\d.]+ MB \([\d.]+ MB/device\)", par[1][1])
    masked = [[re.sub(r"\d+(\.\d+)?", "#", x) for x in out] for out in outs]
    assert masked[0] == masked[1]
    # the port draws its weights, batches and salts from torch generators,
    # the JAX runner from its keys: the final losses within about three
    # times the largest gap of the two streams over seeds 0-3 (0.0072),
    # and both near the analytic anchor, as tests/test_config_mesh.py
    # holds a run whose key schedule differs
    jax_losses = [float(x) for x in re.findall(r"Train: ([\d.]+) \| Val: ([\d.]+)",
                                               "\n".join(outs[0]))[-1]]
    for k, want in zip(("train", "val"), jax_losses):
        assert abs(res["losses"][k] - want) <= 2e-2, (k, res["losses"], jax_losses)
    anchor = math.log(57) + math.log(3)
    for got in (res["losses"]["train"], jax_losses[0]):
        assert got == pytest.approx(anchor, abs=0.15)
    sums = res["param_checksums"]
    assert len(sums) == 4 and all(s == sums[0] for s in sums), sums
    total, per_dev = res["train_state_bytes"]
    assert per_dev < total
    saved = load_checkpoint(str(d / "output" / "demo_model.ckpt"), res["cfg"], "cpu")[0]
    for a, b in zip(tree_leaves(saved), tree_leaves(res["params"])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    text = text.replace("mesh: {mod: 2, model: 2}", "mesh: \"off\"")
    (d / "config.yaml").write_text(text.replace("save_model: 1", "save_model: 0"))
    one, _ = _run_entries(d, capfd, jax_too=False)
    for k in ("train", "val"):
        assert abs(res["losses"][k] - one["losses"][k]) <= 1e-5, (k, res["losses"], one["losses"])
    text = text.replace("create_new_model: 1", "create_new_model: 0")
    (d / "config.yaml").write_text(text)
    loaded, (out,) = _run_entries(d, capfd, jax_too=False, seed=4)
    assert "Model: Loaded successfully" in out and "TRAINING COMPLETED SUCCESSFULLY" in out
    assert loaded["plan"].trivial and np.isfinite(loaded["losses"]["train"])
