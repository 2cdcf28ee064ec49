"""The port's training path held against the JAX package on the CPU.

Inputs, salts and batches are made with numpy and handed to both packages;
parameters cross over through ``convert.params_from_jax``. Tolerances:
- dropout masks, KeyGen salts, index plans, windows, augmentation, the
  optimizer update alone: exact (the same integer and f32 arithmetic);
- losses: absolute error <= tol * max(1, |ref|), tol f32 1e-5 (the same
  operations, another summation order), bf16 compute 2e-2 (the same
  rounding points, but a bf16 rounding of an intermediate can flip);
- every gradient leaf, and every parameter's change over a 5-step
  trajectory, against its own scale (``_leaf_errs``): gradients f32 1e-5,
  bf16 0.1 (the largest sound leaf reads 0.065); parameter changes f32
  1e-4, bf16 0.25 (the largest sound leaf reads 0.17: Adam's first steps
  are near sign(g), so an element whose small gradient flips sign under
  bf16 rounding moves the other way). A zero gradient or a Trainer that
  never updates reads 1.0.
"""

import re
from pathlib import Path

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from trade_aid_multimodal_transformer_tpu.config import compat as jax_compat
from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.init import init_params as jax_init
from trade_aid_multimodal_transformer_tpu.models.transformer import total_loss as jax_total_loss
from trade_aid_multimodal_transformer_tpu.ops import layers as jl
from trade_aid_multimodal_transformer_tpu.sampling.augment import augment_tokens as jax_augment_tokens
from trade_aid_multimodal_transformer_tpu.sampling.feed import resolve_rand_sizes as jax_rand_sizes
from trade_aid_multimodal_transformer_tpu.sampling.indices import (
    SplitIndexPlan as JaxPlan,
    gather_windows as jax_gather_windows,
)
from trade_aid_multimodal_transformer_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from trade_aid_multimodal_transformer_tpu.train.metrics import (
    ModalityMetricSpec as JaxSpec,
    batch_directional_metrics as jax_metrics,
)
from trade_aid_multimodal_transformer_tpu.train.steps import (
    build_lr_schedule as jax_schedule,
    make_optimizer as jax_make_optimizer,
)
from trade_aid_multimodal_transformer_tpu_torch.config import compat as port_compat
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import map_tree, tree_leaves
from trade_aid_multimodal_transformer_tpu_torch.models.transformer import total_loss
from trade_aid_multimodal_transformer_tpu_torch.ops import kernels
from trade_aid_multimodal_transformer_tpu_torch.ops import layers as tl
from trade_aid_multimodal_transformer_tpu_torch.sampling import (
    BatchFeed,
    SplitIndexPlan,
    apply_shifts,
    gather_windows,
    resolve_rand_sizes,
)
from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_optimizer_state,
    save_checkpoint,
)
from trade_aid_multimodal_transformer_tpu_torch.train.metrics import (
    ModalityMetricSpec,
    batch_directional_metrics,
)
from trade_aid_multimodal_transformer_tpu_torch.parallel.resolve import plan_mesh
from trade_aid_multimodal_transformer_tpu_torch.train.runner import run_training
from trade_aid_multimodal_transformer_tpu_torch.train.steps import (
    StepRng,
    Trainer,
    build_lr_schedule,
    make_optimizer,
)

from test_torch_host import FOLDER_CONFIG, write_stock_folder  # noqa: E402  (tests/ is on the path)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.1}
DELTA_TOL = {"float32": 1e-4, "bfloat16": 0.25}
SALTS = [(123456789, 3141592653), (0, 1), (4294967295, 2654435761), (77, 77)]
TINY = dict(vocab_sizes=(50, 20, 9, 7), cross_attention=(True, False, True, False),
            n_embd=32, n_head=2, n_layer=2, block_size=16)


def _leaf_errs(got, ref) -> list:
    """Per leaf |got - ref| / max(|ref|, 1e-4 |all of ref|), L2 norms: each
    leaf against its own scale. A leaf below a 1e-4 share of the whole is
    held to that share, so a leaf whose reference is rounding noise (the
    self-attention key biases' gradients here, ~1e-11) is not divided by it."""
    got = [np.asarray(g, np.float32) for g in got]
    ref = [np.asarray(r, np.float32) for r in ref]
    norms = [float(np.linalg.norm(r)) for r in ref]
    floor = 1e-4 * float(np.sqrt(sum(n * n for n in norms)))
    return [float(np.linalg.norm(g - r)) / max(n, floor) for g, r, n in zip(got, ref, norms)]


# ------------------------------------------------------------------ dropout


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 16, 16), (4, 2, 8, 32)])
@pytest.mark.parametrize("salts", SALTS[:3])
def test_hash_keep_mask_nd_is_bit_equal_to_jax(shape, salts):
    s1, s2 = salts
    ref = jl.hash_keep_mask_nd(jnp.uint32(s1), jnp.uint32(s2), shape, 0.2)
    got = tl.hash_keep_mask_nd(s1, s2, shape, 0.2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_keygen_salts_equal_jax_including_nesting():
    for key in SALTS:
        jk, tk = jl.KeyGen(jnp.asarray(key, jnp.uint32)), tl.KeyGen(np.asarray(key, np.uint32))
        for _ in range(6):
            block_j, block_t = jk(), tk()
            assert tuple(int(v) for v in np.asarray(block_j)) == block_t
            inner_j, inner_t = jl.KeyGen(block_j), tl.KeyGen(block_t)
            for _ in range(5):
                assert tuple(int(v) for v in np.asarray(inner_j())) == inner_t()
    assert tl.KeyGen(None)() is None
    assert all(tl.mix32_const(i) == int(jl.mix32_const(i)) for i in range(50))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_forward_and_backward_equal_jax(dtype):
    """Values and the gradient (the mask regenerated in the backward) are
    bit-identical to JAX's ``dropout`` for seeded salts."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 8, 24)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    key = SALTS[0]
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref, vjp = jax.vjp(lambda a: jl.dropout(a, 0.2, jnp.asarray(key, jnp.uint32), True), jx)
    (ref_g,) = vjp(jnp.asarray(g).astype(getattr(jnp, dtype)))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    out = tl.dropout(tx, 0.2, key, True)
    out.backward(torch.from_numpy(g).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(tx.grad.float().numpy(), np.asarray(ref_g, np.float32))
    assert tl.dropout(tx, 0.2, key, False) is tx and tl.dropout(tx, 0.0, key, True) is tx


def test_dense_cross_dropout_uses_the_jax_site_layout():
    """The port's dense cross core takes q and k/v in the JAX site's
    (B, H, T, hs) order (the model projects so outside the whole-row kernel
    band) and draws its mask over JAX's (J, B, H, T, T) affinity: equal to the
    JAX dense core on the same inputs."""
    from trade_aid_multimodal_transformer_tpu.ops.attention import cross_causal_attention as jcross
    from trade_aid_multimodal_transformer_tpu_torch.ops.attention import cross_causal_attention

    rng = np.random.default_rng(3)
    J, H, B, T, hs = 3, 2, 4, 4, 8  # T below the kernel band: the dense core on both sides
    q = rng.standard_normal((B, H, T, hs)).astype(np.float32)
    k, v = (rng.standard_normal((J, B, H, T, hs)).astype(np.float32) for _ in range(2))
    ref = jcross(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3,
                 jnp.asarray(SALTS[0], jnp.uint32), True, "jnp")
    got = cross_causal_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 "auto", 0.3, SALTS[0], True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


# ------------------------------------------------------------------ model


def _pair(compute_dtype: str, dropout: float, seed: int = 0, **kw):
    cfg_kw = dict(TINY, compute_dtype=compute_dtype, dropout=dropout, **kw)
    jcfg, tcfg = JaxConfig(**cfg_kw), ModelConfig(**cfg_kw)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams


def _torch_params(jparams):
    return map_tree(lambda t: t.requires_grad_(),
                    params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))


def _batch(cfg, B: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, (B, cfg.block_size + 1)) for v in cfg.vocab_sizes])
    return ids[..., :-1].astype(np.int32), ids[..., 1:].astype(np.int32)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_total_loss_and_every_gradient_match_jax(compute_dtype, dropout):
    """Dense path on both sides, the same params, batch and raw uint32[2] rng."""
    jcfg, tcfg, jparams = _pair(compute_dtype, dropout)
    xb, yb = _batch(tcfg, 3, seed=1)
    key = SALTS[0]
    (jloss, jlosses), jgrads = jax.jit(jax.value_and_grad(
        lambda p, x, y, k: jax_total_loss(p, jcfg, x, y, k, True), has_aux=True))(
        jparams, jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(key, jnp.uint32))
    tparams = _torch_params(jparams)
    loss, losses = total_loss(tparams, tcfg, torch.from_numpy(xb), torch.from_numpy(yb), key, True)
    grads = torch.autograd.grad(loss, tree_leaves(tparams))
    tol = TOL[compute_dtype]
    assert abs(loss.item() - float(jloss)) <= tol * max(1.0, abs(float(jloss)))
    for a, b in zip(losses, jlosses):
        assert abs(a.item() - float(b)) <= tol * max(1.0, abs(float(b)))
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    assert max(_leaf_errs([g.numpy() for g in grads], jleaves)) <= GRAD_TOL[compute_dtype]


def test_training_forward_without_rng_raises_only_with_dropout():
    _, tcfg, jparams = _pair("float32", 0.2)
    tparams = _torch_params(jparams)
    xb, yb = (torch.from_numpy(a) for a in _batch(tcfg, 1, seed=2))
    with pytest.raises(ValueError, match="key"):
        total_loss(tparams, tcfg, xb, yb, None, True)
    total_loss(tparams, tcfg, xb, yb, None, False)  # eval: no dropout, no key


# ------------------------------------------------------------------ optimizer


OPT_CASES = {
    "adamw_f32": dict(),
    "adamw_mu_bf16": dict(moment_dtype="bfloat16"),
    "lowmem_bf16": dict(moment_dtype="bfloat16", nu_dtype="bfloat16"),
    "cosine": dict(lr_schedule={"type": "cosine", "warmup_steps": 2, "decay_steps": 6,
                                "min_lr_ratio": 0.1}),
    "linear_lowmem": dict(nu_dtype="bfloat16",
                          lr_schedule={"type": "linear", "warmup_steps": 2, "decay_steps": 6}),
    "bf16_params": dict(params_dtype="bfloat16", moment_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_update_alone_equals_jax(case):
    """Seven updates of a small tree with the same gradients: parameters and
    moments bit-equal to the JAX package's make_optimizer."""
    kw = OPT_CASES[case]
    pdt = np.float32
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 7)), "b": [rng.standard_normal((3,))]}
    bf16 = kw.get("params_dtype") == "bfloat16"
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32), tree)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jopt, topt = jax_make_optimizer(1e-2, **kw), make_optimizer(1e-2, **kw)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(7):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(pdt), tree)
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16 if bf16 else jnp.float32), g)
        u, js = jopt.update(jg, js, jp)
        jp = optax.apply_updates(jp, u)
        topt.update_(tp, [torch.from_numpy(np.array(x.astype(jnp.float32))).to(t.dtype)
                          for x, t in zip(jax.tree_util.tree_leaves(jg), tree_leaves(tp))], ts)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b.float().numpy())
    adam = js if topt.lowmem else js[0]
    assert int(adam.count) == ts["count"] == 7
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(adam, name)), tree_leaves(ts[name])):
            np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b.float().numpy())


@pytest.mark.parametrize("spec", [
    None,
    {"type": "cosine", "warmup_steps": 3, "decay_steps": 20, "min_lr_ratio": 0.1},
    {"type": "cosine", "warmup_steps": 0, "decay_steps": 10},
    {"type": "linear", "warmup_steps": 4, "decay_steps": 12, "min_lr_ratio": 0.2},
    {"type": "linear", "warmup_steps": 0, "decay_steps": 5},
    {"type": "constant", "warmup_steps": 5, "decay_steps": 10},
])
def test_lr_schedules_equal_optax(spec):
    ref, ours = jax_schedule(3e-4, spec), build_lr_schedule(3e-4, spec)
    for count in range(25):
        want = float(ref(count)) if callable(ref) else float(ref)
        got = float(ours(count)) if callable(ours) else float(ours)
        assert abs(got - want) <= 1e-7 * 3e-4, (count, got, want)
    with pytest.raises(ValueError):
        build_lr_schedule(1e-3, {"type": "step", "decay_steps": 3})


# ------------------------------------------------------------------ trajectory


TRAJ = {
    # dropout on, f32 compute, optax.adamw with f32 moments
    "adamw_f32": (dict(compute_dtype="float32"), dict(), 1),
    # the production optimizer path: bf16 compute, bf16 mu and nu (lowmem)
    "lowmem_bf16": (dict(compute_dtype="bfloat16"),
                    dict(moment_dtype="bfloat16", nu_dtype="bfloat16"), 1),
    # two microbatches per step and a warmup-cosine schedule
    "accum2_cosine": (dict(compute_dtype="float32"),
                      dict(lr_schedule={"type": "cosine", "warmup_steps": 2, "decay_steps": 5}), 2),
}


def _jax_trajectory(jcfg, jparams, opt, batches, salts, accum):
    vg = jax.jit(jax.value_and_grad(
        lambda p, x, y, k: jax_total_loss(p, jcfg, x, y, k, True), has_aux=True))
    state, p, losses = opt.init(jparams), jparams, []
    for step in range(len(batches) // accum):
        loss_sum, grad_sum = jnp.asarray(0.0), jax.tree.map(jnp.zeros_like, p)
        for i in range(step * accum, (step + 1) * accum):
            (loss, _), g = vg(p, jnp.asarray(batches[i][0]), jnp.asarray(batches[i][1]),
                              jnp.asarray(salts[i], jnp.uint32))
            if accum == 1:
                loss_sum, grad_sum = loss, g
            else:  # the JAX Trainer's microbatch walk
                loss_sum, grad_sum = loss_sum + loss, jax.tree.map(jnp.add, grad_sum, g)
        if accum > 1:
            inv = 1.0 / accum
            loss_sum = loss_sum * inv
            grad_sum = jax.tree.map(lambda g: (g.astype(jnp.float32) * inv).astype(g.dtype), grad_sum)
        u, state = opt.update(grad_sum, state, p)
        p = optax.apply_updates(p, u)
        losses.append(float(loss_sum))
    return p, losses


@pytest.mark.parametrize("case", sorted(TRAJ))
def test_five_step_trajectory_matches_jax(case):
    model_kw, opt_kw, accum = TRAJ[case]
    jcfg, tcfg, jparams = _pair(model_kw["compute_dtype"], 0.2, seed=4)
    steps = 5
    batches = [_batch(tcfg, 2, seed=10 + i) for i in range(steps * accum)]
    salts = [(int(a), int(b)) for a, b in
             np.random.default_rng(9).integers(0, 2**32, (steps * accum, 2), dtype=np.uint64)]
    jp, jlosses = _jax_trajectory(jcfg, jparams, jax_make_optimizer(1e-3, **opt_kw),
                                  batches, salts, accum)
    tparams = _torch_params(jparams)
    init = [t.detach().clone() for t in tree_leaves(tparams)]
    opt = make_optimizer(1e-3, **opt_kw)
    trainer = Trainer(tcfg, None, opt, [], 1, grad_accum=accum)
    state = opt.init(tparams)
    tlosses = []
    for step in range(steps):
        micro = range(step * accum, (step + 1) * accum)
        tlosses.append(trainer.step(
            tparams, state,
            [tuple(torch.from_numpy(a) for a in batches[i]) for i in micro],
            [salts[i] for i in micro]).item())
    tol = TOL[model_kw["compute_dtype"]]
    np.testing.assert_allclose(tlosses, jlosses, atol=tol * max(1.0, max(jlosses)), rtol=0)
    # every parameter's change from its initial value, against JAX's
    jdelta = [np.asarray(a, np.float32) - np.asarray(b, np.float32)
              for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(jparams))]
    tdelta = [(b.detach() - a).numpy() for a, b in zip(init, tree_leaves(tparams))]
    assert max(_leaf_errs(tdelta, jdelta)) <= DELTA_TOL[model_kw["compute_dtype"]]
    assert state["count"] == steps


# ------------------------------------------------------------------ sampling


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("is_percents", [False, True])
def test_index_plan_and_windows_equal_jax(split, is_percents):
    file_lengths = [40, 25, 33, 18]
    size = 90 if split == "train" else 26
    jplan = JaxPlan.build(size, 8, split, file_lengths, is_percents)
    plan = SplitIndexPlan.build(size, 8, split, file_lengths, is_percents)
    for name in ("file_starts", "valid_counts", "cum_valid"):
        np.testing.assert_array_equal(getattr(plan, name), getattr(jplan, name))
    assert plan.total_valid == jplan.total_valid
    key = jax.random.PRNGKey(3)
    draws = np.asarray(jax.random.randint(key, (64,), 0, jplan.total_valid))
    ref = np.asarray(jplan.sample_starts(key, 64))
    got = plan.starts_from_draws(torch.from_numpy(np.array(draws)).long())
    np.testing.assert_array_equal(got.numpy(), ref)
    data = np.arange(size * 3).reshape(3, size) % 97
    ref_w = jax.vmap(lambda d: jax_gather_windows(d, jnp.asarray(ref), 8))(jnp.asarray(data))
    np.testing.assert_array_equal(gather_windows(torch.from_numpy(data), got, 8).numpy(),
                                  np.asarray(ref_w))


def test_sampled_starts_lie_in_the_valid_set():
    plan = SplitIndexPlan.build(300, 16, "train", [120, 100, 80], True)
    valid = set(plan.valid_start_set().tolist())
    gen = torch.Generator().manual_seed(0)
    starts = torch.cat([plan.sample_starts(gen, 256) for _ in range(8)])
    assert set(starts.tolist()) <= valid
    assert len(set(starts.tolist())) > 0.5 * len(valid)


@pytest.mark.parametrize("rand_size,vocab", [(1, 10), (2, 57), (3, 8)])
def test_augment_tokens_equal_jax_on_the_same_shifts(rand_size, vocab):
    key = jax.random.PRNGKey(rand_size)
    tokens = np.random.default_rng(0).integers(0, vocab, (4, 33)).astype(np.int32)
    ref = np.asarray(jax_augment_tokens(key, jnp.asarray(tokens), rand_size, vocab))
    shifts = np.asarray(jax.random.randint(key, tokens.shape, -rand_size, rand_size + 1,
                                           dtype=jnp.int32))
    got = apply_shifts(torch.from_numpy(tokens), torch.from_numpy(shifts), rand_size, vocab)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.min() >= 0 and got.max() < vocab


def test_batch_feed_windows_and_rand_sizes():
    params = [["p", 13, 2, False, None, None, None, 2, True],
              ["q", 13, None, False, None, None, None, None, False]]
    assert resolve_rand_sizes(params) == jax_rand_sizes(params) == [2, None]
    assert resolve_rand_sizes(params, True) == jax_rand_sizes(params, True) == [2, None]
    rng = np.random.default_rng(1)
    train = [rng.integers(0, 9, 200), rng.integers(0, 5, 200)]
    val = [rng.integers(0, 9, 40), rng.integers(0, 5, 40)]
    feed = BatchFeed(train, val, [120, 120], 16, 6, False, [2, None], [9, 5])
    gen = torch.Generator().manual_seed(0)
    xb, yb = feed.get_batch(gen, "val", False)
    assert xb.shape == yb.shape == (2, 6, 16)
    assert torch.equal(xb[:, :, 1:], yb[:, :, :-1])
    data = torch.from_numpy(np.stack(val))
    for b in range(6):  # the same start for every modality
        s = [i for i in range(40 - 16) if torch.equal(data[0, i:i + 16], xb[0, b])]
        assert any(torch.equal(data[1, i:i + 16], xb[1, b]) for i in s)
    xt, _ = feed.get_batch(gen, "train", True)
    assert xt[0].max() < 9 and xt[0].min() >= 0


@pytest.mark.parametrize("shared", [True, False])
def test_batch_feed_noise_scope(shared):
    """augment_shared (the reference's scope, set with compat_legacy_rand_index)
    perturbs the whole train array once per draw, so windows drawn at the same
    start are equal; the default draws noise per window, so they differ."""
    data = np.tile(np.arange(5, 10), 12)  # 60 tokens, all inside the edge guard
    feed = BatchFeed([data], [data[:30]], [60], 8, 256, False, [2], [20], augment_shared=shared)
    plan_gen, gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    starts = feed.train_plan.sample_starts(plan_gen, 256)  # the draw sample() makes first
    xb, _ = feed.sample(gen, "train", augment=True)
    assert not torch.equal(xb[0], torch.from_numpy(data)[starts[:, None] + torch.arange(8)])
    first = {}
    same = []
    for s0, w in zip(starts.tolist(), xb[0]):
        if s0 in first:
            same.append(torch.equal(first[s0], w))
        first.setdefault(s0, w)
    assert same and all(same) == shared and any(same) == shared


# ------------------------------------------------------------------ metrics


@pytest.mark.parametrize("is_percent", [False, True])
def test_directional_metrics_equal_jax(is_percent):
    vocab = [-2.0, -0.5, 0.0, 0.5, 1.0, 3.0]
    spec, jspec = ModalityMetricSpec.build(vocab, is_percent, 8), JaxSpec.build(vocab, is_percent, 8)
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((16, 6)).astype(np.float32)
    x, y = rng.integers(0, 6, 16), rng.integers(0, 6, 16)
    ref = jax_metrics(jnp.asarray(logits), jnp.asarray(x), jnp.asarray(y), jspec)
    got = batch_directional_metrics(torch.from_numpy(logits), torch.from_numpy(x),
                                    torch.from_numpy(y), spec)
    assert int(got[0]) == int(ref[0]) and int(got[1]) == int(ref[1])
    assert abs(float(got[2]) - float(ref[2])) <= 1e-5
    assert not ModalityMetricSpec.build(["a", "b"], False, 8).eligible


# ------------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("case", ["adamw_mu_bf16", "lowmem_bf16", "cosine"])
def test_optimizer_state_round_trips_between_packages(tmp_path, case):
    """A JAX checkpoint's moments load into the port, and the port's write
    the same keys back (so a resumed run in either package continues them)."""
    kw = OPT_CASES[case]
    jcfg, tcfg, jparams = _pair("float32", 0.0, seed=2)
    jopt, topt = jax_make_optimizer(1e-3, **kw), make_optimizer(1e-3, **kw)
    rng = np.random.default_rng(5)
    jstate = jopt.init(jparams)
    for _ in range(2):
        g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), jparams)
        u, jstate = jopt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, u)
    path = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(path, jparams, jstate, step=2)
    params, step = load_checkpoint(path, tcfg, "cpu")
    state = load_optimizer_state(path, params, topt)
    assert step == 2 and state["count"] == 2
    adam = jstate if topt.lowmem else jstate[0]
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(adam, name)), tree_leaves(state[name])):
            np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b.float().numpy())
    back = str(tmp_path / "port.ckpt")
    save_checkpoint(back, params, step=2, opt_state=state, optimizer=topt)
    p2, o2, s2, _ = jax_load_checkpoint(back, jparams, jopt.init(jparams))
    assert s2 == 2
    for a, b in zip(jax.tree_util.tree_leaves(o2), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert load_optimizer_state(str(tmp_path / "jax.ckpt"), params,
                                make_optimizer(1e-3, nu_dtype="bfloat16" if not topt.lowmem
                                               else "float32")) is None


# ------------------------------------------------------------------ runner


TRAIN_CONFIG = FOLDER_CONFIG.replace(
    "  block_size: 16\n",
    "  block_size: 16\n  max_iters: 3\n  eval_interval: 2\n  eval_iters: 2\n",
).replace("dropout: 0.0", "dropout: 0.2") + """tpu_options:
  compute_dtype: bfloat16
  adam_moment_dtype: bfloat16
  adam_nu_dtype: bfloat16
"""


@pytest.fixture
def train_folder(tmp_path, monkeypatch):
    write_stock_folder(tmp_path / "your_data" / "stocks", n_files=3, rows=300, seed=7)
    (tmp_path / "config.yaml").write_text(TRAIN_CONFIG)
    (tmp_path / "input_schemas.yaml").write_text(
        (Path(__file__).resolve().parent.parent / "examples" / "production_input_schemas.yaml").read_text())
    monkeypatch.chdir(tmp_path)
    port_compat.reset_compatibility_layer()
    yield tmp_path
    port_compat.reset_compatibility_layer()
    jax_compat.reset_compatibility_layer()


def test_run_training_on_the_cpu_prints_sections_and_saves_a_shared_checkpoint(train_folder, capsys):
    kernels.reset_launch_counts()
    res = run_training(caller_globals={}, seed=3)
    out = capsys.readouterr().out
    for section in ("TRADE-AID MULTIMODAL TRANSFORMER", "VOCABULARY BUILDING", "DATASET SPLITTING",
                    "MODEL CREATION & TRAINING", "TRAINING PROGRESS", "  - Device: cpu",
                    "DIRECTIONAL METRICS - Train Set", "LOSS METRICS: Step 0/3",
                    "LOSS METRICS: Step 2/3", "TRAINING COMPLETED SUCCESSFULLY",
                    "Final Save: Model checkpoint"):
        assert section in out, section
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert np.isfinite(res["losses"]["train"]) and np.isfinite(res["losses"]["val"])
    log = (train_folder / "output" / "training_log.txt").read_text()
    assert "TRADE-AID MULTIMODAL TRANSFORMER TRAINING LOG" in log and "STEP 2/3" in log
    ckpt = str(train_folder / "output" / "model.ckpt")
    # the port reads its own checkpoint back, moments included
    params, step = load_checkpoint(ckpt, res["cfg"], "cpu")
    state = load_optimizer_state(ckpt, params, res["trainer"].optimizer)
    assert step == 3 and state["count"] == 3
    for a, b in zip(tree_leaves(params), tree_leaves(res["params"])):
        assert torch.equal(a, b.detach().float())
    # the JAX package reads it with its own templates of the same config
    jcfg = JaxConfig(vocab_sizes=res["cfg"].vocab_sizes, cross_attention=res["cfg"].cross_attention,
                     n_embd=32, n_head=2, n_layer=2, block_size=16, dropout=0.2,
                     compute_dtype="bfloat16")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    jopt = jax_make_optimizer(1e-3, moment_dtype="bfloat16", nu_dtype="bfloat16")
    jp, jo, jstep, _ = jax_load_checkpoint(ckpt, jparams, jopt.init(jparams))
    assert jstep == 3 and int(jo.count) == 3
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree_util.tree_leaves(jo.nu), tree_leaves(state["nu"])):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b.float().numpy())


def test_run_training_console_equals_jax_with_numbers_masked(train_folder, capsys):
    """The port's console is the JAX runner's, line for line, on the same
    config and data, once every number (losses, times, counts) is masked.
    ``mesh: off`` keeps the JAX runner on one of the tests' 8 virtual CPU
    devices."""
    import re

    from trade_aid_multimodal_transformer_tpu.train.runner import run_training as jax_run_training

    cfg = train_folder / "config.yaml"
    cfg.write_text(cfg.read_text() + "  mesh: off\n")
    outs = []
    for run, compat in ((jax_run_training, jax_compat), (run_training, port_compat)):
        compat.reset_compatibility_layer()
        run(caller_globals={}, seed=3)
        outs.append([re.sub(r"\d+(\.\d+)?", "#", line)
                     for line in capsys.readouterr().out.splitlines()])
    assert outs[0] == outs[1]


def test_run_training_resumes_from_its_checkpoint(train_folder, capsys):
    run_training(caller_globals={}, seed=3)
    cfg = train_folder / "config.yaml"
    cfg.write_text(cfg.read_text().replace('model_file_name: "output/model.ckpt"',
                                           'model_file_name: "output/model.ckpt"\n  create_new_model: 0'))
    port_compat.reset_compatibility_layer()
    capsys.readouterr()
    res = run_training(caller_globals={}, seed=4)
    out = capsys.readouterr().out
    assert "Model: Loaded successfully" in out
    assert res["opt_state"]["count"] == 6  # three more steps on the loaded moments


_PLAN_KW = dict(batch_size=8, block_size=64, n_head=6, num_modalities=4, n_layer=6)


def test_mesh_that_needs_more_devices_raises():
    """On one card the trivial plans resolve and a plan that needs more
    devices raises as the JAX package's (``ValueError``); on the CPU the
    ranks of ``context_parallel`` are processes, so ``("auto", 2)`` resolves
    to the sequence axis."""
    for ok in ("auto", "off", None, 1, {"data": 1, "model": 1}):
        assert plan_mesh(ok, 1, n_devices=1, **_PLAN_KW).trivial
    for bad, cp in ((2, 1), ({"data": 2}, 1), ("auto", 2)):
        with pytest.raises(ValueError, match="device"):
            plan_mesh(bad, cp, n_devices=1, **_PLAN_KW)
    plan = plan_mesh("auto", 2, n_devices=2, **_PLAN_KW)
    assert (plan.seq, plan.n_devices, plan.describe()) == (2, 2, "context x2")


# (mesh, context_parallel, devices, fsdp): JAX's plan or error, in the port
# the same plan where it has only a sequence axis, the same error where JAX
# raises, and NotImplementedError (a later slice) where JAX's plan has a
# data, tensor, modality or pipeline axis
PLAN_CASES = [
    ("auto", 1, 1, False), ("off", 1, 1, False), (None, 1, 1, False), (1, 1, 1, False),
    ({"data": 1, "model": 1}, 1, 1, False), ("auto", 2, 2, False), ("off", 2, 2, False),
    ("off", 4, 8, False), ("auto", 4, 4, False), ({"data": 1}, 2, 2, False),
    ("auto", 2, 1, False), ("auto", 3, 4, False), (2, 1, 1, False), ({"data": 2}, 1, 1, False),
    ("auto", 1, 2, False), ("auto", 2, 8, False), ("auto", 1, 4, True), ({"data": 2}, 1, 2, False),
    ({"model": 2}, 1, 2, False), ({"mod": 2}, 1, 2, False), ({"pipe": 2}, 1, 2, False),
    ({"mod": 3}, 1, 4, False), ({"pipe": 4}, 1, 4, False), ({"data": 3}, 1, 4, False),
    ({"bogus": 2}, 1, 2, False), ({"data": 0}, 1, 2, False), ("sideways", 1, 1, False),
    ({"data": 1}, 2, 2, True),
]


@pytest.mark.parametrize("mesh,cp,n,fsdp", PLAN_CASES)
def test_plan_mesh_matches_jax(mesh, cp, n, fsdp):
    from trade_aid_multimodal_transformer_tpu.parallel.resolve import plan_mesh as jax_plan_mesh

    kw = dict(_PLAN_KW, pipeline_microbatches=4, fsdp=fsdp)
    try:
        ref = jax_plan_mesh(mesh, cp, devices=[object()] * n, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            plan_mesh(mesh, cp, n_devices=n, **kw)
        return
    if ref.n_devices != ref.seq or ref.fsdp:
        with pytest.raises(NotImplementedError, match="later slice"):
            plan_mesh(mesh, cp, n_devices=n, **kw)
        return
    got = plan_mesh(mesh, cp, n_devices=n, **kw)
    assert (got.describe(), got.n_devices, got.seq, got.trivial) == (
        ref.describe(), ref.n_devices, ref.seq, ref.trivial)


def test_trainer_chunk_and_step_draw_from_the_feed():
    """train_chunk / train_step draw their batches from the feed and their
    salts from the StepRng; the same seed gives the same losses."""
    _, tcfg, jparams = _pair("float32", 0.2, seed=6)
    rng = np.random.default_rng(0)
    sets = [rng.integers(0, v, 120) for v in tcfg.vocab_sizes]
    feed = BatchFeed(sets, [a[:40] for a in sets], [120], 16, 2, False, [1, None, None, None],
                     list(tcfg.vocab_sizes))
    runs = []
    for _ in range(2):
        params, opt = _torch_params(jparams), make_optimizer(1e-3)
        trainer = Trainer(tcfg, feed, opt, [], 1)
        state, step_rng = opt.init(params), StepRng(1, "cpu")
        _, _, losses = trainer.train_chunk(params, state, step_rng, 2)
        _, _, last = trainer.train_step(params, state, step_rng)
        runs.append(losses.tolist() + [last.item()])
        assert state["count"] == 3
    assert runs[0] == runs[1] and all(np.isfinite(runs[0]))


def test_step_rng_draws_u32_salts():
    rng = StepRng(5, "cpu")
    salts = [rng.salts() for _ in range(50)]
    assert all(0 <= s < 2**32 for pair in salts for s in pair)
    assert len(set(salts)) == 50
    again = StepRng(5, "cpu")
    assert [again.salts() for _ in range(50)] == salts
