"""The port's long-context path held against the JAX package on the CPU: the
flash kernels' plain versions (K5f ``flash_attention_plain``, K5b
``flash_attention_bwd_plain``, K6f / K6f-r ``flash_cross_attention_plain``)
against the Pallas kernels in interpret mode, and the model at block_size
1024 with the card's dispatch rehearsed through those plain versions.

Inputs are made with numpy and handed to both packages; parameters cross
over through ``convert.params_from_jax``. Tolerances:
- dropout keep-masks: bit for bit (the same integer hash on the same block
  grid);
- kernels: max-abs error <= tol * max(1, max|ref|), tol f32 1e-5 (the same
  arithmetic on the same block grid, another summation order), bf16 2e-2
  (the same rounding points; a different summation order can flip a bf16
  rounding of an intermediate); lse (f32 in both dtypes) 1e-5 relative;
- the model (f32): logits atol 1e-4, losses 1e-5 relative, every gradient
  leaf by its L2 error against its own scale 1e-5 (``_leaf_errs`` of
  tests/test_torch_train.py); the --serve chunk's logits atol 1e-4 against
  the JAX package's cached forward.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trade_aid_multimodal_transformer_tpu.models import cache as jcache
from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.init import init_params as jax_init
from trade_aid_multimodal_transformer_tpu.models.transformer import forward as jax_forward
from trade_aid_multimodal_transformer_tpu.models.transformer import total_loss as jax_total_loss
from trade_aid_multimodal_transformer_tpu.ops import pallas_attention as jpa
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.models import cache as tcache
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import map_tree, tree_leaves
from trade_aid_multimodal_transformer_tpu_torch.models.transformer import forward, total_loss
from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K

from test_torch_train import _leaf_errs  # noqa: E402  (tests/ is on the path)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SALTS = np.array([123456789, 3141592653], np.uint32)


def _rel_err(got, ref):
    ref = np.asarray(jnp.asarray(ref, jnp.float32)) if not isinstance(ref, torch.Tensor) else ref.float().numpy()
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _normal(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _seed(rate):
    return jpa.seed_from_key(jnp.asarray(SALTS)) if rate else jnp.zeros((1,), jnp.int32)


# ------------------------------------------------------------------ shapes


@pytest.mark.parametrize("t", [128, 256, 384, 640, 768, 896, 1024, 1536, 2048, 3072, 8192])
def test_pick_block_and_eligibility_equal_jax(t):
    assert K.flash_pick_block(t) == jpa._pick_block(t, jpa.DEFAULT_BQ)
    for t_ in (t, t + 8, t + 64):
        for hs in (16, 64, 256, 320):
            q = np.broadcast_to(np.float32(0), (2, t_, hs))  # shapes only
            kv = np.broadcast_to(np.float32(0), (3, 2, t_, hs))
            assert K.flash_eligible(t_, hs) == jpa.flash_attention_eligible(q, q, q)
            assert K.flash_eligible(t_, hs) == jpa.flash_cross_eligible(q, kv, kv)


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5])
@pytest.mark.parametrize("t", [256, 768, 1024])
def test_flash_keep_mask_is_bit_equal_to_jax(t, rate):
    """The plain versions' mask of block (iq, jk) of every row, and a stream's
    shifted seed, against the interpret-mode ``_keep_mask`` of the kernels."""
    blk = K.flash_pick_block(t)
    seed = jpa.seed_from_key(jnp.asarray(SALTS))[0]
    for stream in (None, 0, 2):
        jseed = seed if stream is None else seed + (stream + 1) * jpa._STREAM_SEED_STRIDE
        tseed = K._flash_seed(rate, SALTS, stream)
        for iq, jk in ((0, 0), (t // blk - 1, 0), (t // blk - 1, t // blk - 1)):
            got = K._flash_keep(tseed, 3, iq, jk, blk, blk, rate, None)
            for n in range(3):
                ref = jpa._keep_mask(jseed, n, iq, jk, (blk, blk), rate, True)
                np.testing.assert_array_equal(got[n].numpy(), np.asarray(ref))


# ------------------------------------------------------------------ K5f, K5b


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hs", [16, 64])
@pytest.mark.parametrize("t", [256, 640, 768, 1024])
def test_flash_causal_value_lse_and_grads_match_jax_interpret(t, hs, dtype, rate):
    """``flash_causal_attention`` (K5f forward, K5b backward, through their
    plain versions on the CPU) against the JAX entry and its custom VJP in
    interpret mode, and K5f's logsumexp against ``_flash_forward``'s. T 640
    and 768 key the dropout on 128- and 384-blocks."""
    rng = np.random.default_rng(t + hs)
    q, k, v, do = (_normal((2, 1, t, hs), rng) for _ in range(4))
    salts = SALTS if rate else None

    def f(q_, k_, v_):
        return jpa.flash_causal_attention(
            q_, k_, v_, interpret=True, dropout_rate=rate,
            dropout_key=None if salts is None else jnp.asarray(salts))

    ref, vjp = jax.vjp(f, *(_to_jax(a, dtype) for a in (q, k, v)))
    ref_grads = vjp(_to_jax(do, dtype))
    tq, tk, tv = (_to_torch(a, dtype).requires_grad_() for a in (q, k, v))
    out = K.flash_causal_attention(tq, tk, tv, rate, salts)
    out.backward(_to_torch(do, dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == tq.shape
    assert _rel_err(out, ref) <= TOL[dtype]
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        assert got.dtype == getattr(torch, dtype)
        assert _rel_err(got, want) <= TOL[dtype]

    blk = jpa._pick_block(t, jpa.DEFAULT_BQ)
    q3, k3, v3 = (_to_jax(a.reshape(2, t, hs), dtype) for a in (q, k, v))
    _, lse_ref = jpa._flash_forward(q3, k3, v3, _seed(rate), blk, blk, rate, True)
    _, lse = K.flash_attention_plain(*(_to_torch(a.reshape(2, t, hs), dtype) for a in (q, k, v)),
                                     rate, salts)
    assert lse.dtype == torch.float32 and lse.shape == (2, 1, t)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=1e-5, atol=0)


FWD_TIERS = {"row": jpa._flash_forward, "streamed": jpa._flash_forward_streamed}
BWD_TIERS = {"fused": jpa._flash_backward_fused, "split": jpa._flash_backward,
             "streamed": jpa._flash_backward_streamed}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tier", sorted(BWD_TIERS))
def test_flash_plain_versions_match_every_jax_tier(tier, dtype):
    """The TPU package runs K5 in three tiers by its VMEM budget (row /
    fused, split, streamed); the port's one kernel pair is their counterpart.
    Each tier's kernels, called directly in interpret mode with dropout on,
    against the plain versions on the same out, lse and cotangent."""
    t, hs, rate = 768, 16, 0.25
    rng = np.random.default_rng(11)
    q, k, v, g = (_normal((3, t, hs), rng) for _ in range(4))
    jq, jk, jv, jg = (_to_jax(a, dtype) for a in (q, k, v, g))
    tq, tk, tv, tg = (_to_torch(a, dtype) for a in (q, k, v, g))
    blk, seed = jpa._pick_block(t, jpa.DEFAULT_BQ), _seed(rate)
    fwd = FWD_TIERS["streamed" if tier == "streamed" else "row"]
    out_ref, lse_ref = fwd(jq, jk, jv, seed, blk, blk, rate, True)
    out, lse = K.flash_attention_plain(tq, tk, tv, rate, SALTS)
    assert _rel_err(out, out_ref) <= TOL[dtype]
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=1e-5, atol=0)
    refs = BWD_TIERS[tier](jq, jk, jv, out_ref, lse_ref, jg, seed, blk, blk, rate, True)
    got = K.flash_attention_bwd(tq, tk, tv, _to_torch(np.asarray(out_ref.astype(jnp.float32)), dtype),
                                torch.from_numpy(np.asarray(lse_ref)), tg, rate, SALTS)
    for name, a, r in zip(("dq", "dk", "dv"), got, refs):
        assert a.dtype == getattr(torch, dtype)
        assert _rel_err(a, r) <= TOL[dtype], name


def test_flash_entry_dispatches_every_tier_to_the_same_values(monkeypatch):
    """The JAX entry's own dispatch, its budgets patched in this test only so
    that T = 512 takes the split and the streamed backward: every tier gives
    the gradients of the port's one kernel pair."""
    t, hs, rate = 512, 16, 0.25
    rng = np.random.default_rng(5)
    q, k, v, do = (_normal((2, t, hs), rng) for _ in range(4))

    def grads_jax():
        f = functools.partial(jpa.flash_causal_attention, interpret=True, dropout_rate=rate,
                              dropout_key=jnp.asarray(SALTS))
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        return vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    K.flash_causal_attention(tq, tk, tv, rate, SALTS).backward(torch.from_numpy(do))
    got = (tq.grad, tk.grad, tv.grad)
    monkeypatch.setattr(jpa, "FUSED_BWD_VMEM_BUDGET", 0)  # split
    for a, r in zip(got, grads_jax()):
        assert _rel_err(a, r) <= TOL["float32"]
    monkeypatch.setattr(jpa, "KV_ROW_VMEM_BUDGET", 1024)  # streamed
    for a, r in zip(got, grads_jax()):
        assert _rel_err(a, r) <= TOL["float32"]


# ------------------------------------------------------------------ K6f, K6f-r


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("J,t,hs", [(2, 256, 16), (3, 1024, 16), (3, 768, 64)])
def test_flash_cross_value_residuals_and_grads_match_jax_interpret(J, t, hs, dtype, rate):
    """``flash_cross_attention`` against the JAX entry and its custom VJP in
    interpret mode (K6f-r forward, per stream K5b with the stream's seed, dq
    summed in q's type); its no-grad forward (K6f); and K6f-r's sum, stream
    outputs and logsumexps against ``_flash_cross_forward_res``. q is JAX's
    (B, H, T, hs), the layout the model projects outside the whole-row band."""
    rng = np.random.default_rng(J * t + hs)
    q, do = _normal((2, 2, t, hs), rng), _normal((2, 2, t, hs), rng)
    k, v = (_normal((J, 2, 2, t, hs), rng) for _ in range(2))
    salts = SALTS if rate else None

    def f(q_, k_, v_):
        return jpa.flash_cross_attention(
            q_, k_, v_, interpret=True, dropout_rate=rate,
            dropout_key=None if salts is None else jnp.asarray(salts))

    ref, vjp = jax.vjp(f, *(_to_jax(a, dtype) for a in (q, k, v)))
    ref_grads = vjp(_to_jax(do, dtype))
    tq, tk, tv = (_to_torch(a, dtype).requires_grad_() for a in (q, k, v))
    out = K.flash_cross_attention(tq, tk, tv, rate, salts)
    out.backward(_to_torch(do, dtype))
    assert _rel_err(out, ref) <= TOL[dtype]
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
        assert _rel_err(got, want) <= TOL[dtype]
    with torch.no_grad():
        assert torch.equal(K.flash_cross_attention(tq, tk, tv, rate, salts), out.detach())

    blk = jpa._pick_block(t, jpa.DEFAULT_BQ)
    jq, jk, jv = (_to_jax(a, dtype) for a in (q.reshape(4, t, hs), k.reshape(J, 4, t, hs),
                                                v.reshape(J, 4, t, hs)))
    s_ref, outs_ref, lses_ref = jpa._flash_cross_forward_res(jq, jk, jv, _seed(rate), blk, blk,
                                                             rate, True)
    s, outs, lses = K.flash_cross_attention_plain(
        *(_to_torch(np.asarray(a.astype(jnp.float32)), dtype) for a in (jq, jk, jv)), rate, salts,
        residuals=True)
    assert _rel_err(s, s_ref) <= TOL[dtype] and _rel_err(outs, outs_ref) <= TOL[dtype]
    np.testing.assert_allclose(lses.numpy(), np.asarray(lses_ref), rtol=1e-5, atol=0)


def test_flash_wrappers_check_shapes_and_salts():
    q = torch.zeros(2, 256, 16)
    with pytest.raises(ValueError):
        K.flash_attention_fwd(q, q[:, :128], q[:, :128])
    with pytest.raises(ValueError):
        K.flash_cross_attention_fwd(q, q, q)  # k, v need a stream axis
    with pytest.raises(ValueError, match="salts"):
        K.flash_attention_fwd(q, q, q, dropout_rate=0.2)
    with pytest.raises(ValueError):
        K.flash_attention_bwd(q, q, q, q, torch.zeros(2, 256), q)  # lse is (n, 1, T)
    with pytest.raises(ValueError):
        K._check_flash("flash", 200, 16)  # not a multiple of 128


# ------------------------------------------------------------------ the model


LONG = dict(vocab_sizes=(13, 7, 9), cross_attention=(True, False, True), n_embd=32, n_head=2,
            n_layer=2, block_size=1024, attn_impl="pallas")
FLASH = ("flash_causal_attention", "flash_cross_attention")


def _long_pair(dropout=0.0, seed=0):
    kw = dict(LONG, dropout=dropout)
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _ids(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, (B, T)) for v in cfg.vocab_sizes]).astype(np.int32)


@pytest.fixture
def card_dispatch(monkeypatch):
    """The card's dispatch run on the CPU. In the port the device test is
    forced on, so attention in the flash band goes through the flash wrappers
    (and a cached decode step through the decode wrapper), which take their
    plain versions for CPU tensors; the calls are counted. In the JAX package
    (``attn_impl: pallas``) its flash entries run in interpret mode, as
    tests/test_kernels.py runs them."""
    calls = dict.fromkeys(FLASH + ("decode_attention_packed",), 0)
    for name in calls:
        def spy(*args, _fn=getattr(K, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(K, name, spy)
    monkeypatch.setattr(tatt, "_kernel_device", lambda device, impl: impl != "jnp")
    monkeypatch.setattr(tcache, "_decode_kernel_active", lambda kc, t_new, impl: t_new == 1)
    for name in FLASH:
        monkeypatch.setattr(jpa, name, functools.partial(getattr(jpa, name), interpret=True))
    return calls


def test_long_forward_matches_jax(card_dispatch):
    """Logits at block_size 1024 (f32, eval), the port through the flash
    wrappers, against the JAX forward through its flash kernels and against
    its dense forward (``attn_impl: jnp``)."""
    jcfg, tcfg, jparams, tparams = _long_pair(seed=1)
    idx = _ids(tcfg, 1, 1024, seed=2)
    got = forward(tparams, tcfg, torch.from_numpy(idx))[0]
    n_cross = sum(tcfg.cross_attention)
    assert card_dispatch == {"flash_causal_attention": 2, "flash_cross_attention": 2 * n_cross,
                             "decode_attention_packed": 0}
    ref = jax_forward(jparams, jcfg, jnp.asarray(idx))[0]
    dense = jax_forward(jparams, JaxConfig(**dict(LONG, attn_impl="jnp")), jnp.asarray(idx))[0]
    for a, r, d in zip(got, ref, dense):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=0)
        np.testing.assert_allclose(a.numpy(), np.asarray(d), atol=1e-4, rtol=0)


def test_long_training_step_matches_jax_with_dropout(card_dispatch):
    """One training step at block_size 1024 with dropout 0.2: loss and every
    gradient leaf through the flash wrappers (K5f/K6f-r forward, K5b
    backward), against the JAX step through its flash kernels in interpret
    mode. Every attention dropout mask is keyed by the JAX kernels' rows and
    blocks, the cross streams by JAX's (B, H) rows."""
    jcfg, tcfg, jparams, tparams = _long_pair(dropout=0.2, seed=3)
    rng = np.random.default_rng(4)
    ids = np.stack([rng.integers(0, v, (1, 1025)) for v in tcfg.vocab_sizes]).astype(np.int32)
    xb, yb = ids[..., :-1], ids[..., 1:]
    key = (123456789, 3141592653)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_total_loss(p, jcfg, jnp.asarray(xb), jnp.asarray(yb),
                                 jnp.asarray(key, jnp.uint32), True), has_aux=True)(jparams)
    tparams = map_tree(lambda t: t.requires_grad_(), tparams)
    loss, _ = total_loss(tparams, tcfg, torch.from_numpy(xb), torch.from_numpy(yb), key, True)
    grads = torch.autograd.grad(loss, tree_leaves(tparams))
    assert card_dispatch["flash_causal_attention"] == 2
    assert card_dispatch["flash_cross_attention"] == 2 * sum(tcfg.cross_attention)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    assert max(_leaf_errs([g.numpy() for g in grads], jleaves)) <= 1e-5


def test_long_serve_chunk_matches_jax(card_dispatch):
    """A steady --serve chunk at block_size 1024: a prefill over the last
    S - S/8 = 896 tokens (the flash band: K5f, K6f) and decode steps at
    positions 896.. (K8p over a cache packed by 8), against the JAX package's
    cached forward on the same tokens, f32."""
    jcfg, tcfg, jparams, tparams = _long_pair(seed=5)
    S, mod = tcfg.block_size, 0
    W = S - S // 8
    idx = _ids(tcfg, 2, W + 3, seed=6)
    jlogits, jc = jcache._prefill(jparams, jcfg, jnp.asarray(idx[:, :, :W]), mod)
    with torch.inference_mode():
        logits, cache = tcache._prefill(tparams, tcfg, torch.from_numpy(idx[:, :, :W]), mod)
        got, want = [logits], [jlogits]
        for s in range(3):
            col = idx[:, :, W + s:W + s + 1]
            logits, cache = tcache.forward_cached(tparams, tcfg, torch.from_numpy(col), cache,
                                                  W + s, mod)
            jlogits, jc = jcache.forward_cached(jparams, jcfg, jnp.asarray(col), jc, W + s, mod)
            got.append(logits)
            want.append(jlogits)
    n_cross = sum(tcfg.cross_attention)
    assert card_dispatch == {"flash_causal_attention": 2, "flash_cross_attention": 2 * n_cross,
                             "decode_attention_packed": 3 * 2 * (1 + n_cross)}
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=0)
