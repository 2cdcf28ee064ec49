"""The port's KV cache and cached serving held against the JAX package's
``models/cache.py``.

Parameters cross over through ``convert.params_from_jax``; token ids and
cache inputs are made with numpy and handed to both packages. Tolerances:
- cache leaves (appends, tails, int8 rows and scales): bit for bit;
- f32 logits, atol 1e-4: the same operations, another summation order;
- bf16 compute, atol 2e-2: both round at the cached path's own points
  (``embed_at``, the head bias, each cross stream before the sum);
- sampling: the port's cached samplers against its own ``generate_fast``,
  token for token (both draw one ``torch.multinomial`` per token).
On the CPU every attention of the cached path is the dense expression, as
it is in the JAX package off the TPU; the decode kernels' plain versions
are held against the Pallas kernels in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trade_aid_multimodal_transformer_tpu.models import cache as jcache
from trade_aid_multimodal_transformer_tpu.models.config import ModelConfig as JaxConfig
from trade_aid_multimodal_transformer_tpu.models.init import init_params as jax_init
from trade_aid_multimodal_transformer_tpu_torch.convert import params_from_jax
from trade_aid_multimodal_transformer_tpu_torch.models import cache as tcache
from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.sampler import generate_fast
from trade_aid_multimodal_transformer_tpu_torch.ops import kernels

CONFIGS = {
    # hs 32, S 32: pack 4 (the packed layout, int8 allowed)
    "packed": dict(vocab_sizes=(13, 7, 9), cross_attention=(True, False, True),
                   n_embd=64, n_head=2, n_layer=2, block_size=32),
    # hs 8, S 16: pack 1 (the plain layout)
    "plain": dict(vocab_sizes=(19, 7), cross_attention=(True, False),
                  n_embd=16, n_head=2, n_layer=2, block_size=16),
}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _pair(name, compute_dtype="float32", seed=0):
    kw = dict(CONFIGS[name], compute_dtype=compute_dtype)
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _ids(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, (B, T)) for v in cfg.vocab_sizes]).astype(np.int32)


def _bits(a):
    """Exact comparable numpy view of a JAX or torch array (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _assert_trees_bit_equal(jtree, ttree):
    jf, tf = _flat(jtree), _flat(ttree)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        a, b = _bits(jf[k]), _bits(tf[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("hs", [8, 16, 24, 32, 48, 64, 96, 128, 256])
@pytest.mark.parametrize("S", [8, 16, 32, 64, 72, 128])
def test_cache_pack_equals_jax(hs, S):
    assert tcache.cache_pack(hs, S) == jcache.cache_pack(hs, S)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_init_cache_tree_equals_jax(compute_dtype, kv_dtype):
    jcfg, tcfg, jparams, tparams = _pair("packed", compute_dtype)
    _assert_trees_bit_equal(jcache.init_cache(jcfg, 3, jparams, kv_dtype=kv_dtype),
                            tcache.init_cache(tcfg, 3, tparams, kv_dtype))
    _, pcfg, _, pparams = _pair("plain")
    with pytest.raises(ValueError, match="packed"):
        tcache.init_cache(pcfg, 1, pparams, "int8")


def test_quantize_rows_bit_equal():
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((3, 5, 128)) * rng.uniform(0.01, 30, (3, 5, 1))).astype(np.float32)
    rows[0, 0] = 0.0  # an empty row: scale 1e-12
    jq, js = jcache._quantize_rows(jnp.asarray(rows))
    tq, ts = tcache._quantize_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _append_both(c_np, tail_np, scale_np, new_np, start, q8, dtype):
    """One append in each package from the same buffers."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    store_j, store_t = (jnp.int8, torch.int8) if q8 else (jdt, tdt)
    jc, jt, js = jcache._cache_append(
        jnp.asarray(c_np).astype(store_j), jnp.asarray(tail_np).astype(jdt),
        jnp.asarray(new_np).astype(jdt), start,
        scale=None if scale_np is None else jnp.asarray(scale_np))
    tc, tt, ts = tcache._cache_append(
        torch.from_numpy(c_np.copy()).to(store_t), torch.from_numpy(tail_np).to(tdt),
        torch.from_numpy(new_np).to(tdt), start,
        None if scale_np is None else torch.from_numpy(scale_np.copy()))
    return (jc, jt, js), (tc, tt, ts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("pack", [2, 4])
def test_cache_append_bit_equal(pack, q8, dtype):
    """A bulk prefill with a trailing partial row, then single appends across
    a row boundary; then a prefill that starts inside a row (leading partial
    row). Cache, tail and scales are bit-equal to JAX's after every append."""
    hs, S, lead = 128 // pack, 8 * pack, (2, 3)
    rng = np.random.default_rng(pack + 2 * q8)
    c = np.zeros((*lead, S // pack, pack * hs), np.float32)
    tail = np.zeros((*lead, pack, hs), np.float32)
    scale = np.zeros((*lead, S // pack), np.float32) if q8 else None
    j_state = t_state = None
    plan = [(0, 2 * pack + 1)] + [(2 * pack + 1 + i, 1) for i in range(pack + 2)]
    for start, t in plan:
        new = rng.standard_normal((*lead, t, hs)).astype(np.float32)
        if j_state is None:
            j_state, t_state = _append_both(c, tail, scale, new, start, q8, dtype)
        else:
            jc, jt, js = j_state
            tc, tt, ts = t_state
            j_state = jcache._cache_append(jc, jt, jnp.asarray(new).astype(getattr(jnp, dtype)),
                                           start, scale=js)
            t_state = tcache._cache_append(tc, tt, torch.from_numpy(new).to(getattr(torch, dtype)),
                                           start, ts)
        for a, b in zip(j_state, t_state):
            if a is not None:
                np.testing.assert_array_equal(_bits(b), _bits(a))
    # a prefill starting inside a row: leading partial row, bulk, trailing
    new = rng.standard_normal((*lead, 2 * pack + 1, hs)).astype(np.float32)
    (jc, jt, js), (tc, tt, ts) = _append_both(c, tail, scale, new, pack - 1, q8, dtype)
    for a, b in zip((jc, jt, js), (tc, tt, ts)):
        if a is not None:
            np.testing.assert_array_equal(_bits(b), _bits(a))


def test_cache_append_plain_layout_bit_equal():
    rng = np.random.default_rng(3)
    c = np.zeros((2, 1, 2, 16, 8), np.float32)
    new = rng.standard_normal((2, 1, 2, 5, 8)).astype(np.float32)
    jc, _, _ = jcache._cache_append(jnp.asarray(c), None, jnp.asarray(new), 4)
    tc, tail, _ = tcache._cache_append(torch.from_numpy(c), None, torch.from_numpy(new), 4)
    assert tail is None
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


_jax_forward_cached = jax.jit(jcache.forward_cached,
                              static_argnames=("cfg", "head_modality", "prefill"))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_cached_matches_jax(compute_dtype, kv_dtype):
    """Prefill logits against JAX ``_prefill``, then 10 decode steps fed
    JAX's own token stream, the logits against JAX ``forward_cached`` at each
    step, and the caches' int8 scales (a function of exact values only when
    the activations agree) close to JAX's."""
    jcfg, tcfg, jparams, tparams = _pair("packed", compute_dtype, seed=1)
    t0, steps, mod, tol = 8, 10, 2, TOL[compute_dtype]
    idx = _ids(tcfg, 2, t0, seed=2)
    jl, jc = jcache._prefill(jparams, jcfg, jnp.asarray(idx), mod, kv_dtype=kv_dtype)
    cols, _, _, _ = jcache._decode_steps(jparams, jcfg, jc, t0, jl, jnp.asarray(idx[:, :, -1]),
                                         jax.random.PRNGKey(4), mod, steps)
    cols = np.array(cols)  # (steps, M, B)
    tl, tc = tcache._prefill(tparams, tcfg, torch.from_numpy(idx), mod, kv_dtype)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, tcfg.vocab_sizes[mod])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=0)
    for s in range(steps):
        col = cols[s][:, :, None]
        jl, jc = _jax_forward_cached(jparams, jcfg, jnp.asarray(col), jc, t0 + s, head_modality=mod)
        tl, tc = tcache.forward_cached(tparams, tcfg, torch.from_numpy(col), tc, t0 + s, mod)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=0,
                                   err_msg=f"step {s}")
    if kv_dtype:
        np.testing.assert_allclose(tc[0]["sa_k_scale"].numpy(), np.asarray(jc[0]["sa_k_scale"]),
                                   rtol=tol, atol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_cached_full_logits_plain_layout(compute_dtype):
    """Without a head modality the cached forward returns every modality's
    logits over the new positions, here on the plain layout, against JAX."""
    jcfg, tcfg, jparams, tparams = _pair("plain", compute_dtype, seed=5)
    idx = _ids(tcfg, 2, 6, seed=6)
    jl, _ = jcache.forward_cached(jparams, jcfg, jnp.asarray(idx),
                                  jcache.init_cache(jcfg, 2, jparams), 0, prefill=True)
    tl, _ = tcache.forward_cached(tparams, tcfg, torch.from_numpy(idx),
                                  tcache.init_cache(tcfg, 2, tparams), 0, prefill=True)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL[compute_dtype], rtol=0)


@pytest.mark.parametrize("t0,new", [(5, 11), (5, 20), (16, 4)])
def test_generate_cached_equals_generate_fast(t0, new):
    """Pure cached phase, boundary-exact fill, crossing into the full-window
    sampler, and a prompt already at block_size (mirrors the JAX package's
    TestCachedGenerate)."""
    _, tcfg, _, tparams = _pair("plain", seed=7)
    idx = torch.from_numpy(_ids(tcfg, 2, t0, seed=8)).long()
    fast = generate_fast(tparams, tcfg, idx, torch.Generator().manual_seed(11), new, 0)
    cached = tcache.generate_cached(tparams, tcfg, idx, torch.Generator().manual_seed(11), new, 0)
    assert cached.shape == (tcfg.num_modalities, 2, t0 + new)
    assert torch.equal(fast, cached)


def test_generate_serve_exact_prefix_and_steady_chunks():
    """generate_serve: token-exact while the window grows; past it, each
    chunk is a prefill over the last S - refresh tokens at positions
    0..S-refresh-1 and refresh cached steps, the last chunk shorter, as the
    JAX package's ``_serve_chunks`` runs them (the manual loop below)."""
    _, tcfg, _, tparams = _pair("plain", seed=9)
    S, refresh, mod = tcfg.block_size, 4, 0
    idx = torch.from_numpy(_ids(tcfg, 2, 4, seed=10)).long()
    out = tcache.generate_serve(tparams, tcfg, idx, torch.Generator().manual_seed(3), 26, mod,
                                refresh=refresh)
    assert out.shape == (tcfg.num_modalities, 2, 30)
    exact = generate_fast(tparams, tcfg, idx, torch.Generator().manual_seed(3), S - 4, mod)
    assert torch.equal(out[:, :, :S], exact)

    gen = torch.Generator().manual_seed(3)
    generate_fast(tparams, tcfg, idx, gen, S - 4, mod)  # the exact phase's draws
    W, seq = S - refresh, out[:, :, :S]
    with torch.inference_mode():
        for n in (4, 4, 4, 2):
            logits, cache = tcache._prefill(tparams, tcfg, seq[:, :, -W:], mod)
            cols, _ = tcache._decode_steps(tparams, tcfg, cache, W, logits, seq[:, :, -1], gen,
                                           mod, n)
            seq = torch.cat([seq, cols], dim=-1)
    assert torch.equal(out, seq)
    assert torch.all(out[1, :, 4:] == idx[1, :, -1:])


def test_generate_serve_int8_and_errors():
    _, tcfg, _, tparams = _pair("packed", seed=11)
    S = tcfg.block_size
    idx = torch.from_numpy(_ids(tcfg, 1, S, seed=12)).long()
    out = tcache.generate_serve(tparams, tcfg, idx, torch.Generator().manual_seed(0), 9, 1,
                                refresh=4, kv_dtype="int8")
    assert out.shape == (3, 1, S + 9)
    assert 0 <= int(out[1].min()) and int(out[1].max()) < tcfg.vocab_sizes[1]
    with pytest.raises(ValueError, match="refresh"):
        tcache.generate_serve(tparams, tcfg, idx, torch.Generator(), 2, 0, refresh=S)
    _, pcfg, _, pparams = _pair("plain")
    with pytest.raises(ValueError, match="packed"):
        tcache.generate_serve(pparams, pcfg, idx[:2, :, :4], torch.Generator(), 2, 0,
                              kv_dtype="int8")


def test_cpu_serving_launches_no_kernel():
    _, tcfg, _, tparams = _pair("packed", seed=13)
    kernels.reset_launch_counts()
    idx = torch.from_numpy(_ids(tcfg, 1, 8, seed=14)).long()
    tcache.generate_serve(tparams, tcfg, idx, torch.Generator().manual_seed(0), 30, 0, refresh=4)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


SERVE_CALLS = {  # (config, kv_dtype) -> the decode wrapper the card runs
    ("packed", None): "decode_attention_packed",
    ("packed", "int8"): "decode_attention_packed_q8",
    ("plain", None): "decode_attention",
}


@pytest.mark.parametrize("name,kv_dtype", sorted(SERVE_CALLS, key=str))
def test_card_dispatch_rehearsed_with_plain_versions(monkeypatch, name, kv_dtype):
    """The card's dispatch run on the CPU: with the device tests forced on,
    the prefill goes through the K3f and K2f wrappers and every decode step
    through the decode wrapper of its layout, which take their plain
    versions for CPU tensors. The calls follow the slice's launch formula
    (per chunk n_layer K3f, n_layer per cross modality K2f, and refresh *
    n_layer * (1 + cross modalities) decode calls), and the logits agree with
    the dense cached path (f32 1e-5: other rounding points of the same
    function)."""
    from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt

    _, tcfg, _, tparams = _pair(name, seed=15)
    S, refresh, mod = tcfg.block_size, 8, 0
    idx = torch.from_numpy(_ids(tcfg, 2, S, seed=16)).long()
    dense_logits = []
    with torch.inference_mode():
        logits, cache = tcache._prefill(tparams, tcfg, idx[:, :, -(S - refresh):], mod, kv_dtype)
        dense_logits.append(logits)
        for s in range(3):
            logits, cache = tcache.forward_cached(tparams, tcfg, idx[:, :, s:s + 1], cache,
                                                  S - refresh + s, mod)
            dense_logits.append(logits)

    calls = dict.fromkeys(("short_causal_attention", "short_cross_attention", SERVE_CALLS[name, kv_dtype]), 0)
    for fn in calls:
        def spy(*args, _fn=getattr(kernels, fn), _name=fn):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(kernels, fn, spy)
    monkeypatch.setattr(tatt, "_kernel_device", lambda device, impl: True)
    monkeypatch.setattr(tcache, "_decode_kernel_active", lambda kc, t_new, impl: t_new == 1)
    with torch.inference_mode():
        logits, cache = tcache._prefill(tparams, tcfg, idx[:, :, -(S - refresh):], mod, kv_dtype)
        np.testing.assert_allclose(logits.numpy(), dense_logits[0].numpy(), atol=1e-5, rtol=0)
        for s in range(3):
            logits, cache = tcache.forward_cached(tparams, tcfg, idx[:, :, s:s + 1], cache,
                                                  S - refresh + s, mod)
            np.testing.assert_allclose(logits.numpy(), dense_logits[s + 1].numpy(), atol=1e-5,
                                       rtol=0)
    n_cross = sum(tcfg.cross_attention)
    L = tcfg.n_layer
    assert calls == {"short_causal_attention": L, "short_cross_attention": n_cross * L,
                     SERVE_CALLS[name, kv_dtype]: 3 * L * (1 + n_cross)}
    calls.update(dict.fromkeys(calls, 0))
    tokens = 2 * refresh + 3
    tcache.generate_serve(tparams, tcfg, idx, torch.Generator().manual_seed(1), tokens, mod,
                          refresh=refresh, kv_dtype=kv_dtype)
    chunks = 3
    assert calls == {"short_causal_attention": chunks * L,
                     "short_cross_attention": chunks * n_cross * L,
                     SERVE_CALLS[name, kv_dtype]: tokens * L * (1 + n_cross)}
