"""The port's last four kernels held against the JAX package on the CPU: the
whole-row self-attention backward (K3b) with its forward (K3f) through the
differentiable ``short_causal_attention``, the packed kernels (K4f, K4b)
through ``short_causal_attention_packed`` and ``causal_attention_packed``,
the transposed-cache decode kernel (K9), and the port of
``tools/flash_crossover.py``.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernels in interpret mode, as tests/test_kernels.py runs them.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances: max-abs error <= tol * max(1, max|ref|), f32 1e-5 (the same
arithmetic, another summation order), bf16 2e-2 (the same rounding points;
another summation order can flip a bf16 rounding of an intermediate).
Dropout keep-masks are compared bit for bit. The CUDA kernels are held
against these plain versions on the card (tests/test_torch_kernels.py,
marked ``cuda``, and chip_smoke.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trade_aid_multimodal_transformer_tpu.ops import attention as jatt
from trade_aid_multimodal_transformer_tpu.ops import pallas_attention as jpa
from trade_aid_multimodal_transformer_tpu_torch import flash_crossover as X
from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SALTS = np.array([123456789, 3141592653], np.uint32)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(np.asarray(got, np.float32) - ref).max() / max(1.0, np.abs(ref).max())


def _key(salts):
    return None if salts is None else jnp.asarray(salts)


def _close(got, want, dtype):
    assert _rel_err(got.detach().float().numpy(), _np(want)) <= TOL[dtype]


# ------------------------------------------------------------ K3f + K3b


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hs", [16, 64])
@pytest.mark.parametrize("T", [8, 64])
def test_short_causal_value_and_grads_match_jax_interpret(T, hs, dtype, rate):
    """The differentiable ``short_causal_attention`` (K3f's plain version
    forward, K3b's backward) against the Pallas kernel pair ``_short3`` in
    interpret mode: the output and ``jax.vjp``'s dq, dk, dv."""
    rng = np.random.default_rng(T + hs)
    q, k, v, do = (rng.standard_normal((2, 3, T, hs)).astype(np.float32) for _ in range(4))
    salts = SALTS if rate else None

    def f(q_, k_, v_):
        return jpa.short_causal_attention(q_, k_, v_, interpret=True, dropout_rate=rate,
                                          dropout_key=_key(salts))

    ref, vjp = jax.vjp(f, *(_to_jax(a, dtype) for a in (q, k, v)))
    ref_grads = vjp(_to_jax(do, dtype))
    tq, tk, tv = (_to_torch(a, dtype).requires_grad_() for a in (q, k, v))
    out = K.short_causal_attention(tq, tk, tv, rate, salts)
    assert out.grad_fn is not None and out.dtype == getattr(torch, dtype)
    out.backward(_to_torch(do, dtype))
    _close(out, ref, dtype)
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        assert got.dtype == getattr(torch, dtype)
        _close(got, want, dtype)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_causal_bwd_plain_matches_jax_bwd_call(dtype, rate):
    """K3b's plain version called directly, against ``_short_bwd_call`` in
    interpret mode on the same q, k, v, out and dout (the output the JAX
    forward gave), at JAX's group size for this shape."""
    rng = np.random.default_rng(11)
    n, T, hs = 6, 24, 16
    q, k, v, do = (rng.standard_normal((n, T, hs)).astype(np.float32) for _ in range(4))
    salts = SALTS if rate else None
    seed = jpa.seed_from_key(jnp.asarray(SALTS)) if rate else jnp.zeros((1,), jnp.int32)
    jq, jk, jv, jdo = (_to_jax(a, dtype) for a in (q, k, v, do))
    g = jpa._short_pick_g(n, T, hs, jq.dtype.itemsize)
    jout = jpa._short_fwd_call(jq, jk, jv, seed, g, rate, True)
    ref = jpa._short_bwd_call(jq, jk, jv, jout, jdo, seed, g, rate, True)
    got = K.short_causal_attention_bwd(*(_to_torch(a, dtype) for a in (q, k, v)),
                                       _to_torch(_np(jout), dtype), _to_torch(do, dtype),
                                       rate, salts)
    for a, b in zip(got, ref):
        _close(a, b, dtype)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_short_causal_mask_is_bit_equal_to_jax_for_any_group(itemsize):
    """The mask K3f and K3b regenerate, over (n, T, T) keyed by the collapsed
    row, against ``_short_keep_mask`` in interpret mode program by program,
    at the JAX kernels' group size for bf16 and for f32 operands (the row
    index does not depend on the group size)."""
    n, T, hs, rate = 48, 64, 16, 0.3
    got = K.causal_mask(torch.zeros(4, 12, T, hs), rate, SALTS).reshape(n, T, T).numpy()
    seed = jpa.seed_from_key(jnp.asarray(SALTS))[0]
    g = jpa._short_pick_g(n, T, hs, itemsize)
    for pid in range(n // g):
        ref = jpa._short_keep_mask(seed, jnp.int32(pid), g, (g, T, T), rate, True)
        np.testing.assert_array_equal(got[pid * g:(pid + 1) * g], np.asarray(ref))


def test_differentiable_causal_attention_in_the_band(monkeypatch):
    """``causal_attention`` with the card's dispatch rehearsed (the kernel
    device check patched to true: the whole-row band takes the kernels'
    plain versions) is differentiable, with dropout, and its value and
    gradients equal the Pallas pair's in interpret mode, the JAX package's
    ``short_causal_attention`` (the card's path there)."""
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal((2, 3, 32, 16)).astype(np.float32) for _ in range(4))
    rate = 0.2

    def f(q_, k_, v_):
        return jpa.short_causal_attention(q_, k_, v_, interpret=True, dropout_rate=rate,
                                          dropout_key=jnp.asarray(SALTS))

    ref, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    monkeypatch.setattr(tatt, "_kernel_device", lambda device, impl: True)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tatt.causal_attention(tq, tk, tv, "auto", rate, tuple(int(s) for s in SALTS), True)
    out.backward(torch.from_numpy(do))
    _close(out, ref, "float32")
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        _close(got, want, "float32")


# ------------------------------------------------------------ K4f + K4b


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_packed_value_and_grad_match_jax_interpret(dtype, rate):
    """The differentiable ``short_causal_attention_packed`` (K4f's and K4b's
    plain versions) at nb = 2, H = 3 against the Pallas pair
    ``_short_packed`` in interpret mode: the output and d(qkv)."""
    nb, H, T, hs = 2, 3, 16, 16
    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((nb, 3 * H, T, hs)).astype(np.float32)
    do = rng.standard_normal((nb, H, T, hs)).astype(np.float32)
    salts = SALTS if rate else None

    def f(x):
        return jpa.short_causal_attention_packed(x, H, interpret=True, dropout_rate=rate,
                                                 dropout_key=_key(salts))

    ref, vjp = jax.vjp(f, _to_jax(qkv, dtype))
    (ref_grad,) = vjp(_to_jax(do, dtype))
    tx = _to_torch(qkv, dtype).requires_grad_()
    out = K.short_causal_attention_packed(tx, H, rate, salts)
    assert out.shape == (nb, H, T, hs) and out.dtype == getattr(torch, dtype)
    out.backward(_to_torch(do, dtype))
    _close(out, ref, dtype)
    assert tx.grad.shape == qkv.shape
    _close(tx.grad, ref_grad, dtype)


def test_short_packed_mask_is_bit_equal_to_jax():
    """K4's mask rows b * H + h, against ``_short_keep_mask`` of each program
    of the packed kernel (g = gb * H rows from ``_short_packed_pick_gb``)."""
    nb, H, T, hs, rate = 8, 3, 40, 16, 0.3
    q = torch.zeros(nb, 3 * H, T, hs)[:, :H]
    got = K.causal_mask(q, rate, SALTS).reshape(nb * H, T, T).numpy()
    seed = jpa.seed_from_key(jnp.asarray(SALTS))[0]
    gb = jpa._short_packed_pick_gb(nb, H, T, hs, 2)
    g = gb * H
    for pid in range(nb // gb):
        ref = jpa._short_keep_mask(seed, jnp.int32(pid), g, (g, T, T), rate, True)
        np.testing.assert_array_equal(got[pid * g:(pid + 1) * g], np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_packed_plain_versions_match_jax_calls(dtype):
    """K4f's and K4b's plain versions called directly with leading axes
    (2, 1), against ``_short_packed_fwd_call`` / ``_short_packed_bwd_call``
    in interpret mode at dropout 0.3."""
    H, T, hs, rate = 2, 16, 32, 0.3
    rng = np.random.default_rng(6)
    qkv = rng.standard_normal((2, 1, 3 * H, T, hs)).astype(np.float32)
    do = rng.standard_normal((2, 1, H, T, hs)).astype(np.float32)
    seed = jpa.seed_from_key(jnp.asarray(SALTS))
    jx = _to_jax(qkv, dtype).reshape(2, 3 * H, T, hs)
    gb = jpa._short_packed_pick_gb(2, H, T, hs, jx.dtype.itemsize)
    jout = jpa._short_packed_fwd_call(jx, seed, gb, H, rate, True)
    jd = jpa._short_packed_bwd_call(jx, jout, _to_jax(do, dtype).reshape(2, H, T, hs), seed, gb,
                                    H, rate, True)
    tx = _to_torch(qkv, dtype)
    out = K.short_causal_attention_packed_fwd(tx, H, rate, SALTS)
    _close(out.reshape(2, H, T, hs), jout, dtype)
    dqkv = K.short_causal_attention_packed_bwd(tx, _to_torch(_np(jout), dtype).reshape(out.shape),
                                               _to_torch(do, dtype), H, rate, SALTS)
    assert dqkv.shape == qkv.shape
    _close(dqkv.reshape(2, 3 * H, T, hs), jd, dtype)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_attention_packed_matches_jax_on_the_cpu(dtype, train):
    """``causal_attention_packed`` against the JAX package's on the CPU: on
    both sides the packed kernels are off there, the packed axis is split
    and ``causal_attention`` runs its dense core (dropout 0.2 when
    training, the same hash on the same site key)."""
    H, rate = 3, 0.2
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((2, 3 * H, 16, 8)).astype(np.float32)
    salts = np.array([11, 22], np.uint32)
    ref = jatt.causal_attention_packed(_to_jax(qkv, dtype), H, rate, jnp.asarray(salts), train)
    out = tatt.causal_attention_packed(_to_torch(qkv, dtype), H, rate,
                                       tuple(int(s) for s in salts), train)
    assert out.shape == (2, H, 16, 8)
    _close(out, ref, dtype)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_causal_attention_packed_card_dispatch_rehearsed(monkeypatch, rate):
    """``causal_attention_packed`` with the card's dispatch rehearsed (the
    packed kernels' plain versions) against the JAX package's packed Pallas
    pair in interpret mode (its TPU path), value and d(qkv)."""
    H = 2
    rng = np.random.default_rng(8)
    qkv = rng.standard_normal((3, 3 * H, 24, 16)).astype(np.float32)
    do = rng.standard_normal((3, H, 24, 16)).astype(np.float32)
    salts = SALTS if rate else None

    def f(x):
        return jpa.short_causal_attention_packed(x, H, interpret=True, dropout_rate=rate,
                                                 dropout_key=_key(salts))

    ref, vjp = jax.vjp(f, jnp.asarray(qkv))
    (ref_grad,) = vjp(jnp.asarray(do))
    monkeypatch.setattr(tatt, "_kernel_device", lambda device, impl: True)
    tx = torch.from_numpy(qkv).requires_grad_()
    out = tatt.causal_attention_packed(tx, H, rate, None if salts is None else
                                       tuple(int(s) for s in salts), True)
    out.backward(torch.from_numpy(do))
    _close(out, ref, "float32")
    _close(tx.grad, ref_grad, "float32")


@pytest.mark.parametrize("impl", ["auto", "pallas", "jnp"])
@pytest.mark.parametrize("t,hs", [(64, 64), (8, 16), (512, 256), (520, 64), (68, 64), (4, 16),
                                  (64, 512)])
def test_packed_attention_active_matches_jax(t, hs, impl):
    """On the CPU neither package takes the packed kernels; on the card the
    port takes them where JAX's ``short_packed_eligible`` holds, for impl
    auto and pallas, and never inside a context-parallel scope."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tatt.packed_attention_active(t, hs, impl, cpu) is False
    assert jatt.packed_attention_active(t, hs, impl) is False
    want = impl != "jnp" and jpa.short_packed_eligible(t, hs)
    assert tatt.packed_attention_active(t, hs, impl, cuda) == want
    assert K.short_packed_eligible(t, hs) == jpa.short_packed_eligible(t, hs)
    with tatt.context_parallel_scope(object()):
        assert not tatt.packed_attention_active(t, hs, impl, cuda)


# ------------------------------------------------------------ K9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 256, 1024, 2048])
@pytest.mark.parametrize("which", ["zero", "seven", "127", "last", "255", "256"])
def test_decode_t_plain_matches_jax_interpret(which, S, dtype):
    """K9's plain version against ``decode_attention_t`` in interpret mode,
    q (2, 3, 1, hs) against transposed caches (2, 3, hs, S): hs 32 at S 128
    and 256, 64 at S 1024, 256 at S 2048; pos 0, 7, 127, 255, 256 (the edges
    of the card's chunks of 256; past the cache at S 128) and S - 1 (an int
    and a one-element int32 tensor)."""
    pos = {"zero": 0, "seven": 7, "127": 127, "last": S - 1, "255": 255, "256": 256}[which]
    rng = np.random.default_rng(S + pos)
    hs = {128: 32, 256: 32, 1024: 64, 2048: 256}[S]
    q = rng.standard_normal((2, 3, 1, hs)).astype(np.float32)
    kT, vT = (rng.standard_normal((2, 3, hs, S)).astype(np.float32) for _ in range(2))
    ref = jpa.decode_attention_t(*(_to_jax(a, dtype) for a in (q, kT, vT)), pos, interpret=True)
    args = [_to_torch(a, dtype) for a in (q, kT, vT)]
    out = K.decode_attention_t(*args, pos)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=TOL[dtype], rtol=0)
    out_t = K.decode_attention_t(*args, torch.tensor([pos], dtype=torch.int32))
    assert torch.equal(out, out_t)
    # the same function as the plain-layout kernel on the untransposed cache
    same = K.decode_attention(args[0], args[1].transpose(-1, -2).contiguous(),
                              args[2].transpose(-1, -2).contiguous(), pos)
    np.testing.assert_allclose(out.float().numpy(), same.float().numpy(), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("case", [((2, 1, 16), (2, 16, 128)), ((2, 1, 16), (2, 16, 120)),
                                  ((2, 1, 16), (2, 8, 128)), ((2, 2, 16), (2, 16, 128)),
                                  ((3, 1, 1, 64), (3, 1, 64, 256)), ((2, 1, 512), (2, 512, 128))])
def test_decode_t_eligible_matches_jax(case):
    """Eligibility parity on the cases of the JAX package's own test (S a
    multiple of 128, hs matching, one query position) and two more."""
    qs, ks = case
    assert K.decode_attention_t_eligible(torch.zeros(qs), torch.zeros(ks)) == \
        jpa.decode_attention_t_eligible(jnp.zeros(qs), jnp.zeros(ks))


def test_decode_t_checks_shapes_and_launches_nothing_on_the_cpu():
    K.reset_launch_counts()
    q, kT = torch.zeros(2, 1, 16), torch.zeros(2, 16, 128)
    K.decode_attention_t(q, kT, kT, 3)
    K.short_causal_attention_packed(torch.zeros(2, 6, 8, 4).requires_grad_(), 2).sum().backward()
    q3 = torch.zeros(2, 8, 4, requires_grad=True)
    K.short_causal_attention(q3, q3, q3).sum().backward()
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
    with pytest.raises(ValueError):  # q holds two positions
        K.decode_attention_t(torch.zeros(2, 2, 16), kT, kT, 3)
    with pytest.raises(ValueError):  # kT not (..., hs, S)
        K.decode_attention_t(q, kT.transpose(-1, -2), kT.transpose(-1, -2), 3)
    with pytest.raises(ValueError):  # 3H != 9
        K.short_causal_attention_packed(torch.zeros(2, 6, 8, 4), 3)
    with pytest.raises(ValueError, match="salts"):
        K.short_causal_attention_bwd(q3, q3, q3, q3, q3, 0.2)


# ------------------------------------------------------------ the crossover tool


@pytest.mark.parametrize("t", [64, 256])
def test_crossover_row_on_the_cpu(t):
    """The tool's per-T row with ``--device cpu`` at batch 1, 2 heads, hs 16:
    every eligible core timed (dense always, the whole-row kernels in the
    band, the flash kernels from 256), forward + backward and the forward
    alone, finite times, the ratios, no launch on the CPU; and the cores'
    gradients of the tool's loss agree (the plain versions of K3b and K5b
    against the dense core's autograd)."""
    row = X.crossover_row(t, batch=1, heads=2, hs=16, dtype=torch.float32, device="cpu")
    assert row["T"] == t
    assert row["applications"] == {c: 4 * X.reps_for(t) for c in X.cores(t, 16)}
    assert (row["flash_ms"] is not None) == (t >= 256) and row["short_ms"] is not None
    times = [row[c] for c in ("dense_ms", "flash_ms", "short_ms") if row[c] is not None]
    assert all(np.isfinite(x) and x > 0 for x in times)
    assert row["dense/short"] == pytest.approx(row["dense_ms"] / row["short_ms"])
    assert row["launches"] == {c: {} for c in X.cores(t, 16)}
    assert row["fwd_applications"] == row["applications"]
    assert row["fwd_launches"] == row["launches"]
    assert all((row[f"{c}_fwd_ms"] is None) == (row[f"{c}_ms"] is None) for c in X.CORE_KERNELS)
    fwd = [row[f"{c}_fwd_ms"] for c in X.CORE_KERNELS if row[f"{c}_fwd_ms"] is not None]
    assert all(np.isfinite(x) and x > 0 for x in fwd)
    assert row["fwd_dense/short"] == pytest.approx(row["dense_fwd_ms"] / row["short_fwd_ms"])
    assert str(t) in X.format_row(row)
    q, k, v = X.inputs(t, 1, 2, 16, torch.float32, "cpu")
    ref = X.grads(X.cores(t, 16)["dense"], q, k, v)
    for name, core in X.cores(t, 16).items():
        for a, b in zip(X.grads(core, q, k, v), ref):
            assert _rel_err(a.numpy(), b.numpy()) <= TOL["float32"], name


def test_crossover_entry_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        X.main([])
    assert X.T_LIST == (64, 128, 256, 512, 1024, 2048, 4096, 8192)
    assert [X.reps_for(t) for t in X.T_LIST] == [32, 32, 32, 32, 32, 20, 10, 5]
