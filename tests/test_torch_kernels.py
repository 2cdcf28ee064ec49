"""The port's kernel modules held against the JAX package's Pallas kernels.

On the CPU each wrapper of ``trade_aid_multimodal_transformer_tpu_torch.ops.
kernels`` runs its plain PyTorch version; that version is held against the
JAX kernel run in interpret mode, on the same numpy inputs, as
tests/test_kernels.py runs it. Tolerances: f32 atol 1e-5 (same arithmetic,
another summation order); bf16 atol 2e-2 (the same rounding points, but a
different summation order can flip a bf16 rounding of an intermediate).
The CUDA kernels themselves are held against the plain versions on the card
by the tests marked ``cuda`` below and by chip_smoke.py, with max-abs error
<= tol * max(1, max|ref|): f32 1e-4 and bf16 2e-2 for the backward kernels
and the dropout forwards (other summation orders over up to 2048 rows for
the weight gradients). The serving kernels (K3f, the cache prefill, and the
decode kernels K8, K8p, K8q, K9) are held the same way; the decode kernels'
plain versions keep each Pallas kernel's own rounding points, which differ.
The differentiable whole-row kernels (K3f + K3b, and the packed K4f + K4b)
are held the same way; their plain versions against the Pallas kernels in
tests/test_torch_short.py.
The flash kernels (K5f, K5b, K6f, K6f-r) and the ring's chunk kernels (K7f,
K7b) are held the same way on the card; their plain versions against the
Pallas kernels in tests/test_torch_flash.py and tests/test_torch_ring.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trade_aid_multimodal_transformer_tpu.ops import pallas_attention as jpa
from trade_aid_multimodal_transformer_tpu_torch.config.system import resolve_device
from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
from trade_aid_multimodal_transformer_tpu_torch.ops import kernels as K

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _fqkv_inputs(M, B, T, C, H, hs, seed):
    rng = np.random.default_rng(seed)
    hs2 = hs // 2
    x = rng.standard_normal((M, B, T, C)).astype(np.float32)
    w1 = (rng.standard_normal((M, C, 3 * H * hs2)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal((M, 3 * H * hs2)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((M, 3 * H, hs2, hs)) * 0.2).astype(np.float32)
    return x, w1, b1, w2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 16, 32, 2, 16), (1, 2, 8, 24, 3, 8), (2, 1, 24, 32, 1, 32)])
def test_fused_qkv_plain_matches_jax_interpret(shape, dtype):
    M, B, T, C, H, hs = shape
    x, w1, b1, w2 = _fqkv_inputs(M, B, T, C, H, hs, seed=sum(shape))
    ref = jpa.fused_qkv_attention(
        _to_jax(x, dtype), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), H, interpret=True
    )
    out = K.fused_qkv_attention(
        _to_torch(x, dtype), torch.from_numpy(w1), torch.from_numpy(b1), torch.from_numpy(w2), H
    )
    assert out.dtype == getattr(torch, dtype)
    assert tuple(out.shape) == (M, H, B, T, hs) == tuple(ref.shape)
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=TOL[dtype], rtol=0)


def _cross_inputs(J, n, T, hs, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, T, hs)).astype(np.float32)
    k = rng.standard_normal((J, n, T, hs)).astype(np.float32)
    v = rng.standard_normal((J, n, T, hs)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4, 16, 16), (2, 3, 8, 8), (1, 2, 32, 24)])
def test_short_cross_plain_matches_jax_interpret(shape, dtype):
    J, n, T, hs = shape
    q, k, v = _cross_inputs(J, n, T, hs, seed=sum(shape))
    ref = jpa.short_cross_attention(
        _to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype), interpret=True
    )
    out = K.short_cross_attention(_to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_cross_t_plain_matches_jax_interpret(dtype):
    """The transposed-KV entry keeps the JAX contract (J, ..., hs, T)."""
    J, H, B, T, hs = 3, 2, 2, 16, 16
    rng = np.random.default_rng(5)
    q = rng.standard_normal((H, B, T, hs)).astype(np.float32)
    kT = rng.standard_normal((J, H, B, hs, T)).astype(np.float32)
    vT = rng.standard_normal((J, H, B, hs, T)).astype(np.float32)
    ref = jpa.short_cross_attention_t(
        _to_jax(q, dtype), _to_jax(kT, dtype), _to_jax(vT, dtype), interpret=True
    )
    out = K.short_cross_attention_t(_to_torch(q, dtype), _to_torch(kT, dtype), _to_torch(vT, dtype))
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=TOL[dtype], rtol=0)


def test_dense_cross_core_matches_plain_kernel_version():
    """Outside the band the model's cross core is the dense sum; in f32 it
    agrees with the kernel's plain version (same function, other rounding
    order: normalised vs unnormalised probabilities)."""
    q, k, v = (torch.from_numpy(a) for a in _cross_inputs(3, 4, 16, 16, seed=3))
    dense = tatt.cross_causal_attention(q, k, v)
    np.testing.assert_allclose(
        dense.numpy(), K.short_cross_attention_plain(q, k, v).numpy(), atol=1e-5, rtol=0
    )


SALTS = np.array([123456789, 3141592653], np.uint32)


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(np.asarray(got, np.float32) - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 4, 16, 32, 2, 16), (1, 6, 8, 24, 3, 8)])
def test_fused_qkv_value_and_grads_match_jax_interpret(shape, dtype, rate):
    """Forward and (dx, dw1, db1, dw2) of the differentiable entry, dropout
    off and on with the same raw salts, against the Pallas kernel and its
    custom VJP in interpret mode. Tolerance: max-abs error <= tol *
    max(1, max|ref|), tol as TOL (the masks are bit-identical)."""
    M, B, T, C, H, hs = shape
    x, w1, b1, w2 = _fqkv_inputs(M, B, T, C, H, hs, seed=sum(shape))
    do = np.random.default_rng(1).standard_normal((M, H, B, T, hs)).astype(np.float32)
    salts = SALTS if rate else None

    def f(x_, w1_, b1_, w2_):
        return jpa.fused_qkv_attention(
            x_, w1_, b1_, w2_, H, interpret=True, dropout_rate=rate,
            dropout_key=None if salts is None else jnp.asarray(salts),
        )

    ref, vjp = jax.vjp(f, _to_jax(x, dtype), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2))
    ref_grads = vjp(_to_jax(do, dtype))
    tx = _to_torch(x, dtype).requires_grad_()
    tw = [torch.from_numpy(a).requires_grad_() for a in (w1, b1, w2)]
    out = K.fused_qkv_attention(tx, *tw, H, dropout_rate=rate, dropout_salts=salts)
    out.backward(_to_torch(do, dtype))
    assert _rel_err(out.detach().float().numpy(), _np(ref)) <= TOL[dtype]
    for got, want in zip([tx.grad] + [t.grad for t in tw], ref_grads):
        assert got.dtype == (getattr(torch, dtype) if got is tx.grad else torch.float32)
        assert _rel_err(got.float().numpy(), _np(want)) <= TOL[dtype]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 2, 3, 16, 16), (2, 3, 1, 8, 8)])
def test_short_cross_value_and_grads_match_jax_interpret(shape, dtype, rate):
    """Forward and (dq, dk, dv) of the cross entry on the model's (H, B, T,
    hs) query, against ``short_cross_attention_t`` (transposed k/v) and its
    custom VJP in interpret mode, dropout off and on. Tolerance as above."""
    J, H, B, T, hs = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((H, B, T, hs)).astype(np.float32)
    k, v = (rng.standard_normal((J, H, B, T, hs)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    salts = SALTS if rate else None

    def f(q_, kT_, vT_):
        return jpa.short_cross_attention_t(
            q_, kT_, vT_, interpret=True, dropout_rate=rate,
            dropout_key=None if salts is None else jnp.asarray(salts),
        )

    ref, vjp = jax.vjp(f, *(_to_jax(a, dtype) for a in (q, np.swapaxes(k, -1, -2), np.swapaxes(v, -1, -2))))
    dq_ref, dkT_ref, dvT_ref = vjp(_to_jax(do, dtype))
    tq, tk, tv = (_to_torch(a, dtype).requires_grad_() for a in (q, k, v))
    out = K.short_cross_attention(tq, tk, tv, dropout_rate=rate, dropout_salts=salts)
    out.backward(_to_torch(do, dtype))
    assert _rel_err(out.detach().float().numpy(), _np(ref)) <= TOL[dtype]
    assert _rel_err(tq.grad.float().numpy(), _np(dq_ref)) <= TOL[dtype]
    assert _rel_err(tk.grad.float().numpy(), np.swapaxes(_np(dkT_ref), -1, -2)) <= TOL[dtype]
    assert _rel_err(tv.grad.float().numpy(), np.swapaxes(_np(dvT_ref), -1, -2)) <= TOL[dtype]


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_hash_keep_mask_is_bit_equal_to_jax(rate):
    seed = jpa.seed_from_key(jnp.asarray(SALTS))
    n_idx = np.arange(6).reshape(2, 3, 1, 1)
    ref = jpa.hash_keep_mask(seed[0], jnp.asarray(n_idx, jnp.int32), 3, 5, (2, 3, 24, 40), rate)
    got = K.hash_keep_mask(K.seed_from_salts(SALTS), torch.from_numpy(n_idx), 3, 5,
                           (2, 3, 24, 40), rate)
    assert int(seed[0]) == K.seed_from_salts(SALTS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with np.errstate(over="ignore"):  # int32 wraparound, as in the kernels
        want = int(np.int32(2**31 - 5) + np.int32(3) * jpa._STREAM_SEED_STRIDE)
    assert K.stream_seed(2**31 - 5, 2) == want


@pytest.mark.parametrize("args", [(32, 6, 64, 64, 384), (7, 2, 16, 16, 32), (64, 6, 512, 64, 384),
                                  (16, 3, 64, 128, 100)])
def test_fqkv_pick_gb_equals_jax(args):
    for itemsize in (2, 4):
        assert K.fqkv_pick_gb(*args, itemsize) == jpa._fqkv_pick_gb(*args, itemsize)


def test_wrappers_require_salts_for_dropout():
    x, w1, b1, w2 = (torch.from_numpy(a) for a in _fqkv_inputs(1, 1, 8, 8, 1, 4, seed=0))
    with pytest.raises(ValueError, match="salts"):
        K.fused_qkv_attention(x, w1, b1, w2, 1, dropout_rate=0.2)
    q, k, v = (torch.from_numpy(a) for a in _cross_inputs(2, 1, 8, 4, seed=0))
    with pytest.raises(ValueError, match="salts"):
        K.short_cross_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError):
        K.short_cross_attention(q, k, v, dropout_rate=1.0, dropout_salts=SALTS)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on any other device than the CPU or CUDA raises instead of
    reaching the plain version, and CPU calls launch nothing."""
    K.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _cross_inputs(2, 1, 8, 4, seed=1))
    K.short_cross_attention(q.requires_grad_(), k, v).sum().backward()
    K.short_causal_attention(q, q, q)
    K.short_causal_attention(q, k[0], v[0]).sum().backward()
    K.short_causal_attention_packed(torch.cat([q, k[0], v[0]]).requires_grad_(), 1).sum().backward()
    K.decode_attention_packed(q[:, :1], k[0, :, :4].reshape(1, 2, 8), v[0, :, :4].reshape(1, 2, 8), 3)
    K.decode_attention_t(q[:, :1], k[0].transpose(-1, -2), v[0].transpose(-1, -2), 3)
    fq, fk, fv = (torch.from_numpy(a) for a in _cross_inputs(2, 1, 256, 8, seed=2))
    K.flash_causal_attention(fq.requires_grad_(), fk[0], fv[0]).sum().backward()
    K.flash_cross_attention(fq, fk, fv).sum().backward()
    for causal in (True, False):
        out, lse = K.flash_chunk_fwd(fq, fk[0], fv[0], causal)
        K.flash_chunk_bwd(fq, fk[0], fv[0], out, lse, fq, causal)
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
    assert len(K.KERNELS) == 20
    with pytest.raises(ValueError, match="unsupported device"):
        K.short_cross_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    x, w1, b1, w2 = (torch.from_numpy(a).to("meta") for a in _fqkv_inputs(1, 1, 8, 8, 1, 4, 0))
    with pytest.raises(ValueError, match="unsupported device"):
        K.fused_qkv_attention(x, w1, b1, w2, 1)


def test_wrappers_check_shapes():
    x, w1, b1, w2 = (torch.from_numpy(a) for a in _fqkv_inputs(1, 2, 8, 8, 2, 4, seed=0))
    with pytest.raises(ValueError):
        K.fused_qkv_attention(x, w1, b1, w2, 3)  # w2 holds 3*2 virtual heads
    q, k, v = (torch.from_numpy(a) for a in _cross_inputs(2, 1, 8, 4, seed=0))
    with pytest.raises(ValueError):
        K.short_cross_attention(q, k[:, :, :4], v[:, :, :4])
    with pytest.raises(ValueError):
        K.short_causal_attention(q, k[0], v[0, :, :4])
    kc = k.reshape(2, 1, 4, 8)
    with pytest.raises(ValueError):  # two query positions
        K.decode_attention(q[:, :2], k[0], v[0], 1)
    with pytest.raises(ValueError):  # lane width not a multiple of hs
        K.decode_attention_packed(q[:, :1], kc[0, ..., :6], kc[0, ..., :6], 1)
    scales = torch.ones(2, 4)
    with pytest.raises(ValueError):  # not an int8 cache
        K.decode_attention_packed_q8(q[:, :1], kc[0], kc[0], scales[0], scales[0], 1)


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda", "gpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(name)
    assert resolve_device("cpu") == "cpu"
    with pytest.raises(ValueError):
        resolve_device("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("auto") == "cuda"


def test_kernel_band_dispatch():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tatt.fused_qkv_attention_active(64, 64, "auto", cuda)
    assert tatt.fused_qkv_attention_active(8, 16, "pallas", cuda)
    assert not tatt.fused_qkv_attention_active(64, 64, "auto", cpu)
    assert not tatt.fused_qkv_attention_active(64, 64, "jnp", cuda)
    assert not tatt.fused_qkv_attention_active(4, 64, "auto", cuda)
    assert not tatt.fused_qkv_attention_active(68, 64, "auto", cuda)
    assert not tatt.fused_qkv_attention_active(1024, 64, "auto", cuda)
    assert not tatt.fused_qkv_attention_active(64, 512, "auto", cuda)
    with pytest.raises(ValueError):
        tatt.fused_qkv_attention_active(64, 64, "xla", cuda)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [8, 56, 72])
@pytest.mark.parametrize("hs", [16, 24, 64])
def test_short_causal_plain_matches_jax_interpret(hs, T, dtype, rate):
    """K3f's plain version against ``short_causal_attention`` in interpret
    mode, dropout off and on with the same raw salts. Tolerance as the
    dropout cases above: max-abs error <= tol * max(1, max|ref|)."""
    rng = np.random.default_rng(hs + T)
    q, k, v = (rng.standard_normal((2, 3, T, hs)).astype(np.float32) for _ in range(3))
    salts = SALTS if rate else None
    ref = jpa.short_causal_attention(
        *(_to_jax(a, dtype) for a in (q, k, v)), interpret=True, dropout_rate=rate,
        dropout_key=None if salts is None else jnp.asarray(salts),
    )
    out = K.short_causal_attention(*(_to_torch(a, dtype) for a in (q, k, v)), rate, salts)
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == q.shape
    assert _rel_err(out.float().numpy(), _np(ref)) <= TOL[dtype]


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_short_causal_dropout_mask_is_bit_equal_to_jax(rate):
    """K3f's mask over (n, T, T): every program of the JAX kernel
    (``_short_keep_mask`` in interpret mode, g rows per program from
    ``_short_pick_g``) against the port's, keyed by the collapsed row."""
    n, T, hs = 24, 56, 64
    q = torch.zeros(4, 6, T, hs)
    got = K.causal_mask(q, rate, SALTS).reshape(n, T, T).numpy()
    seed = jpa.seed_from_key(jnp.asarray(SALTS))[0]
    g = jpa._short_pick_g(n, T, hs, 2)
    for pid in range(n // g):
        ref = jpa._short_keep_mask(seed, jnp.int32(pid), g, (g, T, T), rate, True)
        np.testing.assert_array_equal(got[pid * g:(pid + 1) * g], np.asarray(ref))
    assert K.causal_mask(q, 0.0, None) is None


def _decode_inputs(n, S, hs, pack, seed, q8=False):
    """q (n, 1, hs); a cache of S positions as (n, S/pack, pack*hs), f32
    (int8 values with positive per-row scales when q8)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 1, hs)).astype(np.float32)
    shape = (n, S // pack, pack * hs)
    if q8:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.5, 4.0, shape[:-1]).astype(np.float32) for _ in range(2))
        return q, k, v, ks, vs
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return q, k, v


DECODE_POS = ["zero", "pack-1", "half", "last"]


def _pos(which, S, pack):
    return {"zero": 0, "pack-1": pack - 1, "half": S // 2, "last": S - 1}[which]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pack", [1, 2, 4])
@pytest.mark.parametrize("which", DECODE_POS)
def test_decode_plain_versions_match_jax_interpret(which, pack, dtype):
    """The three decode kernels' plain versions against the Pallas kernels in
    interpret mode (as tests/test_kernels.py runs them), with S = 64 and
    hs = 128 / pack: the plain layout (K8) on the unpacked cache, the packed
    layout (K8p), and the int8 packed layout (K8q)."""
    S, hs, n = 64, 128 // pack, 6
    pos = _pos(which, S, pack)
    q, kp, vp = _decode_inputs(n, S, hs, pack, seed=pack + pos)
    k, v = kp.reshape(n, S, hs), vp.reshape(n, S, hs)
    tpos = torch.tensor([pos], dtype=torch.int32)
    ref = jpa.decode_attention(*(_to_jax(a, dtype) for a in (q, k, v)), pos, interpret=True)
    out = K.decode_attention(*(_to_torch(a, dtype) for a in (q, k, v)), tpos)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=TOL[dtype], rtol=0)
    ref = jpa.decode_attention_packed(*(_to_jax(a, dtype) for a in (q, kp, vp)), pos, interpret=True)
    out = K.decode_attention_packed(*(_to_torch(a, dtype) for a in (q, kp, vp)), pos)
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=TOL[dtype], rtol=0)
    q, k8, v8, ks, vs = _decode_inputs(n, S, hs, pack, seed=pack + pos, q8=True)
    ref = jpa.decode_attention_packed_q8(_to_jax(q, dtype), jnp.asarray(k8), jnp.asarray(v8),
                                         jnp.asarray(ks), jnp.asarray(vs), pos, interpret=True)
    out = K.decode_attention_packed_q8(_to_torch(q, dtype), torch.from_numpy(k8),
                                       torch.from_numpy(v8), torch.from_numpy(ks),
                                       torch.from_numpy(vs), tpos)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=TOL[dtype], rtol=0)


def test_causal_attention_dispatch_on_the_cpu_is_dense():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32)) for _ in range(3))
    np.testing.assert_allclose(tatt.causal_attention(q, k, v).numpy(),
                               tatt.causal_attention_dense(q, k, v).numpy(), atol=0, rtol=0)
    np.testing.assert_allclose(K.short_causal_attention(q, k, v).numpy(),
                               tatt.causal_attention_dense(q, k, v).numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [(4, 32, 64, 384, 6, 64), (4, 1, 64, 384, 6, 64), (2, 3, 8, 32, 2, 16),
     (1, 2, 512, 64, 2, 64), (1, 2, 40, 64, 1, 256),
     # the bf16 mma.sync body's edges: T 8 / 72 (two query chunks) / 512, hs
     # 32 / 128, C 100 (not a multiple of 8: element loads of x), B odd
     (2, 3, 8, 64, 2, 64), (1, 5, 72, 96, 3, 32), (1, 2, 72, 64, 2, 128),
     (1, 2, 512, 96, 2, 32), (1, 1, 512, 64, 1, 128), (1, 3, 64, 100, 2, 96)],
)
def test_fused_qkv_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    M, B, T, C, H, hs = shape
    x, w1, b1, w2 = (torch.from_numpy(a).to(cuda_device) for a in _fqkv_inputs(*shape, seed=1))
    x = x.to(getattr(torch, dtype))
    before = K.launch_counts()["fused_qkv_attention"]
    out = K.fused_qkv_attention(x, w1, b1, w2, H)
    torch.cuda.synchronize()
    assert K.launch_counts()["fused_qkv_attention"] == before + 1
    # no body uses float atomics: the same bits
    assert torch.equal(out, K.fused_qkv_attention(x, w1, b1, w2, H))
    ref = K.fused_qkv_attention_plain(x, w1, b1, w2, H)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [(3, 192, 64, 64), (3, 6, 64, 64), (2, 5, 8, 32), (3, 4, 512, 64), (2, 3, 200, 128),
     (2, 3, 64, 24)],
)
def test_short_cross_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    q, k, v = (
        torch.from_numpy(a).to(cuda_device).to(getattr(torch, dtype))
        for a in _cross_inputs(*shape, seed=2)
    )
    before = K.launch_counts()["short_cross_attention"]
    out = K.short_cross_attention(q, k, v)
    torch.cuda.synchronize()
    assert K.launch_counts()["short_cross_attention"] == before + 1
    ref = K.short_cross_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)


CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _card_close(name, got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    bound = CARD_TOL[dtype] * max(1.0, ref.float().abs().max().item())
    assert err <= bound, f"{name}: max abs err {err} > {bound}"


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [(4, 32, 64, 384, 6, 64), (4, 1, 64, 384, 6, 64), (4, 1, 56, 384, 6, 64),
     (4, 32, 56, 384, 6, 64), (2, 3, 8, 32, 2, 16), (1, 2, 512, 64, 2, 64),
     (1, 5, 72, 96, 3, 32), (1, 2, 40, 64, 1, 256), (1, 3, 64, 100, 2, 96),
     (2, 3, 8, 64, 2, 64), (1, 2, 72, 64, 2, 128), (1, 2, 512, 96, 2, 32)],
)
def test_fused_qkv_fwd_bwd_kernels_match_plain_on_card(cuda_device, shape, dtype, rate):
    M, B, T, C, H, hs = shape
    x, w1, b1, w2 = (torch.from_numpy(a).to(cuda_device) for a in _fqkv_inputs(*shape, seed=3))
    x = x.to(getattr(torch, dtype))
    salts = SALTS if rate else None
    dout = torch.randn((M, H, B, T, hs), generator=torch.Generator().manual_seed(4)).to(x)
    before = K.launch_counts()
    out = K.fused_qkv_attention_fwd(x, w1, b1, w2, H, rate, salts)
    grads = K.fused_qkv_attention_bwd(x, w1, b1, w2, out, dout, H, rate, salts)
    again = K.fused_qkv_attention_bwd(x, w1, b1, w2, out, dout, H, rate, salts)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["fused_qkv_attention"] == before["fused_qkv_attention"] + 1
    assert after["fused_qkv_attention_bwd"] == before["fused_qkv_attention_bwd"] + 2
    for g, h in zip(grads, again):  # no float atomics: the same bits
        assert torch.equal(g, h)
    assert torch.equal(out, K.fused_qkv_attention_fwd(x, w1, b1, w2, H, rate, salts))
    _card_close("K1f", out, K.fused_qkv_attention_plain(x, w1, b1, w2, H, rate, salts), dtype)
    ref = K.fused_qkv_attention_bwd_plain(x, w1, b1, w2, out, dout, H, rate, salts)
    for name, g, r in zip(("dx", "dw1", "db1", "dw2"), grads, ref):
        assert g.dtype == r.dtype
        _card_close(f"K1b {name}", g, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [(3, 192, 64, 64), (3, 6, 64, 64), (3, 6, 56, 64), (3, 192, 56, 64), (2, 5, 8, 32),
     (3, 4, 512, 64), (2, 3, 72, 32), (2, 3, 200, 128), (2, 2, 64, 256), (2, 3, 64, 24),
     (2, 3, 136, 128), (2, 3, 64, 16), (2, 3, 64, 96)],
)
def test_short_cross_fwd_bwd_kernels_match_plain_on_card(cuda_device, shape, dtype, rate):
    q, k, v = (
        torch.from_numpy(a).to(cuda_device).to(getattr(torch, dtype))
        for a in _cross_inputs(*shape, seed=5)
    )
    salts = SALTS if rate else None
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)).to(q)
    before = K.launch_counts()
    out = K.short_cross_attention_fwd(q, k, v, rate, salts)
    grads = K.short_cross_attention_bwd(q, k, v, dout, rate, salts)
    again = K.short_cross_attention_bwd(q, k, v, dout, rate, salts)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["short_cross_attention"] == before["short_cross_attention"] + 1
    assert after["short_cross_attention_bwd"] == before["short_cross_attention_bwd"] + 2
    for g, h in zip(grads, again):  # no float atomics: the same bits
        assert torch.equal(g, h)
    assert torch.equal(out, K.short_cross_attention_fwd(q, k, v, rate, salts))
    _card_close("K2f", out, K.short_cross_attention_plain(q, k, v, rate, salts), dtype)
    ref = K.short_cross_attention_bwd_plain(q, k, v, dout, rate, salts)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        _card_close(f"K2b {name}", g, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [(24 * 32, 56, 64), (24, 56, 64), (6, 8, 16), (4, 64, 24), (3, 512, 64), (2, 72, 128),
     (2, 64, 256), (3, 72, 32), (2, 200, 96), (2, 136, 128)],
)
def test_short_causal_kernel_matches_plain_on_card(cuda_device, shape, dtype, rate):
    q, k, v = (
        torch.from_numpy(a).to(cuda_device).to(getattr(torch, dtype))
        for a in _cross_inputs(3, *shape, seed=7)
    )
    k, v = k[0], v[1]
    salts = SALTS if rate else None
    before = K.launch_counts()["short_causal_attention"]
    out = K.short_causal_attention(q, k, v, rate, salts)
    torch.cuda.synchronize()
    assert K.launch_counts()["short_causal_attention"] == before + 1
    assert torch.equal(out, K.short_causal_attention(q, k, v, rate, salts))  # the same bits
    _card_close("K3f", out, K.short_causal_attention_plain(q, k, v, rate, salts), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 512, 1024])
@pytest.mark.parametrize("pack", [1, 2, 4])
@pytest.mark.parametrize("which", DECODE_POS)
def test_decode_kernels_match_plain_on_card(cuda_device, which, pack, S, dtype, n):
    """K8, K8p and K8q against their plain versions, pos on the device: a
    warp a row up to 128 positions, several above; n = 5 rows do not fill a
    block of 4 rows. Two runs give the same bits."""
    hs = 128 // pack
    pos = _pos(which, S, pack)
    dt = getattr(torch, dtype)
    q, kp, vp = (torch.from_numpy(a).to(cuda_device) for a in _decode_inputs(n, S, hs, pack, 8))
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    k, v = kp.reshape(n, S, hs), vp.reshape(n, S, hs)
    tpos = torch.tensor([pos], dtype=torch.int32, device=cuda_device)
    _, k8, v8, ks, vs = (torch.from_numpy(a).to(cuda_device)
                         for a in _decode_inputs(n, S, hs, pack, 9, q8=True))
    before = K.launch_counts()
    outs = [K.decode_attention(q, k, v, tpos), K.decode_attention_packed(q, kp, vp, tpos),
            K.decode_attention_packed_q8(q, k8, v8, ks, vs, tpos)]
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name in ("decode_attention", "decode_attention_packed", "decode_attention_packed_q8"):
        assert after[name] == before[name] + 1
    again = [K.decode_attention(q, k, v, tpos), K.decode_attention_packed(q, kp, vp, tpos),
             K.decode_attention_packed_q8(q, k8, v8, ks, vs, tpos)]
    for out, out2 in zip(outs, again):
        assert torch.equal(out, out2)
    refs = [K.decode_attention_plain(q, k, v, pos), K.decode_attention_packed_plain(q, kp, vp, pos),
            K.decode_attention_packed_q8_plain(q, k8, v8, ks, vs, pos)]
    for name, out, ref in zip(("K8", "K8p", "K8q"), outs, refs):
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape", [(768, 64, 64), (6, 8, 16), (4, 64, 24), (3, 512, 64), (2, 72, 128), (2, 64, 256)])
def test_short_causal_fwd_bwd_kernels_match_plain_on_card(cuda_device, shape, dtype, rate):
    """K3f and K3b through the differentiable entry against their plain
    versions: one launch each per forward and backward; K3b run twice gives
    the same bits."""
    q, k, v = (
        torch.from_numpy(a).to(cuda_device).to(getattr(torch, dtype))
        for a in _cross_inputs(3, *shape, seed=17)
    )
    k, v, do = k[0], v[1], k[2]
    salts = SALTS if rate else None
    before = K.launch_counts()
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = K.short_causal_attention(qg, kg, vg, rate, salts)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["short_causal_attention"] == before["short_causal_attention"] + 1
    assert after["short_causal_attention_bwd"] == before["short_causal_attention_bwd"] + 1
    _card_close("K3f", out, K.short_causal_attention_plain(q, k, v, rate, salts), dtype)
    again = K.short_causal_attention_bwd(q, k, v, out.detach(), do, rate, salts)
    ref = K.short_causal_attention_bwd_plain(q, k, v, out.detach(), do, rate, salts)
    for name, g, r, g2 in zip(("dq", "dk", "dv"), grads, ref, again):
        assert g.dtype == r.dtype and torch.equal(g, g2)
        _card_close(f"K3b {name}", g, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 6, 64, 64), (1, 1, 8, 16), (3, 6, 512, 64),
                                   (3, 2, 72, 24), (4, 6, 64, 64), (2, 3, 200, 64),
                                   (1, 2, 72, 96), (2, 2, 56, 128), (1, 3, 64, 32)])
def test_short_packed_kernels_match_plain_on_card(cuda_device, shape, dtype, rate):
    """K4f and K4b through ``short_causal_attention_packed`` against their
    plain versions, one launch each; K4f and K4b twice give the same bits."""
    nb, H, T, hs = shape
    gen = torch.Generator().manual_seed(sum(shape))
    qkv = torch.randn((nb, 3 * H, T, hs), generator=gen).to(cuda_device, getattr(torch, dtype))
    do = torch.randn((nb, H, T, hs), generator=gen).to(qkv)
    salts = SALTS if rate else None
    before = K.launch_counts()
    xg = qkv.clone().requires_grad_()
    out = K.short_causal_attention_packed(xg, H, rate, salts)
    (dqkv,) = torch.autograd.grad(out, (xg,), do)
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name in ("short_causal_attention_packed", "short_causal_attention_packed_bwd"):
        assert after[name] == before[name] + 1
    _card_close("K4f", out, K.short_causal_attention_packed_plain(qkv, H, rate, salts), dtype)
    again = K.short_causal_attention_packed_bwd(qkv, out.detach(), do, H, rate, salts)
    assert torch.equal(dqkv, again)
    assert torch.equal(out.detach(), K.short_causal_attention_packed_fwd(qkv, H, rate, salts))
    _card_close("K4b", dqkv, K.short_causal_attention_packed_bwd_plain(
        qkv, out.detach(), do, H, rate, salts), dtype)


K9_FIRST_SHAPES = [(384, 64, 1024), (24, 64, 128), (5, 256, 256), (7, 16, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,hs,S", [(384, 64, 1024), (24, 64, 128), (5, 256, 256), (7, 16, 128),
                                    (24, 64, 1024), (24, 64, 8192), (3, 256, 2048),
                                    (7, 16, 130)])
def test_decode_t_kernel_matches_plain_on_card(cuda_device, n, hs, S, dtype):
    """K9 against its plain version at pos 0, 127, S/2, S - 1 and the edges
    of the launcher's chunks (chunk - 1, chunk, 2 chunk - 1) read on the
    device, one launch each; two runs give the same bits. One column past
    pos must differ at pos 0, 127 and S/2 of the first four shapes and
    wherever it moves the plain version by more than 1.5 times the limit
    (S 130: element loads)."""
    gen = torch.Generator().manual_seed(n + S)
    dt = getattr(torch, dtype)
    q = torch.randn((n, 1, hs), generator=gen).to(cuda_device, dt)
    kT, vT = (torch.randn((n, hs, S), generator=gen).to(cuda_device, dt) for _ in range(2))
    ch = K.decode_attention_t_plan(q, kT, vT)["chunk"]
    for pos in sorted({0, 127, S // 2, S - 1} | {p for p in (ch - 1, ch, 2 * ch - 1) if p < S}):
        tpos = torch.tensor([pos], dtype=torch.int32, device=cuda_device)
        before = K.launch_counts()["decode_attention_t"]
        out = K.decode_attention_t(q, kT, vT, tpos)
        torch.cuda.synchronize()
        assert K.launch_counts()["decode_attention_t"] == before + 1
        ref = K.decode_attention_t_plain(q, kT, vT, pos)
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)
        assert torch.equal(out, K.decode_attention_t(q, kT, vT, tpos))
        if pos == S - 1:
            continue
        moved = (K.decode_attention_t_plain(q, kT, vT, pos + 1).float()
                 - ref.float()).abs().max().item()
        if ((n, hs, S) in K9_FIRST_SHAPES and pos in (0, 127, S // 2)
                or moved > 1.5 * TOL[dtype]):
            wrong = K.decode_attention_t(q, kT, vT, tpos + 1)
            assert (wrong.float() - ref.float()).abs().max().item() > TOL[dtype]


# the bf16 bodies' template edges too: each padded head size D (64, 128,
# 256) and hs 36, not a multiple of 8 (element loads and stores); the
# training step's rows at B = 8 and B = 1 (192, 24)
FLASH_SHAPES = [(192, 1024, 64), (24, 1024, 64), (24, 896, 64), (3, 256, 16), (2, 640, 128),
                (2, 768, 24), (2, 1024, 256), (1, 2048, 64), (2, 256, 36), (2, 1024, 96),
                (2, 256, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_fwd_bwd_kernels_match_plain_on_card(cuda_device, shape, dtype, rate):
    """K5f (out and lse) and K5b against their plain versions on the same
    inputs; K5b twice gives the same bits (no atomics)."""
    n, T, hs = shape
    gen = torch.Generator().manual_seed(n + T + hs)
    q, k, v, dout = (torch.randn(shape, generator=gen).to(cuda_device, getattr(torch, dtype))
                     for _ in range(4))
    salts = SALTS if rate else None
    before = K.launch_counts()
    out, lse = K.flash_attention_fwd(q, k, v, rate, salts)
    grads = K.flash_attention_bwd(q, k, v, out, lse, dout, rate, salts)
    again = K.flash_attention_bwd(q, k, v, out, lse, dout, rate, salts)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 2
    ref_out, ref_lse = K.flash_attention_plain(q, k, v, rate, salts)
    _card_close("K5f", out, ref_out, dtype)
    _card_close("K5f lse", lse, ref_lse, "float32")
    ref = K.flash_attention_bwd_plain(q, k, v, out, lse, dout, rate, salts)
    for name, g, r, g2 in zip(("dq", "dk", "dv"), grads, ref, again):
        assert g.dtype == r.dtype and torch.equal(g, g2)
        _card_close(f"K5b {name}", g, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 1024, 64), (3, 256, 200)])
def test_flash_bwd_stream_seeds_match_plain_on_card(cuda_device, shape, dtype):
    """K5b as the cross backward launches it, once per stream j with the
    dropout keyed by stream j's seed, against the plain version given the
    same stream; the streams draw different masks."""
    gen = torch.Generator().manual_seed(sum(shape))
    q, k, v, dout = (torch.randn(shape, generator=gen).to(cuda_device, getattr(torch, dtype))
                     for _ in range(4))
    out, lse = K.flash_attention_fwd(q, k, v, 0.2, SALTS)
    dqs = []
    for j in range(3):
        grads = K.flash_attention_bwd(q, k, v, out, lse, dout, 0.2, SALTS, stream=j)
        torch.cuda.synchronize()
        ref = K.flash_attention_bwd_plain(q, k, v, out, lse, dout, 0.2, SALTS, stream=j)
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            _card_close(f"K5b stream {j} {name}", g, r, dtype)
        dqs.append(grads[0])
    assert not torch.equal(dqs[0], dqs[1]) and not torch.equal(dqs[1], dqs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 48, 1024, 64), (3, 96, 896, 64), (2, 3, 256, 16),
                                   (3, 4, 768, 24), (2, 2, 1024, 256), (1, 2, 1024, 36),
                                   (3, 2, 256, 36), (1, 2, 256, 96), (3, 2, 1024, 96),
                                   (1, 2, 256, 200), (3, 2, 256, 200)])
def test_flash_cross_kernels_match_plain_on_card(cuda_device, shape, dtype, rate):
    """K6f and K6f-r against the plain version (sum, each stream's output
    and logsumexp); both kernels give the same sum."""
    J, n, T, hs = shape
    gen = torch.Generator().manual_seed(J + n + T + hs)
    q = torch.randn((n, T, hs), generator=gen).to(cuda_device, getattr(torch, dtype))
    k, v = (torch.randn(shape, generator=gen).to(q) for _ in range(2))
    salts = SALTS if rate else None
    before = K.launch_counts()
    out = K.flash_cross_attention_fwd(q, k, v, rate, salts)
    s, outs, lses = K.flash_cross_attention_res(q, k, v, rate, salts)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["flash_cross_attention"] == before["flash_cross_attention"] + 1
    assert after["flash_cross_attention_res"] == before["flash_cross_attention_res"] + 1
    ref, ref_outs, ref_lses = K.flash_cross_attention_plain(q, k, v, rate, salts, residuals=True)
    assert torch.equal(out, s)
    _card_close("K6f", out, ref, dtype)
    _card_close("K6f-r outs", outs, ref_outs, dtype)
    _card_close("K6f-r lses", lses, ref_lses, "float32")


# the ring's chunk pairs: production self (192 rows, chunks of 512 and 256)
# and cross (48 rows) shapes, t_q != t_k (t_k > t_q at 24 rows: under the
# causal mask the key tiles past t_q store zeros), hs 16 / 128 / 256; t_q != t_k at
# hs 200 (key tiles of 32 rows against 64 query rows a block: under the
# causal mask the block's last key tile is wholly masked for two warps)
# and at hs 36
CHUNK_SHAPES = [(192, 512, 512, 64), (192, 256, 256, 64), (48, 512, 512, 64),
                (2, 128, 512, 64), (24, 256, 1024, 64), (2, 512, 256, 16), (2, 384, 1024, 128),
                (2, 256, 256, 256), (2, 256, 512, 200), (2, 512, 384, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CHUNK_SHAPES)
def test_flash_chunk_kernels_match_plain_on_card(cuda_device, shape, dtype, rate, causal):
    """K7f (out and lse) and K7b against their plain versions, the backward
    given the logsumexp and output merged over two chunks (as the ring
    gives them); K7b twice gives the same bits."""
    n, tq, tk, hs = shape
    gen = torch.Generator().manual_seed(n + tq + tk + hs)
    q, dout = (torch.randn((n, tq, hs), generator=gen).to(cuda_device, getattr(torch, dtype))
               for _ in range(2))
    k, v, k2, v2 = (torch.randn((n, tk, hs), generator=gen).to(q) for _ in range(4))
    seed = 1234567 if rate else None
    before = K.launch_counts()
    out, lse = K.flash_chunk_fwd(q, k, v, causal, seed, rate)
    out2, lse2 = K.flash_chunk_fwd(q, k2, v2, False, seed, rate)
    torch.cuda.synchronize()
    mask = "causal" if causal else "full"
    ref_out, ref_lse = K.flash_chunk_fwd_plain(q, k, v, causal, seed, rate)
    _card_close("K7f", out, ref_out, dtype)
    _card_close("K7f lse", lse, ref_lse, "float32")
    merged = torch.logaddexp(lse, lse2)
    o = (out.float() * torch.exp(lse - merged)[..., None]
         + out2.float() * torch.exp(lse2 - merged)[..., None]).to(q.dtype)
    grads = K.flash_chunk_bwd(q, k, v, o, merged, dout, causal, seed, rate)
    again = K.flash_chunk_bwd(q, k, v, o, merged, dout, causal, seed, rate)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after[f"flash_chunk_fwd_{mask}"] == before[f"flash_chunk_fwd_{mask}"] + 1 + (not causal)
    assert after[f"flash_chunk_bwd_{mask}"] == before[f"flash_chunk_bwd_{mask}"] + 2
    ref = K.flash_chunk_bwd_plain(q, k, v, o, merged, dout, causal, seed, rate)
    for name, g, r, g2 in zip(("dq", "dk", "dv"), grads, ref, again):
        assert g.dtype == r.dtype and torch.equal(g, g2)
        _card_close(f"K7b {name}", g, r, dtype)
