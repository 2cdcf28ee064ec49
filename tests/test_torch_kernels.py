"""The port's kernel modules held against the JAX package's Pallas kernels.

On the CPU each wrapper of ``trade_aid_multimodal_transformer_tpu_torch.ops.
kernels`` runs its plain PyTorch version; that version is held against the
JAX kernel run in interpret mode, on the same numpy inputs, as
tests/test_kernels.py runs it. Tolerances: f32 atol 1e-5 (same arithmetic,
another summation order); bf16 atol 2e-2 (the same rounding points, but a
different summation order can flip a bf16 rounding of an intermediate).
The CUDA kernels themselves are held against the plain versions on the card
by the tests marked ``cuda`` below and by chip_smoke.py.
"""

import numpy as np
import pytest

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


def test_wrappers_raise_on_dropout():
    x, w1, b1, w2 = (torch.from_numpy(a) for a in _fqkv_inputs(1, 1, 8, 8, 1, 4, seed=0))
    with pytest.raises(NotImplementedError):
        K.fused_qkv_attention(x, w1, b1, w2, 1, dropout_rate=0.2)
    q, k, v = (torch.from_numpy(a) for a in _cross_inputs(2, 1, 8, 4, seed=0))
    with pytest.raises(NotImplementedError):
        K.short_cross_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(NotImplementedError):
        K.short_cross_attention_t(q, k.transpose(-1, -2), v.transpose(-1, -2), dropout_rate=0.1)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on any other device than the CPU or CUDA raises instead of
    reaching the plain version, and CPU calls launch nothing."""
    K.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _cross_inputs(2, 1, 8, 4, seed=1))
    K.short_cross_attention(q, k, v)
    assert K.launch_counts() == {"fused_qkv_attention": 0, "short_cross_attention": 0}
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
     (1, 2, 512, 64, 2, 64), (1, 2, 40, 64, 1, 256)],
)
def test_fused_qkv_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    M, B, T, C, H, hs = shape
    x, w1, b1, w2 = (torch.from_numpy(a).to(cuda_device) for a in _fqkv_inputs(*shape, seed=1))
    x = x.to(getattr(torch, dtype))
    before = K.fused_qkv_attention.launches
    out = K.fused_qkv_attention(x, w1, b1, w2, H)
    torch.cuda.synchronize()
    assert K.fused_qkv_attention.launches == before + 1
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
    before = K.short_cross_attention.launches
    out = K.short_cross_attention(q, k, v)
    torch.cuda.synchronize()
    assert K.short_cross_attention.launches == before + 1
    ref = K.short_cross_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)
