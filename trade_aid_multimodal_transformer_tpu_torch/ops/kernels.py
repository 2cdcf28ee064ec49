"""Hand-written CUDA kernels of the serving path, their wrappers and their
plain PyTorch versions.

Two kernels replace the two Pallas kernels that the JAX package's inference
forward runs at production width (ops/pallas_attention.py there):

- ``fused_qkv_attention``: the factored tanh q/k/v projection and whole-row
  causal self-attention in one kernel (``csrc/fused_qkv_attention.cu``,
  replacing ``_fqkv_fwd_kernel``);
- ``short_cross_attention``: one query stream against J key/value streams,
  each normalised, summed (``csrc/short_cross_attention.cu``, replacing
  ``_short_cross_fwd_kernel``).

Each wrapper takes its plain version for a tensor on the CPU, and only
there. For a CUDA tensor it launches the kernel or raises: there is no
fallback. The sources are compiled with ``nvcc`` for ``sm_90a`` into
``_build/`` at the first CUDA launch (or by ``build_kernels()``), one shared
library with a plain C interface per source, bound with ``ctypes``.

Every launch adds one to the wrapper's ``launches`` attribute, and nothing
else does, so a caller can show that a run went through the kernels.
Forward only, without dropout: training's backward kernels and in-kernel
dropout come with the training path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

SHORT_MIN_SEQ_LEN = 8
SHORT_MAX_SEQ_LEN = 512

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source name -> (C function, its argument types)
_SIGNATURES = {
    "fused_qkv_attention": (
        "tat_fused_qkv_attention_fwd",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "short_cross_attention": (
        "tat_short_cross_attention_fwd",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    ),
}
_libs: Dict[str, ctypes.CDLL] = {}


# ------------------------------------------------------------------ build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> Dict[str, float]:
    """Compile every kernel source not yet loaded, one ``nvcc`` per source,
    all started together, and load the libraries. Returns the seconds each
    build took (0.0 where a library of the same sources was already on
    disk). Raises when a build fails."""
    todo = [n for n in _SIGNATURES if n not in _libs]
    if not todo:
        return {}
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(
        not (_BUILD / f"lib{n}-{_digest(n)}.so").exists() for n in todo
    ) else None
    started, procs, seconds = {}, {}, {}
    for name in todo:
        so = _BUILD / f"lib{name}-{_digest(name)}.so"
        if so.exists():
            seconds[name] = 0.0
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        started[name] = time.perf_counter()
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, so,
        )
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - started[name]
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    for name in todo:
        lib = ctypes.CDLL(str(_BUILD / f"lib{name}-{_digest(name)}.so"))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return seconds


def build_log(name: str) -> str:
    """What nvcc and ptxas printed for a kernel source (registers, shared
    memory, spills), or '' if it was not built in this checkout."""
    p = _BUILD / f"lib{name}-{_digest(name)}.log"
    return p.read_text() if p.exists() else ""


def _fn(name: str):
    if name not in _libs:
        build_kernels()
    return getattr(_libs[name], _SIGNATURES[name][0])


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with cudaError {err}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    every tensor lies on one CUDA device (kernel); raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check_cuda_operands(what: str, acts, weights=()) -> None:
    dt = acts[0].dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: activations must be bfloat16 or float32, got {dt}")
    for t in acts:
        if t.dtype != dt:
            raise TypeError(f"{what}: activation dtypes differ ({t.dtype} vs {dt})")
    for t in weights:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: weights must be float32, got {t.dtype}")
    for t in (*acts, *weights):
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def in_band(t: int, hs: int) -> bool:
    """The shapes both kernels take, as the JAX package's short kernels:
    8 <= T <= 512, T % 8 == 0, 0 < hs <= 256."""
    return SHORT_MIN_SEQ_LEN <= t <= SHORT_MAX_SEQ_LEN and t % 8 == 0 and 0 < hs <= 256


def _check_band(what: str, t: int, hs: int) -> None:
    if not in_band(t, hs):
        raise ValueError(
            f"{what}: T={t}, hs={hs} outside the kernel band 8 <= T <= 512, T % 8 == 0, hs <= 256"
        )


def _no_dropout(what: str, dropout_rate: float) -> None:
    if dropout_rate > 0.0:
        raise NotImplementedError(
            f"{what}: in-kernel dropout comes with the training path; "
            "the serving kernels run with dropout_rate 0"
        )


# ------------------------------------------------------------------ plain


def _whole_row_attention(q, k, v):
    """Causal softmax(q k^T * hs^-0.5) v over the trailing (T, hs) axes, with
    the kernels' rounding points: f32 (f64 for f64) scores, max, exp and row
    sum; p cast to v's type before P.V; result o / l unrounded, in the
    accumulation type. Leading axes broadcast."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    t_q, t_k = q.shape[-2], k.shape[-2]
    scale = k.shape[-1] ** -0.5
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).to(acc), v.to(acc)) / l


def fused_qkv_attention_plain(x, w1, b1, w2, n_head: int):
    """Plain PyTorch version of ``fused_qkv_attention`` (same arguments)."""
    dt = x.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    M, B, T, _ = x.shape
    H, hs2 = n_head, w2.shape[-2]
    pre = torch.einsum("mbtc,mcd->mbtd", x.to(acc), w1.to(dt).to(acc))
    t = torch.tanh(pre + b1.to(acc)[:, None, None, :]).to(dt)
    t = t.reshape(M, B, T, 3 * H, hs2)
    qkv = torch.einsum("mbtvd,mvde->mvbte", t.to(acc), w2.to(dt).to(acc)).to(dt)
    q, k, v = qkv[:, :H], qkv[:, H:2 * H], qkv[:, 2 * H:]
    return _whole_row_attention(q, k, v).to(dt)


def short_cross_attention_plain(q, k, v):
    """Plain PyTorch version of ``short_cross_attention`` (same arguments)."""
    return _whole_row_attention(q[None], k, v).sum(dim=0).to(q.dtype)


# ------------------------------------------------------------------ wrappers


def fused_qkv_attention(x, w1, b1, w2, n_head: int, dropout_rate: float = 0.0):
    """Factored QKV projection + whole-row causal attention, one kernel.

    x: (M, B, T, C) normalised input, bf16 or f32; w1: (M, C, 3D) with
    D = H*hs/2; b1: (M, 3D); w2: (M, 3H, hs/2, hs), the q/k/v head groups
    concatenated; weights f32. Returns (M, H, B, T, hs) in x's type, head-major
    like the JAX entry ``fused_qkv_attention``."""
    what = "fused_qkv_attention"
    _no_dropout(what, dropout_rate)
    if x.ndim != 4 or w1.ndim != 3 or b1.ndim != 2 or w2.ndim != 4:
        raise ValueError(f"{what}: expected x 4-D, w1 3-D, b1 2-D, w2 4-D")
    M, B, T, C = x.shape
    H = n_head
    hs2, hs = w2.shape[-2], w2.shape[-1]
    d3 = 3 * H * hs2
    if (w1.shape != (M, C, d3) or b1.shape != (M, d3)
            or w2.shape != (M, 3 * H, hs2, hs) or hs != 2 * hs2):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)} do not match H={H}"
        )
    if _on_cpu(x, w1, b1, w2):
        return fused_qkv_attention_plain(x, w1, b1, w2, n_head)
    _check_cuda_operands(what, (x,), (w1, b1, w2))
    _check_band(what, T, hs)
    out = torch.empty((M, H, B, T, hs), dtype=x.dtype, device=x.device)
    err = _fn("fused_qkv_attention")(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), out.data_ptr(),
        M, B, T, C, H, hs, int(x.dtype == torch.bfloat16), hs ** -0.5, _stream(),
    )
    _check_launch(err, what)
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0


def short_cross_attention(q, k, v, dropout_rate: float = 0.0):
    """Sum over J key/value streams of whole-row causal attention, one kernel.

    q: (..., T, hs); k, v: (J, ..., T, hs); one type, bf16 or f32. Returns
    (..., T, hs) in q's type."""
    what = "short_cross_attention"
    _no_dropout(what, dropout_rate)
    if q.ndim < 2 or k.shape != v.shape or k.ndim != q.ndim + 1 or k.shape[1:] != q.shape:
        raise ValueError(
            f"{what}: expected q (..., T, hs) and k, v (J, ..., T, hs); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if _on_cpu(q, k, v):
        return short_cross_attention_plain(q, k, v)
    _check_cuda_operands(what, (q, k, v))
    T, hs = q.shape[-2], q.shape[-1]
    _check_band(what, T, hs)
    J = k.shape[0]
    n = q.numel() // (T * hs)
    out = torch.empty_like(q)
    err = _fn("short_cross_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        J, n, T, hs, int(q.dtype == torch.bfloat16), hs ** -0.5, _stream(),
    )
    _check_launch(err, what)
    short_cross_attention.launches += 1
    return out


short_cross_attention.launches = 0


def short_cross_attention_t(q, kT, vT, dropout_rate: float = 0.0):
    """``short_cross_attention`` with k and v given transposed, (J, ..., hs, T),
    the JAX entry's contract. The kernel takes (J, ..., T, hs), so they are
    transposed here first."""
    if kT.shape != vT.shape or kT.shape[1:] != (*q.shape[:-2], q.shape[-1], q.shape[-2]):
        raise ValueError(f"transposed kv shape mismatch: {tuple(kT.shape)} vs q {tuple(q.shape)}")
    k = kT.transpose(-1, -2).contiguous()
    v = vT.transpose(-1, -2).contiguous()
    return short_cross_attention(q, k, v, dropout_rate)


KERNELS = {
    "fused_qkv_attention": fused_qkv_attention,
    "short_cross_attention": short_cross_attention,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
