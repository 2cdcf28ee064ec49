"""Hand-written CUDA kernels of the serving and training paths, their
wrappers and their plain PyTorch versions.

Four kernels replace the four Pallas kernel bodies that the JAX package's
training step runs at production width (ops/pallas_attention.py there):

- K1f ``fused_qkv_attention_fwd``: the factored tanh q/k/v projection and
  whole-row causal self-attention in one kernel
  (``csrc/fused_qkv_attention.cu``, replacing ``_fqkv_fwd_kernel``);
- K1b ``fused_qkv_attention_bwd``: its backward, dx and dw1/db1/dw2
  (``csrc/fused_qkv_attention_bwd.cu``, replacing ``_fqkv_bwd_kernel``);
- K2f ``short_cross_attention_fwd``: one query stream against J key/value
  streams, each normalised, summed (``csrc/short_cross_attention.cu``,
  replacing ``_short_cross_fwd_kernel``);
- K2b ``short_cross_attention_bwd``: dq summed over the streams and every
  dk_j / dv_j (same source, replacing ``_short_cross_bwd_kernel``).

All four take attention dropout in the kernel, keyed as the JAX kernels key
it in interpret mode (``hash_keep_mask``), so the masks are bit-identical.
``fused_qkv_attention`` and ``short_cross_attention`` are the differentiable
entries (``torch.autograd.Function``: forward kernel, backward kernel; the
backward regenerates the mask from the salts).

Each wrapper takes its plain version for a tensor on the CPU, and only
there. For a CUDA tensor it launches the kernel or raises: there is no
fallback. The sources are compiled with ``nvcc`` for ``sm_90a`` into
``_build/`` at the first CUDA launch (or by ``build_kernels()``), one shared
library with a plain C interface per source, bound with ``ctypes``.

Every call of a wrapper that launches its kernel adds one to the wrapper's
``launches`` attribute, and nothing else does, so a caller can show that a
run went through the kernels (K1b's one call runs ten CUDA launches).
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

from .layers import _U32, _mul32

SHORT_MIN_SEQ_LEN = 8
SHORT_MAX_SEQ_LEN = 512

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# source name -> {C function: its argument types}
_SIGNATURES = {
    "fused_qkv_attention": {
        "tat_fused_qkv_attention_fwd":
            [_P] * 5 + [_I] * 7 + [_F, _U, _U, _I, _F, _I, _P],
    },
    "fused_qkv_attention_bwd": {
        "tat_fused_qkv_attention_bwd":
            [_P] * 17 + [_I] * 7 + [_F, _U, _U, _I, _F, _I, _P],
    },
    "short_cross_attention": {
        "tat_short_cross_attention_fwd": [_P] * 4 + [_I] * 5 + [_F, _U, _U, _I, _F, _P],
        "tat_short_cross_attention_bwd": [_P] * 8 + [_I] * 5 + [_F, _U, _U, _I, _F, _P],
    },
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
        for fn_name, argtypes in _SIGNATURES[name].items():
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


def _fn(source: str, fn_name: str):
    if source not in _libs:
        build_kernels()
    return getattr(_libs[source], fn_name)


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


# ------------------------------------------------------------------ dropout
#
# The JAX kernels draw attention dropout in interpret mode from an integer
# hash (pallas_attention.py ``hash_keep_mask``); that stream is the port's
# contract, reproduced bit for bit here (u32 arithmetic in int64 masked to 32
# bits) and in the kernels (csrc/attention_tile.cuh ``keep_bit``).

STREAM_SEED_STRIDE = 1000003  # per-stream seed offset of the cross kernels


def _int32(v: int) -> int:
    v &= _U32
    return v - (1 << 32) if v >= 1 << 31 else v


def seed_from_salts(salts) -> int:
    """The kernels' int32 dropout seed from a raw uint32[2] salt pair
    (``seed_from_key``'s raw-salt branch: s0 ^ s1, bit-cast to int32)."""
    s0, s1 = (int(v) for v in salts)
    return _int32(s0 ^ s1)


def stream_seed(seed: int, j: int) -> int:
    """The seed of cross stream j: seed + (j + 1) * 1000003 in int32."""
    return _int32(seed + (j + 1) * STREAM_SEED_STRIDE)


def keep_threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def hash_keep_mask(seed, n_idx, iq, jk, shape, rate: float, device=None) -> torch.Tensor:
    """``hash_keep_mask`` of the JAX package: bool keep-mask of ``shape``
    whose last two axes are (query row r, key column c); ``n_idx`` broadcasts
    against the shape (an int or an integer tensor)."""
    shape = tuple(shape)
    r = torch.arange(shape[-2], dtype=torch.int64, device=device)[:, None]
    c = torch.arange(shape[-1], dtype=torch.int64, device=device)[None, :]
    n = torch.as_tensor(n_idx, dtype=torch.int64, device=device) & _U32
    x = ((int(seed) & _U32) * 2654435761 & _U32) ^ _mul32(n, 40503)
    x = x ^ ((int(iq) & _U32) * 1000003 & _U32) ^ ((int(jk) & _U32) * 97 & _U32)
    h = (_mul32(r, 2246822519) + _mul32(c, 3266489917) + x) & _U32
    h = h ^ (h >> 13)
    h = _mul32(h, 2654435761)
    h = h ^ (h >> 16)
    return torch.broadcast_to(h >= keep_threshold(rate), shape)


def fqkv_pick_gb(nb: int, H: int, t: int, hs: int, c: int, itemsize: int = 2) -> int:
    """The JAX fused kernel's batch group (``_fqkv_pick_gb``): its programs
    hold gb batch rows, and the dropout mask rows follow that grouping."""
    budget = 7 * 1024 * 1024
    att_row = (10 * t * hs + 5 * t * t) * 2 * itemsize * H
    proj_row = t * (c + 3 * H * (hs // 2) * 3) * 2 * itemsize
    for gb in (32, 16, 8, 4, 2, 1):
        if nb % gb == 0 and gb * (att_row + proj_row) <= budget:
            return gb
    return 1


def fqkv_mask_rows(M: int, B: int, H: int, gb: int, device=None) -> torch.Tensor:
    """(M, H, B, 1, 1) mask row of each (m, h, b) in the JAX fused kernel:
    pid * gb * H + h * gb + b % gb, with pid = m * (B / gb) + b // gb."""
    m = torch.arange(M, device=device)[:, None, None]
    h = torch.arange(H, device=device)[None, :, None]
    b = torch.arange(B, device=device)[None, None, :]
    pid = m * (B // gb) + b // gb
    return (pid * gb * H + h * gb + b % gb)[..., None, None]


def _dropout_args(what: str, rate: float, salts):
    """(seed, thresh, on, keepf, inv) of a launch; salts is a raw uint32[2]."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{what}: dropout rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return 0, 0, 0, 1.0, 1.0
    if salts is None:
        raise ValueError(f"{what}: dropout_rate > 0 requires dropout_salts")
    return seed_from_salts(salts) & _U32, keep_threshold(rate), 1, 1.0 - rate, 1.0 / (1.0 - rate)


# ------------------------------------------------------------------ plain


def _acc(dt: torch.dtype) -> torch.dtype:
    return torch.float64 if dt == torch.float64 else torch.float32


def _scores_p_l(q, k):
    """Causal p = exp(s - m) and l = rowsum(p) over the trailing (T, hs)
    axes, s = q k^T * hs^-0.5 in f32 (f64 for f64)."""
    acc = _acc(q.dtype)
    t_q, t_k = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * k.shape[-1] ** -0.5
    mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p, p.sum(dim=-1, keepdim=True)


def _whole_row_attention(q, k, v, keep=None, rate: float = 0.0):
    """Causal softmax(q k^T * hs^-0.5) v over the trailing (T, hs) axes, with
    the kernels' rounding points: f32 (f64 for f64) scores, max, exp and row
    sum; p masked by ``keep``, then cast to v's type before P.V; result
    o / (l * (1 - rate)) unrounded, in the accumulation type. Leading axes
    broadcast."""
    acc = _acc(q.dtype)
    p, l = _scores_p_l(q, k)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), dtype=acc, device=p.device))
        l = l * torch.tensor(1.0 - rate, dtype=acc)
    return torch.matmul(p.to(v.dtype).to(acc), v.to(acc)) / l


def _attention_bwd(q, k, v, do, keep, rate: float, o=None):
    """Whole-row causal attention backward with the JAX kernels' math
    (``_short_cross_bwd_kernel`` / ``_fqkv_bwd_kernel``). q, do: (..., T, hs)
    broadcasting against k, v. D = rowsum(do * o) when o is given (the fused
    kernel), else rowsum(w * do v^T) (the cross kernel). Returns dq, dk, dv
    in the accumulation type, dq per stream (the caller sums)."""
    acc = _acc(q.dtype)
    zero = torch.zeros((), dtype=acc, device=q.device)
    scale = k.shape[-1] ** -0.5
    p, l = _scores_p_l(q, k)
    if keep is not None:
        inv = torch.tensor(1.0 / (1.0 - rate), dtype=acc)
        w = torch.where(keep, p, zero) * (inv / l)
    else:
        w = p / l
    w = w.to(v.dtype).to(acc)
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    if o is None:
        d_cap = (w * dp).sum(dim=-1, keepdim=True)
    else:
        d_cap = (do.to(acc) * o.to(acc)).sum(dim=-1, keepdim=True)
    if keep is not None:
        dp = torch.where(keep, dp, zero) * inv
    ds = ((p / l) * (dp - d_cap)).to(v.dtype).to(acc)
    dq = scale * torch.matmul(ds, k.to(acc))
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.to(acc))
    dv = torch.matmul(w.transpose(-1, -2), do.to(acc))
    return dq, dk, dv


def _fqkv_mask(x, w2, n_head: int, rate: float, salts):
    """(M, H, B, T, T) keep-mask of the fused kernel, or None without dropout."""
    if rate == 0.0:
        return None
    M, B, T, C = x.shape
    gb = fqkv_pick_gb(B, n_head, T, w2.shape[-1], C, x.element_size())
    rows = fqkv_mask_rows(M, B, n_head, gb, x.device)
    return hash_keep_mask(seed_from_salts(salts), rows, 0, 0, (M, n_head, B, T, T), rate, x.device)


def _fqkv_project_plain(x, w1, b1, w2, n_head: int):
    """t2 (f32 tanh output), t3 (rounded, (M, B, T, 3H, hs/2)) and qkv
    (M, 3H, B, T, hs) with the kernels' rounding points."""
    dt, acc = x.dtype, _acc(x.dtype)
    M, B, T, _ = x.shape
    hs2 = w2.shape[-2]
    pre = torch.einsum("mbtc,mcd->mbtd", x.to(acc), w1.to(dt).to(acc))
    t2 = torch.tanh(pre + b1.to(acc)[:, None, None, :])
    t3 = t2.to(dt).reshape(M, B, T, 3 * n_head, hs2)
    qkv = torch.einsum("mbtvd,mvde->mvbte", t3.to(acc), w2.to(dt).to(acc)).to(dt)
    return t2, t3, qkv


def fused_qkv_attention_plain(x, w1, b1, w2, n_head: int, dropout_rate: float = 0.0,
                              dropout_salts=None):
    """Plain PyTorch version of the fused forward kernel (same arguments)."""
    H = n_head
    _, _, qkv = _fqkv_project_plain(x, w1, b1, w2, H)
    keep = _fqkv_mask(x, w2, H, float(dropout_rate), dropout_salts)
    q, k, v = qkv[:, :H], qkv[:, H:2 * H], qkv[:, 2 * H:]
    return _whole_row_attention(q, k, v, keep, float(dropout_rate)).to(x.dtype)


def fused_qkv_attention_bwd_plain(x, w1, b1, w2, out, dout, n_head: int,
                                  dropout_rate: float = 0.0, dropout_salts=None):
    """Plain PyTorch version of the fused backward kernel: returns dx (x's
    type) and dw1, db1, dw2 (f32, f64 for f64), as ``_fqkv_bwd_kernel``."""
    dt, acc = x.dtype, _acc(x.dtype)
    H, rate = n_head, float(dropout_rate)
    M, B, T, C = x.shape
    t2, t3, qkv = _fqkv_project_plain(x, w1, b1, w2, H)
    keep = _fqkv_mask(x, w2, H, rate, dropout_salts)
    q, k, v = qkv[:, :H], qkv[:, H:2 * H], qkv[:, 2 * H:]
    dq, dk, dv = _attention_bwd(q, k, v, dout, keep, rate, o=out)
    dqkv = torch.cat([dq, dk, dv], dim=1).to(dt).to(acc)  # (M, 3H, B, T, hs)
    w1c, w2c = w1.to(dt).to(acc), w2.to(dt).to(acc)
    dt3 = torch.einsum("mvbte,mvde->mbtvd", dqkv, w2c).reshape(M, B, T, -1)
    dw2 = torch.einsum("mbtvd,mvbte->mvde", t3.to(acc), dqkv)
    dpre = dt3.to(dt).to(acc) * (1.0 - t2 * t2)
    db1 = dpre.sum(dim=(1, 2))
    dprec = dpre.to(dt).to(acc)
    dx = torch.einsum("mbtd,mcd->mbtc", dprec, w1c).to(dt)
    dw1 = torch.einsum("mbtc,mbtd->mcd", x.to(acc), dprec)
    return dx, dw1, db1, dw2


def _cross_mask(q, J: int, rate: float, salts):
    """(J, ..., T, T) keep-mask of the cross kernel, or None: stream j keyed
    by its stream seed, rows by the collapsed query row."""
    if rate == 0.0:
        return None
    lead, T = q.shape[:-2], q.shape[-2]
    n = 1
    for d_ in lead:
        n *= d_
    rows = torch.arange(n, device=q.device).reshape(*lead, 1, 1)
    seed = seed_from_salts(salts)
    return torch.stack([
        hash_keep_mask(stream_seed(seed, j), rows, 0, 0, (*lead, T, T), rate, q.device)
        for j in range(J)
    ])


def short_cross_attention_plain(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """Plain PyTorch version of the cross forward kernel (same arguments)."""
    rate = float(dropout_rate)
    keep = _cross_mask(q, k.shape[0], rate, dropout_salts)
    return _whole_row_attention(q[None], k, v, keep, rate).sum(dim=0).to(q.dtype)


def short_cross_attention_bwd_plain(q, k, v, dout, dropout_rate: float = 0.0,
                                    dropout_salts=None):
    """Plain PyTorch version of the cross backward kernel: dq summed over the
    streams, dk and dv per stream, in the inputs' type."""
    rate = float(dropout_rate)
    keep = _cross_mask(q, k.shape[0], rate, dropout_salts)
    dq, dk, dv = _attention_bwd(q[None], k, v, dout[None], keep, rate)
    return dq.sum(dim=0).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ wrappers


def _check_fqkv_shapes(what, x, w1, b1, w2, H):
    if x.ndim != 4 or w1.ndim != 3 or b1.ndim != 2 or w2.ndim != 4:
        raise ValueError(f"{what}: expected x 4-D, w1 3-D, b1 2-D, w2 4-D")
    M, B, T, C = x.shape
    hs2, hs = w2.shape[-2], w2.shape[-1]
    d3 = 3 * H * hs2
    if (w1.shape != (M, C, d3) or b1.shape != (M, d3)
            or w2.shape != (M, 3 * H, hs2, hs) or hs != 2 * hs2):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)} do not match H={H}"
        )


def fused_qkv_attention_fwd(x, w1, b1, w2, n_head: int, dropout_rate: float = 0.0,
                            dropout_salts=None):
    """The forward kernel (K1f): the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors. Returns (M, H, B, T, hs) in x's type."""
    what = "fused_qkv_attention"
    H = n_head
    _check_fqkv_shapes(what, x, w1, b1, w2, H)
    seed, thresh, on, keepf, _ = _dropout_args(what, dropout_rate, dropout_salts)
    if _on_cpu(x, w1, b1, w2):
        return fused_qkv_attention_plain(x, w1, b1, w2, H, dropout_rate, dropout_salts)
    _check_cuda_operands(what, (x,), (w1, b1, w2))
    M, B, T, C = x.shape
    hs = w2.shape[-1]
    _check_band(what, T, hs)
    gb = fqkv_pick_gb(B, H, T, hs, C, x.element_size())
    out = torch.empty((M, H, B, T, hs), dtype=x.dtype, device=x.device)
    err = _fn("fused_qkv_attention", "tat_fused_qkv_attention_fwd")(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), out.data_ptr(),
        M, B, T, C, H, hs, int(x.dtype == torch.bfloat16), hs ** -0.5,
        seed, thresh, on, keepf, gb, _stream(),
    )
    _check_launch(err, what)
    fused_qkv_attention_fwd.launches += 1
    return out


fused_qkv_attention_fwd.launches = 0


def fused_qkv_attention_bwd(x, w1, b1, w2, out, dout, n_head: int,
                            dropout_rate: float = 0.0, dropout_salts=None):
    """The backward kernel (K1b): dx in x's type and dw1, db1, dw2 in f32."""
    what = "fused_qkv_attention_bwd"
    H = n_head
    _check_fqkv_shapes(what, x, w1, b1, w2, H)
    seed, thresh, on, _, inv = _dropout_args(what, dropout_rate, dropout_salts)
    M, B, T, C = x.shape
    hs2, hs = w2.shape[-2], w2.shape[-1]
    if out.shape != (M, H, B, T, hs) or dout.shape != out.shape:
        raise ValueError(f"{what}: out / dout must be {(M, H, B, T, hs)}")
    if _on_cpu(x, w1, b1, w2, out, dout):
        return fused_qkv_attention_bwd_plain(x, w1, b1, w2, out, dout, H, dropout_rate,
                                             dropout_salts)
    _check_cuda_operands(what, (x, out, dout), (w1, b1, w2))
    _check_band(what, T, hs)
    gb = fqkv_pick_gb(B, H, T, hs, C, x.element_size())
    dev, dt, f32 = x.device, x.dtype, torch.float32
    d3 = 3 * H * hs2
    dx = torch.empty_like(x)
    dw1 = torch.empty((M, C, d3), dtype=f32, device=dev)
    db1 = torch.empty((M, d3), dtype=f32, device=dev)
    dw2 = torch.empty((M, 3 * H, hs2, hs), dtype=f32, device=dev)
    ws = [torch.empty((M, B * T, d3), dtype=f32, device=dev) for _ in range(2)]
    ws += [torch.empty((M, B * T, d3), dtype=dt, device=dev)]
    ws += [torch.empty((M, 3 * H, B, T, hs), dtype=dt, device=dev) for _ in range(2)]
    ws += [torch.empty((M, B * T, d3), dtype=dt, device=dev)]
    ws += [torch.empty((M * H * B, T, hs), dtype=f32, device=dev)]
    err = _fn("fused_qkv_attention_bwd", "tat_fused_qkv_attention_bwd")(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
        *(w.data_ptr() for w in ws),
        M, B, T, C, H, hs, int(dt == torch.bfloat16), hs ** -0.5,
        seed, thresh, on, inv, gb, _stream(),
    )
    _check_launch(err, what)
    fused_qkv_attention_bwd.launches += 1
    return dx, dw1, db1, dw2


fused_qkv_attention_bwd.launches = 0


class FusedQKVAttention(torch.autograd.Function):
    """K1f forward, K1b backward; gradients for x, w1, b1 and w2. The
    dropout mask is regenerated from the salts in the backward: no mask is
    stored."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, n_head, dropout_rate, dropout_salts):
        out = fused_qkv_attention_fwd(x, w1, b1, w2, n_head, dropout_rate, dropout_salts)
        ctx.save_for_backward(x, w1, b1, w2, out)
        ctx.args = (n_head, dropout_rate, dropout_salts)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w1, b1, w2, out = ctx.saved_tensors
        dx, dw1, db1, dw2 = fused_qkv_attention_bwd(x, w1, b1, w2, out, dout.contiguous(),
                                                    *ctx.args)
        return dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), None, None, None


def fused_qkv_attention(x, w1, b1, w2, n_head: int, dropout_rate: float = 0.0,
                        dropout_salts=None):
    """Factored QKV projection + whole-row causal attention, differentiable.

    x: (M, B, T, C) normalised input, bf16 or f32; w1: (M, C, 3D) with
    D = H*hs/2; b1: (M, 3D); w2: (M, 3H, hs/2, hs), the q/k/v head groups
    concatenated; weights f32. dropout_salts: the site's raw uint32[2] salts
    (needed when dropout_rate > 0). Returns (M, H, B, T, hs) in x's type,
    head-major like the JAX entry ``fused_qkv_attention``."""
    salts = None if dropout_salts is None else tuple(int(s) for s in dropout_salts)
    return FusedQKVAttention.apply(x, w1, b1, w2, n_head, float(dropout_rate), salts)


def _check_cross_shapes(what, q, k, v):
    if q.ndim < 2 or k.shape != v.shape or k.ndim != q.ndim + 1 or k.shape[1:] != q.shape:
        raise ValueError(
            f"{what}: expected q (..., T, hs) and k, v (J, ..., T, hs); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def short_cross_attention_fwd(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """The forward kernel (K2f): plain version for CPU tensors, CUDA kernel
    for CUDA tensors. Returns (..., T, hs) in q's type."""
    what = "short_cross_attention"
    _check_cross_shapes(what, q, k, v)
    seed, thresh, on, keepf, _ = _dropout_args(what, dropout_rate, dropout_salts)
    if _on_cpu(q, k, v):
        return short_cross_attention_plain(q, k, v, dropout_rate, dropout_salts)
    _check_cuda_operands(what, (q, k, v))
    T, hs = q.shape[-2], q.shape[-1]
    _check_band(what, T, hs)
    J, n = k.shape[0], q.numel() // (T * hs)
    out = torch.empty_like(q)
    err = _fn("short_cross_attention", "tat_short_cross_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        J, n, T, hs, int(q.dtype == torch.bfloat16), hs ** -0.5,
        seed, thresh, on, keepf, _stream(),
    )
    _check_launch(err, what)
    short_cross_attention_fwd.launches += 1
    return out


short_cross_attention_fwd.launches = 0


def short_cross_attention_bwd(q, k, v, dout, dropout_rate: float = 0.0, dropout_salts=None):
    """The backward kernel (K2b): dq (summed over streams), dk, dv."""
    what = "short_cross_attention_bwd"
    _check_cross_shapes(what, q, k, v)
    if dout.shape != q.shape:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    seed, thresh, on, _, inv = _dropout_args(what, dropout_rate, dropout_salts)
    if _on_cpu(q, k, v, dout):
        return short_cross_attention_bwd_plain(q, k, v, dout, dropout_rate, dropout_salts)
    _check_cuda_operands(what, (q, k, v, dout))
    T, hs = q.shape[-2], q.shape[-1]
    _check_band(what, T, hs)
    J, n = k.shape[0], q.numel() // (T * hs)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = _fn("short_cross_attention", "tat_short_cross_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
        J, n, T, hs, int(q.dtype == torch.bfloat16), hs ** -0.5,
        seed, thresh, on, inv, _stream(),
    )
    _check_launch(err, what)
    short_cross_attention_bwd.launches += 1
    return dq, dk, dv


short_cross_attention_bwd.launches = 0


class ShortCrossAttention(torch.autograd.Function):
    """K2f forward, K2b backward; gradients for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_rate, dropout_salts):
        out = short_cross_attention_fwd(q, k, v, dropout_rate, dropout_salts)
        ctx.save_for_backward(q, k, v)
        ctx.args = (dropout_rate, dropout_salts)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = short_cross_attention_bwd(q, k, v, dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None


def short_cross_attention(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """Sum over J key/value streams of whole-row causal attention,
    differentiable. q: (..., T, hs); k, v: (J, ..., T, hs); one type, bf16 or
    f32. Stream j's dropout is keyed by its stream seed and the collapsed
    query row, as the JAX kernel's. Returns (..., T, hs) in q's type."""
    salts = None if dropout_salts is None else tuple(int(s) for s in dropout_salts)
    return ShortCrossAttention.apply(q, k, v, float(dropout_rate), salts)


def short_cross_attention_t(q, kT, vT, dropout_rate: float = 0.0, dropout_salts=None):
    """``short_cross_attention`` with k and v given transposed, (J, ..., hs, T),
    the JAX entry's contract. The kernels take (J, ..., T, hs), so they are
    transposed here first (and the gradients back)."""
    if kT.shape != vT.shape or kT.shape[1:] != (*q.shape[:-2], q.shape[-1], q.shape[-2]):
        raise ValueError(f"transposed kv shape mismatch: {tuple(kT.shape)} vs q {tuple(q.shape)}")
    k = kT.transpose(-1, -2).contiguous()
    v = vT.transpose(-1, -2).contiguous()
    return short_cross_attention(q, k, v, dropout_rate, dropout_salts)


KERNELS = {
    "fused_qkv_attention": fused_qkv_attention_fwd,
    "fused_qkv_attention_bwd": fused_qkv_attention_bwd,
    "short_cross_attention": short_cross_attention_fwd,
    "short_cross_attention_bwd": short_cross_attention_bwd,
}

def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
