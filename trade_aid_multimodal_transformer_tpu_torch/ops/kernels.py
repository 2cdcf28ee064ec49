"""Hand-written CUDA kernels of the serving and training paths, their
wrappers and their plain PyTorch versions.

Twelve kernels replace the Pallas kernel bodies that the JAX package's
training step and its two serving paths run at production width, at the
short block sizes and at long context (ops/pallas_attention.py there):

- K1f ``fused_qkv_attention_fwd``: the factored tanh q/k/v projection and
  whole-row causal self-attention in one kernel
  (``csrc/fused_qkv_attention.cu``, replacing ``_fqkv_fwd_kernel``);
- K1b ``fused_qkv_attention_bwd``: its backward, dx and dw1/db1/dw2
  (``csrc/fused_qkv_attention_bwd.cu``, replacing ``_fqkv_bwd_kernel``);
- K2f ``short_cross_attention_fwd``: one query stream against J key/value
  streams, each normalised, summed (``csrc/short_cross_attention.cu``,
  replacing ``_short_cross_fwd_kernel``);
- K2b ``short_cross_attention_bwd``: dq summed over the streams and every
  dk_j / dv_j (same source, replacing ``_short_cross_bwd_kernel``);
- K3f ``short_causal_attention``: whole-row causal self-attention over
  separate q, k, v, forward only: the KV-cache prefill
  (``csrc/short_causal_attention.cu``, replacing ``_short_fwd_kernel``);
- K8, K8p, K8q ``decode_attention``, ``decode_attention_packed``,
  ``decode_attention_packed_q8``: one query position against a KV cache row
  in the plain, packed and packed int8 layouts (``csrc/decode_attention.cu``,
  replacing ``_decode_kernel``, ``_decode_p_kernel`` and ``_decode_p8_kernel``);
- K5f ``flash_attention_fwd``: blockwise (flash) causal attention with its
  logsumexp for long T (``csrc/flash_attention.cu`` with
  ``csrc/flash_fwd.cuh``, replacing ``_flash_forward`` and
  ``_flash_forward_streamed``);
- K5b ``flash_attention_bwd``: its dq, dk, dv (same source, replacing
  ``_flash_backward_fused``, ``_flash_backward`` and
  ``_flash_backward_streamed``);
- K6f, K6f-r ``flash_cross_attention_fwd``, ``flash_cross_attention_res``:
  the flash forward of one query stream against J key/value streams, summed,
  and the same with each stream's output and logsumexp for the backward
  (``csrc/flash_cross_attention.cu``, replacing ``_flash_cross_forward`` and
  ``_flash_cross_forward_res``);
- K7f, K7b ``flash_chunk_fwd``, ``flash_chunk_bwd``: one (query chunk, key
  chunk) pair of ring (context-parallel) attention, t_q and t_k apart, with
  the causal mask or none; the backward from a logsumexp given by the caller
  (the ring-merged one) (``csrc/flash_attention.cu``, replacing
  ``flash_chunk_fwd`` and ``flash_chunk_bwd``, which run the K5 Pallas
  kernels at chunk granularity).

K1f, K1b, K2f, K2b, K3f, K5f, K5b, K6f, K6f-r, K7f and K7b take attention dropout in
the kernel, keyed as the JAX kernels key it in interpret mode
(``hash_keep_mask``), so the masks are bit-identical. ``fused_qkv_attention``,
``short_cross_attention``, ``flash_causal_attention`` and
``flash_cross_attention`` are the differentiable entries
(``torch.autograd.Function``: forward kernel, backward kernel; the backward
regenerates the mask from the salts). K3f and the decode kernels are forward
only (the model reaches them only in serving), and their CUDA paths raise
under autograd.

Each wrapper takes its plain version for a tensor on the CPU, and only
there. For a CUDA tensor it launches the kernel or raises: there is no
fallback. The sources are compiled with ``nvcc`` for ``sm_90a`` into
``_build/`` at the first CUDA launch (or by ``build_kernels()``), one shared
library with a plain C interface per source, bound with ``ctypes``.

Every call of a wrapper that launches its kernel adds one to the wrapper's
``launches`` attribute, and nothing else does, so a caller can show that a
run went through the kernels (K1b's one call runs ten CUDA launches, K5b's
and K7b's two). K7 counts its causal and full-mask launches apart
(``KERNELS`` names ``flash_chunk_{fwd,bwd}_{causal,full}``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict

import torch

from .layers import _U32, _mul32

SHORT_MIN_SEQ_LEN = 8
SHORT_MAX_SEQ_LEN = 512
FLASH_MIN_SEQ_LEN = 256
FLASH_BLOCK_STEP = 128
FLASH_BLOCK = 512

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
    "short_causal_attention": {
        "tat_short_causal_attention_fwd": [_P] * 4 + [_I] * 4 + [_F, _U, _U, _I, _F, _P],
    },
    "decode_attention": {
        "tat_decode_attention": [_P] * 5 + [_I] * 4 + [_F, _P],
        "tat_decode_attention_packed": [_P] * 5 + [_I] * 5 + [_F, _P],
        "tat_decode_attention_packed_q8": [_P] * 7 + [_I] * 5 + [_F, _P],
    },
    "flash_attention": {
        "tat_flash_attention_fwd": [_P] * 5 + [_I] * 4 + [_F, _U, _U, _I, _F, _I, _P],
        "tat_flash_attention_bwd": [_P] * 9 + [_I] * 4 + [_F, _U, _U, _I, _F, _I, _P],
        "tat_flash_chunk_fwd": [_P] * 5 + [_I] * 6 + [_F, _U, _U, _I, _F, _I, _I, _P],
        "tat_flash_chunk_bwd": [_P] * 9 + [_I] * 6 + [_F, _U, _U, _I, _F, _I, _I, _P],
    },
    "flash_cross_attention": {
        "tat_flash_cross_attention_fwd": [_P] * 4 + [_I] * 5 + [_F, _U, _U, _I, _F, _I, _P],
        "tat_flash_cross_attention_fwd_res": [_P] * 6 + [_I] * 5 + [_F, _U, _U, _I, _F, _I, _P],
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
    """The shapes the whole-row kernels (K1, K2, K3) take, as the JAX
    package's short kernels: 8 <= T <= 512, T % 8 == 0, 0 < hs <= 256."""
    return SHORT_MIN_SEQ_LEN <= t <= SHORT_MAX_SEQ_LEN and t % 8 == 0 and 0 < hs <= 256


def _check_band(what: str, t: int, hs: int) -> None:
    if not in_band(t, hs):
        raise ValueError(
            f"{what}: T={t}, hs={hs} outside the kernel band 8 <= T <= 512, T % 8 == 0, hs <= 256"
        )


def flash_pick_block(t: int, target: int = FLASH_BLOCK) -> int:
    """The JAX flash kernels' block (``_pick_block``): the largest multiple of
    128 <= target dividing t. Their dropout masks are keyed on this grid."""
    b = min(target, t)
    while t % b:
        b -= FLASH_BLOCK_STEP
    return b


def flash_eligible(t: int, hs: int) -> bool:
    """The shapes the flash kernels (K5, K6) take, as the JAX package's
    ``flash_attention_eligible`` / ``flash_cross_eligible``: T >= 256,
    T % 128 == 0, 0 < hs <= 256."""
    return t >= FLASH_MIN_SEQ_LEN and t % FLASH_BLOCK_STEP == 0 and 0 < hs <= 256


def _check_flash(what: str, t: int, hs: int) -> None:
    if not flash_eligible(t, hs):
        raise ValueError(f"{what}: T={t}, hs={hs} outside the flash kernels' shapes "
                         "T >= 256, T % 128 == 0, hs <= 256")


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


def _salts(dropout_salts):
    """The salts as a tuple of ints (what the autograd Functions keep)."""
    return None if dropout_salts is None else tuple(int(s) for s in dropout_salts)


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


def _collapsed_rows(q) -> torch.Tensor:
    """(..., 1, 1) index of each collapsed row of q's leading axes."""
    lead = q.shape[:-2]
    return torch.arange(q[..., 0, 0].numel(), device=q.device).reshape(*lead, 1, 1)


def _cross_mask(q, J: int, rate: float, salts):
    """(J, ..., T, T) keep-mask of the cross kernel, or None: stream j keyed
    by its stream seed, rows by the collapsed query row."""
    if rate == 0.0:
        return None
    shape = (*q.shape[:-2], q.shape[-2], q.shape[-2])
    rows, seed = _collapsed_rows(q), seed_from_salts(salts)
    return torch.stack([
        hash_keep_mask(stream_seed(seed, j), rows, 0, 0, shape, rate, q.device)
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


def causal_mask(q, rate: float, salts):
    """(..., T, T) keep-mask of the self-attention kernel, or None: keyed by
    the seed itself (no stream offset) and the collapsed row, as
    ``_short_keep_mask`` keys it in interpret mode."""
    if rate == 0.0:
        return None
    shape = (*q.shape[:-2], q.shape[-2], q.shape[-2])
    return hash_keep_mask(seed_from_salts(salts), _collapsed_rows(q), 0, 0, shape, rate, q.device)


def short_causal_attention_plain(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """Plain PyTorch version of the self-attention kernel (same arguments)."""
    rate = float(dropout_rate)
    return _whole_row_attention(q, k, v, causal_mask(q, rate, dropout_salts), rate).to(q.dtype)


# Flash: q, k, v (n, T, hs), the leading axes collapsed into rows n. The plain
# versions walk the JAX kernels' block grid (bq = bk = flash_pick_block(T)):
# an online max and sum per key block, the keep-mask on the unnormalised p
# while l sums unmasked, p rounded to v's type before P.V, out = acc / (l * (1 -
# rate)) and lse = m + log l; the backward recomputes p = exp(s - lse) per
# block pair with delta = rowsum(dO * out), masks and divides dp and p by
# 1 - rate, rounds ds (and the dropped p) to the input type before the
# products, accumulates dq in f32 and rounds it last. Element (r, c) of block
# (iq, jk) of row n is kept by the hash of (seed, n, iq, jk, r, c).


def _flash_seed(rate: float, salts, stream) -> int:
    """The u32 seed of a flash launch: 0 without dropout, else the salts'
    seed, offset for cross stream ``stream`` when it is given."""
    if rate == 0.0:
        return 0
    seed = seed_from_salts(salts)
    return (seed if stream is None else stream_seed(seed, stream)) & _U32


def _flash_keep(seed: int, n: int, iq: int, jk: int, bq: int, bk: int, rate: float, device):
    """(n, bq, bk) keep-mask of block (iq, jk) of every collapsed row."""
    rows = torch.arange(n, device=device).reshape(n, 1, 1)
    return hash_keep_mask(seed, rows, iq, jk, (n, bq, bk), rate, device)


def _hidden(causal: bool, iq: int, bq: int, jk: int, bk: int, device):
    """(bq, bk) mask of the scores of block (iq, jk) that the top-left causal
    mask hides (key column > query row), or None without the mask."""
    if not causal:
        return None
    rows = iq * bq + torch.arange(bq, device=device)[:, None]
    return jk * bk + torch.arange(bk, device=device)[None, :] > rows


def _flash_fwd_plain(q, k, v, seed: int, rate: float, causal: bool = True):
    """``_flash_fwd_kernel``'s arithmetic: q (n, t_q, hs), k, v (n, t_k, hs)
    on JAX's blocks bq = pick(t_q), bk = pick(t_k), the causal mask or none
    -> (out in q's type, lse (n, 1, t_q))."""
    acc = _acc(q.dtype)
    n, tq, hs = q.shape
    tk = k.shape[1]
    bq, bk = flash_pick_block(tq), flash_pick_block(tk)
    scale = hs ** -0.5
    outs, lses = [], []
    for iq in range(tq // bq):
        qb = q[:, iq * bq:(iq + 1) * bq].to(acc)
        m = torch.full((n, bq, 1), float("-inf"), dtype=acc, device=q.device)
        l = torch.zeros((n, bq, 1), dtype=acc, device=q.device)
        o = torch.zeros((n, bq, hs), dtype=acc, device=q.device)
        n_kv = min((iq * bq + bq + bk - 1) // bk, tk // bk) if causal else tk // bk
        for jk in range(n_kv):
            kb, vb = k[:, jk * bk:(jk + 1) * bk], v[:, jk * bk:(jk + 1) * bk]
            s = torch.matmul(qb, kb.to(acc).transpose(-1, -2)) * scale
            hidden = _hidden(causal, iq, bq, jk, bk, q.device)
            if hidden is not None:
                s = s.masked_fill(hidden, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            if rate > 0.0:
                keep = _flash_keep(seed, n, iq, jk, bq, bk, rate, q.device)
                p = torch.where(keep, p, torch.zeros((), dtype=acc, device=q.device))
            o = o * corr + torch.matmul(p.to(v.dtype).to(acc), vb.to(acc))
            m = m_new
        outs.append((o / (l * (1.0 - rate))).to(q.dtype))
        lses.append((m + torch.log(l))[..., 0].to(torch.float32))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)[:, None, :]


def _flash_bwd_plain(q, k, v, out, lse, dout, seed: int, rate: float, causal: bool = True):
    """``_flash_bwd_fused_kernel``'s arithmetic on JAX's blocks: dq, dk, dv
    in the inputs' types, from lse (n, 1, t_q), whatever logsumexp it is."""
    acc = _acc(q.dtype)
    zero = torch.zeros((), dtype=acc, device=q.device)
    n, tq, hs = q.shape
    tk = k.shape[1]
    bq, bk = flash_pick_block(tq), flash_pick_block(tk)
    scale = hs ** -0.5
    delta = (dout.to(acc) * out.to(acc)).sum(dim=-1, keepdim=True)  # (n, t_q, 1)
    lse_c = lse.reshape(n, tq, 1).to(acc)
    dq = torch.zeros((n, tq, hs), dtype=acc, device=q.device)
    dks, dvs = [], []
    for jk in range(tk // bk):
        kb = k[:, jk * bk:(jk + 1) * bk].to(acc)
        vb = v[:, jk * bk:(jk + 1) * bk].to(acc)
        dk = torch.zeros((n, bk, hs), dtype=acc, device=q.device)
        dv = torch.zeros((n, bk, hs), dtype=acc, device=q.device)
        for iq in range((jk * bk) // bq if causal else 0, tq // bq):
            sl = slice(iq * bq, (iq + 1) * bq)
            qb, gb = q[:, sl].to(acc), dout[:, sl].to(acc)
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            p = torch.exp(s - lse_c[:, sl])
            hidden = _hidden(causal, iq, bq, jk, bk, q.device)
            if hidden is not None:
                p = torch.where(hidden, zero, p)
            dp = torch.matmul(gb, vb.transpose(-1, -2))
            pd = p
            if rate > 0.0:
                keep = _flash_keep(seed, n, iq, jk, bq, bk, rate, q.device)
                pd = torch.where(keep, p / (1.0 - rate), zero)
                dp = torch.where(keep, dp / (1.0 - rate), zero)
            dv = dv + torch.matmul(pd.to(dout.dtype).to(acc).transpose(-1, -2), gb)
            ds = (p * (dp - delta[:, sl])).to(q.dtype).to(acc)
            dk = dk + torch.matmul(ds.transpose(-1, -2), qb) * scale
            dq[:, sl] += torch.matmul(ds, kb) * scale
        dks.append(dk.to(k.dtype))
        dvs.append(dv.to(v.dtype))
    return dq.to(q.dtype), torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def flash_attention_plain(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """Plain PyTorch version of the flash forward kernel (K5f): q, k, v
    (n, T, hs) -> (out (n, T, hs) in q's type, lse (n, 1, T) f32)."""
    rate = float(dropout_rate)
    return _flash_fwd_plain(q, k, v, _flash_seed(rate, dropout_salts, None), rate)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, dropout_rate: float = 0.0,
                              dropout_salts=None, stream=None):
    """Plain PyTorch version of the flash backward kernel (K5b, the math of
    ``_flash_bwd_fused_kernel``): dq, dk, dv in the inputs' type. ``stream``
    offsets the dropout seed as cross stream ``stream`` (the cross backward)."""
    rate = float(dropout_rate)
    return _flash_bwd_plain(q, k, v, out, lse, dout, _flash_seed(rate, dropout_salts, stream),
                            rate)


def flash_cross_attention_plain(q, k, v, dropout_rate: float = 0.0, dropout_salts=None,
                                residuals: bool = False):
    """Plain PyTorch version of the flash cross forward kernels (K6f, and with
    ``residuals`` K6f-r): q (n, T, hs), k, v (J, n, T, hs). Stream j runs the
    flash forward with its stream seed, its output is rounded to q's type and
    the streams are summed in q's type in stream order. Returns the sum, or
    (sum, outs (J, n, T, hs), lses (J, n, 1, T))."""
    rate = float(dropout_rate)
    total, outs, lses = None, [], []
    for j in range(k.shape[0]):
        o, lse = _flash_fwd_plain(q, k[j], v[j], _flash_seed(rate, dropout_salts, j), rate)
        total = o if total is None else total + o
        outs.append(o)
        lses.append(lse)
    return (total, torch.stack(outs), torch.stack(lses)) if residuals else total


def flash_chunk_eligible(t_q: int, t_k: int, hs: int) -> bool:
    """The chunk shapes K7 takes, as the JAX package's ``flash_chunk_eligible``:
    t_q and t_k multiples of 128, hs <= 256 (the caller adds its own floor on
    the chunk length)."""
    return t_q % FLASH_BLOCK_STEP == 0 and t_k % FLASH_BLOCK_STEP == 0 and 0 < hs <= 256


def _chunk_seed(seed, rate: float) -> int:
    """The u32 seed of a chunk launch from the chunk pair's int32 seed."""
    if rate == 0.0:
        return 0
    if seed is None:
        raise ValueError("flash_chunk: dropout rate > 0 requires the chunk pair's seed")
    return int(seed) & _U32


def _collapse(x):
    """(..., t, hs) -> (n, t, hs) contiguous, and the leading shape."""
    return x.reshape(-1, *x.shape[-2:]).contiguous(), x.shape[:-2]


def flash_chunk_fwd_plain(q, k, v, causal: bool, seed=None, rate: float = 0.0):
    """Plain PyTorch version of the chunk forward kernel (K7f): q
    (..., t_q, hs), k, v (..., t_k, hs), the top-left causal mask or none,
    dropout keyed by the chunk pair's int32 ``seed`` on JAX's blocks of t_q
    and t_k -> (out (..., t_q, hs) in q's type, lse (..., t_q) f32)."""
    rate = float(rate)
    (q3, lead), (k3, _), (v3, _) = _collapse(q), _collapse(k), _collapse(v)
    out, lse = _flash_fwd_plain(q3, k3, v3, _chunk_seed(seed, rate), rate, causal)
    return out.reshape(q.shape), lse.reshape(*lead, q.shape[-2])


def flash_chunk_bwd_plain(q, k, v, out, lse, dout, causal: bool, seed=None, rate: float = 0.0):
    """Plain PyTorch version of the chunk backward kernel (K7b): dq, dk, dv
    in the inputs' types from the output and logsumexp ``lse`` (..., t_q)
    merged over the ring (delta = rowsum(dout * out) of that output)."""
    rate = float(rate)
    (q3, _), (k3, _), (v3, _) = _collapse(q), _collapse(k), _collapse(v)
    o3, g3 = _collapse(out)[0], _collapse(dout)[0]
    lse3 = lse.reshape(q3.shape[0], 1, q3.shape[1])
    dq, dk, dv = _flash_bwd_plain(q3, k3, v3, o3, lse3, g3, _chunk_seed(seed, rate), rate, causal)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


# Decode: one query position (..., 1, hs) against a cache (..., S, hs) whose
# column c is visible iff c <= pos. A packed cache (..., S/pack, pack*hs) is
# the row-major view of (..., S, hs): position c at row c // pack, lane block
# c % pack.

INV127 = 1.0 / 127.0


def unpack_cache(c: torch.Tensor, hs: int) -> torch.Tensor:
    """(..., S/pack, pack*hs) -> the (..., S, hs) view of the same bytes."""
    return c.reshape(*c.shape[:-2], c.shape[-2] * (c.shape[-1] // hs), hs)


def _decode_scores(q, k, pos):
    """Scores q k^T * hs^-0.5 in f32 (f64 for f64) of (..., 1, hs) against
    (..., S, hs), and the visible columns; pos is an int or a one-element
    tensor."""
    acc = _acc(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * q.shape[-1] ** -0.5
    visible = torch.arange(k.shape[-2], device=q.device) <= pos
    return s, visible


def _row_scales(scale, pack: int):
    """(..., S/pack) per-row int8 scales -> (..., 1, S) per-position factors
    scale / 127 in f32."""
    return (scale.float() * INV127).repeat_interleave(pack, dim=-1)[..., None, :]


def decode_attention_plain(q, k, v, pos):
    """Plain PyTorch version of the plain-layout decode kernel (``_decode_
    kernel``): w = p / sum(p) rounded to v's type before P.V."""
    acc = _acc(q.dtype)
    s, visible = _decode_scores(q, k, pos)
    p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
    return torch.matmul(p.to(v.dtype).to(acc), v.to(acc)).to(q.dtype)


def decode_attention_packed_plain(q, kp, vp, pos):
    """Plain PyTorch version of the packed decode kernel (``_decode_p_kernel``):
    one max over all positions, the unnormalised p rounded to v's type before
    P.V, the sum divided by l."""
    acc, hs = _acc(q.dtype), q.shape[-1]
    k, v = unpack_cache(kp, hs), unpack_cache(vp, hs)
    s, visible = _decode_scores(q, k, pos)
    s = s.masked_fill(~visible, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(v.dtype).to(acc), v.to(acc))
    return (o / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def decode_attention_packed_q8_plain(q, kp, vp, k_scale, v_scale, pos):
    """Plain PyTorch version of the int8 packed decode kernel
    (``_decode_p8_kernel``): s = (q.k * hs^-0.5) * k_scale / 127; p * v_scale
    / 127 rounded to q's type before P.V; the sum divided by l."""
    acc, hs = _acc(q.dtype), q.shape[-1]
    pack = kp.shape[-1] // hs
    k, v = unpack_cache(kp, hs).to(q.dtype), unpack_cache(vp, hs).to(q.dtype)
    s, visible = _decode_scores(q, k, pos)
    s = (s * _row_scales(k_scale, pack)).masked_fill(~visible, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = (p * _row_scales(v_scale, pack)).to(q.dtype).to(acc)
    return (torch.matmul(w, v.to(acc)) / p.sum(dim=-1, keepdim=True)).to(q.dtype)


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
    return FusedQKVAttention.apply(x, w1, b1, w2, n_head, float(dropout_rate),
                                   _salts(dropout_salts))


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
    return ShortCrossAttention.apply(q, k, v, float(dropout_rate), _salts(dropout_salts))


def short_cross_attention_t(q, kT, vT, dropout_rate: float = 0.0, dropout_salts=None):
    """``short_cross_attention`` with k and v given transposed, (J, ..., hs, T),
    the JAX entry's contract. The kernels take (J, ..., T, hs), so they are
    transposed here first (and the gradients back)."""
    if kT.shape != vT.shape or kT.shape[1:] != (*q.shape[:-2], q.shape[-1], q.shape[-2]):
        raise ValueError(f"transposed kv shape mismatch: {tuple(kT.shape)} vs q {tuple(q.shape)}")
    k = kT.transpose(-1, -2).contiguous()
    v = vT.transpose(-1, -2).contiguous()
    return short_cross_attention(q, k, v, dropout_rate, dropout_salts)


def _check_no_grad(what: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel is forward only (no backward kernel)")


def short_causal_attention(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """Whole-row causal self-attention (K3f), forward only. q, k, v:
    (..., T, hs), one type, bf16 or f32; the leading axes collapse into rows.
    The plain version for CPU tensors, the CUDA kernel for CUDA tensors in the
    band. Returns (..., T, hs) in q's type."""
    what = "short_causal_attention"
    if q.ndim < 2 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one shape (..., T, hs); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    seed, thresh, on, keepf, _ = _dropout_args(what, dropout_rate, dropout_salts)
    if _on_cpu(q, k, v):
        return short_causal_attention_plain(q, k, v, dropout_rate, dropout_salts)
    _check_cuda_operands(what, (q, k, v))
    _check_no_grad(what, q, k, v)
    T, hs = q.shape[-2], q.shape[-1]
    _check_band(what, T, hs)
    out = torch.empty_like(q)
    err = _fn("short_causal_attention", "tat_short_causal_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.numel() // (T * hs), T, hs, int(q.dtype == torch.bfloat16), hs ** -0.5,
        seed, thresh, on, keepf, _stream(),
    )
    _check_launch(err, what)
    short_causal_attention.launches += 1
    return out


short_causal_attention.launches = 0


def _check_decode_shapes(what, q, k, v, hs_mult: bool):
    """q (..., 1, hs); k, v one shape (..., rows, width) with q's leading
    axes; width == hs (plain) or a multiple of hs (packed)."""
    hs = q.shape[-1]
    if (q.ndim < 3 or q.shape[-2] != 1 or k.shape != v.shape or k.ndim != q.ndim
            or k.shape[:-2] != q.shape[:-2]
            or (k.shape[-1] % hs if hs_mult else k.shape[-1] != hs)):
        raise ValueError(f"{what}: expected q (..., 1, hs) and k, v (..., S, "
                         f"{'pack*hs' if hs_mult else 'hs'}); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _pos_tensor(what: str, pos, device) -> torch.Tensor:
    """pos as the kernels read it: a one-element int32 tensor on the device.
    An int becomes one (a fill on the card, no host-to-device copy)."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((1,), int(pos), dtype=torch.int32, device=device)
    if pos.numel() != 1 or pos.dtype != torch.int32 or pos.device != device:
        raise ValueError(f"{what}: pos must be an int or a one-element int32 tensor on {device}")
    return pos.reshape(1)


def _decode_launch(what: str, fn_name: str, q, k, v, pos, scales=(), pack=()):
    """Launch a decode kernel; scales are the q8 kernel's k_scale and v_scale,
    pack the packed kernels' positions per row."""
    hs = q.shape[-1]
    out = torch.empty_like(q)
    pos_t = _pos_tensor(what, pos, q.device)
    err = _fn("decode_attention", fn_name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in scales),
        pos_t.data_ptr(), out.data_ptr(), q.numel() // hs, k.shape[-2] * (k.shape[-1] // hs),
        hs, *pack, int(q.dtype == torch.bfloat16), hs ** -0.5, _stream(),
    )
    _check_launch(err, what)
    return out


def decode_attention(q, k, v, pos):
    """Cached-decode attention over a plain (..., S, hs) cache (K8): q
    (..., 1, hs), columns c <= pos visible; pos an int or a one-element int32
    tensor on q's device, which the kernel reads on the card. Returns
    (..., 1, hs) in q's type."""
    what = "decode_attention"
    _check_decode_shapes(what, q, k, v, hs_mult=False)
    if _on_cpu(q, k, v):
        return decode_attention_plain(q, k, v, pos)
    _check_cuda_operands(what, (q, k, v))
    _check_no_grad(what, q, k, v)
    out = _decode_launch(what, "tat_decode_attention", q, k, v, pos)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_packed(q, kp, vp, pos):
    """Cached-decode attention over a packed (..., S/pack, pack*hs) cache
    (K8p); otherwise as ``decode_attention``."""
    what = "decode_attention_packed"
    _check_decode_shapes(what, q, kp, vp, hs_mult=True)
    if _on_cpu(q, kp, vp):
        return decode_attention_packed_plain(q, kp, vp, pos)
    _check_cuda_operands(what, (q, kp, vp))
    _check_no_grad(what, q, kp, vp)
    out = _decode_launch(what, "tat_decode_attention_packed", q, kp, vp, pos,
                         pack=(kp.shape[-1] // q.shape[-1],))
    decode_attention_packed.launches += 1
    return out


decode_attention_packed.launches = 0


def decode_attention_packed_q8(q, kp, vp, k_scale, v_scale, pos):
    """Cached-decode attention over a packed int8 cache with one f32 scale per
    packed row, k_scale and v_scale (..., S/pack) (K8q); q bf16 or f32;
    otherwise as ``decode_attention_packed``."""
    what = "decode_attention_packed_q8"
    _check_decode_shapes(what, q, kp, vp, hs_mult=True)
    if (kp.dtype != torch.int8 or vp.dtype != torch.int8 or k_scale.shape != kp.shape[:-1]
            or v_scale.shape != kp.shape[:-1]):
        raise ValueError(f"{what}: expected int8 k, v and scales of shape {tuple(kp.shape[:-1])}")
    if _on_cpu(q, kp, vp, k_scale, v_scale):
        return decode_attention_packed_q8_plain(q, kp, vp, k_scale, v_scale, pos)
    _check_cuda_operands(what, (q,), (k_scale, v_scale))
    if not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")
    _check_no_grad(what, q)
    out = _decode_launch(what, "tat_decode_attention_packed_q8", q, kp, vp, pos,
                         scales=(k_scale, v_scale), pack=(kp.shape[-1] // q.shape[-1],))
    decode_attention_packed_q8.launches += 1
    return out


decode_attention_packed_q8.launches = 0


def _check_flash_operands(what, q, k, v, cross: bool = False):
    """q (n, T, hs); k, v (n, T, hs), or (J, n, T, hs) for the cross kernels."""
    if q.ndim != 3 or k.shape != v.shape or k.shape[int(cross):] != q.shape or k.ndim != 3 + cross:
        raise ValueError(f"{what}: expected q (n, T, hs) and k, v "
                         f"{'(J, n, T, hs)' if cross else '(n, T, hs)'}; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _flash_launch_args(q, rate: float, salts, stream=None):
    """(n, T, hs, is_bf16, scale, seed, thresh, on, keepf, JAX block) of a
    flash launch."""
    n, t, hs = q.shape
    _, thresh, on, keepf, _ = _dropout_args("flash", rate, salts)
    return (n, t, hs, int(q.dtype == torch.bfloat16), hs ** -0.5,
            _flash_seed(float(rate), salts, stream), thresh, on, keepf, flash_pick_block(t))


def flash_attention_fwd(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """The flash forward kernel (K5f): q, k, v (n, T, hs), one type, bf16 or
    f32 -> (out (n, T, hs) in q's type, lse (n, 1, T) f32). The plain version
    for CPU tensors, the CUDA kernel for CUDA tensors with T % 128 == 0,
    T >= 256, hs <= 256."""
    what = "flash_attention"
    _check_flash_operands(what, q, k, v)
    _dropout_args(what, dropout_rate, dropout_salts)
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, dropout_rate, dropout_salts)
    _check_cuda_operands(what, (q, k, v))
    n, t, hs = q.shape
    _check_flash(what, t, hs)
    out = torch.empty_like(q)
    lse = torch.empty((n, 1, t), dtype=torch.float32, device=q.device)
    err = _fn("flash_attention", "tat_flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *_flash_launch_args(q, dropout_rate, dropout_salts), _stream(),
    )
    _check_launch(err, what)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, dropout_rate: float = 0.0,
                        dropout_salts=None, stream=None):
    """The flash backward kernel (K5b): dq, dk, dv in the inputs' type from
    the forward's out and lse and the output gradient dout. delta =
    rowsum(dout * out) is one PyTorch reduction before the launch, as the JAX
    package computes it outside its kernel. ``stream`` keys the dropout as
    cross stream ``stream`` (the cross backward, one launch per stream)."""
    what = "flash_attention_bwd"
    _check_flash_operands(what, q, k, v)
    n, t, hs = q.shape
    if out.shape != q.shape or dout.shape != q.shape or tuple(lse.shape) != (n, 1, t):
        raise ValueError(f"{what}: out and dout must be {tuple(q.shape)}, lse {(n, 1, t)}")
    _dropout_args(what, dropout_rate, dropout_salts)
    if _on_cpu(q, k, v, out, lse, dout):
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, dropout_rate, dropout_salts,
                                         stream)
    _check_cuda_operands(what, (q, k, v, out, dout), (lse,))
    _check_flash(what, t, hs)
    delta = (dout.float() * out.float()).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _fn("flash_attention", "tat_flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_flash_launch_args(q, dropout_rate, dropout_salts, stream), _stream(),
    )
    _check_launch(err, what)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashCausalAttention(torch.autograd.Function):
    """K5f forward, K5b backward; gradients for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_rate, dropout_salts):
        out, lse = flash_attention_fwd(q, k, v, dropout_rate, dropout_salts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (dropout_rate, dropout_salts)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None


def flash_causal_attention(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """Blockwise causal self-attention over trailing (T, hs), differentiable,
    the JAX entry ``flash_causal_attention``: the leading axes collapse into
    rows, whose index keys the dropout. q, k, v: one shape and type, bf16 or
    f32. Returns (..., T, hs) in q's type."""
    if q.ndim < 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_causal_attention: q, k, v must share one shape (..., T, hs); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    t, hs = q.shape[-2:]
    q3, k3, v3 = (x.reshape(-1, t, hs).contiguous() for x in (q, k, v))
    out = FlashCausalAttention.apply(q3, k3, v3, float(dropout_rate), _salts(dropout_salts))
    return out.reshape(q.shape)


def flash_cross_attention_fwd(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """The flash cross forward kernel (K6f): q (n, T, hs), k, v (J, n, T, hs)
    -> the sum over streams (n, T, hs) in q's type."""
    what = "flash_cross_attention"
    _check_flash_operands(what, q, k, v, cross=True)
    _dropout_args(what, dropout_rate, dropout_salts)
    if _on_cpu(q, k, v):
        return flash_cross_attention_plain(q, k, v, dropout_rate, dropout_salts)
    _check_cuda_operands(what, (q, k, v))
    _check_flash(what, q.shape[1], q.shape[2])
    out = torch.empty_like(q)
    err = _fn("flash_cross_attention", "tat_flash_cross_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), k.shape[0],
        *_flash_launch_args(q, dropout_rate, dropout_salts), _stream(),
    )
    _check_launch(err, what)
    flash_cross_attention_fwd.launches += 1
    return out


flash_cross_attention_fwd.launches = 0


def flash_cross_attention_res(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """The flash cross forward kernel with residuals (K6f-r): the sum, and
    each stream's output (J, n, T, hs) in q's type and logsumexp
    (J, n, 1, T) f32, which the backward reads."""
    what = "flash_cross_attention_res"
    _check_flash_operands(what, q, k, v, cross=True)
    _dropout_args(what, dropout_rate, dropout_salts)
    if _on_cpu(q, k, v):
        return flash_cross_attention_plain(q, k, v, dropout_rate, dropout_salts, residuals=True)
    _check_cuda_operands(what, (q, k, v))
    n, t, hs = q.shape
    _check_flash(what, t, hs)
    out, outs = torch.empty_like(q), torch.empty_like(k)
    lses = torch.empty((k.shape[0], n, 1, t), dtype=torch.float32, device=q.device)
    err = _fn("flash_cross_attention", "tat_flash_cross_attention_fwd_res")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), outs.data_ptr(),
        lses.data_ptr(), k.shape[0],
        *_flash_launch_args(q, dropout_rate, dropout_salts), _stream(),
    )
    _check_launch(err, what)
    flash_cross_attention_res.launches += 1
    return out, outs, lses


flash_cross_attention_res.launches = 0


class FlashCrossAttention(torch.autograd.Function):
    """K6f-r forward; per stream j a K5b launch on (q, k_j, v_j, out_j,
    lse_j, dout) keyed by stream j's seed, dq summed over the streams in q's
    type in stream order (the JAX package's ``_flash_cross_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_rate, dropout_salts):
        out, outs, lses = flash_cross_attention_res(q, k, v, dropout_rate, dropout_salts)
        ctx.save_for_backward(q, k, v, outs, lses)
        ctx.args = (dropout_rate, dropout_salts)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, outs, lses = ctx.saved_tensors
        dout = dout.contiguous()
        dq = torch.zeros_like(q)
        dks, dvs = [], []
        for j in range(k.shape[0]):
            dq_j, dk_j, dv_j = flash_attention_bwd(q, k[j], v[j], outs[j], lses[j], dout,
                                                   *ctx.args, stream=j)
            dq = dq + dq_j
            dks.append(dk_j)
            dvs.append(dv_j)
        return dq, torch.stack(dks), torch.stack(dvs), None, None


def flash_cross_attention(q, k, v, dropout_rate: float = 0.0, dropout_salts=None):
    """Sum over J key/value streams of blockwise causal attention, the JAX
    entry ``flash_cross_attention``: q (..., T, hs), k, v (J, ..., T, hs),
    the leading axes of q collapsed into the rows that key the dropout.
    Differentiable (K6f-r forward, K5b per stream backward); where no input
    needs a gradient the forward is K6f. Returns (..., T, hs) in q's type."""
    _check_cross_shapes("flash_cross_attention", q, k, v)
    t, hs = q.shape[-2:]
    q3 = q.reshape(-1, t, hs).contiguous()
    k4, v4 = (x.reshape(k.shape[0], -1, t, hs).contiguous() for x in (k, v))
    rate, salts = float(dropout_rate), _salts(dropout_salts)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out = FlashCrossAttention.apply(q3, k4, v4, rate, salts)
    else:
        out = flash_cross_attention_fwd(q3, k4, v4, rate, salts)
    return out.reshape(q.shape)


# K7's launch counts, its causal and full-mask kernels apart
CHUNK_LAUNCHES = {(name, causal): SimpleNamespace(launches=0)
                  for name in ("fwd", "bwd") for causal in (True, False)}


def _check_chunk(what, q, k, v, rate: float, seed, acts=(), f32=()):
    """Checks a chunk call; True where it takes the plain version (CPU)."""
    if (q.ndim < 2 or k.shape != v.shape or k.shape[:-2] != q.shape[:-2]
            or k.shape[-1] != q.shape[-1]):
        raise ValueError(f"{what}: expected q (..., t_q, hs) and k, v (..., t_k, hs) with the "
                         f"same leading axes; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not 0.0 <= float(rate) < 1.0:
        raise ValueError(f"{what}: dropout rate must be in [0, 1), got {rate}")
    _chunk_seed(seed, float(rate))
    if _on_cpu(q, k, v, *acts, *f32):
        return True
    _check_cuda_operands(what, (q, k, v, *acts), f32)
    t_q, t_k, hs = q.shape[-2], k.shape[-2], q.shape[-1]
    if not flash_chunk_eligible(t_q, t_k, hs):
        raise ValueError(f"{what}: t_q={t_q}, t_k={t_k}, hs={hs} outside the chunk kernels' "
                         "shapes t_q % 128 == 0, t_k % 128 == 0, hs <= 256")
    return False


def _chunk_launch_args(q, k, causal: bool, seed, rate: float):
    """(n, t_q, t_k, hs, causal, is_bf16, scale, seed, thresh, on, keepf, bq,
    bk) of a chunk launch."""
    *_, t_q, hs = q.shape
    t_k = k.shape[-2]
    rate = float(rate)
    on = int(rate > 0.0)
    return (q.numel() // (t_q * hs), t_q, t_k, hs, int(bool(causal)),
            int(q.dtype == torch.bfloat16), hs ** -0.5, _chunk_seed(seed, rate),
            keep_threshold(rate) if on else 0, on, 1.0 - rate,
            flash_pick_block(t_q), flash_pick_block(t_k))


def flash_chunk_fwd(q, k, v, causal: bool, seed=None, rate: float = 0.0):
    """The chunk forward kernel (K7f): q (..., t_q, hs), k, v (..., t_k, hs),
    one type, bf16 or f32; ``causal``: the top-left causal mask (the diagonal
    chunk of a ring), else every key; ``seed``: the chunk pair's int32
    dropout seed. Returns (out (..., t_q, hs) in q's type, lse (..., t_q)
    f32). The plain version for CPU tensors, the CUDA kernel for CUDA tensors
    with t_q % 128 == 0, t_k % 128 == 0, hs <= 256."""
    what = "flash_chunk_fwd"
    if _check_chunk(what, q, k, v, rate, seed):
        return flash_chunk_fwd_plain(q, k, v, causal, seed, rate)
    (q3, lead), (k3, _), (v3, _) = _collapse(q), _collapse(k), _collapse(v)
    out = torch.empty_like(q3)
    lse = torch.empty((q3.shape[0], 1, q3.shape[1]), dtype=torch.float32, device=q.device)
    err = _fn("flash_attention", "tat_flash_chunk_fwd")(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *_chunk_launch_args(q3, k3, causal, seed, rate), _stream(),
    )
    _check_launch(err, what)
    CHUNK_LAUNCHES["fwd", bool(causal)].launches += 1
    return out.reshape(q.shape), lse.reshape(*lead, q.shape[-2])


def flash_chunk_bwd(q, k, v, out, lse, dout, causal: bool, seed=None, rate: float = 0.0):
    """The chunk backward kernel (K7b): dq (..., t_q, hs), dk, dv
    (..., t_k, hs) in the inputs' type, from the output ``out`` and
    logsumexp ``lse`` (..., t_q) merged over the whole ring and the output
    gradient ``dout``; mask and dropout as the forward's. delta =
    rowsum(dout * out) is one PyTorch reduction before the launch. Two runs
    give the same bits (no atomics)."""
    what = "flash_chunk_bwd"
    if out.shape != q.shape or dout.shape != q.shape or tuple(lse.shape) != tuple(q.shape[:-1]):
        raise ValueError(f"{what}: out and dout must be {tuple(q.shape)}, lse "
                         f"{tuple(q.shape[:-1])}")
    if _check_chunk(what, q, k, v, rate, seed, (out, dout), (lse,)):
        return flash_chunk_bwd_plain(q, k, v, out, lse, dout, causal, seed, rate)
    q3, k3, v3, o3, g3 = (_collapse(x)[0] for x in (q, k, v, out, dout))
    lse3 = lse.reshape(q3.shape[0], 1, q3.shape[1]).contiguous()
    delta = (g3.float() * o3.float()).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q3), torch.empty_like(k3), torch.empty_like(v3)
    err = _fn("flash_attention", "tat_flash_chunk_bwd")(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), g3.data_ptr(), lse3.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_chunk_launch_args(q3, k3, causal, seed, rate), _stream(),
    )
    _check_launch(err, what)
    CHUNK_LAUNCHES["bwd", bool(causal)].launches += 1
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


KERNELS = {
    "fused_qkv_attention": fused_qkv_attention_fwd,
    "fused_qkv_attention_bwd": fused_qkv_attention_bwd,
    "short_cross_attention": short_cross_attention_fwd,
    "short_cross_attention_bwd": short_cross_attention_bwd,
    "short_causal_attention": short_causal_attention,
    "decode_attention": decode_attention,
    "decode_attention_packed": decode_attention_packed,
    "decode_attention_packed_q8": decode_attention_packed_q8,
    "flash_attention": flash_attention_fwd,
    "flash_attention_bwd": flash_attention_bwd,
    "flash_cross_attention": flash_cross_attention_fwd,
    "flash_cross_attention_res": flash_cross_attention_res,
    "flash_chunk_fwd_causal": CHUNK_LAUNCHES["fwd", True],
    "flash_chunk_fwd_full": CHUNK_LAUNCHES["fwd", False],
    "flash_chunk_bwd_causal": CHUNK_LAUNCHES["bwd", True],
    "flash_chunk_bwd_full": CHUNK_LAUNCHES["bwd", False],
}

def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
