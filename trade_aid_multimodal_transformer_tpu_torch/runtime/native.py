"""ctypes bindings for the native (C++) data transforms (port of the JAX
package's ``runtime/native.py``).

``transforms.cpp`` beside this file is the port's own copy of the JAX
package's source; the port never loads the JAX package's library. It is
built at first use with ``g++`` into ``_build/`` (named by a digest of the
source and the flags, written under a temporary name and renamed, so
processes that build at once do not collide) and loaded from there. The
flags leave out ``-march=native``, which the JAX package adds: a library
in a directory that several nodes share must run on each of their CPUs,
and ``-ffp-contract=off`` keeps the compiler from fusing a product and a
sum into one rounding.

Every entry point returns None where the library is not there: no
compiler, a failed build, or ``TAT_DISABLE_NATIVE`` set. Callers then take
the numpy/Python paths of data/transforms.py and data/vocab.py, which are
the semantic ground truth; the native functions reproduce them bit for bit
(tests/test_torch_native.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "transforms.cpp"
_BUILD = _HERE / "_build"
_FLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"libtat_transforms-{digest}.so"


def _build(so: Path) -> bool:
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("TAT_DISABLE_NATIVE"):
            return None
        so = library_path()
        if so.exists() or _build(so):
            try:
                _lib = _bind(ctypes.CDLL(str(so)))
            except OSError:
                _lib = None
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    dp = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.tat_round_decimal.argtypes = [dp, ctypes.c_int64, ctypes.c_int, dp]
    lib.tat_round_decimal.restype = None
    lib.tat_percent_changes.argtypes = [dp, ctypes.c_int64, ctypes.c_int, dp, u8p]
    lib.tat_percent_changes.restype = ctypes.c_int64
    lib.tat_range_numeric.argtypes = [dp, ctypes.c_int64, ctypes.c_int, ctypes.c_int, dp, u8p, u8p]
    lib.tat_range_numeric.restype = None
    lib.tat_bin_assign.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int, i64p]
    lib.tat_bin_assign.restype = None
    lib.tat_factorize.argtypes = [dp, ctypes.c_int64, i32p, dp]
    lib.tat_factorize.restype = ctypes.c_int64
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype=ctypes.c_double):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f64(values) -> np.ndarray:
    return np.ascontiguousarray(values, dtype=np.float64)


def round_decimal(values: np.ndarray, dp: int) -> Optional[np.ndarray]:
    """Correctly rounded decimal rounding (Python's ``round``) of every
    element; None where the library is not there."""
    lib = _load()
    if lib is None:
        return None
    arr = _f64(values)
    out = np.empty_like(arr)
    lib.tat_round_decimal(_ptr(arr), arr.size, dp, _ptr(out))
    return out


def percent_changes(values: np.ndarray, dp: int
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """(changes, zero mask, index of the first zero previous value or -1),
    or None."""
    lib = _load()
    if lib is None:
        return None
    arr = _f64(values)
    out = np.empty_like(arr)
    mask = np.empty(arr.size, dtype=np.uint8)
    first_zero = lib.tat_percent_changes(_ptr(arr), arr.size, dp, _ptr(out),
                                         _ptr(mask, ctypes.c_uint8))
    return out, mask.astype(bool), int(first_zero)


def range_numeric(values: np.ndarray, nwd: int, dp: int
                  ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(values, lower-clip mask, integer upper-clip mask), or None."""
    lib = _load()
    if lib is None:
        return None
    arr = _f64(values)
    out = np.empty_like(arr)
    cl = np.empty(arr.size, dtype=np.uint8)
    cu = np.empty(arr.size, dtype=np.uint8)
    lib.tat_range_numeric(_ptr(arr), arr.size, nwd, dp, _ptr(out), _ptr(cl, ctypes.c_uint8),
                          _ptr(cu, ctypes.c_uint8))
    return out, cl.astype(bool), cu.astype(bool)


def factorize(values: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(int32 sorted-rank codes, sorted unique values) of finite float64
    data, ``np.unique(values, return_inverse=True)``; None where the
    library is not there. NaN-holding inputs take the numpy path."""
    lib = _load()
    if lib is None:
        return None
    arr = _f64(values)
    codes = np.empty(arr.size, dtype=np.int32)
    uniq = np.empty(arr.size, dtype=np.float64)
    u = lib.tat_factorize(_ptr(arr), arr.size, _ptr(codes, ctypes.c_int32), _ptr(uniq))
    return codes, uniq[:u].copy()


def bin_assign(values: np.ndarray, pos_boundaries: np.ndarray) -> Optional[np.ndarray]:
    """int64 bin of every element over the positive boundaries (and their
    mirror), or None."""
    lib = _load()
    if lib is None:
        return None
    arr = _f64(values)
    b = _f64(pos_boundaries)
    out = np.empty(arr.size, dtype=np.int64)
    lib.tat_bin_assign(_ptr(arr), arr.size, _ptr(b), b.size - 1, _ptr(out, ctypes.c_int64))
    return out
