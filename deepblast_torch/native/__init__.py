"""Native (C) traceback walk, compiled at first use with the system C
compiler and loaded with ``ctypes``.

The port's own copy of ``deepblast_tpu/native`` (affine walk only).  The
greedy traceback touches O(n + m) cells per pair; in C it costs
microseconds where the Python walk (``deepblast_torch.ops.dp._traceback_walk``,
kept as the oracle) costs milliseconds.  The library is built into
``deepblast_torch/_build/``, keyed by the hash of the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["build", "traceback_affine"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "ctraceback.c")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = None
_LOCK = threading.Lock()


def build():
    """Compile ``ctraceback.c`` unless this source's library exists;
    returns the path of the shared library."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"ctraceback-{tag}.so")
    if not os.path.exists(so):
        tmp = f"{so}.tmp{os.getpid()}"
        subprocess.run([os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC",
                        "-o", tmp, SOURCE],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic when several processes build at once
    return so


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
            for name, ct in (("traceback_affine_f32", ctypes.c_float),
                             ("traceback_affine_f64", ctypes.c_double)):
                fn = getattr(lib, name)
                fn.restype = i64
                fn.argtypes = [ctypes.POINTER(ct), i64, i64, i64, i64,
                               i32p, i64]
            _LIB = lib
    return _LIB


def traceback_affine(base, si, sj, n, m):
    """C walk over ``cell(i, j) = base[i*si + j*sj]`` for a 1-D contiguous
    float32/float64 ``base``; returns ``[(i, j, state), ...]``."""
    base = np.ascontiguousarray(base)
    if base.ndim != 1:
        raise ValueError("base must be 1-D")
    if n < 1 or m < 1 or (n - 1) * si + (m - 1) * sj >= base.size:
        raise ValueError(f"({n}, {m}) cells at strides ({si}, {sj}) do not "
                         f"fit in {base.size} values")
    lib = _lib()
    if base.dtype == np.float32:
        fn, ct = lib.traceback_affine_f32, ctypes.c_float
    elif base.dtype == np.float64:
        fn, ct = lib.traceback_affine_f64, ctypes.c_double
    else:
        raise TypeError(f"traceback needs float32/float64, got {base.dtype}")
    cap = n + m + 1
    out = np.empty((cap, 3), np.int32)
    cnt = fn(base.ctypes.data_as(ctypes.POINTER(ct)), si, sj, n, m,
             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
    if cnt < 0:
        raise RuntimeError("traceback overflowed its n + m + 1 states")
    return list(map(tuple, out[:cnt].tolist()))
