"""Build, binding and launch wrappers of the CUDA DP kernels
(``deepblast_torch/csrc/dp_kernels.cu``).

TPU functions replaced (``deepblast_tpu/ops/``):

* :func:`skew` <- ``skew_bm.py:195`` ``skew_bm`` (via ``dp_bm.skew_input``);
* :func:`forward` <- ``dp_bm.py:1025`` ``decode_stream_bm``, forward phases;
* :func:`forward_score` <- ``dp_bm.py:509`` ``forward_score_bm``;
* :func:`backward` <- ``dp_bm.py:1025`` ``decode_stream_bm``, backward phases.

The source is compiled by ``nvcc`` for ``sm_90a`` at first use into
``deepblast_torch/_build/`` (keyed by the hash of source and flags), as a
shared library with a plain C interface, and loaded with ``ctypes``.
Nothing here is imported or built when the module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` (every slot is written by the kernel),
launches on PyTorch's current stream, raises if the launch reports an
error, and adds one to its entry in :data:`LAUNCHES`.  The plain versions
with the same signatures are in ``ops/dp_ref.py``; the wrappers never fall
back to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from deepblast_torch.ops.dp_ref import MODE_BOUNDS

__all__ = ["LAUNCHES", "reset_launches", "build", "skew", "forward",
           "forward_score", "backward"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_PKG, "csrc", "dp_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_OPS = {"softmax": 0, "sparsemax": 1, "hardmax": 2}

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES = {"skew": 0, "forward": 0, "forward_score": 0, "backward": 0}

_LIB = None
_LOCK = threading.Lock()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA DP kernels are built "
                           "with the CUDA toolkit at first use")
    return cand


def build():
    """Compile the kernels if no library for this source and these flags
    exists yet; returns the path of the shared library."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libdp_kernels-{tag}.so")
    if not os.path.exists(so):
        tmp = f"{so}.tmp{os.getpid()}"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)  # atomic when several processes build at once
    return so


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.dp_skew.argtypes = [p, i, i, i, p, p]
            lib.dp_forward.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                       p, p, p, p]
            lib.dp_backward.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p]
            for fn in (lib.dp_skew, lib.dp_forward, lib.dp_backward):
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _check_f32(name, t, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _check_len(name, t, B, device):
    if t.device != device or t.dtype != torch.int32 or t.shape != (B,) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 ({B},) tensor "
                         f"on {device}")


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"CUDA {what} launch failed: cudaError {rc}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def skew(x):
    """Natural ``(B, N, M)`` float32 -> stream ``(B, K, S)``; every slot is
    written (zeros outside the band)."""
    _check_f32("x", x)
    B, N, M = x.shape
    out = torch.empty((B, N + M - 1, N + 1), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().dp_skew(_ptr(x), B, N, M, _ptr(out), _stream(x.device))
    _raise_on(rc, "skew")
    LAUNCHES["skew"] += 1
    return out


def _forward(th_s, A_s, ln, lm, mode, operator, store):
    _check_f32("th_s", th_s)
    _check_f32("A_s", A_s, th_s.shape)
    B, K, S = th_s.shape
    _check_len("ln", ln, B, th_s.device)
    _check_len("lm", lm, B, th_s.device)
    vt = torch.zeros((B,), dtype=torch.float32, device=th_s.device)
    if store:
        dx = torch.empty_like(th_s)
        dm = torch.empty_like(th_s)
    with torch.cuda.device(th_s.device):
        rc = _lib().dp_forward(
            _ptr(th_s), _ptr(A_s), _ptr(ln), _ptr(lm), B, K, S,
            MODE_BOUNDS[mode][0], _OPS[operator], int(store), _ptr(vt),
            _ptr(dx) if store else None, _ptr(dm) if store else None,
            _stream(th_s.device))
    name = "forward" if store else "forward_score"
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return (vt, dx, dm) if store else vt


def forward(th_s, A_s, ln, lm, *, mode="nw", operator="softmax"):
    """``(vt (B,), Dx, Dm (B, K, S))``: the forward with residual stores."""
    return _forward(th_s, A_s, ln, lm, mode, operator, True)


def forward_score(th_s, A_s, ln, lm, *, mode="nw", operator="softmax"):
    """``vt (B,)``: the score-only forward (no residual stores; each pair's
    walk stops at its terminal diagonal)."""
    return _forward(th_s, A_s, ln, lm, mode, operator, False)


def backward(dxs, dms, ln, lm, Et, *, mode="nw", operator="softmax"):
    """Expected alignment stream ``E (B, K, S)``, seeded with ``Et``."""
    _check_f32("Dx", dxs)
    _check_f32("Dm", dms, dxs.shape)
    B, K, S = dxs.shape
    _check_f32("Et", Et, (B,))
    _check_len("ln", ln, B, dxs.device)
    _check_len("lm", lm, B, dxs.device)
    E = torch.empty_like(dxs)
    with torch.cuda.device(dxs.device):
        rc = _lib().dp_backward(
            _ptr(dxs), _ptr(dms), _ptr(ln), _ptr(lm), _ptr(Et), B, K, S,
            MODE_BOUNDS[mode][1], _OPS[operator], _ptr(E),
            _stream(dxs.device))
    _raise_on(rc, "backward")
    LAUNCHES["backward"] += 1
    return E
