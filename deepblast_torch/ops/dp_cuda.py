"""Build, binding and launch wrappers of the CUDA DP kernels
(``deepblast_torch/csrc/dp_kernels.cu``).

TPU functions replaced (``deepblast_tpu/ops/``):

* :func:`skew` <- ``skew_bm.py:195`` ``skew_bm`` (via ``dp_bm.skew_input``
  and, for cotangents, ``dp_bm.skew_cotangent``);
* :func:`unskew` <- ``skew_bm.py:321`` ``unskew_bm``;
* :func:`forward` <- ``dp_bm.py:1025`` ``decode_stream_bm``, forward phases;
  ``dp_bm.py:423`` ``forward_bm``; ``dp_bm_train.py:179``
  ``forward_bm_phased``;
* :func:`forward_score` <- ``dp_bm.py:509`` ``forward_score_bm``;
* :func:`backward` <- ``dp_bm.py:1025`` ``decode_stream_bm``, backward phases;
  with ``want_gap`` also ``dp_bm.py:617`` ``backward_bm`` and
  ``dp_bm_train.py:303`` ``backward_bm_phased``;
* :func:`adjoint_forward` <- ``dp_bm.py:709`` ``adjoint_forward_bm``;
  ``dp_bm_train.py:442`` ``adjoint_forward_bm_phased`` (``za=None`` form);
* :func:`adjoint_backward` <- ``dp_bm.py:827`` ``adjoint_backward_bm``;
  ``dp_bm_train.py:595`` ``adjoint_backward_bm_phased``.

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

__all__ = ["LAUNCHES", "reset_launches", "build", "skew", "unskew",
           "forward", "forward_score", "backward", "adjoint_forward",
           "adjoint_backward"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_PKG, "csrc", "dp_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_OPS = {"softmax": 0, "sparsemax": 1, "hardmax": 2}

#: launches of each kernel since the last :func:`reset_launches`
#: (``backward`` counts its launches with and without the gap output)
LAUNCHES = {"skew": 0, "unskew": 0, "forward": 0, "forward_score": 0,
            "backward": 0, "adjoint_forward": 0, "adjoint_backward": 0}

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
            lib.dp_unskew.argtypes = [p, i, i, i, i, i, p, p]
            lib.dp_forward.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                       p, p, p, p]
            lib.dp_backward.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                        p, p, p]
            lib.dp_adjoint_forward.argtypes = [p, p, p, p, p, p, i, i, i,
                                               i, i, p, p, p, p]
            lib.dp_adjoint_backward.argtypes = [p, p, p, p, p, p, p, i, i,
                                                i, i, i, p, p, p]
            for fn in (lib.dp_skew, lib.dp_unskew, lib.dp_forward,
                       lib.dp_backward, lib.dp_adjoint_forward,
                       lib.dp_adjoint_backward):
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


def unskew(s, N, M):
    """Stream ``(B, K, S)`` float32 -> natural ``(B, N, M)``,
    ``out[b, i, j] = s[b, i+j, i+1]``; every natural cell is written."""
    _check_f32("s", s)
    B, K, S = s.shape
    if S != N + 1 or K != N + M - 1:
        raise ValueError(f"stream {tuple(s.shape)} does not hold ({N}, {M})")
    out = torch.empty((B, N, M), dtype=s.dtype, device=s.device)
    with torch.cuda.device(s.device):
        rc = _lib().dp_unskew(_ptr(s), B, K, S, N, M, _ptr(out),
                              _stream(s.device))
    _raise_on(rc, "unskew")
    LAUNCHES["unskew"] += 1
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


def backward(dxs, dms, ln, lm, Et, *, mode="nw", operator="softmax",
             want_gap=False):
    """``(E, EA)``: the expected alignment stream ``E (B, K, S)`` seeded
    with ``Et``, and with ``want_gap`` the gap expectation
    ``EA = E (Qx + Qy)`` (else None)."""
    _check_f32("Dx", dxs)
    _check_f32("Dm", dms, dxs.shape)
    B, K, S = dxs.shape
    _check_f32("Et", Et, (B,))
    _check_len("ln", ln, B, dxs.device)
    _check_len("lm", lm, B, dxs.device)
    E = torch.empty_like(dxs)
    EA = torch.empty_like(dxs) if want_gap else None
    with torch.cuda.device(dxs.device):
        rc = _lib().dp_backward(
            _ptr(dxs), _ptr(dms), _ptr(ln), _ptr(lm), _ptr(Et), B, K, S,
            MODE_BOUNDS[mode][1], _OPS[operator], _ptr(E),
            _ptr(EA) if want_gap else None, _stream(dxs.device))
    _raise_on(rc, "backward")
    LAUNCHES["backward"] += 1
    return E, EA


def adjoint_forward(dxs, dms, zt_s, za_s, ln, lm, *, mode="nw",
                    operator="softmax"):
    """``(vtd (B,), Dxd, Dmd (B, K, S))``: the tangent of the forward along
    the skewed cotangents; ``za_s=None`` launches the kernel without a Za
    stream (a zero gap cotangent)."""
    _check_f32("Dx", dxs)
    _check_f32("Dm", dms, dxs.shape)
    _check_f32("Zt", zt_s, dxs.shape)
    if za_s is not None:
        _check_f32("Za", za_s, dxs.shape)
    B, K, S = dxs.shape
    _check_len("ln", ln, B, dxs.device)
    _check_len("lm", lm, B, dxs.device)
    vtd = torch.zeros((B,), dtype=torch.float32, device=dxs.device)
    dxd = torch.empty_like(dxs)
    dmd = torch.empty_like(dxs)
    with torch.cuda.device(dxs.device):
        rc = _lib().dp_adjoint_forward(
            _ptr(dxs), _ptr(dms), _ptr(zt_s),
            None if za_s is None else _ptr(za_s), _ptr(ln), _ptr(lm),
            B, K, S, MODE_BOUNDS[mode][2], _OPS[operator], _ptr(vtd),
            _ptr(dxd), _ptr(dmd), _stream(dxs.device))
    _raise_on(rc, "adjoint_forward")
    LAUNCHES["adjoint_forward"] += 1
    return vtd, dxd, dmd


def adjoint_backward(dxs, dms, dxds, dmds, E, ln, lm, *, mode="nw",
                     operator="softmax"):
    """``(Ed, EdA)``, both ``(B, K, S)``: the tangent of the backward and
    the fused gap adjoint ``EdA = Ed (Qx + Qy) + E (Qdx + Qdy)``."""
    _check_f32("Dx", dxs)
    for name, t in (("Dm", dms), ("Dxd", dxds), ("Dmd", dmds), ("E", E)):
        _check_f32(name, t, dxs.shape)
    B, K, S = dxs.shape
    _check_len("ln", ln, B, dxs.device)
    _check_len("lm", lm, B, dxs.device)
    Ed = torch.empty_like(dxs)
    EdA = torch.empty_like(dxs)
    with torch.cuda.device(dxs.device):
        rc = _lib().dp_adjoint_backward(
            _ptr(dxs), _ptr(dms), _ptr(dxds), _ptr(dmds), _ptr(E), _ptr(ln),
            _ptr(lm), B, K, S, MODE_BOUNDS[mode][3], _OPS[operator],
            _ptr(Ed), _ptr(EdA), _stream(dxs.device))
    _raise_on(rc, "adjoint_backward")
    LAUNCHES["adjoint_backward"] += 1
    return Ed, EdA
