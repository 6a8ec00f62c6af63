"""Build, binding and launch wrappers of the CUDA DP kernels
(``deepblast_torch/csrc/dp_kernels.cu``).

TPU functions replaced (``deepblast_tpu/ops/``):

* :func:`skew` <- ``skew_bm.py:195`` ``skew_bm`` (via ``dp_bm.skew_input``
  and, for cotangents, ``dp_bm.skew_cotangent``);
* :func:`skew_pair` <- ``skew_bm.py:243`` ``skew_bm_pair`` (via
  ``dp_bm.skew_input_pair`` and ``dp_bm.skew_cotangent_pair``);
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
  ``dp_bm_train.py:595`` ``adjoint_backward_bm_phased``;

and the Q-stream passes of the long-sequence backends (``pallas``,
``pallas_long``), whose relayouts ``skew_pallas.py:95`` ``skew_pallas`` and
``:133`` ``unskew_pallas`` are :func:`skew` and :func:`unskew`:

* :func:`forward_q` <- ``dp_pallas.py:223`` ``forward_pallas``;
* :func:`backward_q` <- ``dp_pallas.py:328`` ``backward_pallas`` (with
  ``want_gap`` also ``_backward_v2``'s ``E (Qx + Qy)``);
* :func:`adjoint_forward_q` <- ``dp_pallas.py:423``
  ``adjoint_forward_pallas``;
* :func:`adjoint_backward_q` <- ``dp_pallas.py:548``
  ``adjoint_backward_pallas`` (with ``_adjoint_backward_v2``'s ``EdA``).

The source is compiled by ``nvcc`` for ``sm_90a`` at first use into
``deepblast_torch/_build/`` (keyed by the hash of source and flags), as a
shared library with a plain C interface, and loaded with ``ctypes``.
Nothing here is imported or built when the module is imported.

The default backend's wrappers and the relayouts take the storage menu of
``ops/menu.py`` (``dtypes=``; the skew's ``out_dtype`` / ``quant_scale``)
and launch the kernel instance of those storage types.  Each stream must
have the type the menu gives it: a stream of another type raises, nothing
is cast.  The Q-stream wrappers take no menu; :func:`forward_q` stores the
three Q streams in ``q_dtype`` (float32 or bfloat16, the counterpart of
``dp_pallas.Q_DTYPE``), and the other three read Q streams of either type,
one type for all three, and launch that instance (counted apart:
``LAUNCHES["forward_q_bf16"]``, ...).  Every other stream of a Q pass is
float32.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` (every slot is written by the kernel),
launches on PyTorch's current stream, raises if the launch reports an
error, and adds one to its entry in :data:`LAUNCHES`.  The default
backend's DP kernels (the forward, the score-only forward, the backward
and the two adjoint passes) keep a pair's rows in the registers of at
most 1,024 threads (:data:`MAX_SLOTS`); the four Q kernels in the
registers of a thread-block cluster of up to 16 CTAs a pair
(:data:`CLUSTER_SLOTS`; the cluster size is :func:`_cluster_size`'s
rule).  A pair padded past what the kernel holds raises a ``ValueError``
naming the limit before anything is launched.  The plain versions with
the same signatures are in ``ops/dp_ref.py``; the wrappers never fall
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
from deepblast_torch.ops.menu import E_SCALE, I16_MAX, as_menu

__all__ = ["LAUNCHES", "SPLITS", "MAX_SLOTS", "CLUSTER_SLOTS",
           "Q_CLUSTERS", "Q_DTYPES", "Q_STRIP", "reset_launches", "build",
           "skew", "skew_pair", "unskew", "forward", "forward_score",
           "backward", "adjoint_forward", "adjoint_backward", "forward_q",
           "backward_q", "adjoint_forward_q", "adjoint_backward_q"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_PKG, "csrc", "dp_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: the source's DP_PART objects (1 the forward, 2 the backward, 3 the
#: adjoint backward, 4 the adjoint forward, 5 the split Q forward and
#: adjoint backward, 6 the split Q backward and adjoint forward, 0 the
#: rest), compiled by one nvcc each, all at once, then linked
PARTS = 7

_OPS = {"softmax": 0, "sparsemax": 1, "hardmax": 2}
# storage codes of the kernels' DT_* (csrc/dp_kernels.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2}

#: the Q kernels' storage types of the Q streams and the suffix of their
#: instances' names in :data:`LAUNCHES`
Q_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}

#: launches of each kernel since the last :func:`reset_launches`
#: (``backward`` counts its launches with and without the gap output; a Q
#: kernel's bf16 instance counts under its name + ``_bf16``)
LAUNCHES = {"skew": 0, "skew_pair": 0, "unskew": 0, "forward": 0,
            "forward_score": 0,
            "backward": 0, "adjoint_forward": 0, "adjoint_backward": 0,
            "forward_q": 0, "backward_q": 0, "adjoint_forward_q": 0,
            "adjoint_backward_q": 0, "forward_q_bf16": 0,
            "backward_q_bf16": 0, "adjoint_forward_q_bf16": 0,
            "adjoint_backward_q_bf16": 0}

#: the most slots a pair may have in the strip kernels, which keep its rows
#: in registers: 1,024 threads of the widest strip
#: (``DP_SWITCH_FORWARD_STRIP`` for the forward passes,
#: ``DP_SWITCH_BACKWARD_STRIP`` for the reverse ones, in
#: ``csrc/dp_kernels.cu``)
MAX_SLOTS = {"forward": 1024 * 20, "forward_score": 1024 * 20,
             "adjoint_forward": 1024 * 20, "backward": 1024 * 6,
             "adjoint_backward": 1024 * 6}

#: cluster sizes the split Q kernels launch with (16 is the non-portable
#: size), and their strip width, slots a thread (``Q_STRIP`` in the source)
Q_CLUSTERS = (1, 2, 4, 8, 16)
Q_STRIP = 2
#: the fewest slots :func:`_cluster_size` gives a CTA: one warp of strips
Q_MIN_CTA_SLOTS = 32 * Q_STRIP
#: the most slots a pair may have in the split Q kernels: 16 CTAs of 1,024
#: threads of strips; the ``pallas_long`` training step runs all four
CLUSTER_SLOTS = {k: 16 * 1024 * Q_STRIP for k in
                 ("forward_q", "backward_q", "adjoint_forward_q",
                  "adjoint_backward_q")}
#: the split of each split Q kernel instance's last launch, under its name
#: in :data:`LAUNCHES` (``+ "_bf16"`` for bf16 Q streams): pairs ``B``,
#: slots ``S``, cluster size ``C``, ``threads`` a CTA, and ``clusters``,
#: how many clusters of that size the device holds at once
SPLITS = {k + s: None for k in CLUSTER_SLOTS for s in Q_DTYPES.values()}
_Q_KERNEL_IDS = {"forward_q": 0, "adjoint_backward_q": 1, "backward_q": 2,
                 "adjoint_forward_q": 3}

_LIB = None
_LOCK = threading.Lock()
_MAX_CLUSTERS = {}


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


def _run(procs):
    """Wait for every nvcc process; raise with the output of the first
    that failed; return their standard error, joined."""
    outs = [p.communicate() for p in procs]
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}\n{err}")
    return "".join(err for _, err in outs)


def build():
    """Compile the kernels if no library for this source and these flags
    exists yet; returns the path of the shared library.  The source's
    :data:`PARTS` objects compile in parallel: each strip kernel's entry,
    with the most template instances, in an object of its own, the
    relayouts and the Q kernels in one more.  ptxas's report (registers,
    spills and stack of every kernel instance) is kept beside the library
    as ``<library>.ptxas``."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libdp_kernels-{tag}.so")
    if not os.path.exists(so):
        tmp = f"{so}.tmp{os.getpid()}"
        objs = [f"{tmp}.{part}.o" for part in range(PARTS)]
        report = _run([subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f"-DDP_PART={part}", "-c", "-o", obj,
             SOURCE], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for part, obj in enumerate(objs)])
        _run([subprocess.Popen([_nvcc(), "-shared", "-o", tmp, *objs],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)])
        for obj in objs:
            os.remove(obj)
        with open(f"{tmp}.ptxas", "w") as f:
            f.write(report)
        os.replace(f"{tmp}.ptxas", f"{so}.ptxas")
        os.replace(tmp, so)  # atomic when several processes build at once
    return so


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.dp_skew.argtypes = [p, i, i, i, p, i, f, p]
            lib.dp_skew_pair.argtypes = [p, p, i, i, i, p, p, i, f, p]
            lib.dp_unskew.argtypes = [p, i, f, i, i, i, i, i, p, p]
            lib.dp_forward.argtypes = [p, p, i, f, p, p, i, i, i, i, i, i,
                                       i, p, p, p, p]
            lib.dp_backward.argtypes = [p, p, i, p, p, p, i, i, i, i, i, i,
                                        f, p, p, p]
            lib.dp_adjoint_forward.argtypes = [p, p, i, p, p, i, p, p, i, i,
                                               i, i, i, p, p, p, p]
            lib.dp_adjoint_backward.argtypes = [p, p, p, p, i, p, i, p, p,
                                                i, i, i, i, i, p, p, p]
            lib.dp_forward_q.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p,
                                         p, p, p, p]
            lib.dp_backward_q.argtypes = [p, p, p, i, p, p, p, i, i, i, i, i,
                                          p, p, p]
            lib.dp_adjoint_forward_q.argtypes = [p, p, p, i, p, p, p, p, i, i,
                                                 i, i, i, i, p, p, p, p, p]
            lib.dp_adjoint_backward_q.argtypes = [p, p, p, i, p, p, p, p, p,
                                                  p, i, i, i, i, i, p, p, p]
            lib.dp_q_clusters.argtypes = [i, i, i, i, i, i]
            for fn in (lib.dp_skew, lib.dp_skew_pair, lib.dp_unskew,
                       lib.dp_forward,
                       lib.dp_backward, lib.dp_adjoint_forward,
                       lib.dp_adjoint_backward, lib.dp_forward_q,
                       lib.dp_backward_q, lib.dp_adjoint_forward_q,
                       lib.dp_adjoint_backward_q, lib.dp_q_clusters):
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _check_stream(name, t, dtype=torch.float32, shape=None):
    """A contiguous CUDA tensor of ``dtype`` (what the menu gives this
    stream) and, when given, ``shape``; raises otherwise."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
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


def _check_slots(name, S):
    """Raise a ``ValueError`` naming the limit when one pair of ``name``
    does not fit: its strips in the registers of 1,024 threads, or, for
    the split Q kernels, of a cluster of them."""
    q_most = max(CLUSTER_SLOTS.values())
    hint = ('backend="scan" runs longer pairs, slowly (plain operations '
            "per anti-diagonal, no slot limit); kernels for them need the "
            "DP rows in device memory (ROADMAP.md queue A item 4)")
    if name in CLUSTER_SLOTS:
        most = CLUSTER_SLOTS[name]
        if S > most:
            raise ValueError(
                f"CUDA {name}: a pair padded to S = {S} slots exceeds the "
                f"strips of one cluster (S <= {most} slots for this kernel: "
                f"16 CTAs of 1,024 threads of {Q_STRIP} slots); the "
                f"pallas_long training step, which runs all four Q "
                f"kernels, holds S <= {q_most} slots; {hint}")
        return
    if S <= q_most:
        hint = (f'backend="pallas_long" keeps its rows in the registers of '
                f"a cluster and holds pairs up to S = {q_most} slots")
    most = MAX_SLOTS[name]
    if S > most:
        raise ValueError(f"CUDA {name}: a pair padded to S = {S} slots "
                         f"exceeds the strips of one block (S <= {most} "
                         f"slots for this kernel); {hint}")


def _q_threads(S, C):
    """Threads a CTA of a split Q kernel (``q_threads`` in the source)."""
    per = C * Q_STRIP * 32
    return (S + per - 1) // per * 32


def _max_clusters(name, operator, S, C, device, variant=False,
                  q_dtype=torch.float32):
    """How many clusters of C CTAs of ``name`` (at S slots) the device holds
    at once (``cudaOccupancyMaxActiveClusters``; 0: a launch of that size
    would fail), asked of the instance that launches: ``operator``'s and
    ``q_dtype``'s (the Q streams' storage), and with ``variant`` the
    backward's with the gap output or the adjoint forward's with a Za
    stream."""
    key = (name, operator, bool(variant), q_dtype, S, C, device.index)
    if key not in _MAX_CLUSTERS:
        with torch.cuda.device(device):
            n = _lib().dp_q_clusters(_Q_KERNEL_IDS[name], _OPS[operator],
                                     int(bool(variant)), _code(q_dtype), S,
                                     C)
        if n < 0:
            raise RuntimeError(f"CUDA {name}: the occupancy query for "
                               f"clusters of {C} failed: cudaError {-n}")
        _MAX_CLUSTERS[key] = n
    return _MAX_CLUSTERS[key]


def _cluster_size(name, operator, B, S, device, variant=False,
                  q_dtype=torch.float32):
    """The cluster size of a split Q kernel's launch, the rule: the largest
    of :data:`Q_CLUSTERS` that gives each of the B C CTAs an SM of its own
    (B C <= the SM count) and each at least :data:`Q_MIN_CTA_SLOTS` slots,
    but at least the smallest whose CTAs of 1,024 threads hold the pair;
    walking down from it to that smallest, the first size the device can
    launch (:func:`_max_clusters` > 0).  8 pairs of 4,097 slots get 16 CTAs
    each (as fast as 8 and faster than 4 at 8 x 4096 x 4096 and 2 x 3899 x
    3757 on an H100; PERF.md), the bench shape's 256 pairs of 513 slots
    one each.  Raises if no size can be launched.  ``variant`` and
    ``q_dtype`` as :func:`_max_clusters`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    most = max(1, min(sms // max(B, 1), S // Q_MIN_CTA_SLOTS))
    want = max(c for c in Q_CLUSTERS if c <= most)
    need = min(c for c in Q_CLUSTERS if c * 1024 * Q_STRIP >= S)
    for C in sorted(Q_CLUSTERS, reverse=True):
        if need <= C <= max(want, need) and _max_clusters(
                name, operator, S, C, device, variant, q_dtype) > 0:
            return C
    raise ValueError(f"CUDA {name}: no cluster of {Q_CLUSTERS} CTAs that "
                     f"holds a pair of S = {S} slots can be launched on "
                     f"this device")


def _split(name, operator, B, S, device, variant=False,
           q_dtype=torch.float32):
    """The cluster size C of a split Q kernel's launch
    (:func:`_cluster_size`; ``variant`` and ``q_dtype`` as
    :func:`_max_clusters`), recorded in :data:`SPLITS` under the
    instance's name; raises a
    ``ValueError`` when C CTAs do not hold the pair or the device cannot
    launch clusters of that size."""
    C = _cluster_size(name, operator, B, S, device, variant, q_dtype)
    if C * 1024 * Q_STRIP < S:
        raise ValueError(f"CUDA {name}: a pair of S = {S} slots does not fit "
                         f"{C} CTAs of 1,024 threads of {Q_STRIP} slots")
    n = _max_clusters(name, operator, S, C, device, variant, q_dtype)
    if n <= 0:
        raise ValueError(f"CUDA {name}: this device cannot launch clusters "
                         f"of {C} CTAs of {_q_threads(S, C)} threads")
    SPLITS[name + Q_DTYPES[q_dtype]] = dict(B=B, S=S, C=C,
                                            threads=_q_threads(S, C),
                                            clusters=n)
    return C


def _check_streams(names, streams, dtype=torch.float32):
    """Each stream of ``dtype``, contiguous, on the card, of the first's
    shape; returns that shape."""
    _check_stream(names[0], streams[0], dtype)
    for name, t in zip(names[1:], streams[1:]):
        _check_stream(name, t, dtype, streams[0].shape)
    return streams[0].shape


def _check_q(streams, others=(), names=("Qx", "Qm", "Qy")):
    """The three Q streams of one storage type of :data:`Q_DTYPES`, and the
    streams ``others`` (``(name, tensor)``) float32, all contiguous, on the
    card, of one shape; returns ``(shape, q_dtype)``."""
    q_dtype = streams[0].dtype
    if q_dtype not in Q_DTYPES:
        raise TypeError(f"Q streams must be float32 or bfloat16, got "
                        f"{q_dtype}")
    shape = _check_streams(names, streams, q_dtype)
    for name, t in others:
        _check_stream(name, t, torch.float32, shape)
    return shape, q_dtype


def _code(dtype):
    return _DTYPE_CODES[dtype]


def _train_e_dtype(menu):
    """E, EA, Ed, EdA of the training passes: the menu's ``e``, float32 for
    an int16 ``e`` (unbounded values)."""
    e = menu.e_dtype
    return torch.float32 if e in (None, torch.int16) else e


def _check_pass(name, shape, ln, lm, device):
    """The lengths of a DP pass, and its slots against the kernel's
    limit."""
    B, K, S = shape
    _check_len("ln", ln, B, device)
    _check_len("lm", lm, B, device)
    _check_slots(name, S)


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"CUDA {what} launch failed: cudaError {rc}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _skew_out(x, out_dtype, quant_scale):
    _check_stream("x", x)
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, M), got {tuple(x.shape)}")
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"the skew stores float32, bfloat16 or int16, not "
                        f"{out_dtype}")
    if (out_dtype == torch.int16) != (quant_scale is not None):
        raise ValueError("an int16 stream needs a quant_scale, and only an "
                         "int16 stream takes one")
    B, N, M = x.shape
    return out_dtype, (B, N + M - 1, N + 1), float(quant_scale or 0.0)


def skew(x, out_dtype=None, quant_scale=None):
    """Natural ``(B, N, M)`` float32 -> stream ``(B, K, S)`` of
    ``out_dtype`` (float32, bfloat16, or int16 quantized at
    ``quant_scale``); every slot is written (zeros outside the band)."""
    out_dtype, shape, scale = _skew_out(x, out_dtype, quant_scale)
    B, N, M = x.shape
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().dp_skew(_ptr(x), B, N, M, _ptr(out), _code(out_dtype),
                            scale, _stream(x.device))
    _raise_on(rc, "skew")
    LAUNCHES["skew"] += 1
    return out


def skew_pair(x, y, out_dtype=None, quant_scale=None):
    """``(skew(x), skew(y))`` in one launch, bit-identical to two
    :func:`skew` launches; ``x`` and ``y`` of one shape."""
    out_dtype, shape, scale = _skew_out(x, out_dtype, quant_scale)
    _check_stream("y", y, torch.float32, x.shape)
    B, N, M = x.shape
    ox = torch.empty(shape, dtype=out_dtype, device=x.device)
    oy = torch.empty(shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().dp_skew_pair(_ptr(x), _ptr(y), B, N, M, _ptr(ox),
                                 _ptr(oy), _code(out_dtype), scale,
                                 _stream(x.device))
    _raise_on(rc, "skew_pair")
    LAUNCHES["skew_pair"] += 1
    return ox, oy


def unskew(s, N, M):
    """Stream ``(B, K, S)`` -> natural ``(B, N, M)`` float32,
    ``out[b, i, j] = s[b, i+j, i+1]``; a bfloat16 stream is widened, an
    int16 expectation stream dequantized by ``1 / 32767``; every natural
    cell is written."""
    if s.dtype not in _DTYPE_CODES:
        raise TypeError(f"the unskew reads float32, bfloat16 or int16, not "
                        f"{s.dtype}")
    _check_stream("s", s, s.dtype)
    B, K, S = s.shape
    if S != N + 1 or K != N + M - 1:
        raise ValueError(f"stream {tuple(s.shape)} does not hold ({N}, {M})")
    out = torch.empty((B, N, M), dtype=torch.float32, device=s.device)
    with torch.cuda.device(s.device):
        rc = _lib().dp_unskew(_ptr(s), _code(s.dtype), 1.0 / E_SCALE, B, K,
                              S, N, M, _ptr(out), _stream(s.device))
    _raise_on(rc, "unskew")
    LAUNCHES["unskew"] += 1
    return out


def _forward(th_s, A_s, ln, lm, mode, operator, store, dtypes):
    menu = as_menu(dtypes)
    name = "forward" if store else "forward_score"
    in_dt = menu.stream_dtype or torch.float32
    d_dt = menu.d_dtype or torch.float32
    shape = _check_streams(("th_s", "A_s"), (th_s, A_s), in_dt)
    _check_pass(name, shape, ln, lm, th_s.device)
    B, K, S = shape
    vt = torch.zeros((B,), dtype=torch.float32, device=th_s.device)
    if store:
        dx = torch.empty(shape, dtype=d_dt, device=th_s.device)
        dm = torch.empty(shape, dtype=d_dt, device=th_s.device)
    with torch.cuda.device(th_s.device):
        rc = _lib().dp_forward(
            _ptr(th_s), _ptr(A_s), _code(in_dt),
            menu.stream_range / I16_MAX, _ptr(ln), _ptr(lm), B, K, S,
            MODE_BOUNDS[mode][0], _OPS[operator], int(store), _code(d_dt),
            _ptr(vt), _ptr(dx) if store else None,
            _ptr(dm) if store else None, _stream(th_s.device))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return (vt, dx, dm) if store else vt


def forward(th_s, A_s, ln, lm, *, mode="nw", operator="softmax",
            dtypes=None):
    """``(vt (B,), Dx, Dm (B, K, S))``: the forward with residual stores,
    Dx and Dm in the menu's ``d``."""
    return _forward(th_s, A_s, ln, lm, mode, operator, True, dtypes)


def forward_score(th_s, A_s, ln, lm, *, mode="nw", operator="softmax",
                  dtypes=None):
    """``vt (B,)``: the score-only forward (no residual stores; each pair's
    walk stops at its terminal diagonal)."""
    return _forward(th_s, A_s, ln, lm, mode, operator, False, dtypes)


def backward(dxs, dms, ln, lm, Et, *, mode="nw", operator="softmax",
             want_gap=False, dtypes=None, decode=False):
    """``(E, EA)``: the expected alignment stream ``E (B, K, S)`` seeded
    with ``Et``, and with ``want_gap`` the gap expectation
    ``EA = E (Qx + Qy)`` (else None), in the menu's ``e`` (int16 only with
    ``decode``)."""
    menu = as_menu(dtypes)
    d_dt = menu.d_dtype or torch.float32
    e_dt = (menu.e_dtype or torch.float32) if decode \
        else _train_e_dtype(menu)
    shape = _check_streams(("Dx", "Dm"), (dxs, dms), d_dt)
    _check_stream("Et", Et, torch.float32, shape[:1])
    _check_pass("backward", shape, ln, lm, dxs.device)
    B, K, S = shape
    E = torch.empty(shape, dtype=e_dt, device=dxs.device)
    EA = torch.empty(shape, dtype=e_dt, device=dxs.device) if want_gap \
        else None
    with torch.cuda.device(dxs.device):
        rc = _lib().dp_backward(
            _ptr(dxs), _ptr(dms), _code(d_dt), _ptr(ln), _ptr(lm), _ptr(Et),
            B, K, S, MODE_BOUNDS[mode][1], _OPS[operator], _code(e_dt),
            E_SCALE, _ptr(E), _ptr(EA) if want_gap else None,
            _stream(dxs.device))
    _raise_on(rc, "backward")
    LAUNCHES["backward"] += 1
    return E, EA


def adjoint_forward(dxs, dms, zt_s, za_s, ln, lm, *, mode="nw",
                    operator="softmax", dtypes=None):
    """``(vtd (B,), Dxd, Dmd (B, K, S))``: the tangent of the forward along
    the skewed cotangents, Dxd and Dmd in the menu's ``d``; ``za_s=None``
    launches the kernel without a Za stream (a zero gap cotangent)."""
    menu = as_menu(dtypes)
    d_dt = menu.d_dtype or torch.float32
    z_dt = menu.cotangent_dtype or torch.float32
    shape = _check_streams(("Dx", "Dm"), (dxs, dms), d_dt)
    _check_stream("Zt", zt_s, z_dt, shape)
    if za_s is not None:
        _check_stream("Za", za_s, z_dt, shape)
    _check_pass("adjoint_forward", shape, ln, lm, dxs.device)
    B, K, S = shape
    vtd = torch.zeros((B,), dtype=torch.float32, device=dxs.device)
    dxd = torch.empty(shape, dtype=d_dt, device=dxs.device)
    dmd = torch.empty(shape, dtype=d_dt, device=dxs.device)
    with torch.cuda.device(dxs.device):
        rc = _lib().dp_adjoint_forward(
            _ptr(dxs), _ptr(dms), _code(d_dt), _ptr(zt_s),
            None if za_s is None else _ptr(za_s), _code(z_dt), _ptr(ln),
            _ptr(lm), B, K, S, MODE_BOUNDS[mode][2], _OPS[operator],
            _ptr(vtd), _ptr(dxd), _ptr(dmd), _stream(dxs.device))
    _raise_on(rc, "adjoint_forward")
    LAUNCHES["adjoint_forward"] += 1
    return vtd, dxd, dmd


def adjoint_backward(dxs, dms, dxds, dmds, E, ln, lm, *, mode="nw",
                     operator="softmax", dtypes=None):
    """``(Ed, EdA)``, both ``(B, K, S)``: the tangent of the backward and
    the fused gap adjoint ``EdA = Ed (Qx + Qy) + E (Qdx + Qdy)``, stored
    like the training E."""
    menu = as_menu(dtypes)
    d_dt = menu.d_dtype or torch.float32
    e_dt = _train_e_dtype(menu)
    shape = _check_streams(("Dx", "Dm", "Dxd", "Dmd"),
                           (dxs, dms, dxds, dmds), d_dt)
    _check_stream("E", E, e_dt, shape)
    _check_pass("adjoint_backward", shape, ln, lm, dxs.device)
    B, K, S = shape
    Ed = torch.empty(shape, dtype=e_dt, device=dxs.device)
    EdA = torch.empty(shape, dtype=e_dt, device=dxs.device)
    with torch.cuda.device(dxs.device):
        rc = _lib().dp_adjoint_backward(
            _ptr(dxs), _ptr(dms), _ptr(dxds), _ptr(dmds), _code(d_dt),
            _ptr(E), _code(e_dt), _ptr(ln), _ptr(lm), B, K, S,
            MODE_BOUNDS[mode][3], _OPS[operator], _ptr(Ed), _ptr(EdA),
            _stream(dxs.device))
    _raise_on(rc, "adjoint_backward")
    LAUNCHES["adjoint_backward"] += 1
    return Ed, EdA


def forward_q(th_s, A_s, ln, lm, *, mode="nw", operator="softmax",
              q_dtype=None):
    """``(vt (B,), Qx, Qm, Qy (B, K, S))``: the forward storing the three
    soft-argmax streams in ``q_dtype`` (None: float32; bfloat16 rounds to
    nearest even), Q written for every slot; each pair split across a
    cluster of :func:`_cluster_size` CTAs."""
    q_dtype = torch.float32 if q_dtype is None else q_dtype
    if q_dtype not in Q_DTYPES:
        raise TypeError(f"forward_q stores float32 or bfloat16 Q streams, "
                        f"not {q_dtype}")
    shape = _check_streams(("th_s", "A_s"), (th_s, A_s))
    _check_pass("forward_q", shape, ln, lm, th_s.device)
    B, K, S = shape
    C = _split("forward_q", operator, B, S, th_s.device, False, q_dtype)
    vt = torch.zeros((B,), dtype=torch.float32, device=th_s.device)
    qx, qm, qy = (torch.empty_like(th_s, dtype=q_dtype) for _ in range(3))
    with torch.cuda.device(th_s.device):
        rc = _lib().dp_forward_q(
            _ptr(th_s), _ptr(A_s), _ptr(ln), _ptr(lm), B, K, S,
            MODE_BOUNDS[mode][0], _OPS[operator], C, _code(q_dtype),
            _ptr(vt), _ptr(qx), _ptr(qm), _ptr(qy), _stream(th_s.device))
    _raise_on(rc, "forward_q")
    LAUNCHES["forward_q" + Q_DTYPES[q_dtype]] += 1
    return vt, qx, qm, qy


def backward_q(qx, qm, qy, ln, lm, Et, *, mode="nw", want_gap=False):
    """``(E, EA)``: the expected alignment stream read from the stored Q
    streams, seeded with ``Et``, and with ``want_gap`` ``EA = E (Qx + Qy)``
    (else None), both float32 whatever the Q streams store; each pair split
    across a cluster of :func:`_cluster_size` CTAs."""
    shape, q_dtype = _check_q((qx, qm, qy))
    _check_stream("Et", Et, torch.float32, shape[:1])
    _check_pass("backward_q", shape, ln, lm, qx.device)
    B, K, S = shape
    C = _split("backward_q", "softmax", B, S, qx.device, want_gap, q_dtype)
    E = torch.empty_like(qx, dtype=torch.float32)
    EA = torch.empty_like(E) if want_gap else None
    with torch.cuda.device(qx.device):
        rc = _lib().dp_backward_q(
            _ptr(qx), _ptr(qm), _ptr(qy), _code(q_dtype), _ptr(ln), _ptr(lm),
            _ptr(Et), B, K, S, MODE_BOUNDS[mode][1], C, _ptr(E),
            _ptr(EA) if want_gap else None, _stream(qx.device))
    _raise_on(rc, "backward_q")
    LAUNCHES["backward_q" + Q_DTYPES[q_dtype]] += 1
    return E, EA


def adjoint_forward_q(qx, qm, qy, zt_s, za_s, ln, lm, *, mode="nw",
                      operator="softmax"):
    """``(vtd (B,), Qdx, Qdm, Qdy (B, K, S))``: the tangent of the Q
    forward along the skewed cotangents; ``za_s=None`` launches the kernel
    without a Za stream (a zero gap cotangent); each pair split across a
    cluster of :func:`_cluster_size` CTAs."""
    others = [("Zt", zt_s)] + ([] if za_s is None else [("Za", za_s)])
    shape, q_dtype = _check_q((qx, qm, qy), others)
    _check_pass("adjoint_forward_q", shape, ln, lm, qx.device)
    B, K, S = shape
    C = _split("adjoint_forward_q", operator, B, S, qx.device,
               za_s is not None, q_dtype)
    vtd = torch.zeros((B,), dtype=torch.float32, device=qx.device)
    qdx, qdm, qdy = (torch.empty_like(zt_s) for _ in range(3))
    with torch.cuda.device(qx.device):
        rc = _lib().dp_adjoint_forward_q(
            _ptr(qx), _ptr(qm), _ptr(qy), _code(q_dtype), _ptr(zt_s),
            None if za_s is None else _ptr(za_s), _ptr(ln), _ptr(lm), B, K,
            S, MODE_BOUNDS[mode][2], _OPS[operator], C, _ptr(vtd), _ptr(qdx),
            _ptr(qdm), _ptr(qdy), _stream(qx.device))
    _raise_on(rc, "adjoint_forward_q")
    LAUNCHES["adjoint_forward_q" + Q_DTYPES[q_dtype]] += 1
    return vtd, qdx, qdm, qdy


def adjoint_backward_q(qx, qm, qy, qdx, qdm, qdy, E, ln, lm, *, mode="nw"):
    """``(Ed, EdA)``, both ``(B, K, S)``: the tangent of the Q backward and
    the fused gap adjoint ``EdA = Ed (Qx + Qy) + E (Qdx + Qdy)``; each
    pair split across a cluster of :func:`_cluster_size` CTAs."""
    shape, q_dtype = _check_q((qx, qm, qy), [("Qdx", qdx), ("Qdm", qdm),
                                             ("Qdy", qdy), ("E", E)])
    _check_pass("adjoint_backward_q", shape, ln, lm, qx.device)
    B, K, S = shape
    C = _split("adjoint_backward_q", "softmax", B, S, qx.device, False,
               q_dtype)
    Ed = torch.empty_like(E)
    EdA = torch.empty_like(E)
    with torch.cuda.device(qx.device):
        rc = _lib().dp_adjoint_backward_q(
            _ptr(qx), _ptr(qm), _ptr(qy), _code(q_dtype), _ptr(qdx),
            _ptr(qdm), _ptr(qdy), _ptr(E), _ptr(ln), _ptr(lm), B, K, S,
            MODE_BOUNDS[mode][3], C, _ptr(Ed), _ptr(EdA), _stream(qx.device))
    _raise_on(rc, "adjoint_backward_q")
    LAUNCHES["adjoint_backward_q" + Q_DTYPES[q_dtype]] += 1
    return Ed, EdA
