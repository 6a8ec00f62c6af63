"""Smoothed alignment DP: differentiable scores and expected alignments,
expected-alignment streams and the greedy traceback.

PyTorch counterpart of ``deepblast_tpu/ops/dp.py``:

* :func:`alignment_score` (``dp.py:317``) -> ``Vt (B,)``, differentiable
  twice: its gradient is the expected alignment (``_score_bwd``,
  ``dp.py:295-298``);
* :func:`expected_alignment` (``dp.py:335``) -> natural ``(B, N, M)``
  ``E`` (and ``E_A`` with ``return_gap``), differentiable: its VJP is the
  JVP along the cotangents by Hessian symmetry, run by the adjoint passes
  (``_expected_bwd``, ``dp.py:232-271``);
* :func:`expected_alignment_stream` (``dp.py:354``) -> ``(B, K, S)`` stream
  in the port's layout (``ops/skew.py``), read with :func:`stream_cell`;
  inference only;
* :func:`traceback`, :func:`traceback_stream` and :func:`_traceback_walk`
  (``dp.py:399-479``), with the documented border guard (``dp.py:407-412``);
* the backend registry, :func:`register_backend`, :func:`get_backend` and
  :func:`set_default_backend` (``dp.py:151-166``);
* the decoder façade :class:`AlignmentDecoder`,
  :class:`NeedlemanWunschDecoder` and :class:`SmithWatermanDecoder`
  (``dp.py:487-518``), ``nn.Module``s without parameters.

The two ``jax.custom_vjp`` levels become two ``torch.autograd.Function``s:
``_Expected`` (forward: skew of theta and A, forward, backward, unskew; backward: skew
of the cotangents, adjoint forward, adjoint backward, unskew x2) and
``_Score`` (forward: score-only forward; backward: ``_Expected`` itself,
so ``create_graph=True`` gives the second order).  ``_Expected``'s own
backward is ``once_differentiable``: like the JAX package, the DP goes no
deeper than second order.

The ``backend=`` keyword picks the passes, as the JAX package's backend
registry does (``dp.py:61-166``; each backend's forward returns an opaque
residual that only its own reverse passes read).  ``None`` is
:data:`DEFAULT_BACKEND`, read at every call, which
:func:`set_default_backend` and ``register_backend(...,
make_default=True)`` move:

* ``"pallas_bm"``, the default (:class:`_Residuals`): the forward stores the
  differences Dx, Dm and the reverse passes recompute the soft argmax
  from them; a score-only forward; a stream accessor for the traceback;
* ``"pallas"`` or ``"pallas_long"`` (:class:`_QStreams`): the forward
  stores the three soft-argmax streams Q and the reverse passes read them,
  which keeps fewer rows per pair on chip, so pairs longer than the
  default kernels take (S up to 32,768 slots on an H100,
  ``dp_cuda.CLUSTER_SLOTS``, where the default reverse passes stop at
  6,144) still run; the Q streams in :data:`Q_DTYPE`; no score-only forward
  (:func:`alignment_score` runs the Q forward and keeps ``vt``) and no
  stream accessor (:func:`expected_alignment_stream` raises, as
  ``dp.py:371-373``).  The TPU's two names differ only in their
  relayout kernels; here both use the one skew and unskew;
* ``"scan"`` (:class:`_Scan`; ``dp.py:83-146``), the JAX package's
  default off the TPU (``:148``): the Q-stream recursions as plain PyTorch
  operations per anti-diagonal (``ops/dp_ref.py``; the scan oracle,
  ``ops/dp_scan.py``, reaches no Pallas kernel), relayouts included, on
  the device the inputs are on (never moved), in the inputs' type
  (float64 included; the Q streams too); a score-only forward that keeps
  ``vt``, a stream accessor, and no slot limit.  Of the menu it reads
  ``d`` only, as ``_scan_with_dtypes``: the forward and the adjoint
  forward rebuild each stored Q and Qd from argument differences rounded
  through it.  ``backend=None`` never selects it unless
  :func:`set_default_backend` says so.

The Q backends' one storage switch is the module global :data:`Q_DTYPE`,
the counterpart of ``dp_pallas.Q_DTYPE`` (``dp_pallas.py:74``, ``:234``):
``None`` stores the Q streams in float32, ``torch.bfloat16`` rounds each
store to nearest even and the reverse passes widen what they read (E,
EA, Qd, Ed and EdA stay float32).  It is read at every call and passed
to the forward; no entry point sets it, as in the JAX package.

The ``dtypes=`` keyword (a :class:`~deepblast_torch.ops.menu.DTypeMenu`)
sets the storage of the default backend's streams, as the JAX package's
per-call menu does (``dp.py:190-195``; ``dp_bm._with_dtypes``): input
streams in ``stream`` (int16 fixed point quantized by the skew), Dx, Dm,
Dxd, Dmd in ``d``, E and its tangents in ``e`` (int16 only in
:func:`expected_alignment_stream`, the decode).  Cotangent streams take
``stream`` when it is a float type and stay in their own type otherwise
(``dp_bm.skew_cotangent``).  The Q backends ignore the menu, as the JAX
package does (``dp_pallas.py`` registers no ``with_dtypes``).

The default backend skews (theta, A), and (Zt, Za) where there is a Za,
in one pair-skew launch (``skew_bm_pair``).  The JAX package keeps that
behind an opt-in gate (``DEEPBLAST_SKEW_PAIR``, ``dp_bm.py:105-111``)
because the fused form gained nothing end to end on its chip; on the
H100 the pair is bit-identical to two skews and no slower, so the port
has the one path.

For CUDA tensors every pass of the other backends launches a kernel of
``ops/dp_cuda.py``; for CPU tensors it runs the plain version in
``ops/dp_ref.py``.  Any other device raises, except under ``scan``.

Each op's forward, :class:`_Expected`'s backward and the stream's passes
run inside a ``dp`` span timed on the card (``utils/profiling.py``), which
costs nothing unless recording is on.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from deepblast_torch import native
from deepblast_torch.ops import dp_cuda, dp_ref
from deepblast_torch.ops.menu import E_SCALE, DTypeMenu, as_menu
from deepblast_torch.utils.profiling import span

__all__ = [
    "AlignmentDecoder",
    "BACKENDS",
    "DEFAULT_BACKEND",
    "DTypeMenu",
    "NeedlemanWunschDecoder",
    "Q_DTYPE",
    "SmithWatermanDecoder",
    "get_backend",
    "register_backend",
    "set_default_backend",
    "alignment_score",
    "expected_alignment",
    "expected_alignment_stream",
    "stream_cell",
    "traceback",
    "traceback_stream",
]


def _passes(t, be):
    """The kernels (CUDA tensor) or their plain versions (CPU tensor); the
    plain versions on any device for a backend with ``plain`` set."""
    if getattr(be, "plain", False):
        return dp_ref
    if t.device.type == "cuda":
        return dp_cuda
    if t.device.type == "cpu":
        return dp_ref
    raise ValueError(f"no DP implementation for device {t.device}")


class _Residuals:
    """The default passes: residuals Dx, Dm (``ops/dp_bm.py``'s kernels),
    with the storage menu."""

    stream = True
    takes_menu = True

    @staticmethod
    def skew_inputs(ops, theta, A, menu):
        return ops.skew_pair(theta, A, out_dtype=menu.stream_dtype,
                             quant_scale=menu.stream_scale)

    @staticmethod
    def skew_cotangents(ops, Zt, Za, menu):
        ct = menu.cotangent_dtype
        if Za is None:
            return ops.skew(Zt, out_dtype=ct), None
        return ops.skew_pair(Zt, Za, out_dtype=ct)

    @staticmethod
    def forward(ops, th_s, A_s, ln, lm, kw, menu):
        vt, dx, dm = ops.forward(th_s, A_s, ln, lm, dtypes=menu, **kw)
        return vt, (dx, dm)

    @staticmethod
    def score(ops, th_s, A_s, ln, lm, kw, menu):
        return ops.forward_score(th_s, A_s, ln, lm, dtypes=menu, **kw)

    @staticmethod
    def backward(ops, aux, ln, lm, Et, kw, want_gap, menu, decode=False):
        return ops.backward(*aux, ln, lm, Et, want_gap=want_gap, dtypes=menu,
                            decode=decode, **kw)

    @staticmethod
    def adjoint_forward(ops, aux, zt_s, za_s, ln, lm, kw, menu):
        vtd, dxd, dmd = ops.adjoint_forward(*aux, zt_s, za_s, ln, lm,
                                            dtypes=menu, **kw)
        return vtd, (dxd, dmd)

    @staticmethod
    def adjoint_backward(ops, aux, adj, E_s, ln, lm, kw, menu):
        return ops.adjoint_backward(*aux, *adj, E_s, ln, lm, dtypes=menu,
                                    **kw)


#: storage of the Q backends' three Q streams: None (float32) or
#: ``torch.bfloat16`` (``dp_pallas.Q_DTYPE``); read at every call
Q_DTYPE = None


class _QStreams:
    """The long-sequence passes: stored soft-argmax streams Q and Qd
    (``ops/dp_pallas.py``'s kernels); Q stored in :data:`Q_DTYPE`, every
    other stream float32, the menu ignored."""

    stream = False
    takes_menu = False

    @staticmethod
    def skew_inputs(ops, theta, A, menu):
        return ops.skew(theta), ops.skew(A)

    @staticmethod
    def skew_cotangents(ops, Zt, Za, menu):
        return ops.skew(Zt), None if Za is None else ops.skew(Za)

    @staticmethod
    def forward(ops, th_s, A_s, ln, lm, kw, menu):
        vt, qx, qm, qy = ops.forward_q(th_s, A_s, ln, lm, q_dtype=Q_DTYPE,
                                       **kw)
        return vt, (qx, qm, qy)

    @staticmethod
    def score(ops, th_s, A_s, ln, lm, kw, menu):
        return ops.forward_q(th_s, A_s, ln, lm, q_dtype=Q_DTYPE, **kw)[0]

    @staticmethod
    def backward(ops, aux, ln, lm, Et, kw, want_gap, menu, decode=False):
        return ops.backward_q(*aux, ln, lm, Et, mode=kw["mode"],
                              want_gap=want_gap)

    @staticmethod
    def adjoint_forward(ops, aux, zt_s, za_s, ln, lm, kw, menu):
        vtd, *qd = ops.adjoint_forward_q(*aux, zt_s, za_s, ln, lm, **kw)
        return vtd, tuple(qd)

    @staticmethod
    def adjoint_backward(ops, aux, adj, E_s, ln, lm, kw, menu):
        return ops.adjoint_backward_q(*aux, *adj, E_s, ln, lm,
                                      mode=kw["mode"])


class _Scan(_QStreams):
    """The scan oracle (``deepblast_tpu/ops/dp_scan.py`` through the JAX
    registry's ``"scan"`` entry, ``dp.py:83-146``): the Q-stream
    recursions of ``ops/dp_ref.py`` as plain PyTorch operations per
    anti-diagonal on whatever device the inputs are on, in their type, the
    Q streams too (:data:`Q_DTYPE` ignored); of the menu only ``d``
    (``_scan_with_dtypes``), which rebuilds each stored Q and Qd from
    differences rounded through it; no slot limit."""

    stream = True
    takes_menu = True
    plain = True

    @staticmethod
    def forward(ops, th_s, A_s, ln, lm, kw, menu):
        vt, qx, qm, qy = ops.forward_q(th_s, A_s, ln, lm,
                                       residual_dtype=menu.d_dtype, **kw)
        return vt, (qx, qm, qy)

    @staticmethod
    def score(ops, th_s, A_s, ln, lm, kw, menu):
        return ops.forward_q(th_s, A_s, ln, lm, **kw)[0]

    @staticmethod
    def adjoint_forward(ops, aux, zt_s, za_s, ln, lm, kw, menu):
        vtd, *qd = ops.adjoint_forward_q(*aux, zt_s, za_s, ln, lm,
                                         residual_dtype=menu.d_dtype, **kw)
        return vtd, tuple(qd)


#: backend name -> its passes (a class like :class:`_Residuals`: ``stream``,
#: ``takes_menu``, optionally ``plain`` (the plain passes on every device)
#: and the static methods ``skew_inputs`` to ``adjoint_backward``), as the
#: JAX package's ``--backend``; :func:`register_backend` adds to it
BACKENDS = {"pallas_bm": _Residuals, "pallas": _QStreams,
            "pallas_long": _QStreams, "scan": _Scan}
#: the name of the backend that ``backend=None`` selects, read at every call
DEFAULT_BACKEND = "pallas_bm"


def register_backend(name, passes, make_default=False):
    """Add (or replace) backend ``name`` with ``passes``; with
    ``make_default`` it also becomes :data:`DEFAULT_BACKEND`."""
    BACKENDS[name] = passes
    if make_default:
        set_default_backend(name)


def set_default_backend(name):
    """Make the registered backend ``name`` the one ``backend=None``
    selects; an unknown name raises ``ValueError``."""
    global DEFAULT_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown DP backend {name!r}; the port has "
                         f"{sorted(BACKENDS)}")
    DEFAULT_BACKEND = name


def get_backend(name=None):
    """The passes of backend ``name`` (``None``: :data:`DEFAULT_BACKEND`);
    raises ``ValueError`` for a name the port does not have."""
    if name is None:
        name = DEFAULT_BACKEND
    if name in BACKENDS:
        return BACKENDS[name]
    raise ValueError(f"unknown DP backend {name!r}; the port has "
                     f"{sorted(BACKENDS)} and None (the default, "
                     f"{DEFAULT_BACKEND!r})")


def _lengths(theta, lengths):
    B, N, M = theta.shape
    if lengths is None:
        ln = torch.full((B,), N, dtype=torch.int32, device=theta.device)
        lm = torch.full((B,), M, dtype=torch.int32, device=theta.device)
        return ln, lm
    ln, lm = lengths
    return (torch.as_tensor(ln).to(theta.device, torch.int32).contiguous(),
            torch.as_tensor(lm).to(theta.device, torch.int32).contiguous())


def _check(theta, A):
    if theta.dim() != 3 or A.shape != theta.shape:
        raise ValueError(f"theta and A must both be (B, N, M), got "
                         f"{tuple(theta.shape)} and {tuple(A.shape)}")
    return theta.contiguous(), A.contiguous()


def _terminal_seed(theta, Et):
    if Et is None:
        return torch.ones((theta.shape[0],), dtype=theta.dtype,
                          device=theta.device)
    return torch.as_tensor(Et).to(theta.device, theta.dtype).contiguous()


class _Expected(torch.autograd.Function):
    """``(theta, A, Et) -> E`` (and ``E_A`` with ``return_gap``)."""

    @staticmethod
    def forward(ctx, theta, A, Et, ln, lm, mode, operator, return_gap, be,
                menu):
        with span("dp", device=True):
            ops = _passes(theta, be)
            B, N, M = theta.shape
            kw = dict(mode=mode, operator=operator)
            th_s, A_s = be.skew_inputs(ops, theta, A, menu)
            _, aux = be.forward(ops, th_s, A_s, ln, lm, kw, menu)
            del th_s, A_s
            E_s, EA_s = be.backward(ops, aux, ln, lm, Et, kw, return_gap,
                                    menu)
            # the backend's own residual, opaque here (the JAX "aux")
            ctx.save_for_backward(E_s, ln, lm, *aux)
            ctx.cfg = (mode, operator, return_gap, be, menu, theta.dtype)
            ctx.set_materialize_grads(False)
            E = ops.unskew(E_s, N, M)
            return (E, ops.unskew(EA_s, N, M)) if return_gap else E

    @staticmethod
    @once_differentiable
    def backward(ctx, Zt, Za=None):
        with span("dp", device=True):
            E_s, ln, lm, *aux = ctx.saved_tensors
            mode, operator, return_gap, be, menu, dtype = ctx.cfg
            ops = _passes(E_s, be)
            B, K, S = E_s.shape
            N, M = S - 1, K - S + 2
            # cotangents are unbounded: never int16
            # (menu.cotangent_dtype); no gap cotangent (the training
            # decode path): the adjoint forward drops the Za stream
            # instead of streaming zeros
            if Zt is None:
                Zt = E_s.new_zeros((B, N, M), dtype=dtype)
            Za = None if (not return_gap or Za is None) else Za.contiguous()
            zt_s, za_s = be.skew_cotangents(ops, Zt.contiguous(), Za, menu)
            kw = dict(mode=mode, operator=operator)
            vtd, adj = be.adjoint_forward(ops, aux, zt_s, za_s, ln, lm, kw,
                                          menu)
            del zt_s, za_s
            Ed_s, EdA_s = be.adjoint_backward(ops, aux, adj, E_s, ln, lm, kw,
                                              menu)
            # E is linear in Et, so d<cts, E>/dEt = <cts, E>/Et = vtd (the
            # adjoint forward's terminal tangent does not involve Et)
            return (ops.unskew(Ed_s, N, M), ops.unskew(EdA_s, N, M), vtd,
                    None, None, None, None, None, None, None)


class _Score(torch.autograd.Function):
    """``(theta, A) -> Vt``; the gradient is :class:`_Expected` itself."""

    @staticmethod
    def forward(ctx, theta, A, ln, lm, mode, operator, be, menu):
        ops = _passes(theta, be)
        ctx.save_for_backward(theta, A, ln, lm)
        ctx.cfg = (mode, operator, be, menu)
        with span("dp", device=True):
            th_s, A_s = be.skew_inputs(ops, theta, A, menu)
            return be.score(ops, th_s, A_s, ln, lm,
                            dict(mode=mode, operator=operator), menu)

    @staticmethod
    def backward(ctx, gVt):
        theta, A, ln, lm = ctx.saved_tensors
        mode, operator, be, menu = ctx.cfg
        g_theta, g_A = _Expected.apply(theta, A, gVt.contiguous(), ln, lm,
                                       mode, operator, True, be, menu)
        return g_theta, g_A, None, None, None, None, None, None


def alignment_score(theta, A, lengths=None, *, mode="nw",
                    operator="softmax", backend=None, dtypes=None):
    """Terminal smoothed alignment score ``Vt (B,)`` of a padded batch,
    differentiable twice in ``theta`` and ``A``.

    ``theta``/``A``: ``(B, N, M)`` match and per-cell gap potentials;
    ``lengths``: optional ``(ln, lm)`` true lengths (default: full);
    ``backend`` and ``dtypes``: see the module docstring."""
    be = get_backend(backend)
    menu = as_menu(dtypes)
    theta, A = _check(theta, A)
    ln, lm = _lengths(theta, lengths)
    return _Score.apply(theta, A, ln, lm, mode, operator, be, menu)


def expected_alignment(theta, A, lengths=None, Et=None, *, mode="nw",
                       operator="softmax", return_gap=False, backend=None,
                       dtypes=None):
    """Expected (posterior marginal) alignment ``E (B, N, M)`` — the
    gradient of :func:`alignment_score` scaled by ``Et`` (default ones) —
    differentiable in ``theta``, ``A`` and ``Et``.  With ``return_gap``
    also the expected gap-potential usage ``E_A = dVt/dA``: returns
    ``(E, E_A)``.  Under a menu the outputs are float32 whatever ``e``
    stores."""
    be = get_backend(backend)
    menu = as_menu(dtypes)
    theta, A = _check(theta, A)
    ln, lm = _lengths(theta, lengths)
    Et = _terminal_seed(theta, Et)
    return _Expected.apply(theta, A, Et, ln, lm, mode, operator,
                           bool(return_gap), be, menu)


def expected_alignment_stream(theta, A, lengths=None, Et=None, *, mode="nw",
                              operator="softmax", backend=None, dtypes=None):
    """Expected alignment (posterior marginals) as a ``(B, K, S)`` stream:
    skew, forward with residuals, backward.  Inference only (the decode):
    under a menu with ``e="int16"`` the stream is int16 fixed point at
    scale 32767 (``Et`` in ``[0, 1]``), which :func:`traceback_stream`
    dequantizes.  Cell ``(i, j)`` of pair ``b`` is :func:`stream_cell`
    ``(E, b, i, j)``; :func:`traceback_stream` walks it without a
    relayout.  Only the default backend has it; the others raise (use
    :func:`expected_alignment`)."""
    be = get_backend(backend)
    if not be.stream:
        raise ValueError(f"backend {backend!r} has no stream-layout "
                         "accessor; use expected_alignment")
    menu = as_menu(dtypes)
    theta, A = _check(theta, A)
    ops = _passes(theta, be)
    ln, lm = _lengths(theta, lengths)
    Et = _terminal_seed(theta, Et)
    kw = dict(mode=mode, operator=operator)
    with span("dp", device=True):
        th_s, A_s = be.skew_inputs(ops, theta, A, menu)
        _, aux = be.forward(ops, th_s, A_s, ln, lm, kw, menu)
        del th_s, A_s
        return be.backward(ops, aux, ln, lm, Et, kw, False, menu,
                           decode=True)[0]


def stream_cell(stream, b, i, j):
    """Cell ``(i, j)`` of pair ``b`` in a ``(B, K, S)`` stream."""
    return stream[b, i + j, i + 1]


# ---------------------------------------------------------------------------
# Traceback (host-side greedy walk)
# ---------------------------------------------------------------------------

def _host(x):
    """A stream or matrix as a contiguous float32/float64 numpy array: a
    bfloat16 tensor as float32 (exact), an int16 expectation stream
    dequantized as ``q.astype(float32) * float32(1 / 32767)``
    (``dp_bm._stream_accessor``, ``dp_bm.py:1140-1162``)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.cpu().numpy()
    x = np.ascontiguousarray(x)
    if x.dtype == np.int16:
        x = x.astype(np.float32) * np.float32(1.0 / E_SCALE)
    return x


def traceback(grad):
    """Greedy argmax walk over one pair's expected-alignment matrix
    ``(n, m)`` (already cut to the true lengths).  Returns
    ``[(i, j, state), ...]`` with states (x, m, y) = (0, 1, 2), tie order
    (left, diag, up) and trailing-gap padding as the reference walk.

    Documented deviation kept from the JAX package: the diagonal move is
    disabled when *either* index is at the border (the reference's guard
    ``i <= 0 and j <= 0`` reads ``grad[-1, j-1]`` at ``i == 0``)."""
    grad = _host(grad)
    n, m = grad.shape
    return native.traceback_affine(grad.reshape(-1), m, 1, n, m)


def _traceback_walk(get, N, M):
    """The greedy walk over a cell accessor ``get(i, j)`` in Python — the
    oracle the C walk is tested against."""
    m, x, y = 1, 0, 2
    i, j = N - 1, M - 1
    states = [(i, j, m)]
    neg = -100000.0
    while True:
        left = neg if i <= 0 else get(i - 1, j)
        diag = neg if (i <= 0 or j <= 0) else get(i - 1, j - 1)
        upper = neg if j <= 0 else get(i, j - 1)
        if left == neg and diag == neg and upper == neg:
            break
        ij = int(np.argmax([left, diag, upper]))
        if ij == 0:
            i, s = i - 1, x
        elif ij == 1:
            i, j, s = i - 1, j - 1, m
        else:
            j, s = j - 1, y
        states.append((i, j, s))
    while i > 0:
        i -= 1
        states.append((i, j, x))
    while j > 0:
        j -= 1
        states.append((i, j, y))
    return states[::-1]


def traceback_stream(stream, n, m, b=0):
    """Greedy traceback of pair ``b`` (true lengths ``(n, m)``) straight
    from a ``(B, K, S)`` expected-alignment stream.  Pair ``b``'s cell
    ``(i, j)`` has the flat offset ``b*K*S + 1 + i*(S+1) + j*S``, so the C
    walk reads the stream in place.  A CUDA stream is copied to the host
    whole: for many pairs, copy once and pass the numpy array."""
    s = _host(stream)
    B, K, S = s.shape
    N, M = S - 1, K - S + 2
    if not (0 <= b < B and 1 <= n <= N and 1 <= m <= M):
        raise ValueError(f"pair {b} with lengths ({n}, {m}) is outside a "
                         f"stream of {B} pairs padded to ({N}, {M})")
    flat = s.reshape(-1)[b * K * S + 1:]
    return native.traceback_affine(flat, S + 1, S, n, m)


# ---------------------------------------------------------------------------
# Decoder façade (the reference's nn.Module API, deepblast/nw.py:389-458,
# deepblast/sw.py:316-384)
# ---------------------------------------------------------------------------

class AlignmentDecoder(torch.nn.Module):
    """Score, decode and traceback of one alignment mode, without
    parameters: calling it gives :func:`alignment_score`."""

    mode = "nw"

    def __init__(self, operator="softmax", backend=None):
        super().__init__()
        self.operator = operator
        self.backend = backend

    def forward(self, theta, A, lengths=None):
        return alignment_score(theta, A, lengths, mode=self.mode,
                               operator=self.operator, backend=self.backend)

    def decode(self, theta, A, lengths=None, Et=None, return_gap=False):
        """:func:`expected_alignment` in this decoder's mode."""
        return expected_alignment(theta, A, lengths, Et, mode=self.mode,
                                  operator=self.operator,
                                  backend=self.backend,
                                  return_gap=return_gap)

    @staticmethod
    def traceback(grad):
        return traceback(grad)


class NeedlemanWunschDecoder(AlignmentDecoder):
    mode = "nw"


class SmithWatermanDecoder(AlignmentDecoder):
    mode = "sw"
