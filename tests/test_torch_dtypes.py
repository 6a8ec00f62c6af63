"""The port's storage-dtype menu (``ops/menu.py``) against the JAX
package's, on the CPU: the plain relayouts and DP passes against the
``pallas_bm`` kernels in Pallas interpret mode (``deepblast_tpu/ops/
skew_bm.py``, ``dp_bm.py``), the dispatcher's autograd against
``deepblast_tpu.ops.dp`` under the same menu, and the pair skew of the
dispatcher.

Inputs are float32 (float64 where the rounding from float64 is the point),
made from numpy seeds, B <= 2 and N, M <= 24; the decode runs as one phase
(``DECODE_PHASES=1``).  Each pass of the port is fed the JAX pass's own
inputs (relaid from the TPU layout ``(K2, S, Bp)`` to ``(B, K, S)``), so a
comparison sees that pass alone.  Cells are compared where the pair has
them (the TPU streams hold finite garbage elsewhere).  Tolerances:

* relayouts and quantized inputs: exact (one formula on the same values;
  XLA and torch both round float64 to bfloat16 through float32);
* stored bfloat16 residuals: within one bfloat16 step (2^-8 of the
  value), and int16 expectations within one quantum (1/32767): the two
  libraries' float32 exp and log can differ in the last bit, which moves
  a value across a rounding boundary now and then;
* float32 outputs: rtol 2e-5 / atol 2e-6 (tests/test_torch_dp_bm.py);
* against float32 storage, JAX's own gates (tests/test_bf16_streams.py,
  tests/test_i16_streams.py): E error < 5e-3 under bf16 D, < 2e-3 under
  int16 inputs, traceback agreement >= 0.97.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.ops import dp as tdp
from deepblast_torch.ops import dp_ref, skew as tskew
from deepblast_torch.ops.menu import DTypeMenu
from deepblast_tpu.ops import dp as jdp
from deepblast_tpu.ops import dp_bm, dp_bm_train, skew_bm
import torch_threads  # noqa: F401  (PyTorch threads a worker)

RTOL, ATOL = 2e-5, 2e-6
MENUS = {
    "d_bf16": dict(d="bfloat16"),
    "stream_i16": dict(stream="int16"),
    "fast": dict(d="bfloat16", e="int16"),
    "all_bf16": dict(stream="bfloat16", d="bfloat16", e="bfloat16"),
}
_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          jnp.int16: torch.int16}


def _problem(seed, B=2, N=20, M=15, dtype=np.float32):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((B, N, M)).astype(dtype)
    A = (rng.standard_normal((B, N, M)) - 1.0).astype(dtype)
    ln = rng.integers(N // 2, N + 1, size=B)
    lm = rng.integers(M // 2, M + 1, size=B)
    ln[0], lm[0] = N, M
    return theta, A, ln.astype(np.int32), lm.astype(np.int32)


def _np(x):
    """A JAX or torch array as numpy float32/float64/int16 (bfloat16
    widened exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _to_port(x, B, N, M):
    """A full TPU stream ``(K2, S, Bp)`` as the port's ``(B, K, S)``."""
    x = np.asarray(x)
    out = np.ascontiguousarray(
        np.transpose(x[:N + M - 1, :N + 1, :B], (2, 0, 1)))
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(out.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(out)


def _cells(ln, lm):
    """(b, r, s) index arrays of every cell the pairs have."""
    idx = [(b, i + j, i + 1) for b in range(len(ln))
           for i in range(ln[b]) for j in range(lm[b])]
    return tuple(np.asarray(idx).T)


def _jcells(x, cells):
    b, r, s = cells
    return _np(x)[r, s, b]


def _bf16_step(v):
    """One bfloat16 step at each value (2^-7 of its power of two)."""
    v = np.abs(v.astype(np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(v, 1e-30))) - 7)


def _same_stored(got, want, kind):
    if kind == torch.int16:
        assert np.max(np.abs(got.astype(np.int32) - want.astype(np.int32)),
                      initial=0) <= 1
    elif kind == torch.bfloat16:
        assert np.all(np.abs(got - want) <= _bf16_step(want) + 1e-30)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# relayouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_dt,out_dt,scale", [
    (np.float32, None, None),
    (np.float32, "bfloat16", None),
    (np.float64, "bfloat16", None),
    (np.float32, "int16", 32767.0 / 16.0),
    (np.float64, "int16", 4096.0),
])
def test_skew_matches_skew_bm(in_dt, out_dt, scale):
    """Every cell of the plain skew (and of the pair) = ``skew_bm`` /
    ``skew_bm_pair`` in float32, bfloat16 and int16 fixed point; zeros
    elsewhere; the pair = two singles exactly."""
    B, N, M = 2, 17, 13
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((B, N, M)) * 6).astype(in_dt)
    y = (rng.standard_normal((B, N, M)) * 30).astype(in_dt)   # saturates
    if in_dt == np.float64:
        # float64 values that round differently straight to bfloat16 and
        # through float32 (1 + 2^-8 + 2^-30: float32 makes it a tie)
        x[0, 0, :4] = 1 + 2.0 ** -8 + 2.0 ** -30
    jx, jy = skew_bm.skew_bm_pair(jnp.asarray(x), jnp.asarray(y),
                                  out_dtype=out_dt, quant_scale=scale)
    tdt = None if out_dt is None else getattr(torch, out_dt)
    tx, ty = tskew.skew_pair(torch.tensor(x), torch.tensor(y),
                             out_dtype=tdt, quant_scale=scale)
    assert torch.equal(tx, tskew.skew(torch.tensor(x), tdt, scale))
    assert torch.equal(ty, tskew.skew(torch.tensor(y), tdt, scale))
    assert tx.dtype == (tdt or torch.tensor(x).dtype)
    full = (np.full(B, N), np.full(B, M))
    cells = _cells(*full)
    for t, j in ((tx, jx), (ty, jy)):
        assert np.array_equal(_np(t)[cells], _jcells(j, cells))
        assert np.array_equal(
            _np(skew_bm.skew_bm(jnp.asarray(x), out_dtype=out_dt,
                                quant_scale=scale))[cells[1], cells[2],
                                                    cells[0]],
            _jcells(jx, cells))
        outside = np.ones(t.shape, bool)
        outside[cells] = False
        assert not _np(t)[outside].any()
    if out_dt == "int16":
        assert _np(ty).max() == 32767 and _np(ty).min() == -32767


def test_skew_pair_rejects_mismatched_operands():
    x = torch.zeros((2, 5, 4))
    with pytest.raises(ValueError, match="shapes differ"):
        tskew.skew_pair(x, torch.zeros((2, 5, 3)))
    with pytest.raises(ValueError, match="dtypes differ"):
        tskew.skew_pair(x, torch.zeros((2, 5, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="quant_scale"):
        tskew.skew(x, torch.int16)
    with pytest.raises(ValueError, match="not supported"):
        DTypeMenu.make(d="int16")
    with pytest.raises(ValueError, match="not supported"):
        DTypeMenu.make(stream=torch.float16)


@pytest.mark.parametrize("dtype", ["bfloat16", "int16"])
def test_unskew_matches_unskew_output(dtype):
    """The unskew of a bfloat16 stream widens to float32, of an int16
    expectation stream dequantizes at 1/32767, as
    ``dp_bm.unskew_output``."""
    B, N, M = 2, 16, 12
    rng = np.random.default_rng(3)
    E = rng.uniform(0, 1, (B, N, M)).astype(np.float32)
    jE = jnp.asarray(E)
    if dtype == "int16":
        js = skew_bm.skew_bm(jE, out_dtype=jnp.int16, quant_scale=32767.0)
        ts = tskew.skew(torch.tensor(E), torch.int16, 32767.0)
    else:
        js = skew_bm.skew_bm(jE, out_dtype=jnp.bfloat16)
        ts = tskew.skew(torch.tensor(E), torch.bfloat16)
    want = np.asarray(dp_bm.unskew_output(js, N, M, B))
    got = tskew.unskew(ts, N, M)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the DP passes under each menu
# ---------------------------------------------------------------------------

# "fast" runs the training passes under d=bf16 alone (its int16 e is the
# decode's only), so it stands for the d_bf16 menu's passes as well
@pytest.mark.parametrize("name", ["stream_i16", "fast", "all_bf16"])
def test_passes_match_pallas_bm(monkeypatch, name):
    """forward / backward (with the gap) / adjoint forward / adjoint
    backward of the plain passes against ``forward_bm``,
    ``backward_bm``, ``adjoint_forward_bm``, ``adjoint_backward_bm``, and
    the decode against ``decode_stream_bm`` (for the menus with an ``e``;
    the others store E as the backward does), under one menu: stored
    dtypes, stored values, E, vt and the traceback states."""
    monkeypatch.setattr(dp_bm, "DECODE_PHASES", 1)
    jmenu = dp_bm.DTypeMenu.make(**MENUS[name])
    menu = DTypeMenu.make(**MENUS[name])
    theta, A, ln, lm = _problem(len(name), N=16, M=12)
    B, N, M = theta.shape
    cells = _cells(ln, lm)
    jl, jm = jnp.asarray(ln), jnp.asarray(lm)
    tl, tm = torch.tensor(ln), torch.tensor(lm)
    kw = dict(mode="nw", operator="softmax")
    rng = np.random.default_rng(1)
    Zt = rng.standard_normal((B, N, M)).astype(np.float32)
    Za = rng.standard_normal((B, N, M)).astype(np.float32)

    # forward: the skewed inputs (exact), vt, Dx and Dm
    jth = dp_bm.skew_input(jnp.asarray(theta), dtypes=jmenu)
    jA = dp_bm.skew_input(jnp.asarray(A), dtypes=jmenu)
    sdt = menu.stream_dtype
    th_s = tskew.skew(torch.tensor(theta), sdt, menu.stream_scale)
    A_s = tskew.skew(torch.tensor(A), sdt, menu.stream_scale)
    for t, j in ((th_s, jth), (A_s, jA)):
        b, r, s = cells
        assert np.array_equal(_np(t)[cells], _np(j)[r % j.shape[0], s, b])
    jvt, (jdx, jdm) = dp_bm.forward_bm(jth, jA, jl, jm, dtypes=jmenu)
    vt, dx, dm = dp_ref.forward(th_s, A_s, tl, tm, dtypes=menu, **kw)
    ddt = menu.d_dtype or torch.float32
    assert dx.dtype == dm.dtype == ddt == _TORCH[jdx.dtype.type]
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        dp_ref.forward_score(th_s, A_s, tl, tm, dtypes=menu, **kw), vt)
    for t, j in ((dx, jdx), (dm, jdm)):
        _same_stored(_np(t)[cells], _jcells(j, cells), ddt)

    # backward with the gap output, from JAX's residuals
    px, pm = _to_port(jdx, B, N, M), _to_port(jdm, B, N, M)
    Et = torch.ones(B)
    jE, jEA = dp_bm.backward_bm(jnp.ones(B, jnp.float32), (jdx, jdm), jl, jm,
                                want_gap=True, dtypes=jmenu)
    E, EA = dp_ref.backward(px, pm, tl, tm, Et, want_gap=True, dtypes=menu,
                            **kw)
    edt = {None: torch.float32, "int16": torch.float32}.get(
        menu.e, menu.e_dtype)           # the training E: never int16
    assert E.dtype == EA.dtype == edt == _TORCH[jE.dtype.type]
    for t, j in ((E, jE), (EA, jEA)):
        _same_stored(_np(t)[cells], _jcells(j, cells), edt)

    # adjoint forward with and without Za, float cotangent streams
    jzt = dp_bm.skew_cotangent(jnp.asarray(Zt), dtypes=jmenu)
    jza = dp_bm.skew_cotangent(jnp.asarray(Za), dtypes=jmenu)
    zdt = menu.cotangent_dtype
    zt_s = tskew.skew(torch.tensor(Zt), zdt)
    za_s = tskew.skew(torch.tensor(Za), zdt)
    assert zt_s.dtype == _TORCH[jzt.dtype.type] != torch.int16
    jvtd, (jdxd, jdmd) = dp_bm.adjoint_forward_bm((jdx, jdm), jzt, jza, jl,
                                                  jm, dtypes=jmenu)
    vtd, dxd, dmd = dp_ref.adjoint_forward(px, pm, zt_s, za_s, tl, tm,
                                           dtypes=menu, **kw)
    assert dxd.dtype == dmd.dtype == ddt
    np.testing.assert_allclose(vtd.numpy(), np.asarray(jvtd), rtol=RTOL,
                               atol=ATOL)
    for t, j in ((dxd, jdxd), (dmd, jdmd)):
        _same_stored(_np(t)[cells], _jcells(j, cells), ddt)
    _, nxd, _ = dp_ref.adjoint_forward(px, pm, zt_s, None, tl, tm,
                                       dtypes=menu, **kw)
    assert nxd.dtype == ddt

    # adjoint backward from JAX's E and tangent residuals
    jEd, jEdA = dp_bm.adjoint_backward_bm(jE, (jdx, jdm), (jdxd, jdmd), jl,
                                          jm, dtypes=jmenu)
    Ed, EdA = dp_ref.adjoint_backward(
        px, pm, _to_port(jdxd, B, N, M), _to_port(jdmd, B, N, M),
        _to_port(jE, B, N, M), tl, tm, dtypes=menu, **kw)
    assert Ed.dtype == EdA.dtype == edt == _TORCH[jEd.dtype.type]
    for t, j in ((Ed, jEd), (EdA, jEdA)):
        _same_stored(_np(t)[cells], _jcells(j, cells), edt)

    # the decode: E stored in e (int16 allowed), and its tracebacks;
    # without an e it stores what the backward above stored
    if menu.e is None:
        return
    seg = dp_bm.decode_stream_bm(jnp.asarray(theta), jnp.asarray(A), jl, jm,
                                 jnp.ones(B, jnp.float32), dtypes=jmenu)
    seg = jax.tree_util.tree_map(np.asarray, seg)
    Es = tdp.expected_alignment_stream(torch.tensor(theta), torch.tensor(A),
                                       (ln, lm), dtypes=menu)
    assert Es.dtype == (menu.e_dtype or torch.float32) == \
        _TORCH[seg["seg"][0].dtype.type]
    want = seg["seg"][0][cells[1], cells[2] - int(seg["w0"][0]), cells[0]]
    _same_stored(_np(Es)[cells], _np(want), Es.dtype)
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        assert tdp.traceback_stream(Es, n, m, b) == \
            jdp.traceback_stream(seg, n, m, b, backend="pallas_bm")


def _agreement(s1, s2):
    return sum(a == b for a, b in zip(s1, s2)) / max(len(s1), len(s2))


@pytest.mark.parametrize("name,gate", [("d_bf16", 5e-3),
                                       ("stream_i16", 2e-3),
                                       ("fast", 5e-3)])
def test_menu_decode_gates_against_fp32(name, gate):
    """JAX's own gates, on the port: the decode under a menu against
    float32 storage, E error below the gate and traceback agreement >=
    0.97 (tests/test_bf16_streams.py, tests/test_i16_streams.py)."""
    theta, A, ln, lm = _problem(11, B=2, N=24, M=22)
    ln[:], lm[:] = 24, 22
    args = (torch.tensor(theta), torch.tensor(A), (ln, lm))
    E32 = tdp.expected_alignment_stream(*args)
    E16 = tdp.expected_alignment_stream(*args,
                                        dtypes=DTypeMenu.make(**MENUS[name]))
    cells = _cells(ln, lm)
    err = np.max(np.abs(tdp._host(E16)[cells] - E32.numpy()[cells]))
    assert err < gate
    for b in range(2):
        assert _agreement(tdp.traceback_stream(E16, 24, 22, b),
                          tdp.traceback_stream(E32, 24, 22, b)) >= 0.97


# ---------------------------------------------------------------------------
# the dispatcher: autograd under a menu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["d_bf16", "stream_i16"])
def test_dispatcher_grads_match_jax(monkeypatch, name):
    """Through the dispatcher under a menu, against ``deepblast_tpu.ops.dp``
    with ``backend="pallas_bm"`` and the same menu (its training kernels in
    interpret mode, one phase: tests/test_dp_bm_phased.py shows the phase
    plan does not change the result): ``alignment_score``, its gradient
    (first order, = ``expected_alignment`` with the gap output) and the
    gradient of ``<E, Zt> + <EA, Za>`` (second order, the adjoint passes).
    rtol 2e-5 / atol 2e-6, the float32 tolerance: both sides round the
    same float32 values to bf16 or int16 here (the largest deviation is
    under a tenth of it).  The same port calls without the menu fall
    outside it (by 10x under int16 inputs, 170x under bf16 residuals), so
    a dispatcher that lost the menu on its way to the passes fails; the
    residuals the VJP saves are in the menu's ``d``."""
    monkeypatch.setattr(dp_bm_train, "TRAIN_PHASES", 1)
    theta, A, ln, lm = _problem(5, B=2, N=12, M=10)
    jmenu = dp_bm.DTypeMenu.make(**MENUS[name])
    menu = DTypeMenu.make(**MENUS[name])
    rng = np.random.default_rng(2)
    Zt = rng.standard_normal(theta.shape).astype(np.float32)
    Za = rng.standard_normal(theta.shape).astype(np.float32)
    lens = (jnp.asarray(ln), jnp.asarray(lm))
    jkw = dict(backend="pallas_bm", dtypes=jmenu)

    def jloss(t, a):
        E, EA = jdp.expected_alignment(t, a, lens, return_gap=True, **jkw)
        return jnp.sum(E * Zt) + jnp.sum(EA * Za), (E, EA)

    jt, ja = jnp.asarray(theta), jnp.asarray(A)
    (_, jE), jg = jax.value_and_grad(jloss, (0, 1), has_aux=True)(jt, ja)
    want = [np.asarray(w) for w in
            (jdp.alignment_score(jt, ja, lens, **jkw), *jE, *jE, *jg)]

    def port(dtypes):
        t = torch.tensor(theta, requires_grad=True)
        a = torch.tensor(A, requires_grad=True)
        vt = tdp.alignment_score(t, a, (ln, lm), dtypes=dtypes)
        g1 = torch.autograd.grad(vt.sum(), (t, a))
        E, EA = tdp.expected_alignment(t, a, (ln, lm), return_gap=True,
                                       dtypes=dtypes)
        assert E.dtype == EA.dtype == torch.float32
        saved = [x.dtype for x in E.grad_fn.saved_tensors[3:]]
        g2 = torch.autograd.grad((E * torch.tensor(Zt)).sum()
                                 + (EA * torch.tensor(Za)).sum(), (t, a))
        return [x.detach().numpy() for x in (vt, *g1, E, EA, *g2)], saved

    got, saved = port(menu)
    assert saved == [menu.d_dtype or torch.float32] * 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    f32, _ = port(None)
    assert not all(np.allclose(g, w, rtol=RTOL, atol=ATOL)
                   for g, w in zip(f32, want))


def test_cotangents_skew_in_float_under_int16_streams(monkeypatch):
    """Under ``stream="int16"`` the inputs are skewed to int16 and the
    cotangents Zt, Za to float (their own type), never through the
    saturating fixed point (``dp_bm.skew_cotangent``)."""
    theta, A, ln, lm = _problem(8, B=2, N=10, M=9)
    seen = []
    pair = dp_ref.skew_pair

    def spy(x, y, out_dtype=None, quant_scale=None):
        out = pair(x, y, out_dtype, quant_scale)
        seen.extend(o.dtype for o in out)
        return out

    monkeypatch.setattr(dp_ref, "skew_pair", spy)
    t = torch.tensor(theta, requires_grad=True)
    E, EA = tdp.expected_alignment(t, torch.tensor(A), (ln, lm),
                                   return_gap=True,
                                   dtypes=DTypeMenu.make(stream="int16"))
    assert seen == [torch.int16, torch.int16]
    (1e4 * (E * E).sum() + EA.sum()).backward()
    assert seen[2:] == [torch.float32, torch.float32]
    assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 1.0


def test_q_backend_ignores_the_menu():
    """The Q backends take no menu (the JAX package registers none for
    them): the same outputs with and without one."""
    theta, A, ln, lm = _problem(9, B=2, N=12, M=10)
    menu = DTypeMenu.make(stream="int16", d="bfloat16", e="int16")
    out = []
    for dtypes in (None, menu):
        t = torch.tensor(theta, requires_grad=True)
        E = tdp.expected_alignment(t, torch.tensor(A), (ln, lm),
                                   backend="pallas_long", dtypes=dtypes)
        (E * E).sum().backward()
        out.append((E.detach(), t.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# the pair skew in the dispatcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [None, "stream_i16", "all_bf16"])
def test_dispatcher_skew_pair_equals_two_skews(monkeypatch, name):
    """The default backend skews (theta, A), and (Zt, Za) where there is a
    Za, through ``skew_pair``; every output equals a run in which each
    pair is two single skews (the JAX package's gate-off form)."""
    theta, A, ln, lm = _problem(4, B=2, N=12, M=11)
    menu = None if name is None else DTypeMenu.make(**MENUS[name])
    calls = []
    pair = dp_ref.skew_pair

    def spy(*a, **k):
        calls.append(a[0].shape)
        return pair(*a, **k)

    def two_skews(x, y, out_dtype=None, quant_scale=None):
        return (dp_ref.skew(x, out_dtype, quant_scale),
                dp_ref.skew(y, out_dtype, quant_scale))

    def run():
        t = torch.tensor(theta, requires_grad=True)
        a = torch.tensor(A, requires_grad=True)
        vt = tdp.alignment_score(t, a, (ln, lm), dtypes=menu)
        g = torch.autograd.grad(vt.sum(), (t, a), create_graph=True)
        E, EA = tdp.expected_alignment(t, a, (ln, lm), return_gap=True,
                                       dtypes=menu)
        g2 = torch.autograd.grad((E * E).sum() + (EA * g[0]).sum(), (t, a))
        Es = tdp.expected_alignment_stream(t.detach(), a.detach(), (ln, lm),
                                           dtypes=menu)
        return [x.detach() for x in (vt, *g, E, EA, *g2, Es)]

    monkeypatch.setattr(dp_ref, "skew_pair", spy)
    paired = run()
    # theta/A: the score, its gradient (an expected alignment), the
    # expected alignment, the stream; Zt/Za: the VJP of (E, EA) (the
    # score gradient's VJP has no Za: g[1] is not in the loss)
    assert len(calls) == 5
    monkeypatch.setattr(dp_ref, "skew_pair", two_skews)
    single = run()
    for x, y in zip(single, paired):
        assert torch.equal(x, y)
