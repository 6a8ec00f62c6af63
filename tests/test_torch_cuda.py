"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (an H100: the kernels are built for sm_90a) and
skip without one — a CUDA kernel has no CPU mode.  Run them on the card
with ``python -m pytest tests/test_torch_cuda.py -q``.

Tolerance: those of ``chip_smoke.check_kernels`` and
``chip_smoke.check_autograd``, which these tests call so that the smoke
and the tests hold the kernels to one check: skew, unskew, adjoint
forward (vtd, Dxd, Dmd) and adjoint backward (Ed, EdA) exact; forward
(Vt, Dx, Dm), score-only forward and backward (E, EA) rtol 1e-4 / atol
1e-5 (fp32; the kernels round each cell as the plain version does, so
only transcendental ulps could differ); tracebacks identical; autograd
through the kernels = through the plain passes on the card (same
tolerance) and = on the CPU to 1e-4 of each output's largest magnitude.
The Q-stream kernels of the ``pallas_long`` backend, each pair split
across a thread-block cluster, are held bit for bit
(``chip_smoke.check_q_kernels``), also past the shared-memory limit the
default adjoint backward had before it kept its rows in registers, where
the default backend now trains and matches them; all four, every
instance, also with every cluster size forced at the edges of the split
(``chip_smoke.SPLIT_EDGE_SLOTS``), at S = 19,801 (past the 19,370 slots
the first Q backward and adjoint forward held) and at their limit (S =
32,768), one slot past which each refuses; a ``pallas_long`` training
step past S = 19,370 equals the plain passes bit for bit.  The bf16 Q
instances (``ops.dp.Q_DTYPE``) are held the same way, bit for bit: at the
wrapper's cluster size, at every cluster size at the split's edges, and
at S = 32,768.  Every
storage form of the default kernels (the
menus of ``chip_smoke.MENUS``: bf16 and int16 inputs, bf16 residuals,
bf16 and int16 expectations) and the pair skew are held to their plain
versions by ``chip_smoke.check_menu_kernels`` (the same tolerance, stored
values compared as float32; the relayouts exactly, the pair = two single
skews), and a stream of another type than its menu gives it raises.
The redesigned kernels (the skew, the pair skew and the unskew, tiled;
the strip kernels: the forward, the score-only forward, the adjoint
forward with and without Za, the backward and the adjoint backward, the
last on the training E and on an E that is noise at every slot) are
held bit for bit (max abs diff 0.0) to their plain
versions at the shapes of their design's edges (``chip_smoke.EDGE_SHAPES``:
N = 1, M = 1, S not a multiple of the strip or the tile, n < m and n > m,
S past 1,024 slots, whole diagonals of padding, the wider strips, S at
each kernel's limit) in float32 and every storage form
(``chip_smoke.check_passes``), the skew also at the long path's shapes,
and one slot past its limit each wrapper raises the error that names it.
The BiLM and the RNN heads (cuDNN's LSTM, TF32 off) equal their CPU run to
1e-4 of scale, gradients included, and torch's second LSTM bias stays
zero through AdamW steps on the card.
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import ATOL, RTOL
from deepblast_torch.ops import dp as dp_ops
from deepblast_torch.ops import dp_cuda, dp_ref
from deepblast_torch.ops.menu import DTypeMenu
from deepblast_torch.ops.skew import skew as plain_skew
import torch_threads  # noqa: F401  (PyTorch threads a worker)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the DP kernels run only on the card")
    return torch.device("cuda")


def _problem(seed, B, N, M, device):
    rng = np.random.default_rng(seed)
    theta = torch.tensor(rng.standard_normal((B, N, M)), dtype=torch.float32)
    A = torch.tensor(rng.standard_normal((B, N, M)) - 1.0,
                     dtype=torch.float32)
    ln = rng.integers(3, N + 1, size=B)
    lm = rng.integers(3, M + 1, size=B)
    ln[0], lm[0] = N, M
    i32 = dict(dtype=torch.int32, device=device)
    return (theta.to(device), A.to(device), torch.tensor(ln, **i32),
            torch.tensor(lm, **i32))


@pytest.mark.parametrize("B,N,M", [(3, 24, 17), (2, 40, 96), (5, 130, 70)])
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_kernels_match_plain(cuda, B, N, M, mode, operator):
    """chip_smoke's kernel check (outputs over NaN-filled memory, every
    kernel against its plain version, tracebacks) at these shapes."""
    theta, A, ln, lm = _problem(B * N + M, B, N, M, cuda)
    errs = {}
    chip_smoke.check_kernels(theta, A, ln, lm, mode, operator, errs)
    assert set(errs) == set(chip_smoke.KERNELS)


@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_autograd_through_kernels(cuda, mode, operator):
    theta, A, ln, lm = _problem(11, 3, 40, 29, cuda)
    errs = {}
    chip_smoke.check_autograd(theta, A, ln, lm, mode, operator, errs)
    assert errs["autograd"] == 0.0


def test_kernels_past_48kb_of_shared_memory(cuda):
    """S = 701 slots, where the adjoint backward's first version (20 rows
    of shared memory, 56 KB) needed the opt-in past 48 KB: every kernel
    at a pair of 22 warps of strips of 2."""
    theta, A, ln, lm = _problem(5, 2, 700, 90, cuda)
    errs = {}
    chip_smoke.check_kernels(theta, A, ln, lm, "nw", "softmax", errs)
    assert set(errs) == set(chip_smoke.KERNELS)


def test_dispatcher_launches_kernels(cuda):
    """On CUDA tensors the dispatcher runs the kernels (counted), and its
    results equal the plain run of the same inputs on the CPU."""
    theta, A, ln, lm = _problem(7, 3, 33, 21, cuda)
    before = dict(dp_cuda.LAUNCHES)
    vt = dp_ops.alignment_score(theta, A, (ln, lm))
    E = dp_ops.expected_alignment_stream(theta, A, (ln, lm))
    after = dp_cuda.LAUNCHES
    assert after["skew_pair"] - before["skew_pair"] == 2
    assert after["skew"] - before["skew"] == 0
    assert after["forward_score"] - before["forward_score"] == 1
    assert after["forward"] - before["forward"] == 1
    assert after["backward"] - before["backward"] == 1
    args = (theta.cpu(), A.cpu(), (ln.cpu(), lm.cpu()))
    torch.testing.assert_close(vt.cpu(), dp_ops.alignment_score(*args),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(E.cpu(),
                               dp_ops.expected_alignment_stream(*args),
                               rtol=RTOL, atol=ATOL)

    # the training step: pair skew of theta and A, skew of the cotangent;
    # forward, backward, unskew; the two adjoints and two unskews
    t = theta.clone().requires_grad_()
    before = dict(dp_cuda.LAUNCHES)
    aln = dp_ops.expected_alignment(t, A, (ln, lm))
    (aln * aln).sum().backward()
    want = {"skew_pair": 1, "skew": 1, "forward": 1, "backward": 1, "unskew": 3,
            "adjoint_forward": 1, "adjoint_backward": 1, "forward_score": 0}
    assert {k: dp_cuda.LAUNCHES[k] - before[k] for k in want} == want


def test_wrappers_check_inputs(cuda):
    x = torch.zeros((2, 5, 4), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        dp_cuda.skew(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        dp_cuda.skew(x.transpose(1, 2))
    s = dp_cuda.skew(x)
    n = torch.full((2,), 5, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        dp_cuda.forward(s, s, n, n)
    with pytest.raises(ValueError, match="does not hold"):
        dp_cuda.unskew(s, 4, 4)
    n = n.to(torch.int32)
    with pytest.raises(ValueError, match="shape"):
        dp_cuda.adjoint_forward(s, s, s[:1], None, n, n)
    with pytest.raises(TypeError, match="float32"):
        dp_cuda.adjoint_backward(s, s, s, s, s.double(), n, n)


@pytest.mark.parametrize("B,N,M", [(3, 24, 17), (5, 130, 70)])
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_q_kernels_match_plain(cuda, B, N, M, mode, operator):
    """chip_smoke's Q kernel check (outputs over NaN-filled memory, every
    Q kernel against its plain version, tracebacks) at these shapes."""
    theta, A, ln, lm = _problem(B * N + M + 1, B, N, M, cuda)
    errs = {}
    chip_smoke.check_q_kernels(theta, A, ln, lm, mode, operator, errs)
    assert set(errs) == set(chip_smoke.Q_KERNELS)


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_autograd_through_q_kernels(cuda, mode):
    theta, A, ln, lm = _problem(13, 3, 40, 29, cuda)
    errs = {}
    chip_smoke.check_autograd(theta, A, ln, lm, mode, "softmax", errs,
                              backend="pallas_long")
    assert errs["autograd"] == 0.0


def test_q_kernels_past_the_default_limit(cuda):
    """S = 3,001 slots, past the 2,905 the default adjoint backward held in
    shared memory before it kept its rows in registers: the Q kernels (at
    most 6 rows, 72 KB) run and equal their plain versions, and training
    through the default backend now runs and gives pallas_long's
    expected alignment and gradient (each to 1e-4 of its largest
    magnitude, as the autograd checks against another rounding); one slot
    past the reverse passes' strips (S = 6,145) the default backend
    refuses, naming the limit and backend="pallas_long"."""
    theta, A, ln, lm = _problem(17, 2, 3000, 40, cuda)
    errs = {}
    chip_smoke.check_q_kernels(theta, A, ln, lm, "nw", "softmax", errs)
    assert set(errs) == set(chip_smoke.Q_KERNELS)
    out = {}
    for backend in (None, "pallas_long"):
        t = theta.clone().requires_grad_()
        E = dp_ops.expected_alignment(t, A, (ln, lm), backend=backend)
        E.sum().backward()
        out[backend] = (E.detach(), t.grad)
    for got, want in zip(out[None], out["pallas_long"]):
        assert torch.isfinite(got).all()
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= ATOL + RTOL * scale
    x = torch.zeros((1, 6144, 2), device=cuda)
    n = torch.tensor([6144], dtype=torch.int32, device=cuda)
    m = torch.tensor([2], dtype=torch.int32, device=cuda)
    t = x.clone().requires_grad_()
    with pytest.raises(ValueError, match=r'S = 6145 .*S <= 6144 .*'
                                         r'backend="pallas_long"'):
        dp_ops.expected_alignment(t, x, (n, m)).sum().backward()


def test_q_kernels_refuse_past_their_limit(cuda):
    """S = 19,801 slots, past the 19,370 the first Q backward and Q adjoint
    forward held in three rows of shared memory: the four split kernels
    run and equal their plain versions bit for bit.  One slot past their
    limit (S = 32,769) each refuses before launching, naming its limit,
    the ``pallas_long`` step's (the same) and the ROADMAP item."""
    x = torch.zeros((1, 19800, 2), device=cuda)
    s = dp_cuda.skew(x)
    n = torch.tensor([19800], dtype=torch.int32, device=cuda)
    m = torch.tensor([2], dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(19801)
    th_s = torch.randn(s.shape, generator=g, device=cuda)
    vt, *qs = dp_ref.forward_q(th_s, s, n, m)
    for got, w in zip(dp_cuda.forward_q(th_s, s, n, m), (vt, *qs)):
        assert torch.equal(got, w)
    Et = torch.ones((1,), device=cuda)
    for got, w in zip(dp_cuda.backward_q(*qs, n, m, Et, want_gap=True),
                      dp_ref.backward_q(*qs, n, m, Et, want_gap=True)):
        assert torch.equal(got, w)
    zt, za = (torch.randn(s.shape, generator=g, device=cuda)
              for _ in range(2))
    want = dp_ref.adjoint_forward_q(*qs, zt, za, n, m)
    for got, w in zip(dp_cuda.adjoint_forward_q(*qs, zt, za, n, m), want):
        assert torch.equal(got, w)
    E = torch.randn(s.shape, generator=g, device=cuda)
    qds = want[1:]
    for got, w in zip(dp_cuda.adjoint_backward_q(*qs, *qds, E, n, m),
                      dp_ref.adjoint_backward_q(*qs, *qds, E, n, m)):
        assert torch.equal(got, w)
    del x, s, th_s, qs, zt, za, want, qds, E
    most = dp_cuda.CLUSTER_SLOTS["adjoint_backward_q"]
    assert set(dp_cuda.CLUSTER_SLOTS.values()) == {most}
    s = torch.zeros((1, 2, most + 1), device=cuda)
    n = torch.tensor([most], dtype=torch.int32, device=cuda)
    before = dict(dp_cuda.LAUNCHES)
    for call in (lambda: dp_cuda.forward_q(s, s, n, m),
                 lambda: dp_cuda.backward_q(s, s, s, n, m, Et),
                 lambda: dp_cuda.adjoint_forward_q(s, s, s, s, None, n, m),
                 lambda: dp_cuda.adjoint_backward_q(s, s, s, s, s, s, s, n,
                                                    m)):
        with pytest.raises(ValueError, match=rf"S = {most + 1} .*S <= "
                                             rf"{most} .*pallas_long "
                                             rf"training step.*S <= {most} "
                                             r".*ROADMAP.md queue A item 4"):
            call()
    assert dp_cuda.LAUNCHES == before


def test_pallas_long_step_past_the_first_limit(cuda):
    """A ``pallas_long`` training step on a pair of 19,800 x 40 (S =
    19,801, past the 19,370 slots the first Q backward and adjoint
    forward held): E and both gradients equal the plain passes' bit for
    bit, and every Q kernel ran (``chip_smoke.long_step_past``)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(19800)
    errs = {}
    chip_smoke.long_step_past(g, errs)
    assert errs == {"pallas_long_step": 0.0}


@pytest.mark.parametrize("S", chip_smoke.SPLIT_EDGE_SLOTS)
@pytest.mark.parametrize("mode,operator", [("nw", "softmax"),
                                           ("sw", "sparsemax"),
                                           ("nw", "hardmax")])
def test_split_q_kernels_at_every_cluster_size(cuda, S, mode, operator):
    """The four split Q kernels, every instance (the backward with and
    without EA, the adjoint forward with and without Za, the adjoint
    backward on the backward's E and on noise), bit for bit against their
    plain versions with every cluster size of ``dp_cuda.Q_CLUSTERS``
    forced, at the slots of the split's edges
    (``chip_smoke.SPLIT_EDGE_SLOTS``); a size whose CTAs cannot hold the
    pair is refused before launching."""
    g = torch.Generator(device=cuda)
    g.manual_seed(S)
    prob = chip_smoke.split_problem(g, S, mode, operator)
    for C in dp_cuda.Q_CLUSTERS:
        if C * 1024 * dp_cuda.Q_STRIP < S:
            before = dict(dp_cuda.LAUNCHES)
            with pytest.raises(ValueError, match="does not fit"):
                chip_smoke.check_split(prob, mode, operator, C, {})
            assert dp_cuda.LAUNCHES == before
            continue
        errs = {}
        split = chip_smoke.check_split(prob, mode, operator, C, errs)
        assert errs == dict.fromkeys(chip_smoke.Q_KERNELS, 0.0)
        assert set(split) == set(chip_smoke.Q_KERNELS)
        assert {v["C"] for v in split.values()} == {C}


def test_split_q_kernels_at_their_limit(cuda):
    """S = 32,768, the split kernels' limit, at the wrapper's own cluster
    size: all four bit for bit; one slot further each refuses."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    errs = {}
    split, msgs = chip_smoke.check_split_limit(g, errs)
    assert errs == dict.fromkeys(chip_smoke.Q_KERNELS, 0.0)
    assert set(split) == set(chip_smoke.Q_KERNELS) and len(msgs) == 4
    assert all(v["S"] == dp_cuda.CLUSTER_SLOTS[k] for k, v in split.items())


BF16_Q = [chip_smoke.q_name(k, torch.bfloat16) for k in chip_smoke.Q_KERNELS]


@pytest.mark.parametrize("mode,operator", [("nw", "softmax"),
                                           ("sw", "sparsemax"),
                                           ("nw", "hardmax")])
def test_q_kernels_with_bf16_q_match_plain(cuda, mode, operator):
    """The bf16 Q instances (``ops.dp.Q_DTYPE = torch.bfloat16``) at the
    wrapper's cluster size: the forward's rounded Q streams and every
    pass that reads them, bit for bit against the plain passes with
    ``q_dtype=torch.bfloat16`` (chip_smoke's Q check)."""
    theta, A, ln, lm = _problem(29 + len(operator), 5, 130, 70, cuda)
    errs = {}
    chip_smoke.check_q_kernels(theta, A, ln, lm, mode, operator, errs,
                               q_dtype=torch.bfloat16)
    assert errs == dict.fromkeys(BF16_Q, 0.0)


@pytest.mark.parametrize("S", chip_smoke.SPLIT_EDGE_SLOTS)
@pytest.mark.parametrize("mode,operator", [("nw", "softmax"),
                                           ("sw", "sparsemax"),
                                           ("nw", "hardmax")])
def test_split_q_kernels_with_bf16_q_at_every_cluster_size(cuda, S, mode,
                                                           operator):
    """Every bf16 Q instance bit for bit at every cluster size that holds
    the pair, forced, at the split's edges."""
    g = torch.Generator(device=cuda)
    g.manual_seed(S + 1)
    prob = chip_smoke.split_problem(g, S, mode, operator, torch.bfloat16)
    for C in dp_cuda.Q_CLUSTERS:
        if C * 1024 * dp_cuda.Q_STRIP >= S:
            errs = {}
            split = chip_smoke.check_split(prob, mode, operator, C, errs)
            assert errs == dict.fromkeys(BF16_Q, 0.0)
            assert {v["C"] for v in split.values()} == {C}


def test_split_q_kernels_with_bf16_q_at_their_limit(cuda):
    """The bf16 Q instances at S = 32,768 at the wrapper's cluster size,
    bit for bit; the limit is the float32 instances' (registers, not Q
    bytes, bound it)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    errs = {}
    split, msgs = chip_smoke.check_split_limit(g, errs, torch.bfloat16)
    assert errs == dict.fromkeys(BF16_Q, 0.0) and len(msgs) == 4
    assert set(split) == set(BF16_Q)
    assert all(v["S"] == dp_cuda.CLUSTER_SLOTS[k]
               for k, v in zip(chip_smoke.Q_KERNELS, map(split.get, BF16_Q)))


def test_q_wrappers_take_one_q_dtype(cuda):
    """The Q streams of one pass are all float32 or all bf16; the forward
    stores no other type; outputs stay float32."""
    x = torch.zeros((2, 5, 4), device=cuda)
    s = dp_cuda.skew(x)
    b = s.to(torch.bfloat16)
    n = torch.full((2,), 5, dtype=torch.int32, device=cuda)
    m = torch.full((2,), 4, dtype=torch.int32, device=cuda)
    et = torch.ones(2, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dp_cuda.forward_q(s, s, n, m, q_dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        dp_cuda.backward_q(b, s, b, n, m, et)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dp_cuda.backward_q(*(s.half(),) * 3, n, m, et)
    with pytest.raises(TypeError, match="float32"):
        dp_cuda.adjoint_backward_q(b, b, b, b, s, s, s, n, m)
    E, EA = dp_cuda.backward_q(b, b, b, n, m, et, want_gap=True)
    assert E.dtype == EA.dtype == torch.float32


def test_cluster_size_rule(cuda):
    """The rule's picks: one CTA a pair at the bench shape, 16 at the long
    decode and the long training batch (the largest size the device
    launches), never fewer than the pair needs."""
    pick = lambda B, S: dp_cuda._cluster_size("forward_q", "softmax", B, S,
                                              cuda)
    assert pick(256, 513) == 1
    assert pick(8, 4097) == pick(2, 3901) == max(
        c for c in dp_cuda.Q_CLUSTERS if c * 1024 * 2 >= 4097 and
        dp_cuda._max_clusters("forward_q", "softmax", 4097, c, cuda) > 0)
    assert pick(256, 4097) == 4
    assert pick(1, dp_cuda.CLUSTER_SLOTS["forward_q"]) == 16
    for name in chip_smoke.Q_KERNELS:
        for variant in (False, True):
            for q_dtype in dp_cuda.Q_DTYPES:
                rule = lambda B, S: dp_cuda._cluster_size(
                    name, "softmax", B, S, cuda, variant, q_dtype)
                assert rule(256, 513) == 1
                assert rule(1, dp_cuda.CLUSTER_SLOTS[name]) == 16


def test_q_wrappers_check_inputs(cuda):
    x = torch.zeros((2, 5, 4), device=cuda)
    s = dp_cuda.skew(x)
    n = torch.full((2,), 5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        dp_cuda.forward_q(s, s[:1], n, n)
    with pytest.raises(ValueError, match="int32"):
        dp_cuda.backward_q(s, s, s, n.long(), n, torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        dp_cuda.backward_q(s, s, s, n, n, torch.ones(3, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        dp_cuda.adjoint_forward_q(s, s, s, s, s.double(), n, n)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dp_cuda.adjoint_backward_q(s, s, s, s, s, s, s.cpu(), n, n)
    with pytest.raises(ValueError, match="contiguous"):
        dp_cuda.forward_q(s.transpose(1, 2).contiguous().transpose(1, 2),
                          s, n, n)


@pytest.mark.parametrize("menu", sorted(chip_smoke.MENUS))
@pytest.mark.parametrize("mode,operator", [("nw", "softmax"),
                                           ("sw", "sparsemax"),
                                           ("nw", "hardmax")])
def test_menu_kernels_match_plain(cuda, menu, mode, operator):
    """chip_smoke's storage-form check (every kernel instance of the menu,
    the pair skew, the decode's int16 E and its traceback)."""
    theta, A, ln, lm = _problem(len(menu) + len(operator), 3, 40, 29, cuda)
    errs = {}
    chip_smoke.check_menu_kernels(theta, A, ln, lm, mode, operator,
                                  DTypeMenu.make(**chip_smoke.MENUS[menu]),
                                  errs)
    assert set(errs) == set(chip_smoke.KERNELS)


@pytest.mark.parametrize("out_dtype,scale", [(None, None),
                                             (torch.bfloat16, None),
                                             (torch.int16, 2047.9375)])
def test_skew_pair_is_two_skews(cuda, out_dtype, scale):
    """One launch, bit-identical to two single skews and to the plain
    pair, at a shape that is not a multiple of the block size."""
    theta, A, _, _ = _problem(21, 3, 131, 77, cuda)
    A = A * 40.0                                  # saturates as int16
    before = dict(dp_cuda.LAUNCHES)
    px, py = dp_cuda.skew_pair(theta, A, out_dtype, scale)
    assert dp_cuda.LAUNCHES["skew_pair"] - before["skew_pair"] == 1
    assert dp_cuda.LAUNCHES["skew"] == before["skew"]
    for got, x in ((px, theta), (py, A)):
        assert torch.equal(got, dp_cuda.skew(x, out_dtype, scale))
        assert torch.equal(got, plain_skew(x, out_dtype, scale))


def test_menu_autograd_through_kernels(cuda):
    """Autograd under bf16 residuals (the training default) through the
    kernels = through the plain passes on the card."""
    theta, A, ln, lm = _problem(23, 3, 40, 29, cuda)
    errs = {}
    chip_smoke.check_autograd(theta, A, ln, lm, "nw", "softmax", errs,
                              dtypes=DTypeMenu.make(d="bfloat16"))
    assert errs["autograd"] == 0.0


def test_dispatcher_launches_skew_pair(cuda, monkeypatch):
    """theta/A (and Zt/Za with a Za) go through one pair launch, the
    single skew runs only for the lone cotangent, and the outputs equal a
    run in which each pair is two single skew launches."""
    theta, A, ln, lm = _problem(29, 3, 50, 41, cuda)
    menu = DTypeMenu.make(stream="int16", d="bfloat16", e="int16")

    def run():
        t = theta.clone().requires_grad_()
        a = A.clone().requires_grad_()
        E, EA = dp_ops.expected_alignment(t, a, (ln, lm), return_gap=True,
                                          dtypes=menu)
        ((E * E).sum() + EA.sum()).backward()
        aln = dp_ops.expected_alignment(t, a, (ln, lm), dtypes=menu)
        (aln * aln).sum().backward()
        Es = dp_ops.expected_alignment_stream(theta, A, (ln, lm),
                                              dtypes=menu)
        return E, EA, t.grad, a.grad, Es

    before = dict(dp_cuda.LAUNCHES)
    paired = run()
    used = {k: dp_cuda.LAUNCHES[k] - before[k] for k in ("skew", "skew_pair")}
    # pairs: two forwards, one (Zt, Za), the stream; single: the lone Zt
    assert used == {"skew_pair": 4, "skew": 1}
    skew = dp_cuda.skew
    monkeypatch.setattr(dp_cuda, "skew_pair",
                        lambda x, y, **k: (skew(x, **k), skew(y, **k)))
    for x, y in zip(run(), paired):
        assert torch.equal(x, y)


def test_menu_wrappers_check_dtypes(cuda):
    """A stream of another type than the menu gives it raises; nothing is
    cast."""
    theta, A, ln, lm = _problem(31, 2, 12, 9, cuda)
    f32 = dp_cuda.skew(theta)
    i16 = DTypeMenu.make(stream="int16", e="int16")
    bf = DTypeMenu.make(d="bfloat16")
    with pytest.raises(TypeError, match="int16"):
        dp_cuda.forward(f32, f32, ln, lm, dtypes=i16)
    _, dx, dm = dp_cuda.forward(f32, f32, ln, lm)
    with pytest.raises(TypeError, match="bfloat16"):
        dp_cuda.backward(dx, dm, ln, lm, torch.ones(2, device=cuda),
                         dtypes=bf)
    with pytest.raises(TypeError, match="float32"):
        dp_cuda.adjoint_forward(dx, dm, f32.bfloat16(), None, ln, lm)
    q = dp_cuda.skew(theta, torch.int16, 2047.9375)
    with pytest.raises(TypeError, match="float32"):
        dp_cuda.adjoint_backward(dx, dm, dx, dm, q, ln, lm, dtypes=i16)
    with pytest.raises(ValueError, match="quant_scale"):
        dp_cuda.skew(theta, torch.int16)
    with pytest.raises(TypeError, match="float32, bfloat16 or int16"):
        dp_cuda.unskew(f32.double(), 12, 9)
    with pytest.raises(ValueError, match="shape"):
        dp_cuda.skew_pair(theta, A[:1])


_EDGES = [e for e in chip_smoke.EDGE_SHAPES if e[1] + 1 < 1024 * 6]
_LIMITS = [e for e in chip_smoke.EDGE_SHAPES if e[1] + 1 >= 1024 * 6]


def _edge(seed, B, N, M, short):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return chip_smoke.edge_problem(g, B, N, M, short)


@pytest.mark.parametrize("B,N,M,short", _EDGES)
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_strip_kernels_at_edges(cuda, B, N, M, short, mode, operator):
    theta, A, ln, lm = _edge(B * N + M, B, N, M, short)
    errs = {}
    chip_smoke.check_passes(theta, A, ln, lm, mode, operator, None, errs)
    assert errs == {k: 0.0 for k in ("skew", "skew_pair", "unskew",
                                     "forward", "forward_score",
                                     "adjoint_forward", "backward",
                                     "adjoint_backward")}


@pytest.mark.parametrize("B,N,M,short", _EDGES)
@pytest.mark.parametrize("menu", sorted(chip_smoke.MENUS))
def test_strip_kernels_at_edges_menus(cuda, B, N, M, short, menu):
    theta, A, ln, lm = _edge(N + len(menu), B, N, M, short)
    errs = {}
    mode, operator = ("sw", "sparsemax") if len(menu) % 2 else \
        ("nw", "softmax")
    chip_smoke.check_passes(theta, A, ln, lm, mode, operator,
                            DTypeMenu.make(**chip_smoke.MENUS[menu]), errs)
    assert set(errs.values()) == {0.0}


@pytest.mark.parametrize("B,N,M,short", _LIMITS)
@pytest.mark.parametrize("mode,operator,menu", [("nw", "softmax", None),
                                                ("sw", "hardmax", "fast")])
def test_strip_kernels_at_their_limits(cuda, B, N, M, short, mode, operator,
                                       menu):
    """S = 6,144 (the reverse passes' 1,024 strips of 6) and S = 20,480
    (the forward passes' 1,024 strips of 20, where the reverse passes
    refuse)."""
    theta, A, ln, lm = _edge(N, B, N, M, short)
    menu = menu and DTypeMenu.make(**chip_smoke.MENUS[menu])
    errs = {}
    chip_smoke.check_passes(theta, A, ln, lm, mode, operator, menu, errs)
    assert set(errs.values()) == {0.0}


def test_strip_kernels_refuse_past_their_limits(cuda):
    """One slot past the strips of 1,024 threads each wrapper raises the
    error that names its limit, before launching."""
    for name, most in dp_cuda.MAX_SLOTS.items():
        s = torch.zeros((1, most + 2, most + 1), device=cuda)
        n = torch.tensor([most], dtype=torch.int32, device=cuda)
        m = torch.tensor([2], dtype=torch.int32, device=cuda)
        before = dict(dp_cuda.LAUNCHES)
        with pytest.raises(ValueError, match=rf"S = {most + 1} .*"
                                             rf"S <= {most} "):
            if name == "backward":
                dp_cuda.backward(s, s, n, m, torch.ones(1, device=cuda))
            elif name == "adjoint_backward":
                dp_cuda.adjoint_backward(s, s, s, s, s, n, m)
            elif name == "adjoint_forward":
                dp_cuda.adjoint_forward(s, s, s, s, n, m)
            else:
                getattr(dp_cuda, name)(s, s, n, m)
        assert dp_cuda.LAUNCHES == before


@pytest.mark.parametrize("B,N,M", [(8, 4096, 4096), (2, 3899, 3757)])
def test_skew_at_long_shapes(cuda, B, N, M):
    """The tiled skew at the long path's shapes (the 8 x 4096 x 4096 decode
    and a long training batch, K and S not multiples of the tile), bit
    for bit against the plain relayout; the pair, in every storage form,
    at the training batch."""
    g = torch.Generator(device="cuda")
    g.manual_seed(N)
    x = torch.randn((B, N, M), generator=g, device=cuda)
    assert torch.equal(dp_cuda.skew(x), plain_skew(x))
    if B == 8:
        return
    y = torch.randn((B, N, M), generator=g, device=cuda) * 40.0
    for out_dtype, scale in ((None, None), (torch.bfloat16, None),
                             (torch.int16, 2047.9375)):
        for got, z in zip(dp_cuda.skew_pair(x, y, out_dtype, scale), (x, y)):
            assert torch.equal(got, plain_skew(z, out_dtype, scale))


# -- the BiLM and the RNN head (cuDNN's LSTM; ROADMAP A2) --------------------

def test_bilm_and_rnn_heads_match_the_cpu(cuda):
    """``chip_smoke.check_recurrent``: the BiLM's features and the RNN
    heads' outputs on the card = on the CPU to 1e-4 of scale, ragged
    lengths; and the heads' gradients (both sides) to 1e-4 of scale."""
    from deepblast_torch.train.trainer import DeepBLAST, DeepBLASTConfig
    model = DeepBLAST(DeepBLASTConfig(
        lm_type="bilstm", layer_type="rnn", embedding_dim=64, hidden_dim=32,
        dropout=0.0), device="cuda").init()
    errs = {}
    chip_smoke.check_recurrent(model, ["ACDEFGHIKLMNPQ", "MKTAYIAKQRQISF",
                                       "W"], errs)
    assert errs["bilm_cpu"] <= 1e-4 and errs["rnn_head_cpu"] <= 1e-4
    head = model.aligner.match_embedding
    cpu = copy.deepcopy(head).cpu()
    g = torch.Generator().manual_seed(3)
    x = torch.randn((3, 17, head.embed.in_features), generator=g)
    n = torch.tensor([17, 9, 1])
    mask = (torch.arange(17)[None, :] < n[:, None])[..., None]
    for m, dev in ((head, "cuda"), (cpu, "cpu")):
        m.train()       # cuDNN's LSTM backward needs it; dropout is 0
        (m(x.to(dev), n.to(dev)) * mask.to(dev)).square().sum().backward()
    for (k, p), q in zip(head.named_parameters(), cpu.parameters()):
        if not p.requires_grad:     # torch's second LSTM bias, frozen
            assert p.grad is None and q.grad is None, k
            continue
        scale = q.grad.abs().max().item()
        assert (p.grad.cpu() - q.grad).abs().max().item() <= 1e-4 * scale, k


def test_lstm_second_bias_stays_zero_on_the_card(cuda):
    """torch's second LSTM bias (flax has one) stays frozen at zero on the
    card through AdamW steps, in a deep copy too; the weights stay in one
    cuDNN buffer (no compaction warning)."""
    import warnings
    from deepblast_torch.models.heads import StackedRNN
    head = StackedRNN(12, 8, 6, device="cuda")
    assert not any(m.bias_ih_l0.requires_grad for m in
                   copy.deepcopy(head).modules()
                   if isinstance(m, torch.nn.LSTM))
    opt = torch.optim.AdamW(head.parameters(), lr=1e-2)
    x = torch.randn((2, 9, 12), device="cuda")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for _ in range(3):
            opt.zero_grad()
            head(x, torch.tensor([9, 4], device="cuda")).sum().backward()
            opt.step()
    assert not [w for w in seen if "contiguous chunk" in str(w.message)]
    for name in ("fwd0", "bwd0", "fwd1", "bwd1"):
        rnn = getattr(head, name)
        assert rnn.bias_ih_l0.abs().max().item() == 0.0, name
        assert rnn.bias_hh_l0.abs().max().item() > 0.0, name


def test_gru_head_matches_the_cpu(cuda):
    """The GRU head (flax's biases kept by ``FlaxGRU.forward``) on the card
    = on the CPU to 1e-4 of scale, outputs and gradients, in a deep copy
    too; its hidden-side reset and update biases get no gradient."""
    from deepblast_torch.models import exact_cuda_math
    from deepblast_torch.models.heads import StackedRNN
    exact_cuda_math()
    head = StackedRNN(12, 8, 6, rnn_type="gru")
    pair = [copy.deepcopy(head).cuda(), copy.deepcopy(head)]
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, 11, 12), generator=g)
    n = torch.tensor([11, 5, 1])
    mask = (torch.arange(11)[None, :] < n[:, None])[..., None]
    outs = []
    for m in pair:
        dev = next(m.parameters()).device
        m.train()
        out = m(x.to(dev), n.to(dev)) * mask.to(dev)
        out.square().sum().backward()
        outs.append(out.detach().cpu())
    scale = outs[1].abs().max().item()
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4 * scale
    for (k, p), (_, q) in zip(*(m.named_parameters() for m in pair)):
        scale = q.grad.abs().max().item()
        assert (p.grad.cpu() - q.grad).abs().max().item() <= 1e-4 * scale, k
        if k.endswith("bias_hh_l0"):
            assert p.grad[:16].abs().max().item() == 0.0, k
