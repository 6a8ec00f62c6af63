"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (an H100: the kernels are built for sm_90a) and
skip without one — a CUDA kernel has no CPU mode.  Run them on the card
with ``python -m pytest tests/test_torch_cuda.py -q``.

Tolerance: those of ``chip_smoke.check_kernels``, which these tests call
so that the smoke and the tests hold the kernels to one check: skew
exact; forward (Vt, Dx, Dm), score-only forward and backward (E) rtol
1e-4 / atol 1e-5 (fp32; the kernels round each cell as the plain version
does, so only transcendental ulps can differ); tracebacks identical.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import ATOL, RTOL
from deepblast_torch.ops import dp as dp_ops
from deepblast_torch.ops import dp_cuda

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
    assert set(errs) == {"skew", "forward", "forward_score", "backward"}


def test_dispatcher_launches_kernels(cuda):
    """On CUDA tensors the dispatcher runs the kernels (counted), and its
    results equal the plain run of the same inputs on the CPU."""
    theta, A, ln, lm = _problem(7, 3, 33, 21, cuda)
    before = dict(dp_cuda.LAUNCHES)
    vt = dp_ops.alignment_score(theta, A, (ln, lm))
    E = dp_ops.expected_alignment_stream(theta, A, (ln, lm))
    after = dp_cuda.LAUNCHES
    assert after["skew"] - before["skew"] == 4
    assert after["forward_score"] - before["forward_score"] == 1
    assert after["forward"] - before["forward"] == 1
    assert after["backward"] - before["backward"] == 1
    args = (theta.cpu(), A.cpu(), (ln.cpu(), lm.cpu()))
    torch.testing.assert_close(vt.cpu(), dp_ops.alignment_score(*args),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(E.cpu(),
                               dp_ops.expected_alignment_stream(*args),
                               rtol=RTOL, atol=ATOL)


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
