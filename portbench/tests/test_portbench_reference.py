"""The plain reference against the port at tiny sizes on the CPU: the two
are written apart, so agreement here means both follow the same
mathematics."""

import math

import numpy as np
import pytest
import torch

import portbench_tiny as tiny
from portbench import traffic, weights
from portbench.reference import heads, model, nw, t5, tmalign
from portbench.reference import train as ref_train


def _port(cfg, seed=3):
    from portbench import program
    return program.build(cfg, tiny.fit_mix(), seed, torch.device("cpu"))


def test_relative_buckets_match_the_port():
    from deepblast_torch.models.lm import relative_position_bucket
    L = 1100
    pos = torch.arange(L)
    want = relative_position_bucket(pos[None, :] - pos[:, None], 32, 128)
    assert torch.equal(t5.relative_buckets(L, 32, 128, "cpu"), want)


def test_t5_and_potentials_match_the_port():
    cfg = tiny.pt_l8()
    port, _ = _port(cfg)
    w = weights.model_weights(cfg, 3, torch.device("cpu"))
    seqs = ["ACDKLMNW" * 3, "WYVTSR" * 5]
    fx = model.features(w, cfg["lm"], seqs)
    for s, f in zip(seqs, fx):
        tok = torch.as_tensor(tmalign.tokens(s))[None]
        got = port.lm(tok, torch.ones_like(tok, dtype=torch.bool))
        assert torch.allclose(got[0], f, atol=1e-5, rtol=1e-5)
    hx, hy = fx[0][None], fx[1][None]
    lens = (torch.tensor([24]), torch.tensor([30]))
    th, A = port.aligner.potentials(hx, hy, lens)
    th_r, A_r = heads.potentials(w, hx, hy, *lens, cfg["heads"]["layers"])
    assert torch.allclose(th, th_r, rtol=1e-5, atol=1e-5)
    assert torch.allclose(A, A_r, rtol=1e-5, atol=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0, 1.0 + 2**-10])
    got = model.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-9, -3.0, 1.0 + 2**-10]


@pytest.mark.parametrize("shape", [(3, 9, 7), (2, 5, 11)])
def test_nw_matches_the_port(shape):
    from deepblast_torch.ops import dp
    from deepblast_torch.train.losses import matrix_cross_entropy
    mix = tiny.nw_mix("train-800")
    B, N, M = shape
    mix["potentials"].update(batch=B, n=N, m=M)
    b = traffic.potentials(mix, 9, torch.device("cpu"))
    xl = torch.tensor([N, N - 2, N - 1][:B])
    yl = torch.tensor([M - 1, M, M - 3][:B])
    th = b["theta"].double().requires_grad_(True)
    A = b["A"].double().requires_grad_(True)
    E = dp.expected_alignment(th, A, (xl, yl))
    matrix_cross_entropy(b["aln"].double(), E, xl, yl, b["gmask"]).backward()
    th_r = b["theta"].double().requires_grad_(True)
    A_r = b["A"].double().requires_grad_(True)
    E_r = nw.expected(th_r, A_r, xl, yl, create_graph=True)
    ref_train.cross_entropy(b["aln"].double(), E_r, xl, yl,
                            b["gmask"]).backward()
    assert torch.allclose(E, E_r, atol=1e-10)
    assert torch.allclose(th.grad, th_r.grad, atol=1e-10)
    assert torch.allclose(A.grad, A_r.grad, atol=1e-10)


def test_greedy_path_matches_the_port_and_judges_it():
    from deepblast_torch.ops import dp
    from deepblast_torch.data.state_utils import revstate_f
    r = np.random.default_rng(4)
    for n, m in [(7, 5), (1, 4), (6, 1), (9, 9)]:
        E = r.random((n, m))
        port = "".join(revstate_f(s) for _, _, s in dp.traceback(E))
        assert nw.greedy_path(E) == port
        assert nw.path_gap(E, port) == 0.0
        if len(port) > 1:
            bad = "2" + port[1:] if port[0] != "2" else "1" + port[1:]
            assert nw.path_gap(E, bad) > 0


def test_adamw_matches_torch():
    p = torch.randn(5, dtype=torch.float64)
    q = torch.nn.Parameter(p.clone())
    opt = torch.optim.AdamW([q], lr=0.01, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    params, state = {"p": p}, {}
    for step in range(1, 4):
        g = torch.randn(5, dtype=torch.float64)
        q.grad = g.clone()
        opt.step()
        ref_train.adamw(params, {"p": g}, state, step, 0.01)
    assert torch.allclose(q.detach(), params["p"], atol=1e-12)


def test_clip_global():
    g = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    got = ref_train.clip_global(g, 1.0)
    assert math.isclose(float(got["a"]), 0.6, rel_tol=1e-6)
    assert ref_train.clip_global(g, 10.0) is g
