"""How far the port's fp32 DP autograd is from fp64, by pair length.

    PYTHONPATH=. python scripts/torch_dp_fp32_error.py 100 400 1000

(from the root of a checkout).

For each length N it builds two random pairs (theta, A ~ N(0, 1), A
shifted by -1, lengths N and N-3/N-5), runs on the CPU, with the plain
passes, the outputs that ``chip_smoke.check_autograd`` compares (the
score, its gradient, the gradient of the gradient's squared norm, E and
EA, and two VJPs of E) in fp32 and in fp64, and prints each output's max
abs difference over its largest magnitude, for the default backend and
for ``pallas_long``.  A few minutes at N = 1000; CPU time only.
"""

import sys
import time

import torch

from deepblast_torch.ops import dp

NAMES = "vt g1t g1a g2t g2a E EA g3t g3a g4t g4a".split()


def outputs(theta, A, ln, lm, Zt, Za, backend):
    t = theta.clone().requires_grad_()
    a = A.clone().requires_grad_()
    kw = dict(backend=backend)
    vt = dp.alignment_score(t, a, (ln, lm), **kw)
    g1 = torch.autograd.grad(vt.sum(), (t, a), create_graph=True)
    g2 = torch.autograd.grad((g1[0] * g1[0]).sum(), (t, a))
    E = dp.expected_alignment(t, a, (ln, lm), **kw)
    g3 = torch.autograd.grad((E * Zt).sum(), (t, a))
    E, EA = dp.expected_alignment(t, a, (ln, lm), return_gap=True, **kw)
    g4 = torch.autograd.grad((E * Zt).sum() + (EA * Za).sum(), (t, a))
    return [x.detach() for x in (vt, *g1, *g2, E, EA, *g3, *g4)]


def main(lengths):
    for N in lengths:
        g = torch.Generator().manual_seed(N)
        f64 = dict(generator=g, dtype=torch.float64)
        theta = torch.randn((2, N, N), **f64)
        A = torch.randn((2, N, N), **f64) - 1
        Zt = torch.randn((2, N, N), **f64)
        Za = torch.randn((2, N, N), **f64)
        ln = torch.tensor([N, N - 3], dtype=torch.int32)
        lm = torch.tensor([N, N - 5], dtype=torch.int32)
        for backend in (None, "pallas_long"):
            t0 = time.time()
            ref = outputs(theta, A, ln, lm, Zt, Za, backend)
            got = outputs(theta.float(), A.float(), ln, lm, Zt.float(),
                          Za.float(), backend)
            rel = [(a.double() - b).abs().max().item()
                   / max(b.abs().max().item(), 1.0) for a, b in zip(got, ref)]
            print(N, backend, f"{time.time() - t0:.0f} s",
                  " ".join(f"{n}={r:.1e}" for n, r in zip(NAMES, rel)),
                  flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [100, 400, 1000])
