"""Why ``cli.train`` under ``--backend scan`` and under ``--backend
pallas_bm --no-dp-bf16-residuals`` part after the first step at the
``deepblast-train`` defaults with seeded random weights, on the CPU.

    python scripts/torch_scan_step_parting.py [--embedding-dim 1024]

On ``chip_smoke.py``'s phase ``scan`` rows (16 of 100-250 residues, batch
8; an embedding LM of ``--embedding-dim`` in place of ProtT5-XL, CNN-1024
heads, the cosine schedule at 5e-5, clip 10; dropout ``--dropout``,
default 0, since a float64 model draws other masks) it prints, as JSON:
the range of the potentials at the first batch; the expected alignment
and its gradient under both routes in float32, each one's distance from
a float64 run of the scan and from the other (of scale); the two routes'
first-step parameter gradients, each one's distance from those of the
same step with the model and the scan in float64 and from the other (of
scale) per tensor; and both routes' losses over the epoch.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _of_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


def main(argv=None):
    from deepblast_torch.data.dataset import TMAlignDataset
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.train.trainer import DeepBLAST, DeepBLASTConfig
    parser = argparse.ArgumentParser()
    parser.add_argument("--embedding-dim", type=int, default=1024)
    parser.add_argument("--dropout", type=float, default=0.0)
    args = parser.parse_args(argv)
    smoke = _smoke()
    rows, _ = smoke.scan_rows(0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.tsv")
        smoke._write_tsv(path, rows)
        runs = {}
        for backend in ("scan", "pallas_bm", "scan float64"):
            cfg = DeepBLASTConfig(
                embedding_dim=args.embedding_dim, batch_size=8, epochs=1,
                dropout=args.dropout, grad_clip=10.0, learning_rate=5e-5,
                backend=backend.split()[0], dp_bf16_residuals=False,
                train_pairs=path)
            model = DeepBLAST(cfg, device="cpu").init()
            if backend.endswith("float64"):
                model.lm.double()
                model.aligner.double()
            data = TMAlignDataset(path, tokenizer=model.tokenizer)
            batches = list(model._batches(data, True, 0))
            model._spe = len(batches)
            model._build_optimizer()
            gen = torch.Generator()
            gen.manual_seed(1)
            losses, grads = [], None
            for i, batch in enumerate(batches):
                b = model._loss_batch(batch)
                if i == 0 and backend == "scan":
                    out["first batch"] = _dp_routes(model, b, dp_ops)
                loss = model._step(b, gen)
                if grads is None:
                    grads = [p.grad.clone().double()
                             for p in model._trained()]
                losses.append(float(loss))
            runs[backend] = (losses, grads)
    out["train_loss"] = {k: v[0] for k, v in runs.items()}
    g64 = runs["scan float64"][1]
    out["first-step parameter gradients (of scale)"] = {
        "scan - float64": [_of_max(a, b)
                           for a, b in zip(runs["scan"][1], g64)],
        "pallas_bm - float64": [_of_max(a, b)
                                for a, b in zip(runs["pallas_bm"][1], g64)],
        "scan - pallas_bm": [_of_max(a, b) for a, b in
                             zip(runs["scan"][1], runs["pallas_bm"][1])]}
    print(json.dumps(out, indent=1))
    return 0


def _dp_routes(model, b, dp_ops):
    """The potentials' range at batch ``b`` and the DP (expected alignment
    and the gradient of a random projection) under each float32 route
    against the float64 scan."""
    with torch.no_grad():
        hx, hy = model._embeddings(b)
        lengths = (b["x_len"].to(torch.int32), b["y_len"].to(torch.int32))
        theta, A = model.aligner.potentials(hx, hy, lengths)
    theta, A = theta.detach(), A.detach()
    z = torch.randn(theta.shape, generator=torch.Generator().manual_seed(2))

    def run(backend, dtype):
        t, a = (x.to(dtype).requires_grad_() for x in (theta, A))
        E = dp_ops.expected_alignment(t, a, lengths, backend=backend)
        g = torch.autograd.grad((E * z.to(dtype)).sum(), (t, a))
        return [x.detach().double() for x in (E, *g)]

    ref = run("scan", torch.float64)
    routes = {r: run(r, torch.float32) for r in ("scan", "pallas_bm")}
    names = ("E", "d theta", "d A")
    dist = {r: dict(zip(names, map(_of_max, o, ref)))
            for r, o in routes.items()}
    dist["scan - pallas_bm"] = dict(zip(names, map(
        _of_max, routes["scan"], routes["pallas_bm"])))
    return {"shape": list(theta.shape),
            "theta": [float(theta.min()), float(theta.max())],
            "A": [float(A.min()), float(A.max())],
            "from float64 (of scale)": dist}


if __name__ == "__main__":
    raise SystemExit(main())
