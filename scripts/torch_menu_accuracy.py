#!/usr/bin/env python3
"""CPU measurements behind the storage-menu slice of deepblast_torch.

Runs the port's plain DP passes (``deepblast_torch/ops/dp_ref.py``) on the
CPU and prints, one JSON line each:

1. ``torch_random``: the decode (``expected_alignment_stream``) under the
   menus d=bf16, fast (d=bf16, e=int16) and i16 (stream=int16, e=int16)
   against float32 storage, on potentials drawn from
   ``torch.Generator().manual_seed(0)`` at (4, 200, 150) then (2, 512,
   512): max E error and per-pair traceback agreement;
2. ``scan_emulation``: on numpy seed 0 at (4, 512, 512), the per-pair
   traceback agreement of bf16 residuals against float32 in the port and
   in the JAX package's scan oracle with its ``residual_dtype`` emulation;
3. ``jax_gate_data``: the data and gates of the JAX package's own checks,
   ``tests/test_bf16_streams.py`` ((4, 48, 40), numpy seed 2) and
   ``scripts/bench_check.py`` (the first 16 pairs of (256, 512, 512),
   numpy seed 0): max E error, mean / min agreement of the natural walks,
   the fast menu's stream walk against the natural walk under bf16 D, and
   the fast decode's E error and agreement against float32 storage;
4. ``config_drop``: the size of the fault that ``DeepBLASTConfig.from_json``
   had (ROADMAP.md queue C): ``score_pairs`` of one 14-residue pair with
   itself under the tiny config with ``backend="pallas_bm",
   dp_bf16_residuals=False`` and ``dp_i16_streams=True`` (or
   ``precision="bf16"``), weights carried over, in the JAX
   package, in the port with the field dropped, and in the port now.

Agreement is the share of equal ``(i, j, state)`` steps at equal
positions of two walks (``scripts/bench_check.py``'s measure).

    python scripts/torch_menu_accuracy.py          # ~1 min, CPU only
"""

import json

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from deepblast_torch.models.convert import params_from_jax  # noqa: E402
from deepblast_torch.ops import dp as tdp  # noqa: E402
from deepblast_torch.ops.menu import DTypeMenu  # noqa: E402
from deepblast_torch.train import trainer as ttrainer  # noqa: E402
from deepblast_tpu.ops import dp as jdp  # noqa: E402
from deepblast_tpu.ops import dp_bm  # noqa: E402
from deepblast_tpu.train import trainer as jtrainer  # noqa: E402

MENUS = {"d_bf16": dict(d="bfloat16"), "fast": dict(d="bfloat16", e="int16"),
         "i16": dict(stream="int16", e="int16")}


def agreement(s1, s2):
    return sum(a == b for a, b in zip(s1, s2)) / max(len(s1), len(s2))


def full(B, N, M):
    return (torch.full((B,), N, dtype=torch.int32),
            torch.full((B,), M, dtype=torch.int32))


def torch_random():
    g = torch.Generator().manual_seed(0)
    out = {}
    for B, N, M in ((4, 200, 150), (2, 512, 512)):
        th = torch.randn((B, N, M), generator=g)
        A = torch.randn((B, N, M), generator=g) - 1
        lens = full(B, N, M)
        E32 = tdp.expected_alignment_stream(th, A, lens)
        for name, kw in MENUS.items():
            E = tdp.expected_alignment_stream(th, A, lens,
                                              dtypes=DTypeMenu.make(**kw))
            out[f"({B}, {N}, {M}) {name}"] = dict(
                max_E_err=float(np.abs(tdp._host(E) - E32.numpy()).max()),
                agreement=[agreement(tdp.traceback_stream(E, N, M, b),
                                     tdp.traceback_stream(E32, N, M, b))
                           for b in range(B)])
    return out


def scan_emulation():
    B, N, M = 4, 512, 512
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((B, N, M)).astype(np.float32)
    A = (rng.standard_normal((B, N, M)) - 1.0).astype(np.float32)
    lens = (jnp.full((B,), N, jnp.int32), jnp.full((B,), M, jnp.int32))
    jt, ja = jnp.asarray(theta), jnp.asarray(A)
    J32 = np.asarray(jdp.expected_alignment(jt, ja, lens, backend="scan"))
    J16 = np.asarray(jdp.expected_alignment(
        jt, ja, lens, backend="scan",
        dtypes=dp_bm.DTypeMenu.make(d="bfloat16")))
    t, a = torch.tensor(theta), torch.tensor(A)
    T32 = tdp.expected_alignment(t, a, full(B, N, M))
    T16 = tdp.expected_alignment(t, a, full(B, N, M),
                                 dtypes=DTypeMenu.make(d="bfloat16"))
    return dict(
        port=[agreement(tdp.traceback(T32[b]), tdp.traceback(T16[b]))
              for b in range(B)],
        jax_scan=[agreement(jdp.traceback(J32[b]), jdp.traceback(J16[b]))
                  for b in range(B)])


def jax_gate_data():
    out = {}
    bf16 = DTypeMenu.make(**MENUS["d_bf16"])
    fast = DTypeMenu.make(**MENUS["fast"])
    for seed, B, N, M, keep in ((2, 4, 48, 40, 4), (0, 256, 512, 512, 16)):
        rng = np.random.default_rng(seed)
        theta = torch.tensor(rng.standard_normal((B, N, M))[:keep],
                             dtype=torch.float32)
        A = torch.tensor(rng.standard_normal((B, N, M))[:keep] - 1.0,
                         dtype=torch.float32)
        lens = full(keep, N, M)
        E32 = tdp.expected_alignment(theta, A, lens)
        E16 = tdp.expected_alignment(theta, A, lens, dtypes=bf16)
        Es = tdp.expected_alignment_stream(theta, A, lens, dtypes=fast)
        E32s = tdp.expected_alignment_stream(theta, A, lens)
        walks = [tdp.traceback(E16[b]) for b in range(keep)]
        agree = [agreement(tdp.traceback(E32[b]), w)
                 for b, w in enumerate(walks)]
        out[f"seed {seed}, {keep} of ({B}, {N}, {M})"] = dict(
            max_E_err=float((E16 - E32).abs().max()),
            mean_agreement=float(np.mean(agree)),
            min_agreement=float(np.min(agree)),
            stream_vs_natural=float(np.mean(
                [agreement(tdp.traceback_stream(Es, N, M, b), w)
                 for b, w in enumerate(walks)])),
            fast_max_E_err=float(np.abs(tdp._host(Es)
                                        - E32s.numpy()).max()),
            fast_mean_agreement=float(np.mean(
                [agreement(tdp.traceback_stream(Es, N, M, b),
                           tdp.traceback_stream(E32s, N, M, b))
                 for b in range(keep)])))
    return out


def config_drop():
    tiny = dict(embedding_dim=16, hidden_dim=16, layers=2, k_size=5,
                vocab_size=32, lm_type="embed", batch_size=4, dropout=0.0,
                backend="pallas_bm", dp_bf16_residuals=False)
    out = {}
    for field, value in (("dp_i16_streams", True), ("precision", "bf16")):
        jmodel = jtrainer.DeepBLAST(jtrainer.DeepBLASTConfig(
            **{field: value}, **tiny))
        state = jmodel.init()
        scores = {}
        kws = {"port, field dropped": {}}
        if field == "dp_i16_streams":
            kws["port now"] = {field: value}
        for name, kw in kws.items():
            tmodel = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
                **kw, **tiny), device="cpu")
            tmodel.lm.load_state_dict(params_from_jax(state.lm_params))
            tmodel.aligner.load_state_dict(
                params_from_jax(state.params["aligner"]))
            tok = tmodel.tokenizer("ACDEFGHIKLMNPQ")[0]
            batch = dict(x=tok[None], y=tok[None], x_len=np.array([14]),
                         y_len=np.array([14]))
            scores[name] = float(tmodel.score_pairs(batch)[0])
        scores["jax"] = float(jmodel.score_pairs(
            state, {k: jnp.asarray(v) for k, v in batch.items()})[0])
        out[f"{field}={value}"] = scores
    return out


if __name__ == "__main__":
    for name, fn in (("torch_random", torch_random),
                     ("scan_emulation", scan_emulation),
                     ("jax_gate_data", jax_gate_data),
                     ("config_drop", config_drop)):
        print(json.dumps({name: fn()}), flush=True)
