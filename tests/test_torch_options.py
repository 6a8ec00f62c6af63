"""The trainer options (``precision``, ``finetune``, ``grad_accum``,
``steps_per_dispatch``) and bf16 Q storage (``Q_DTYPE``) of the port on
the CPU against the JAX package.

* ``precision`` "bf16" and "16": the tiny T5 (``T5Config.tiny``) and the
  aligner's potentials against JAX's ``_lm_apply`` + ``potentials`` with
  the weights carried by ``state_dicts_from_jax``;
* fit trajectories against the JAX trainer (scan backend; the port on
  float32 residuals, as ``test_torch_train``'s): ``finetune`` (the token
  embedding trained), ``grad_accum=2`` with clip 1 and the cosine
  schedule, ``steps_per_dispatch=4`` (``tests/test_train.py``'s
  multi-step data: every batch one shape), ``precision="bf16"``;
* the port at ``steps_per_dispatch`` 4 against itself at 1 with dropout
  0.5, exactly; a run checkpointed in the middle of an accumulation
  resumes to the uninterrupted run, exactly; ``cli.train --finetune True``
  -> ``load_model`` serves the finetuned LM of the best checkpoint;
* bf16 Q: the plain Q passes with ``q_dtype=torch.bfloat16`` against
  ``dp_pallas`` in interpret mode with ``dp_pallas.Q_DTYPE`` bf16
  (monkeypatched, one-row blocks), and the ``pallas_long`` dispatcher's
  autograd under ``ops.dp.Q_DTYPE`` bf16 against ``deepblast_tpu.ops.dp``.

Tolerances, each with what was measured on this CPU:

* bf16 T5 / potentials: 1e-6 of each output's largest magnitude (read:
  0.0 for the embeddings, 3.3e-8 and 8.6e-8 for theta and A); fp16: 2e-3
  of scale (read: 1.0e-3, 4.8e-4, 5.0e-4 -- about one fp16 ulp, 2^-10:
  XLA on the CPU keeps some fp16 intermediates wider); each also closer
  to JAX's run in its dtype than the port's float32 run is (1.2e-2 to
  2.8e-2 of scale in bf16, 1.5e-3 to 3.3e-3 in fp16);
* trajectories: rtol 1e-4 (float32) as ``test_torch_train`` (read, the
  largest relative difference of a logged value: finetune 5.2e-7,
  grad_accum 5.2e-7, steps_per_dispatch 7.9e-7); bf16 potentials rtol
  1e-4 too (read: 1.3e-6);
* bf16 Q: the forward's Q streams to one bf16 ulp of values in [0, 1]
  (2^-8; two libraries' exp can round a value to neighbouring bf16
  values: read 0 of 4,698 slots apart), vt and every reverse pass on the
  same bf16 streams to 2e-5 (as ``test_torch_dp_long``); the dispatcher
  to 2e-5 (read: 6.0e-7 absolute), which the float32 Q run misses (read:
  1.5e-2).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.cli import train as ttrain
from deepblast_torch.data import dataset as tds
from deepblast_torch.models import lm as tlm
from deepblast_torch.models.convert import state_dicts_from_jax
from deepblast_torch.ops import dp as tdp
from deepblast_torch.ops import dp_ref
from deepblast_torch.ops.skew import skew
from deepblast_torch.train import trainer as ttrainer
from deepblast_torch.train.checkpoint import Checkpointer, load_model
from deepblast_tpu.data import dataset as jds
from deepblast_tpu.models import lm as jlm
from deepblast_tpu.ops import dp as jdp
from deepblast_tpu.ops import dp_pallas
from deepblast_tpu.train import trainer as jtrainer
from test_torch_dp_long import _port, _problem, _tpu
from test_torch_train import TINY, _Rec, _rows, _write_tsv
from test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)

T5_CFG = dict(embedding_dim=32, hidden_dim=16, layers=2, k_size=5,
              vocab_size=32, lm_type="prot_t5", batch_size=4,
              learning_rate=5e-3, epochs=1, max_len=64, pad_multiple=8,
              dropout=0.0)
JAX_DTYPES = {"32": jnp.float32, "bf16": jnp.bfloat16, "16": jnp.float16}
PORT_DTYPES = {"32": "float32", "bf16": "bfloat16", "16": "float16"}
# of scale: port vs JAX in the precision's dtype (see the module docstring)
T5_TOL = {"bf16": 1e-6, "16": 2e-3}


def _t5_outputs(prec, jstate):
    """``(hx, theta, A)`` of the JAX trainer and of the port at precision
    ``prec`` on one padded batch, both from the JAX init ``jstate`` (the
    float32 run's, so every precision starts from the same weights)."""
    rng = np.random.default_rng(0)
    lens = np.array([19, 11, 7], np.int32)
    tok = rng.integers(3, 25, size=(3, 19)).astype(np.int32)
    for b, n in enumerate(lens):
        tok[b, n:] = 0
    jm = jtrainer.DeepBLAST(
        jtrainer.DeepBLASTConfig(precision=prec, **T5_CFG),
        lm=jlm.T5Encoder(jlm.T5Config.tiny(dtype=JAX_DTYPES[prec])))
    jstate = jstate or jm.init()
    jl = jnp.asarray(lens)
    hx = jm._lm_apply(jstate.lm_params, jnp.asarray(tok), jl)
    th, A = jm.aligner.apply({"params": jstate.params["aligner"]}, hx, hx,
                             (jl, jl), method=jm.aligner.potentials)
    tm = ttrainer.DeepBLAST(
        ttrainer.DeepBLASTConfig(precision=prec, **T5_CFG),
        lm=tlm.T5Encoder(tlm.T5Config.tiny(dtype=PORT_DTYPES[prec])),
        device="cpu")
    sd = state_dicts_from_jax(jstate)
    tm.lm.load_state_dict(sd["lm"])
    tm.aligner.load_state_dict(sd["aligner"])
    tl = torch.tensor(lens)
    b = dict(x=torch.tensor(tok), y=torch.tensor(tok), x_len=tl, y_len=tl)
    with torch.no_grad():
        thx, _ = tm._embeddings(b)
        tth, tA = tm.aligner.potentials(thx, thx, (tl, tl))
    jout = [np.asarray(v, np.float64) for v in (hx, th, A)]
    tout = [v.double().numpy() for v in (thx, tth, tA)]
    return jstate, jout, tout


@pytest.mark.parametrize("prec", ["bf16", "16"])
def test_t5_and_potentials_at_precision_match_jax(prec):
    """The T5 in the compute dtype (parameters float32) and the aligner's
    rounded contractions: the port's embeddings and potentials against
    JAX's at ``prec``, closer to them than the port's float32 run."""
    jstate, _, t32 = _t5_outputs("32", None)
    _, jout, tout = _t5_outputs(prec, jstate)
    for name, j, t, f in zip(("hx", "theta", "A"), jout, tout, t32):
        scale = np.abs(j).max()
        err = np.abs(t - j).max() / scale
        assert err <= T5_TOL[prec], (name, err)
        assert err < np.abs(f - j).max() / scale, name


def _trajectories(port, jax_, frame=fixture_frame):
    """Fit the port (``port`` config fields, float32 residuals) and the
    JAX trainer (``jax_``, scan backend) from the JAX init on the same
    train and validation data (``frame()``, anew for each dataset: the JAX
    dataset relabels its frame's columns); returns ``((rows, history,
    model), (rows, history, state))``."""
    jmodel = jtrainer.DeepBLAST(jtrainer.DeepBLASTConfig(backend="scan",
                                                         **jax_))
    jmodel.state = jmodel.init()
    tmodel = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
        dp_bf16_residuals=False, **port), device="cpu")
    sd = state_dicts_from_jax(jmodel.state)   # before the JAX fit donates
    tmodel.lm.load_state_dict(sd["lm"])
    tmodel.aligner.load_state_dict(sd["aligner"])
    jrec, trec = _Rec(), _Rec()
    jstate, jhist = jmodel.fit(jds.TMAlignDataset(frame()),
                               jds.TMAlignDataset(frame()), logger=jrec)
    _, thist = tmodel.fit(tds.TMAlignDataset(_rows(frame())),
                          tds.TMAlignDataset(_rows(frame())), logger=trec)
    return (trec.rows, thist, tmodel), (jrec.rows, jhist, jstate)


def _same(port, jax_, rtol, steps):
    (trows, thist, _), (jrows, jhist, _) = port, jax_
    assert [r[:2] for r in trows] == [r[:2] for r in jrows]
    assert sum(r[0] == "train_loss" for r in trows) == steps
    np.testing.assert_allclose([r[2] for r in trows], [r[2] for r in jrows],
                               rtol=rtol)
    for th, jh in zip(thist, jhist):
        assert th.keys() == jh.keys()
        np.testing.assert_allclose(list(th.values()), list(jh.values()),
                                   rtol=rtol)


def test_fit_trajectory_finetune_matches_jax():
    """``finetune``: the token embedding trains with the aligner in one
    AdamW group and one clipped global norm."""
    cfg = dict(TINY, finetune=True)
    port, jax_ = _trajectories(cfg, cfg)
    _same(port, jax_, 1e-4, 6)
    tmodel, jstate = port[2], jax_[2]
    want = state_dicts_from_jax(jstate)["lm"]["embed.weight"]
    got = tmodel.lm.embed.weight.detach()
    start = state_dicts_from_jax(jtrainer.DeepBLAST(
        jtrainer.DeepBLASTConfig(backend="scan", **cfg)).init())["lm"]
    assert not torch.equal(got, start["embed.weight"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-5)


def test_fit_trajectory_grad_accum_matches_jax():
    """``grad_accum=2`` (``optax.MultiSteps``) with clip 1 and the cosine
    schedule: 6 steps, 3 updates, the running mean carried across the
    epoch boundary (3 batches an epoch)."""
    cfg = dict(TINY, grad_accum=2)
    port, jax_ = _trajectories(cfg, cfg)
    _same(port, jax_, 1e-4, 6)
    opt = port[2]._opt
    assert {int(opt.state[p]["step"]) for p in port[2]._trained()} == {3}
    assert port[2]._mini_step == 0 and port[2].step == 6


def test_fit_trajectory_steps_per_dispatch_matches_jax():
    """``steps_per_dispatch=4`` on 16 pairs padded to one shape: one chunk
    of 4 steps an epoch (the JAX trainer's ``lax.scan``)."""
    cfg = dict(TINY, steps_per_dispatch=4, pad_multiple=64)
    port, jax_ = _trajectories(cfg, cfg, lambda: fixture_frame(16, seed=5))
    _same(port, jax_, 1e-4, 8)


def test_fit_trajectory_bf16_precision_matches_jax():
    """``precision="bf16"``: the heads' features rounded to bf16 before
    the float32 contractions (the token-embedding LM stays float32, as in
    JAX)."""
    cfg = dict(TINY, precision="bf16")
    port, jax_ = _trajectories(cfg, cfg)
    _same(port, jax_, 1e-4, 6)


def _port_fit(frame, **kw):
    model = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(**dict(TINY, **kw)),
                               device="cpu").init()
    rec = _Rec()
    model.fit(tds.TMAlignDataset(_rows(frame)), logger=rec)
    return rec.rows, model


@pytest.mark.parametrize("pad_multiple", [64, 8])
def test_steps_per_dispatch_equals_single_steps_exactly(pad_multiple):
    """The port at K = 4 is its own K = 1 run bit for bit, dropout 0.5
    included (the generator is drawn in the same order): every batch one
    shape (whole chunks), and batches of mixed shapes (chunks cut at a
    shape change, the rest single steps)."""
    frame = fixture_frame(16, seed=5)
    kw = dict(dropout=0.5, pad_multiple=pad_multiple)
    rows1, m1 = _port_fit(frame, **kw)
    rows4, m4 = _port_fit(frame, steps_per_dispatch=4, **kw)
    assert rows1 == rows4 and len(rows1) == 8
    for (k, a), b in zip(m1.aligner.state_dict().items(),
                         m4.aligner.state_dict().values()):
        assert torch.equal(a, b), k


def test_resume_in_the_middle_of_an_accumulation(tmp_path):
    """``grad_accum=2`` over 3 batches an epoch: the first epoch's
    checkpoint holds one step of a running mean.  A run resumed from it
    for one epoch (seed 1, so it shuffles as the uninterrupted run's
    second epoch; a constant rate, which no epoch count changes) gives
    that epoch's losses and the final weights exactly."""
    frame = fixture_frame()
    kw = dict(TINY, grad_accum=2, scheduler="none")
    full = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(**kw),
                              device="cpu").init()
    lm = {k: v.clone() for k, v in full.lm.state_dict().items()}
    ck = Checkpointer(str(tmp_path / "ck"), keep=5)
    rec = _Rec()
    full.fit(tds.TMAlignDataset(_rows(frame)), logger=rec, checkpointer=ck)
    state = ck.restore(step=3)
    assert state["grad_accum"]["mini_step"] == 1
    resumed = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
        **dict(kw, epochs=1, seed=1)), device="cpu").init()
    resumed.lm.load_state_dict(lm)       # frozen: the run's initial LM
    resumed.load_train_state(state)
    again = _Rec()
    resumed.fit(tds.TMAlignDataset(_rows(frame)), logger=again)
    assert again.rows == rec.rows[3:] and \
        [r[1] for r in again.rows] == [4, 5, 6]
    for (k, a), b in zip(full.aligner.state_dict().items(),
                         resumed.aligner.state_dict().values()):
        assert torch.equal(a, b), k


def test_finetuned_load_model_serves_its_own_lm(tmp_path):
    """``cli.train --finetune True`` keeps the LM in every checkpoint;
    ``load_model`` takes it (and the aligner) from the best one, not the
    initial LM, and its ``align`` is that model's."""
    train, valid = tmp_path / "train.tsv", tmp_path / "valid.tsv"
    _write_tsv(train, fixture_frame(n_rows=12, seed=1))
    _write_tsv(valid, fixture_frame(n_rows=4, seed=2))
    out = tmp_path / "out"
    assert ttrain.main([
        "--train-pairs", str(train), "--valid-pairs", str(valid),
        "-o", str(out), "--embedding-dim", "16", "--hidden-dim", "16",
        "--batch-size", "4", "--epochs", "2", "--max-len", "64",
        "--learning-rate", "5e-3", "--finetune", "True",
        "--device", "cpu"]) == 0
    with open(out / "config.json") as f:
        assert json.load(f)["finetune"] is True
    best = Checkpointer(str(out / "checkpoints")).restore()
    model = load_model(str(out), device="cpu")
    init = ttrainer.DeepBLAST(model.config, device="cpu").init()
    lm = model.lm.state_dict()
    assert lm.keys() == best["lm"].keys()
    assert all(torch.equal(lm[k], v) for k, v in best["lm"].items())
    assert not torch.equal(lm["embed.weight"],
                           init.lm.state_dict()["embed.weight"])
    mem = ttrainer.DeepBLAST(model.config, device="cpu")
    mem.load_train_state(best)
    for x, y in (("ACDEFGHIKL", "ACDFGHIKLM"), ("MKTAYIAK", "MKTAYK")):
        assert model.align(x, y) == mem.align(x, y)


# -- bf16 Q storage (ROADMAP B10) -------------------------------------------

@pytest.fixture
def bf16_q(monkeypatch):
    """``Q_DTYPE`` bf16 in both packages, one-row Pallas blocks."""
    monkeypatch.setattr(dp_pallas, "DIAG_UNROLL", 1)
    monkeypatch.setattr(dp_pallas, "Q_DTYPE", jnp.bfloat16)
    monkeypatch.setattr(tdp, "Q_DTYPE", torch.bfloat16)


def _port_q(s, B, K, S):
    """A TPU bf16 Q stream -> the port's ``(B, K, S)`` bf16 stream."""
    return _port(jnp.asarray(s, jnp.float32), B, K, S).to(torch.bfloat16)


@pytest.mark.parametrize("shape,mode,operator", [
    ((4, 9, 7), "nw", "softmax"), ((3, 13, 11), "sw", "sparsemax")])
def test_plain_q_passes_with_bf16_q_match_dp_pallas(bf16_q, shape, mode,
                                                    operator):
    """``forward_q(q_dtype=bf16)`` rounds its stores as ``forward_pallas``
    under ``Q_DTYPE`` bf16; the backward (+ EA), the adjoint forward (with
    and without Za) and the adjoint backward (+ EdA) read the same bf16
    streams and return float32, as the JAX passes widen them."""
    B, N, M = shape
    K, S = N + M - 1, N + 1
    theta, A, ln, lm, Zt, Za, Et = _problem(B * N + M + 5, B, N, M)
    jl, jm = jnp.asarray(ln), jnp.asarray(lm)
    tl = torch.tensor(ln, dtype=torch.int32)
    tm = torch.tensor(lm, dtype=torch.int32)
    kw = dict(mode=mode, operator=operator)
    th_j, A_j = dp_pallas.skew_input(theta), dp_pallas.skew_input(A)
    th_t, A_t = skew(torch.tensor(theta)), skew(torch.tensor(A))
    vt_j, qs_j = dp_pallas.forward_pallas(th_j, A_j, jl, jm, **kw)
    assert all(q.dtype == jnp.bfloat16 for q in qs_j)
    vt_t, *qs_t = dp_ref.forward_q(th_t, A_t, tl, tm, q_dtype=torch.bfloat16,
                                   **kw)
    np.testing.assert_allclose(vt_t.numpy(), np.asarray(vt_j), rtol=2e-5,
                               atol=2e-5)
    qs = [_port_q(q, B, K, S) for q in qs_j]
    for got, want in zip(qs_t, qs):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=0, atol=2.0 ** -8)

    def same(got, want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   _port(want, B, K, S).numpy(),
                                   rtol=2e-5, atol=2e-5)

    E_j, EA_j = dp_pallas._backward_v2(jnp.asarray(Et), qs_j, jl, jm,
                                       mode=mode, want_gap=True)
    E_t, EA_t = dp_ref.backward_q(*qs, tl, tm, torch.tensor(Et), mode=mode,
                                  want_gap=True)
    same(E_t, E_j)
    same(EA_t, EA_j)
    zt_t, za_t = skew(torch.tensor(Zt)), skew(torch.tensor(Za))
    for za in (za_t, None):
        za_j = _tpu(torch.zeros_like(zt_t) if za is None else za, th_j)
        vtd_j, qds_j = dp_pallas.adjoint_forward_pallas(
            qs_j, _tpu(zt_t, th_j), za_j, jl, jm, **kw)
        vtd_t, *qds_t = dp_ref.adjoint_forward_q(*qs, zt_t, za, tl, tm, **kw)
        np.testing.assert_allclose(vtd_t.numpy(), np.asarray(vtd_j),
                                   rtol=2e-5, atol=2e-5)
        for got, want in zip(qds_t, qds_j):
            same(got, want)
    qds = [_port(q, B, K, S) for q in qds_j]
    Ed_j, EdA_j = dp_pallas._adjoint_backward_v2(E_j, qs_j, qds_j, jl, jm,
                                                 mode=mode)
    Ed_t, EdA_t = dp_ref.adjoint_backward_q(*qs, *qds, _port(E_j, B, K, S),
                                            tl, tm, mode=mode)
    same(Ed_t, Ed_j)
    same(EdA_t, EdA_j)


def test_pallas_long_autograd_with_bf16_q_matches_jax(bf16_q):
    """``expected_alignment`` (E and E_A) and its VJP in theta, A and Et
    under ``backend="pallas_long"`` with ``Q_DTYPE`` bf16 in both
    packages; the float32 Q run of the port lies farther from JAX's bf16
    run than the tolerance (so the rounding is really taken)."""
    B, N, M = 3, 21, 13
    theta, A, ln, lm, Zt, Za, Et = _problem(41, B, N, M)
    lens = (jnp.asarray(ln), jnp.asarray(lm))

    def f(t, a, e):
        return jdp.expected_alignment(t, a, lens, e, backend="pallas_long",
                                      return_gap=True)

    out_j, vjp = jax.vjp(f, jnp.asarray(theta), jnp.asarray(A),
                         jnp.asarray(Et))
    want = [*out_j, *vjp((jnp.asarray(Zt), jnp.asarray(Za)))]

    def port():
        t = torch.tensor(theta, requires_grad=True)
        a = torch.tensor(A, requires_grad=True)
        e = torch.tensor(Et, requires_grad=True)
        out = tdp.expected_alignment(t, a, (ln, lm), e,
                                     backend="pallas_long", return_gap=True)
        loss = (out[0] * torch.tensor(Zt)).sum() + \
            (out[1] * torch.tensor(Za)).sum()
        return [o.detach() for o in out] + list(
            torch.autograd.grad(loss, (t, a, e)))

    got = port()
    tdp.Q_DTYPE = None          # restored by the fixture's monkeypatch
    f32 = port()
    far = 0.0
    for g, g32, w in zip(got, f32, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5)
        far = max(far, np.abs(g32.numpy() - w).max())
    assert far > 1e-3
