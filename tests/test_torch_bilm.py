"""The BiLM, the RNN head and the BiLM's tokenizers of the port on the CPU
against the JAX package (ROADMAP A2), with weights carried across by
``params_from_jax``:

* ``UniprotTokenizer`` / ``UniprotPairTokenizer`` / ``Uniprot21``: the
  same ids on strings with OUBZ, lowercase letters, unknown letters and
  ``pad_ends``; exact;
* ``BiLM.encode`` and its log-probabilities at ``num_layers`` 1 and 2 with
  ragged lengths, compared at true positions; the port's features at
  true positions do not depend on pad content or pad width
  (``tests/test_models.py:55-78``); ``convert_bepler_bilm`` and
  ``load_bilm`` on a Bepler-layout torch module
  (``tests/test_bilm_convert.py:31-42``) on both sides;
* ``StackedRNN`` (lstm and gru, ragged lengths), ``LMEmbed`` and
  ``EmbedLinear`` against the JAX heads;
* ``cli.train --lm-type bilstm --layer-type rnn`` -> ``load_model``
  (the BiLM's geometry and tokenizer from config.json) -> ``align``.
  The fit trajectories against the JAX trainer are
  ``tests/test_torch_bilm_fit.py``'s.

Tolerances.  The recurrences run in float32 on both sides (flax's
``nn.RNN`` keeps a float32 carry, so float64 parameters do not run):
atol 1e-5 on outputs of unit scale, where two libraries' sums of the
same products differ in the last bits (read: BiLM features 7.5e-8,
log-probabilities 4.8e-7, the heads 6.0e-8); the Bepler module's own
LSTM, which adds its two biases in its own order, to 1e-5 too (read
~1e-7).  ``LMEmbed`` / ``EmbedLinear`` in float64 to 1e-12.
Converted weights and tokenizer ids exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.cli import train as ttrain
from deepblast_torch.data import alphabet as talpha
from deepblast_torch.models import heads as theads
from deepblast_torch.models import lm as tlm
from deepblast_torch.models.convert import params_from_jax
from deepblast_torch.train.checkpoint import Checkpointer, load_model
from deepblast_tpu.data import alphabet as jalpha
from deepblast_tpu.models import heads as jheads
from deepblast_tpu.models import lm as jlm
from test_torch_train import _write_tsv
from test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)

ATOL = 1e-5
STRINGS = ["ACDEFGHIKLMNPQRSTVWY", "ouBZ", "mkTAyIAKqr", "XXJ*-", ""]
# the Bepler layout of tests/test_bilm_convert.py
NIN, NOUT, EMB, HID = 8, 7, 7, 5


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("pad_ends", [False, True])
def test_uniprot_tokenizers_match_jax(pad_ends):
    jt, tt = jalpha.UniprotTokenizer(pad_ends), \
        talpha.UniprotTokenizer(pad_ends)
    jp, tp = jalpha.UniprotPairTokenizer(pad_ends), \
        talpha.UniprotPairTokenizer(pad_ends)
    for s in STRINGS:
        want, got = jt(s), tt(s)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tt(s.encode()), want)
        (gi, gm), (wi, wm) = tp(s), jp(s)
        assert gi.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
        assert tt.decode(got) == jt.decode(want)
    assert list(tt("OUBZ")) == ([20] if pad_ends else []) + \
        [11, 4, 20, 20] + ([20] if pad_ends else [])
    ja, ta = jalpha.Uniprot21(mask=True), talpha.Uniprot21(mask=True)
    assert len(ta) == len(ja) == 20
    assert ta.get_kmer(1234, 4) == ja.get_kmer(1234, 4)


def _bilm_pair(num_layers, seed=0):
    jm = jlm.BiLM(nin=22, nout=21, embedding_dim=6, hidden_dim=5,
                  num_layers=num_layers)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 21, (3, 9))
    lens = np.array([9, 5, 1])
    p = _f32(jm.init(jax.random.key(seed), jnp.asarray(tok),
                     jnp.asarray(lens)))
    tm = tlm.BiLM(22, 21, 6, 5, num_layers)
    tm.load_state_dict(params_from_jax(p))
    return jm, p, tm, tok, lens


@pytest.mark.parametrize("num_layers", [1, 2])
def test_bilm_matches_jax(num_layers):
    """``encode`` (``2 * num_layers * hidden`` features, ``[fwd_0, rvs_0,
    ...]``) and the log-probabilities at the true positions of ragged
    pairs, one of length 1."""
    jm, p, tm, tok, lens = _bilm_pair(num_layers)
    jt, jl = jnp.asarray(tok), jnp.asarray(lens)
    want = np.asarray(jm.apply(p, jt, jl, method=jlm.BiLM.encode))
    want_lp = np.asarray(jm.apply(p, jt, jl))
    with torch.no_grad():
        got = tm.encode(torch.tensor(tok), torch.tensor(lens)).numpy()
        got_lp = tm(torch.tensor(tok), torch.tensor(lens)).numpy()
        full = tm.encode(torch.tensor(tok)).numpy()
    assert got.shape == (3, 9, tm.hidden_size) == (3, 9, 2 * num_layers * 5)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(got_lp[b, :n], want_lp[b, :n], rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(
        full, np.asarray(jm.apply(p, jt, method=jlm.BiLM.encode)), rtol=0,
        atol=ATOL)


def test_bilm_reverse_respects_lengths():
    """Features at true positions do not depend on pad content or pad
    width (``tests/test_models.py:55-78`` on the port)."""
    _, _, tm, tok, lens = _bilm_pair(2, seed=3)
    rng = np.random.default_rng(4)
    wide = np.pad(tok, ((0, 0), (0, 7)))
    wide[:, 9:] = rng.integers(0, 21, (3, 7))
    junk = tok.copy()
    for b, n in enumerate(lens):
        junk[b, n:] = rng.integers(0, 21, 9 - n)
    with torch.no_grad():
        outs = [tm.encode(torch.tensor(t), torch.tensor(lens)).numpy()
                for t in (tok, wide, junk)]
    for b, n in enumerate(lens):
        for o in outs[1:]:
            np.testing.assert_array_equal(o[b, :n], outs[0][b, :n])


def _bepler_module(seed):
    torch.manual_seed(seed)
    m = torch.nn.Module()
    m.embed = torch.nn.Embedding(NIN, EMB, padding_idx=NIN - 1)
    m.rnn = torch.nn.ModuleList([
        torch.nn.LSTM(EMB if i == 0 else HID, HID, 1, batch_first=True)
        for i in range(2)])
    m.linear = torch.nn.Linear(HID, NOUT)
    return m


def test_convert_bepler_bilm_matches_jax(tmp_path):
    """A Bepler-layout module converted by the port equals the JAX tree
    carried across, exactly (the two biases summed as the JAX converter
    sums them); the port's BiLM on it equals the JAX BiLM on its own
    conversion and the module's own LSTMs; ``load_bilm`` of the saved
    state dict gives both the geometry and weights of JAX's."""
    bm = _bepler_module(1)
    sd = bm.state_dict()
    got = tlm.convert_bepler_bilm(sd, num_layers=2)
    jp = jlm.convert_bepler_bilm(sd, num_layers=2)
    want = params_from_jax(jp)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    tm = tlm.BiLM(NIN, NOUT, EMB, HID, 2)
    tm.load_state_dict(got)
    rng = np.random.default_rng(2)
    tok, lens = rng.integers(0, NIN - 1, (2, 9)), np.array([9, 4])
    jb = jlm.BiLM(nin=NIN, nout=NOUT, embedding_dim=EMB, hidden_dim=HID,
                  num_layers=2)
    with torch.no_grad():
        feats = tm.encode(torch.tensor(tok), torch.tensor(lens))
        lp = tm(torch.tensor(tok), torch.tensor(lens)).numpy()
        x = torch.tensor(rng.standard_normal((2, 6, EMB)),
                         dtype=torch.float32)
        np.testing.assert_allclose(tm.lstm0(x)[0].numpy(),
                                   bm.rnn[0](x)[0].numpy(), rtol=0,
                                   atol=ATOL)
    want_f = np.asarray(jb.apply(jp, jnp.asarray(tok), jnp.asarray(lens),
                                 method=jlm.BiLM.encode))
    want_lp = np.asarray(jb.apply(jp, jnp.asarray(tok), jnp.asarray(lens)))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(feats.numpy()[b, :n], want_f[b, :n],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(lp[b, :n], want_lp[b, :n], rtol=0,
                                   atol=ATOL)
    f = tmp_path / "lstm2x.pt"
    torch.save(sd, str(f))
    tmod, tsd = tlm.load_bilm(str(f))
    jmod, jsd = jlm.load_bilm(str(f))
    assert (tmod.nin, tmod.nout, tmod.embedding_dim, tmod.hidden_dim,
            tmod.num_layers) == (jmod.nin, jmod.nout, jmod.embedding_dim,
                                 jmod.hidden_dim, jmod.num_layers)
    want = params_from_jax(jsd)
    assert all(torch.equal(tsd[k], want[k]) for k in want)
    tmod.load_state_dict(tsd)
    assert tlm.pretrained_language_models["bilstm"] is tlm.BiLM
    assert tlm.pretrained_language_models["prot_t5_xl"]().num_layers == 24


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_stacked_rnn_matches_jax(rnn_type):
    """Two bidirectional layers, ragged lengths (one of 1), dropout 0.5
    inactive in eval; the auto-named flax cells map onto ``fwd{i}`` /
    ``bwd{i}``; and through ``build_head("rnn")``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 8, 5)).astype(np.float32)
    lens = np.array([8, 4, 1])
    jm = jheads.StackedRNN(4, 3, layers=2, dropout=0.5, rnn_type=rnn_type)
    p = _f32(jm.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(lens)))
    want = np.asarray(jm.apply(p, jnp.asarray(x), jnp.asarray(lens)))
    tm = theads.StackedRNN(5, 4, 3, layers=2, dropout=0.5,
                           rnn_type=rnn_type).eval()
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(lens)).numpy()
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0,
                                   atol=ATOL)
    if rnn_type == "lstm":
        jb = jheads.build_head("rnn", embedding_dim=5, hidden_dim=4,
                               layers=2)
        pb = _f32(jb.init(jax.random.key(2), jnp.asarray(x),
                          jnp.asarray(lens)))
        tb = theads.build_head("rnn", embedding_dim=5, hidden_dim=4,
                               layers=2)
        tb.load_state_dict(params_from_jax(pb))
        with torch.no_grad():
            got = tb(torch.tensor(x), torch.tensor(lens)).numpy()
        want = np.asarray(jb.apply(pb, jnp.asarray(x), jnp.asarray(lens)))
        for b, n in enumerate(lens):
            np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0,
                                       atol=ATOL)


@pytest.mark.parametrize("copier", ["deepcopy", "pickle"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_stacked_rnn_copies_keep_flax_biases(rnn_type, copier):
    """A deep copy or a pickle of a head keeps flax's cell biases through
    AdamW steps: torch's second LSTM bias and the GRU's hidden-side reset
    and update biases stay zero, get no gradient and take no part in the
    outputs."""
    import copy
    import io
    head = theads.StackedRNN(5, 4, 3, layers=1, rnn_type=rnn_type)
    if copier == "deepcopy":
        head = copy.deepcopy(head)
    else:
        buf = io.BytesIO()
        torch.save(head, buf)
        buf.seek(0)
        head = torch.load(buf, weights_only=False)
    rnns = [head.fwd0, head.bwd0]
    dead = [(r.bias_ih_l0, slice(None)) if rnn_type == "lstm"
            else (r.bias_hh_l0, slice(0, 8)) for r in rnns]
    opt = torch.optim.AdamW([p for p in head.parameters()
                             if p.requires_grad], lr=1e-2)
    x = torch.randn((2, 6, 5), generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([6, 3])
    for _ in range(3):
        opt.zero_grad()
        head(x, lens).square().sum().backward()
        for p, s in dead:
            assert p.grad is None or p.grad[s].abs().max().item() == 0.0
        opt.step()
    for p, s in dead:
        assert p[s].abs().max().item() == 0.0
    with torch.no_grad():
        want = head(x, lens)
        for p, s in dead:
            p[s] = 1.0
        if rnn_type == "gru":   # the GRU's dead biases take no part
            torch.testing.assert_close(head(x, lens), want, rtol=0, atol=0)


@pytest.mark.parametrize("use_lm", [False, True])
def test_lm_embed_and_embed_linear_match_jax(use_lm):
    rng = np.random.default_rng(6)
    tok = rng.integers(0, 22, (2, 7))
    states = rng.standard_normal((2, 7, 10))
    jm = jheads.EmbedLinear(22, 6, 4, use_lm=use_lm)
    args = (jnp.asarray(tok), jnp.asarray(states)) if use_lm else \
        (jnp.asarray(tok),)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               jm.init(jax.random.key(3), *args))
    want = np.asarray(jm.apply(p, *args))
    tm = theads.EmbedLinear(22, 6, 4, use_lm=use_lm, lm_dim=10,
                            dtype=torch.float64)
    tm.load_state_dict(params_from_jax(p))
    targs = (torch.tensor(tok), torch.tensor(states)) if use_lm else \
        (torch.tensor(tok),)
    with torch.no_grad():
        np.testing.assert_allclose(tm(*targs).numpy(), want, rtol=0,
                                   atol=1e-12)
    if use_lm:
        le = theads.LMEmbed(22, 6, 10, dtype=torch.float64)
        jle = jheads.LMEmbed(22, 6)
        pl = {"params": p["params"]["lmembed"]}
        le.load_state_dict(params_from_jax(pl))
        with torch.no_grad():
            np.testing.assert_allclose(le(*targs).numpy(),
                                       np.asarray(jle.apply(pl, *args)),
                                       rtol=0, atol=1e-12)


def test_cli_train_bilstm_rnn_then_load_model_aligns(tmp_path):
    """``cli.train --lm-type bilstm --layer-type rnn`` keeps both in
    config.json with the BiLM's geometry and tokenizer; ``load_model``
    rebuilds that BiLM with the best checkpoint's aligner and serves
    ``align``; a tokenizer of another class is refused."""
    train, valid = tmp_path / "train.tsv", tmp_path / "valid.tsv"
    _write_tsv(train, fixture_frame(n_rows=8, seed=1))
    _write_tsv(valid, fixture_frame(n_rows=4, seed=2))
    out = tmp_path / "out"
    assert ttrain.main([
        "--train-pairs", str(train), "--valid-pairs", str(valid),
        "-o", str(out), "--embedding-dim", "16", "--hidden-dim", "8",
        "--batch-size", "4", "--epochs", "1", "--max-len", "64",
        "--lm-type", "bilstm", "--layer-type", "rnn",
        "--device", "cpu"]) == 0
    with open(out / "config.json") as f:
        cfg = json.load(f)
    assert (cfg["lm_type"], cfg["layer_type"]) == ("bilstm", "rnn")
    assert cfg["bilstm_onehot_channel"] is True
    assert cfg["bilm"] == dict(nin=32, nout=31, embedding_dim=4,
                               hidden_dim=4, num_layers=2,
                               tokenizer="prot_t5")
    model = load_model(str(out), device="cpu")
    assert isinstance(model.lm, tlm.BiLM)
    assert isinstance(model.tokenizer, talpha.ProtT5Tokenizer)
    best = Checkpointer(str(out / "checkpoints")).restore()
    for k, v in best["aligner"].items():
        assert torch.equal(model.aligner.state_dict()[k], v)
    for x, y in (("ACDEFGHIKL", "ACDFGHIKLM"), ("MKTAYIAK", "MKTAYK")):
        s = model.align(x, y)
        assert s.count(":") + s.count("1") == len(x)
        assert s.count(":") + s.count("2") == len(y)
    with pytest.raises(ValueError, match="reads the ids of ProtT5"):
        load_model(str(out), device="cpu",
                   tokenizer=talpha.UniprotPairTokenizer())
