"""The T5 encoder's packed rows (``deepblast_torch.models.lm._Packing``):
where the mask leaves positions padded, the token-wise layers run on the
valid rows alone and only the attention core sees the padded layout.

Checked on the CPU at tiny sizes: the packed forward against the padded
computation (the blocks on the whole ``(B, L)`` with the output multiplied
by the mask, :func:`_padded`), against each row run alone and against the
JAX ``T5Encoder``; finetune gradients; the bf16 compute dtype; a batch of
full rows, or a call with no count of valid rows, taking the padded
path with no index operation and no read of a value; the counters
``lm.rows`` and ``lm.rows_padded``; and the trainer and the search CLI,
whose batches carry the host's lengths so that the count of valid
residues needs no read from the card.

Tolerances: packed against padded in float64, 1e-12 (read: 0.0; the
token-wise layers see the same valid rows, and a masked key's probability
is exactly 0).  Against a row run alone, unpadded, or against JAX: 1e-5,
as ``test_torch_models.test_t5_encoder_matches_flax``: the attention
scores, their softmax and the RMSNorm variance are float32 by design, and
a softmax over a row's ``n`` keys sums in another order than over ``L``
keys with ``L - n`` zeros (read: up to 2.7e-7; the padded computation
reads the same).  Gradients: 1e-12 of each gradient's scale (read:
2.1e-16; a weight's gradient sums the valid rows where the padded one
also adds the pad rows' zeros).  bf16: the packed and padded
computations to 1e-6 of scale (read: 0.0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepblast_torch.data.dataset import TMAlignDataset, make_batches
from deepblast_torch.models import lm as tlm
from deepblast_torch.models.convert import params_from_jax
from deepblast_torch.train import trainer as ttrainer
from deepblast_torch.utils import profiling
from deepblast_tpu.models import lm as jlm
from synthetic_pairs import homolog_row
import torch_threads  # noqa: F401  (PyTorch threads a worker)

LENGTHS = [17, 1, 9, 13, 4]     # a full row, a length-1 row, ragged rows
T = sum(LENGTHS)                # the valid rows, as a caller counts them
INDEX_OPS = ("index_select", "index_copy", "scatter", "searchsorted",
             "cumsum", "nonzero", "index_put")


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.drain()
    yield
    profiling.drain()


def _padded(m, tokens, mask):
    """The encoder as it runs without packing: every block on the padded
    ``(B, L)``, the output multiplied by the mask."""
    mask = mask.bool()
    x = m.embed(tokens).to(m.cfg.compute_dtype)
    bias = None
    for i in range(m.cfg.num_layers):
        x, bias = getattr(m, f"block{i}")(x, mask, bias)
    x = m.ln_final(x)
    return x * mask[..., None].to(x.dtype)


def _encoder(ff="relu", params=torch.float64, **cfg):
    torch.manual_seed(0)
    m = tlm.T5Encoder(tlm.T5Config.tiny(feed_forward_proj=ff, **cfg),
                      dtype=params)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.3)
    return m


def _ragged(lengths=LENGTHS, seed=1):
    g = torch.Generator().manual_seed(seed)
    L = max(lengths)
    tokens = torch.randint(0, 32, (len(lengths), L), generator=g)
    mask = torch.arange(L)[None, :] < torch.tensor(lengths)[:, None]
    return tokens, mask


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_packed_equals_padded_and_each_row_alone(ff):
    m = _encoder(ff)
    tokens, mask = _ragged()
    with torch.no_grad():
        got = m(tokens, mask, T)
        want = _padded(m, tokens, mask)
        alone = [m(tokens[b:b + 1, :n])[0] for b, n in enumerate(LENGTHS)]
    valid = mask[..., None].expand_as(got)
    assert (got[~valid] == 0).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(got[b, :n].numpy(), alone[b].numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_packed_matches_flax(ff):
    rng = np.random.default_rng(4)
    L = max(LENGTHS)
    tokens = rng.integers(0, 32, (len(LENGTHS), L))
    mask = np.arange(L)[None, :] < np.array(LENGTHS)[:, None]
    jm = jlm.T5Encoder(jlm.T5Config.tiny(dtype=jnp.float64,
                                         feed_forward_proj=ff))
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               jm.init(jax.random.key(4), jnp.asarray(tokens)))
    want = np.asarray(jm.apply(p, jnp.asarray(tokens), jnp.asarray(mask)))
    tm = tlm.T5Encoder(tlm.T5Config.tiny(feed_forward_proj=ff),
                       dtype=torch.float64)
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = tm(torch.tensor(tokens), torch.tensor(mask),
                 int(mask.sum())).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[~mask].any()


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_finetune_gradients_equal_the_padded_computations(ff):
    """Gradients flow through the gather and the scatter: every LM
    parameter's gradient is the padded computation's."""
    m = _encoder(ff)
    tokens, mask = _ragged()
    w = torch.randn(tokens.shape + (m.cfg.d_model,), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))

    def grads(forward):
        m.zero_grad(set_to_none=True)
        (forward(m, tokens, mask) * w).sum().backward()
        return {n: p.grad.clone() for n, p in m.named_parameters()}
    got = grads(lambda mod, t, k: mod(t, k, T))
    want = grads(_padded)
    assert got.keys() == want.keys()
    for n in got:
        scale = want[n].abs().max().item()
        assert scale > 0, n
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-12 * scale, err_msg=n)


def test_bf16_compute_dtype_runs_packed():
    m = _encoder(params=torch.float32, dtype="bfloat16")
    tokens, mask = _ragged()
    with torch.no_grad():
        got = m(tokens, mask, T)
        want = _padded(m, tokens, mask)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all() and (got[~mask] == 0).all()
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=1e-6 * scale)


def _ops(forward):
    """``{operator: calls}`` of ``forward()`` on the CPU."""
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        forward()
    return {e.key: e.count for e in prof.key_averages()}


def test_full_rows_take_the_padded_path():
    """Every row full: the padded computation's operators and no more
    (no index operation beyond the embeddings' lookups), its result bit
    for bit, and the counters read the same rows; a ragged batch packs."""
    m = _encoder()
    tokens, _ = _ragged([9, 9, 9])
    full = torch.ones(tokens.shape, dtype=torch.bool)
    want = _ops(lambda: _padded(m, tokens, full))
    assert _ops(lambda: m(tokens, full, tokens.numel())) == want
    assert not [k for k in want if any(op in k for op in INDEX_OPS[1:])]
    with torch.no_grad():
        assert torch.equal(m(tokens, full), _padded(m, tokens, full))
    with profiling.recording():
        with torch.no_grad():
            m(tokens, full, tokens.numel())
            m(tokens)
    assert profiling.drain()["counters"] == {"lm.rows": 54,
                                             "lm.rows_padded": 54}
    tokens, mask = _ragged()
    assert "aten::index_copy_" in _ops(lambda: m(tokens, mask, T))
    with profiling.recording():
        with torch.no_grad():
            m(tokens, mask, T)
    assert profiling.drain()["counters"] == {
        "lm.rows": T, "lm.rows_padded": tokens.numel()}


READS = ("aten::item", "aten::_local_scalar_dense", "aten::nonzero")


def test_without_a_count_of_rows_a_ragged_mask_runs_padded_unread():
    """The encoder never reads the mask's values (a read would wait for a
    card): given no ``rows``, a ragged mask takes the padded path, with
    the padded computation's operators, result and counters; given them,
    it packs, and reads nothing either."""
    m = _encoder()
    tokens, mask = _ragged()
    want = _ops(lambda: _padded(m, tokens, mask))
    got = _ops(lambda: m(tokens, mask))
    assert got == want
    assert not [k for k in got if k in READS]
    assert not [k for k in _ops(lambda: m(tokens, mask, T)) if k in READS]
    with torch.no_grad():
        assert torch.equal(m(tokens, mask), _padded(m, tokens, mask))
    with profiling.recording():
        with torch.no_grad():
            m(tokens, mask)
    assert profiling.drain()["counters"] == {
        "lm.rows": tokens.numel(), "lm.rows_padded": tokens.numel()}


# -- the trainer -------------------------------------------------------------

TINY = dict(embedding_dim=32, hidden_dim=16, layers=1, k_size=3,
            vocab_size=32, lm_type="prot_t5", batch_size=4,
            learning_rate=5e-3, epochs=2, scheduler="none", max_len=64,
            pad_multiple=64, mask_gaps=True, dropout=0.0, grad_clip=1.0)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(7)
    return [homolog_row(rng, f"r{i}", 6, 40) for i in range(8)]


def _model(**kw):
    cfg = ttrainer.DeepBLASTConfig(**dict(TINY, **kw))
    torch.manual_seed(3)
    return ttrainer.DeepBLAST(cfg, lm=tlm.T5Encoder(tlm.T5Config.tiny()),
                              device="cpu").init()


def test_embeddings_of_a_ragged_batch_equal_each_row(rows):
    model = _model()
    ds = TMAlignDataset(rows)
    batch = next(make_batches(ds, 8, shuffle=False, pad_multiple=16))
    assert len(set(batch["x_len"])) > 1
    b = model._as_batch(batch)
    with profiling.recording(), torch.no_grad():
        hx, hy = model._embeddings(b)
    assert profiling.drain()["counters"]["lm.rows"] == \
        int(batch["x_len"].sum()) + int(batch["y_len"].sum())
    for i in range(len(rows)):
        one = {k: v[i:i + 1] for k, v in batch.items()
               if k in ("x", "y", "x_len", "y_len")}
        n, mm = int(batch["x_len"][i]), int(batch["y_len"][i])
        one["x"], one["y"] = one["x"][:, :n], one["y"][:, :mm]
        with torch.no_grad():
            ox, oy = model._embeddings(model._as_batch(one))
        np.testing.assert_allclose(hx[i, :n].numpy(), ox[0].numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(hy[i, :mm].numpy(), oy[0].numpy(),
                                   rtol=0, atol=1e-5)
        assert not hx[i, n:].any() and not hy[i, mm:].any()


class _Losses:
    def __init__(self):
        self.rows = []

    def log_scalar(self, tag, value, step):
        self.rows.append((tag, int(step), float(value)))


def _fit(rows, **kw):
    model = _model(**kw)
    seen = []
    model.lm.register_forward_pre_hook(
        lambda mod, args: seen.append(args[2]))
    rec = _Losses()
    with profiling.recording():
        model.fit(TMAlignDataset(rows), logger=rec)
    return rec.rows, model, seen, profiling.drain()["counters"]


@pytest.mark.parametrize("finetune", [False, True])
def test_fit_packs_with_host_rows_at_every_dispatch_size(rows, finetune):
    """``fit`` at ``steps_per_dispatch`` 1 and 4 (batches of one shape,
    so whole chunks) gives one trajectory bit for bit; the encoder gets
    the host's count of valid rows on every call, and its counters' share
    of padding is ``fit``'s."""
    rows1, m1, seen1, c1 = _fit(rows, finetune=finetune)
    rows4, m4, seen4, c4 = _fit(rows, finetune=finetune,
                                steps_per_dispatch=4)
    assert rows1 == rows4 and len(rows1) == 4
    for (k, a), b in zip(m1.aligner.state_dict().items(),
                         m4.aligner.state_dict().values()):
        assert torch.equal(a, b), k
    for (k, a), b in zip(m1.lm.state_dict().items(),
                         m4.lm.state_dict().values()):
        assert torch.equal(a, b), k
    for seen in (seen1, seen4):
        assert len(seen) == 8 and all(type(r) is int for r in seen)
    for c in (c1, c4):
        assert c["lm.rows"] < c["lm.rows_padded"]
        assert (c["lm.rows"], c["lm.rows_padded"]) == \
            (c["fit.residues"], c["fit.residues_padded"])
    assert c1 == c4


def test_align_takes_the_padded_path(rows):
    """A request is a batch of one at its own length: every row full."""
    model = _model()
    with profiling.recording():
        model.align(rows[0][5], rows[0][6])
    c = profiling.drain()["counters"]
    assert c == {"lm.rows": len(rows[0][5]) + len(rows[0][6]),
                 "lm.rows_padded": len(rows[0][5]) + len(rows[0][6])}


def test_lm_apply_counts_the_masks_rows_from_the_hosts_lengths():
    """Each length within ``[0, L]``, as the mask counts it; no host
    lengths, no count (the padded path)."""
    model = _model()
    seen = []
    model.lm.register_forward_pre_hook(
        lambda mod, args: seen.append(args[2]))
    tokens = torch.zeros((3, 8), dtype=torch.long)
    with torch.no_grad():
        for lengths in ([8, 3, 0], [9, 3, -1]):
            model._lm_apply(tokens, torch.tensor(lengths), np.array(lengths))
        model._lm_apply(tokens, torch.tensor([8, 3, 0]))
    assert seen == [11, 11, None]


def test_host_lengths_ride_beside_lengths_on_a_card():
    """A side's lengths on the host are kept; lengths on a card are not
    read, but the host copies a batch carries beside them are."""
    host = ttrainer._host_lengths(dict(x_len=np.array([8, 3]),
                                       y_len=torch.tensor([2, 2])))
    assert {k: v.tolist() for k, v in host.items()} == {
        "x_len_host": [8, 3], "y_len_host": [2, 2]}
    on_a_card = torch.tensor([2, 2, 2], device="meta")
    assert list(ttrainer._host_lengths(
        dict(x_len=torch.tensor([2, 2, 2]), y_len=on_a_card))) \
        == ["x_len_host"]
    host = ttrainer._host_lengths(dict(
        x_len=on_a_card, y_len=on_a_card, x_len_host=np.array([1, 2, 3]),
        y_len_host=[4, 5, 6]))
    assert {k: v.tolist() for k, v in host.items()} == {
        "x_len_host": [1, 2, 3], "y_len_host": [4, 5, 6]}


def test_search_gives_the_encoder_the_hosts_lengths(rows, tmp_path,
                                                    monkeypatch):
    """The search CLI copies each batch to the device before it scores
    it; the host's lengths ride beside the copy, so the encoder packs
    its valid rows without reading the card."""
    from deepblast_torch.cli import search
    from deepblast_torch.train.checkpoint import save_model
    model = _model()
    ckpt = str(tmp_path / "model")
    save_model(model, ckpt)
    seqs = [r[5] for r in rows[:3]], [r[6] for r in rows[:2]]
    for name, group in zip(("q.fa", "db.fa"), seqs):
        with open(tmp_path / name, "w") as f:
            f.writelines(f">{name[0]}{i}\n{s}\n" for i, s in enumerate(group))
    given = []
    score_pairs = ttrainer.DeepBLAST.score_pairs

    def spy(self, batch):
        given.append({k: type(v) for k, v in batch.items()})
        return score_pairs(self, batch)
    monkeypatch.setattr(ttrainer.DeepBLAST, "score_pairs", spy)
    with profiling.recording():
        assert search.main([
            "--query-fasta", str(tmp_path / "q.fa"),
            "--db-fasta", str(tmp_path / "db.fa"),
            "--load-from-checkpoint", ckpt,
            "--output-file", str(tmp_path / "hits.tsv"),
            "--batch-size", "4", "--pad-multiple", "16",
            "--device", "cpu"]) == 0
    c = profiling.drain()["counters"]
    assert len(given) == 2
    for keys in given:
        assert keys["x_len"] is torch.Tensor
        assert keys["x_len_host"] is keys["y_len_host"] is np.ndarray
    assert 0 < c["lm.rows"] < c["lm.rows_padded"]
