"""JAX model directories into the port: the port's ``load_model`` refuses
an orbax ``checkpoints/`` (it used to serve ``init()`` weights in its
place without a word), and ``scripts/torch_import_jax_model.py``, run in
process, converts a ``deepblast-train`` directory, which the port's
``load_model`` then serves as the JAX ``load_model`` does.

Each JAX directory holds the tiny config's ``config.json`` (seed 3) and
an orbax checkpoint at step 5 of a state initialised with another key,
so weights from ``init()`` would show.  ``dp_bf16_residuals`` is off, so
that both packages decode in float32 (the JAX package's CPU default,
scan, resolves ``"auto"`` to off).  Tolerance: ``align`` strings
identical; ``score_pairs`` rtol 1e-5, as ``test_torch_slice.py``.  The
JAX model's embeddings and ``score_pairs`` run under ``jax.jit``, which
compiles each once for the pairs of one shape, where eager flax LSTMs
and T5 layers are traced again at every call.  The
``prot_t5`` model is built at the tiny T5 geometry (the JAX
``T5Config.prot_t5_xl`` patched in this process): ProtT5-XL's 1.2 B
parameters do not fit a CPU test.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepblast_torch.data.state_utils import pad_sequences
from deepblast_torch.train.checkpoint import IMPORT_SCRIPT, load_model
from deepblast_tpu.models import lm as jlm
from deepblast_tpu.train import checkpoint as jcheckpoint
from deepblast_tpu.train import trainer as jtrainer
import torch_threads  # noqa: F401  (PyTorch threads a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embedding_dim=16, hidden_dim=16, layers=2, k_size=5,
            vocab_size=32, lm_type="embed", batch_size=4,
            learning_rate=5e-3, epochs=1, max_len=64, pad_multiple=8,
            dropout=0.0, seed=3, dp_bf16_residuals=False)
# three pairs of one shape (12 x 9): the JAX align compiles once
PAIRS = [("HECDRKTCDESF", "LKCSGCGKN"), ("YRCHKVCPYTFV", "HECDDCSKQ"),
         ("YACSGGCGQNFR", "LICPKHTRD")]
MODELS = {"embed": {}, "embed_finetune": dict(finetune=True),
          "bilstm": dict(lm_type="bilstm"), "prot_t5": dict(lm_type="prot_t5")}


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_import_jax_model", os.path.join(REPO, IMPORT_SCRIPT))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_dir(path, fields, edit=None):
    """A ``deepblast-train`` directory: config.json and an orbax checkpoint
    at step 5 of ``init(key 7)`` (``edit`` may change the state)."""
    cfg = jtrainer.DeepBLASTConfig(**dict(TINY, **fields))
    state = jtrainer.DeepBLAST(cfg).init(jax.random.key(7))
    state = state.replace(step=jnp.asarray(5, jnp.int32))
    if edit:
        state = edit(state)
    jcheckpoint.save_config(cfg, str(path))
    jcheckpoint.Checkpointer(str(path / "checkpoints")).save(
        state, {"validation_loss": 1.0})
    return str(path)


def _batch(tok):
    xt, xl = pad_sequences([tok(x)[0] for x, _ in PAIRS])
    yt, yl = pad_sequences([tok(y)[0] for _, y in PAIRS])
    return dict(x=xt, y=yt, x_len=xl, y_len=yl)


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """``name -> deepblast-train directory`` of each model of MODELS, made
    once for the module (prot_t5 at the tiny T5 geometry)."""
    made = {}

    def get(name):
        if name not in made:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jlm.T5Config, "prot_t5_xl",
                           classmethod(lambda cls, **kw: cls.tiny(**kw)))
                made[name] = _jax_dir(tmp_path_factory.mktemp(name),
                                      MODELS[name])
        return made[name]
    return get


@pytest.fixture
def tiny_prot_t5(monkeypatch):
    monkeypatch.setattr(jlm.T5Config, "prot_t5_xl",
                        classmethod(lambda cls, **kw: cls.tiny(**kw)))


def test_load_model_refuses_a_jax_model_directory(tmp_path, jax_dirs):
    jax_dir = jax_dirs("embed")
    with pytest.raises(ValueError, match=IMPORT_SCRIPT) as e:
        load_model(jax_dir, device="cpu")
    assert os.path.join(jax_dir, "checkpoints", "5") in str(e.value)
    # a directory with config.json alone keeps init() with the seed
    os.makedirs(tmp_path / "bare")
    jcheckpoint.save_config(jtrainer.DeepBLASTConfig(**TINY),
                            str(tmp_path / "bare"))
    assert load_model(str(tmp_path / "bare"), device="cpu").step == 0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_converted_model_serves_as_jax(tmp_path, jax_dirs, tiny_prot_t5,
                                       capsys, name):
    jax_dir = jax_dirs(name)
    out = str(tmp_path / "port")
    assert _script().main([jax_dir, out]) == 0
    said = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert said["files"] == ["config.json", "model.pt"]

    jmodel = jcheckpoint.load_model(jax_dir)
    jmodel._embeddings = jax.jit(jmodel._embeddings, static_argnames="frozen")
    tmodel = load_model(out, device="cpu")
    with open(os.path.join(out, "config.json")) as f:
        blocks = json.load(f)
    if name == "prot_t5":
        assert blocks["t5"] == dict(vars(jlm.T5Config.tiny()),
                                    dtype="float32")
    if name == "bilstm":
        lm = jmodel.lm
        assert blocks["bilm"] == dict(
            nin=lm.nin, nout=lm.nout, embedding_dim=lm.embedding_dim,
            hidden_dim=lm.hidden_dim, num_layers=lm.num_layers,
            tokenizer="prot_t5")
    for x, y in PAIRS:
        assert tmodel.align(x, y) == jmodel.align(x, y), (x, y)
    batch = _batch(tmodel.tokenizer)
    want = np.asarray(jax.jit(jmodel.score_pairs)(
        jmodel.state, {k: jnp.asarray(v) for k, v in batch.items()}))
    np.testing.assert_allclose(tmodel.score_pairs(batch).numpy(), want,
                               rtol=1e-5)


def test_unreloadable_jax_directory_fails_with_jax_error(tmp_path):
    """A state whose LM tree is not the one the config builds (as a model
    trained from a BiLM artifact: its BiLM has ``linear``, the config's,
    initialised through ``encode``, has not; ROADMAP.md C): the JAX
    ``load_model`` raises, and the script passes that error on, noted."""
    def with_linear(state):
        p = dict(state.lm_params["params"])
        p["linear"] = {"kernel": jnp.zeros((4, 31)), "bias": jnp.zeros(31)}
        return state.replace(lm_params={"params": p})
    jax_dir = _jax_dir(tmp_path / "jax", dict(lm_type="bilstm"), with_linear)
    with pytest.raises(Exception) as e:
        _script().main([jax_dir, str(tmp_path / "port")])
    assert any("JAX package's load_model" in n
               for n in getattr(e.value, "__notes__", []))
    assert not os.path.exists(tmp_path / "port")
