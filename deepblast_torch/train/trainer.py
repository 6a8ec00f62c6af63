"""The model object for serving (``deepblast_tpu/train/trainer.py``).

:class:`DeepBLAST` holds the language model and the
:class:`~deepblast_torch.models.aligner.NeuralAligner` on one device and
serves the two inference entry points of the JAX package:

* :meth:`DeepBLAST.align` — one pair of strings -> alignment state string
  (``trainer.py:704-736``: potentials -> expected-alignment stream ->
  traceback walk on the stream);
* :meth:`DeepBLAST.score_pairs` — a padded batch -> alignment scores
  (``trainer.py:738-749``), the search path.

Entry points run on ``device="cuda"`` unless the caller passes another
device; without a CUDA device and without ``device="cpu"`` they raise.
The slice runs at precision "32": on CUDA the serving path turns TF32 off
for matmuls and cuDNN convolutions (process-wide PyTorch flags).  Fitting,
the losses and the other language models are later slices.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch
from torch import nn

from deepblast_torch.data.alphabet import ProtT5Tokenizer
from deepblast_torch.data.state_utils import revstate_f
from deepblast_torch.models.aligner import NeuralAligner
from deepblast_torch.models.lm import RMSNorm, T5Config, T5Encoder, TokenEmbed
from deepblast_torch.ops import dp as dp_ops

__all__ = ["DeepBLASTConfig", "DeepBLAST", "resolve_device"]


@dataclasses.dataclass
class DeepBLASTConfig:
    """Model hyper-parameters of the serving path (the JAX package's field
    names; its training and dtype-menu fields are ignored on load)."""

    embedding_dim: int = 1024       # LM feature dim fed to the heads
    hidden_dim: int = 1024
    layers: int = 2
    k_size: int = 5
    dropout: float = 0.0
    layer_type: str = "cnn"
    alignment_mode: str = "needleman-wunsch"
    operator: str = "softmax"
    lm_type: str = "embed"          # embed | prot_t5
    vocab_size: int = 32
    seed: int = 0

    @classmethod
    def from_json(cls, s):
        d = json.loads(s)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def resolve_device(device=None):
    """``torch.device`` for an entry point: CUDA unless asked otherwise,
    and an error, never a silent CPU run, when CUDA is asked for and
    absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return device


def init_weights(module, generator):
    """Seeded random weights: Linear/Conv normal with std
    ``1/sqrt(fan_in)`` and zero bias, embeddings standard normal, the T5
    relative-position bias normal(0.02), norms one."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(fan_in),
                            generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            std = 0.02 if name.endswith("relative_attention_bias") else 1.0
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
        elif isinstance(m, RMSNorm):
            nn.init.ones_(m.weight)


class DeepBLAST:
    """Language model + aligner on one device, for ``align`` and
    ``score_pairs``.

    ``lm`` defaults to the model of ``config.lm_type`` (ProtT5-XL geometry
    for ``"prot_t5"``); ``lm_params`` is a ``state_dict`` for it (e.g. from
    :func:`deepblast_torch.models.convert.params_from_jax`)."""

    def __init__(self, config: DeepBLASTConfig, tokenizer=None, lm=None,
                 lm_params=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.tokenizer = tokenizer or ProtT5Tokenizer()
        self.lm = (lm if lm is not None else self._build_lm()).to(
            self.device).eval()
        self._ext_lm_params = lm_params is not None
        if lm_params is not None:
            self.lm.load_state_dict(lm_params)
        self.aligner = NeuralAligner(
            embedding_dim=config.embedding_dim,
            hidden_dim=config.hidden_dim,
            layers=config.layers,
            k_size=config.k_size,
            dropout=config.dropout,
            layer_type=config.layer_type,
            alignment_mode=config.alignment_mode,
            operator=config.operator,
            device=self.device,
        ).eval()

    def _build_lm(self):
        c = self.config
        if c.lm_type == "embed":
            return TokenEmbed(c.vocab_size, c.embedding_dim,
                              device=self.device)
        if c.lm_type == "prot_t5":
            return T5Encoder(T5Config.prot_t5_xl(), device=self.device)
        raise ValueError(f"lm_type {c.lm_type!r} is not ported")

    def init(self, generator=None):
        """Seeded random weights on the model's device (the language model
        too, unless ``lm_params`` were given).  ``generator`` defaults to
        one on the device seeded with ``config.seed``."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.config.seed)
        with torch.no_grad():
            if not self._ext_lm_params:
                init_weights(self.lm, generator)
            init_weights(self.aligner, generator)
        return self

    # -- forward -----------------------------------------------------------

    def _as_batch(self, batch):
        return {k: torch.as_tensor(batch[k]).to(self.device)
                for k in ("x", "y", "x_len", "y_len")}

    def _lm_apply(self, tokens, lengths):
        if isinstance(self.lm, T5Encoder):
            L = tokens.shape[1]
            mask = torch.arange(L, device=tokens.device)[None, :] \
                < lengths[:, None]
            return self.lm(tokens, mask)
        return self.lm(tokens)

    @torch.no_grad()
    def _embeddings(self, batch):
        hx = self._lm_apply(batch["x"], batch["x_len"])
        hy = self._lm_apply(batch["y"], batch["y_len"])
        return hx, hy

    # -- inference ---------------------------------------------------------

    @torch.no_grad()
    def align(self, x: str, y: str) -> str:
        """Alignment of two residue strings as a TM-align state string
        (``1`` gap in y, ``:`` match, ``2`` gap in x)."""
        x_tok, _ = self.tokenizer(x)
        y_tok, _ = self.tokenizer(y)
        batch = self._as_batch(dict(
            x=x_tok[None], y=y_tok[None],
            x_len=np.asarray([len(x_tok)], np.int32),
            y_len=np.asarray([len(y_tok)], np.int32)))
        hx, hy = self._embeddings(batch)
        E = self.aligner.decode_stream(hx, hy,
                                       (batch["x_len"], batch["y_len"]))
        states = dp_ops.traceback_stream(E, len(x_tok), len(y_tok), 0)
        return "".join(revstate_f(s) for _, _, s in states)

    @torch.no_grad()
    def score_pairs(self, batch):
        """Alignment scores ``(B,)`` float32 of a padded batch with keys
        ``x``, ``y`` (token ids) and ``x_len``, ``y_len``."""
        batch = self._as_batch(batch)
        hx, hy = self._embeddings(batch)
        return self.aligner.score(hx, hy, (batch["x_len"], batch["y_len"]))
