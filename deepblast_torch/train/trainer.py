"""The model and its training loop (``deepblast_tpu/train/trainer.py``).

:class:`DeepBLAST` holds the language model and the
:class:`~deepblast_torch.models.aligner.NeuralAligner` on one device and
serves the entry points of the JAX package:

* :meth:`DeepBLAST.fit` — epochs of length-bucketed, shuffled batches:
  LM (frozen under ``no_grad``, or trained with ``finetune``) -> heads ->
  potentials -> differentiable ``expected_alignment`` -> masked loss ->
  ``backward()`` (the adjoint passes) -> global-norm clip -> AdamW with
  the schedule (every ``grad_accum``-th step) -> NaN check; a validation
  epoch with loss and traceback statistics; best-k checkpoints
  (``trainer.py:485-629``);
* :meth:`DeepBLAST.align` — one pair of strings -> alignment state string
  (``trainer.py:704-736``: potentials -> expected-alignment stream ->
  traceback walk on the stream; for a backend without a stream accessor,
  the natural expected alignment -> traceback);
* :meth:`DeepBLAST.score_pairs` — a padded batch -> alignment scores
  (``trainer.py:738-749``), the search path;
* :meth:`DeepBLAST.test` — a TM-align test set -> per-pair traceback
  statistics of the natural expected alignment (``trainer.py:683-699``),
  the ``evaluate`` CLI's path.

The optimizer is optax's ``clip_by_global_norm`` + ``adamw`` in PyTorch:
the clip ``g <- g / |g| * c`` when ``|g| >= c`` (``clip_grad_norm_`` adds
1e-6 to the norm), then ``torch.optim.AdamW`` with optax's defaults
(weight decay 1e-4, where torch's is 1e-2; eps 1e-8; betas 0.9, 0.999),
its rate set per update by ``LambdaLR`` over a base rate of 1.  The
aligner trains, and with ``finetune`` the LM too, in the same AdamW group
and the same global norm (``trainer.py:317-336``: optax applies the weight
decay to every leaf).

The other trainer options of the JAX package (``trainer.py:86-99``):

* ``precision`` ("32", "bf16", "16"): the compute dtype of the T5 LM
  (``T5Config.dtype``; the parameters stay float32) and the aligner's
  ``matmul_dtype`` (``_PRECISION_DTYPES``, ``:158-159``, ``:197``,
  ``:250-253``); the token-embedding LM and the heads stay float32, as in
  JAX, and an LM the caller passes in keeps its own dtype.
* ``grad_accum`` k: ``optax.MultiSteps`` (``:291-292``; optax 0.2.6): each
  step folds its gradient into the running mean ``acc + (g - acc) /
  (n + 1)``; every k-th step clips the mean, updates and advances the
  schedule, and resets the mean; the other steps change nothing (no
  weight decay).  ``step`` counts the steps; the mean and its count carry
  across epochs and into :meth:`train_state`.
* ``steps_per_dispatch`` K (``:375-398``, ``:524-586``): consecutive
  batches of one shape form chunks of K; a chunk's batches are stacked in
  pinned host memory and copied to the device in one asynchronous copy,
  then its K steps are issued back to back, their losses kept on the
  device and read (and NaN-checked) once, after the next chunk or step is
  issued.  A shape change or the end of an epoch sends the batches left
  over through as single steps.  The steps and the dropout generator run
  in the same order as at K = 1, so the trajectory is the same.

The language model (``lm_type``, ``trainer.py:241-275``): ``"embed"``, a
token embedding; ``"prot_t5"``, ProtT5-XL geometry; ``"bilstm"``, a
:class:`~deepblast_torch.models.lm.BiLM` of hidden width
``embedding_dim // 4`` over ``vocab_size`` ids, float32 whatever
``precision`` is, whose ``encode`` features follow a one-hot identity
channel of the token (``bilstm_onehot_channel``), so the heads read
``vocab_size + 4 * (embedding_dim // 4)`` features.  An LM passed in (an
artifact's, ``cli.common.build_model``) keeps its own geometry.

The DP storage menu (``ops/menu.py``) follows the JAX package's config
(``trainer.py:100-124``, ``:208-239``): ``dp_bf16_residuals`` ("auto": on
for the pallas backends, which includes the default ``pallas_bm``; the Q
backends ignore the menu), ``dp_i16_streams`` (int16 input streams, and
int16 E in the decode) and ``dp_decode_menu`` ("fast": bf16 residuals and
int16 E for :meth:`DeepBLAST.align` only).  ``fit`` and ``score_pairs``
run the training menu, ``align`` the decode menu.

Data parallel training (``fit(mesh=...)``, ``trainer.py:485-522``) runs
one process a device under ``torch.distributed`` (``parallel/mesh.py``):
every rank builds the same global batch sequence (the same shuffle seed;
the last short batch of training and validation dropped, as under the JAX
mesh) and takes its rows of each batch (``shard_batch``; of each chunk's
``(K, B, ...)`` arrays on the second axis), padded as the global batch.
The modules ``fit`` trains run under ``DistributedDataParallel`` over the
rank's ``data`` group, built after the seeded ``init`` (it broadcasts rank
0's weights), so the gradients are averaged over the data shards in every
backward, every ``grad_accum`` micro-step included, before the clip and
the update; every rank then holds the same weights.  A step's loss is a
mean over its rows, so the mean of the shards' losses (all-reduced before
they are logged) is the global batch's; the validation losses and
statistics of every shard are gathered before their means.  ``tp``
replicates, as in JAX (the ranks of one ``data`` coordinate take the same
rows).  ``mesh="auto"`` takes ``dp``, the largest divisor of
``batch_size`` that fits ``world // tp``, and the first ``dp * tp`` ranks:
the others take no batches and receive the history and the final weights
from rank 0.  Dropout draws from a generator seeded with ``seed + 1 + d``
(``d`` the rank's ``data`` coordinate), so two shards draw different masks:
with dropout the trajectory is not one process's (nor JAX's, whose RNG
differs anyway).  Rank 0 alone writes metrics and checkpoints
(``utils.logging``, ``train.checkpoint``).

Entry points run on ``device="cuda"`` unless the caller passes another
device; without a CUDA device and without ``device="cpu"`` they raise.
On CUDA the port turns TF32 off for matmuls and cuDNN (convolutions and
the LSTMs), and the reduced-precision split-K reductions of bf16 and fp16
matmuls (process-wide PyTorch flags, ``models.exact_cuda_math``), so a
float32 product is float32 and a bf16 or fp16 one accumulates in float32,
as on the TPU.  Dropout masks come
from a ``torch.Generator`` seeded with ``seed + 1``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from deepblast_torch.data.alphabet import ProtT5Tokenizer
from deepblast_torch.data.dataset import TMAlignDataset, make_batches
from deepblast_torch.data.state_utils import revstate_f, states2edges
from deepblast_torch.eval.score import ROC_COLUMNS, filter_gaps, roc_edges
from deepblast_torch.models.aligner import NeuralAligner
from deepblast_torch.models import exact_cuda_math
from deepblast_torch.models.lm import (BiLM, RMSNorm, T5Config, T5Encoder,
                                       TokenEmbed)
from deepblast_torch.ops import dp as dp_ops
from deepblast_torch.ops.menu import DTypeMenu
from deepblast_torch.parallel import mesh as mesh_lib
from deepblast_torch.train.losses import get_loss
from deepblast_torch.train.schedules import make_schedule
from deepblast_torch.unported import UNPORTED, check_ported

__all__ = ["DeepBLASTConfig", "DeepBLAST", "resolve_device"]


#: JAX config.json fields that change nothing the port computes or trains:
#: the share of validation pairs drawn as figures (no figures yet), and
#: ``use_tp_params``, which the JAX package reads nowhere
_DROPPED_FIELDS = ("visualization_fraction", "use_tp_params")
#: the port's own LM blocks of config.json (read by ``load_model``)
_LM_BLOCKS = ("t5", "bilm")

#: ``precision`` -> the aligner's matmul dtype (None: float32) and the T5
#: compute dtype (``trainer.py:158-159``)
_PRECISION_DTYPES = {"32": None, "bf16": torch.bfloat16, "16": torch.float16}
#: ``precision`` -> the name of the T5 compute dtype (``T5Config.dtype``)
_PRECISION_NAMES = {"32": "float32", "bf16": "bfloat16", "16": "float16"}


@dataclasses.dataclass
class DeepBLASTConfig:
    """Hyper-parameters (the JAX package's field names; see
    :meth:`from_json` for its fields the port does not have)."""

    # model
    embedding_dim: int = 1024       # LM feature dim fed to the heads
    hidden_dim: int = 1024
    layers: int = 2
    k_size: int = 5
    dropout: float = 0.0
    layer_type: str = "cnn"
    alignment_mode: str = "needleman-wunsch"
    operator: str = "softmax"
    backend: Optional[str] = None   # DP passes: None/pallas_bm, pallas(_long)
    lm_type: str = "embed"          # embed | bilstm | prot_t5
    vocab_size: int = 32
    finetune: bool = False          # train the LM with the aligner
    # bilstm: a one-hot identity channel before the BiLM's features (the
    # JAX package's schema marker, trainer.py:66-74); false rebuilds the
    # channel-free heads of older JAX checkpoints
    bilstm_onehot_channel: bool = True
    # optimisation
    batch_size: int = 32
    learning_rate: float = 5e-5
    epochs: int = 10
    scheduler: str = "cosine"
    loss: str = "cross_entropy"
    grad_clip: Optional[float] = None
    grad_accum: int = 1             # optax.MultiSteps every k steps
    steps_per_dispatch: int = 1     # steps a host-to-device copy
    mask_gaps: bool = True
    seed: int = 0
    precision: str = "32"           # 32 | bf16 | 16: LM and head matmuls
    # DP storage menu ("auto": on for the pallas backends, the default's
    # pallas_bm included)
    dp_bf16_residuals: "bool | str" = "auto"
    dp_i16_streams: bool = False
    dp_decode_menu: str = "default"     # default | fast (align only)
    # data
    train_pairs: Optional[str] = None
    valid_pairs: Optional[str] = None
    test_pairs: Optional[str] = None
    max_len: int = 1024
    pad_multiple: int = 16
    output_directory: Optional[str] = None
    # the model axis of fit's mesh="auto" (replicated work, as in JAX)
    tp: int = 1

    @classmethod
    def from_json(cls, s):
        """The config of a ``config.json`` written by the port or by the
        JAX package.  A field whose value the port does not take (e.g.
        ``"backend": "scan"``) raises ``ValueError`` naming its ROADMAP.md item, as does a field neither
        package writes.  Dropped: the fields of
        ``_DROPPED_FIELDS``, which change nothing the port computes or
        trains, and ``"t5"`` / ``"bilm"``, the port's own LM geometry
        (read by ``load_model``).  A bilstm config without
        ``bilstm_onehot_channel`` predates the channel and is refused with
        the JAX package's message (``trainer.py:146-153``)."""
        d = json.loads(s)
        if d.get("lm_type") == "bilstm" and "bilstm_onehot_channel" not in d:
            raise ValueError(
                "this bilstm checkpoint predates the one-hot identity "
                "channel added to the LM features (head input dim changed "
                "from embedding_dim to embedding_dim + vocab_size), so its "
                "head weights cannot load into the current architecture. "
                "Add '\"bilstm_onehot_channel\": false' to its config.json "
                "to rebuild the pre-change architecture, or re-train.")
        names = {f.name for f in dataclasses.fields(cls)}
        kept = {}
        for k, v in d.items():
            if k in _DROPPED_FIELDS or k in _LM_BLOCKS:
                continue
            if k in UNPORTED:
                check_ported(k, v, f"config.json field {k!r} =")
                if k not in names:      # the one value the port runs
                    continue
            if k not in names:
                raise ValueError(f"config.json field {k!r} is not a field of "
                                 "DeepBLASTConfig")
            kept[k] = v
        return cls(**kept)


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
    """Seeded random weights: Linear/Conv and LSTM/GRU normal with std
    ``1/sqrt(fan_in)`` and zero bias, embeddings standard normal, the T5
    relative-position bias normal(0.02), norms one."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.LSTM, nn.GRU)):
            for pname, p in m.named_parameters():
                if pname.startswith("weight"):
                    nn.init.normal_(p, 0.0, 1.0 / math.sqrt(p.shape[1]),
                                    generator=generator)
                else:
                    nn.init.zeros_(p)
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
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
    :func:`deepblast_torch.models.convert.params_from_jax`).  The heads'
    input width is the LM's feature width (:meth:`_lm_width`)."""

    def __init__(self, config: DeepBLASTConfig, tokenizer=None, lm=None,
                 lm_params=None, device=None):
        if config.precision not in _PRECISION_DTYPES:
            raise ValueError(f"precision {config.precision!r}: expected one "
                             f"of {sorted(_PRECISION_DTYPES)}")
        if config.grad_accum < 1 or config.steps_per_dispatch < 1:
            raise ValueError("grad_accum and steps_per_dispatch must be at "
                             "least 1")
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            exact_cuda_math()
        self.tokenizer = tokenizer or ProtT5Tokenizer()
        self.lm = (lm if lm is not None else self._build_lm()).to(
            self.device).eval()
        self._ext_lm_params = lm_params is not None
        if lm_params is not None:
            self.lm.load_state_dict(lm_params)
        self.dp_dtypes = self._dp_dtype_menu(config)
        self.dp_decode_dtypes = self._dp_decode_dtype_menu(config,
                                                           self.dp_dtypes)
        self.aligner = NeuralAligner(
            embedding_dim=self._lm_width(),
            hidden_dim=config.hidden_dim,
            layers=config.layers,
            k_size=config.k_size,
            dropout=config.dropout,
            layer_type=config.layer_type,
            alignment_mode=config.alignment_mode,
            operator=config.operator,
            backend=config.backend,
            matmul_dtype=_PRECISION_DTYPES[config.precision],
            dp_dtypes=self.dp_dtypes,
            device=self.device,
        ).eval()
        self.loss_fn = get_loss(config.loss)
        self.step = 0
        self.state = None   # training state to resume from (load_model)
        self._spe = 1
        self._opt = self._sched = None
        # optax.MultiSteps' state: the running gradient mean (one tensor a
        # trained parameter) and the steps folded into it
        self._acc = None
        self._mini_step = 0
        # fit's mesh, and under one the rank's data group, its size and
        # coordinate, and the DistributedDataParallel of _Trained
        self.mesh = None
        self._data = None
        self._ddp = None

    @staticmethod
    def _dp_dtype_menu(config):
        """The training and scoring storage menu (``trainer.py:208-227``):
        ``"auto"`` resolves by the backend's name, on for the pallas
        backends (``None`` is ``pallas_bm``)."""
        bf16 = config.dp_bf16_residuals
        if bf16 == "auto":
            name = dp_ops.DEFAULT_BACKEND if config.backend is None \
                else config.backend
            bf16 = name.startswith("pallas")
        elif not isinstance(bf16, bool):
            raise ValueError(f"dp_bf16_residuals {bf16!r}: expected 'auto', "
                             "true or false")
        if not (bf16 or config.dp_i16_streams):
            return None
        i16 = "int16" if config.dp_i16_streams else None
        return DTypeMenu.make(stream=i16, d="bfloat16" if bf16 else None,
                              e=i16)

    @staticmethod
    def _dp_decode_dtype_menu(config, train_menu):
        """The decode's menu for :meth:`align` (``trainer.py:229-239``)."""
        if config.dp_decode_menu == "default":
            return train_menu
        if config.dp_decode_menu == "fast":
            return DTypeMenu.make(d="bfloat16", e="int16")
        raise ValueError(f"unknown dp_decode_menu {config.dp_decode_menu!r} "
                         "(expected 'default' or 'fast')")

    def _build_lm(self):
        c = self.config
        if c.lm_type == "embed":
            return TokenEmbed(c.vocab_size, c.embedding_dim,
                              device=self.device)
        if c.lm_type == "bilstm":
            hidden = c.embedding_dim // 4
            return BiLM(nin=c.vocab_size, nout=c.vocab_size - 1,
                        embedding_dim=hidden, hidden_dim=hidden, num_layers=2,
                        device=self.device)
        if c.lm_type == "prot_t5":
            return T5Encoder(T5Config.prot_t5_xl(
                dtype=_PRECISION_NAMES[c.precision]), device=self.device)
        raise ValueError(f"unknown lm_type {c.lm_type!r}")

    def _lm_width(self):
        """The width of the features ``_lm_apply`` gives the heads, which
        the JAX heads infer from them: a BiLM's (and its one-hot
        channel's), a T5's ``d_model``, else ``config.embedding_dim``."""
        if isinstance(self.lm, BiLM):
            return self.lm.hidden_size + (
                self.config.vocab_size
                if self.config.bilstm_onehot_channel else 0)
        if isinstance(self.lm, T5Encoder):
            return self.lm.cfg.d_model
        return self.config.embedding_dim

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

    def _as_batch(self, batch, keys=("x", "y", "x_len", "y_len")):
        return {k: torch.as_tensor(batch[k]).to(self.device) for k in keys}

    def _lm_apply(self, tokens, lengths):
        if isinstance(self.lm, BiLM):
            # the features at position i never see token i (a cloze
            # contract): the one-hot identity channel gives the heads the
            # residue itself (trainer.py:256-275)
            feats = self.lm.encode(tokens, lengths)
            if not self.config.bilstm_onehot_channel:
                return feats
            ids = torch.arange(self.config.vocab_size, device=tokens.device)
            onehot = (tokens[..., None] == ids).to(feats.dtype)
            return torch.cat([onehot, feats], dim=-1)
        if isinstance(self.lm, T5Encoder):
            L = tokens.shape[1]
            mask = torch.arange(L, device=tokens.device)[None, :] \
                < lengths[:, None]
            return self.lm(tokens, mask)
        return self.lm(tokens)

    def _embeddings(self, batch, train=False):
        """LM embeddings of both sides: under ``no_grad`` unless ``train``
        and ``finetune`` (``trainer.py:326-336``), and then with the LM in
        train mode (no LM has dropout; cuDNN's LSTM backward needs it)."""
        grad = train and self.config.finetune
        self.lm.train(grad)
        with torch.set_grad_enabled(grad):
            hx = self._lm_apply(batch["x"], batch["x_len"])
            hy = self._lm_apply(batch["y"], batch["y_len"])
        return hx, hy

    # -- inference ---------------------------------------------------------

    @torch.no_grad()
    def align(self, x: str, y: str) -> str:
        """Alignment of two residue strings as a TM-align state string
        (``1`` gap in y, ``:`` match, ``2`` gap in x), with the aligner in
        eval mode (no dropout), as the JAX package's deterministic apply."""
        self.aligner.eval()
        x_tok, _ = self.tokenizer(x)
        y_tok, _ = self.tokenizer(y)
        batch = self._as_batch(dict(
            x=x_tok[None], y=y_tok[None],
            x_len=np.asarray([len(x_tok)], np.int32),
            y_len=np.asarray([len(y_tok)], np.int32)))
        hx, hy = self._embeddings(batch)
        lengths = (batch["x_len"], batch["y_len"])
        if dp_ops.get_backend(self.config.backend).stream:
            theta, A = self.aligner.potentials(hx, hy, lengths)
            E = dp_ops.expected_alignment_stream(
                theta, A, lengths, mode=self.aligner.mode,
                operator=self.config.operator, backend=self.config.backend,
                dtypes=self.dp_decode_dtypes)
            states = dp_ops.traceback_stream(E, len(x_tok), len(y_tok), 0)
        else:
            aln, _, _ = self.aligner(hx, hy, lengths)
            states = dp_ops.traceback(aln[0])
        return "".join(revstate_f(s) for _, _, s in states)

    @torch.no_grad()
    def score_pairs(self, batch):
        """Alignment scores ``(B,)`` float32 of a padded batch with keys
        ``x``, ``y`` (token ids) and ``x_len``, ``y_len``; the aligner in
        eval mode."""
        self.aligner.eval()
        batch = self._as_batch(batch)
        hx, hy = self._embeddings(batch)
        return self.aligner.score(hx, hy, (batch["x_len"], batch["y_len"]))

    # -- training ----------------------------------------------------------

    def _trained(self):
        """The parameters the optimizer updates: the aligner's, then with
        ``finetune`` the LM's (``trainer.py:316-320``), but for the frozen
        ones (an LSTM's second bias, which flax's cell does not have:
        ``heads.flax_biases``)."""
        params = list(self.aligner.parameters())
        if self.config.finetune:
            params += list(self.lm.parameters())
        return [p for p in params if p.requires_grad]

    def _build_optimizer(self):
        """AdamW over the trained parameters with optax's defaults, its rate
        driven by the schedule (``trainer.py:282-293``); then the state of
        :attr:`state` (a resumed run), if any."""
        c = self.config
        sched = make_schedule(c.scheduler, c.learning_rate, c.epochs,
                              steps_per_epoch=self._spe)
        self._opt = torch.optim.AdamW(
            self._trained(), lr=1.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4)
        self._sched = torch.optim.lr_scheduler.LambdaLR(self._opt, sched)
        self._acc, self._mini_step = None, 0
        state = self.state
        if state is not None and state.get("optimizer"):
            self._opt.load_state_dict(state["optimizer"])
            self._sched.load_state_dict(state["scheduler"])
        if state is not None and state.get("grad_accum"):
            acc = state["grad_accum"]
            self._mini_step = int(acc["mini_step"])
            self._acc = [a.to(self.device).clone() for a in acc["mean"]]

    def train_state(self):
        """What a checkpoint holds: the step, the aligner's weights (and with
        ``finetune`` the LM's), the optimizer's and schedule's state, and
        with ``grad_accum`` the running gradient mean and its count."""
        state = {"step": self.step, "aligner": self.aligner.state_dict(),
                 "optimizer": self._opt.state_dict() if self._opt else None,
                 "scheduler": self._sched.state_dict() if self._sched
                 else None}
        if self.config.finetune:
            state["lm"] = self.lm.state_dict()
        if self._acc is not None:
            state["grad_accum"] = {"mini_step": self._mini_step,
                                   "mean": [a.clone() for a in self._acc]}
        return state

    def load_train_state(self, state):
        """Restore a :meth:`train_state` (the optimizer's part on the next
        :meth:`fit`)."""
        self.aligner.load_state_dict(state["aligner"])
        if "lm" in state:
            self.lm.load_state_dict(state["lm"])
        self.step = int(state["step"])
        self.state = state

    def compute_loss(self, batch, aln):
        """The configured loss of ``aln`` against the batch's targets;
        integer targets are cast to the prediction's dtype
        (``trainer.py:346-353``)."""
        c = self.config
        G = batch["gmask"] if c.mask_gaps else torch.ones_like(batch["gmask"])
        target = batch["path"] if c.loss == "path" else batch["aln"]
        if not target.is_floating_point():
            target = target.to(aln.dtype)
        return self.loss_fn(target, aln, batch["x_len"], batch["y_len"], G)

    def _loss_keys(self):
        return ["x", "y", "x_len", "y_len", "gmask",
                "path" if self.config.loss == "path" else "aln"]

    def _loss_batch(self, batch):
        return self._as_batch(batch, self._loss_keys())

    def _rows(self, batch):
        """This rank's rows of a global batch under ``fit``'s mesh
        (``shard_batch``, and the same rows of its lists); the batch itself
        without one."""
        if self.mesh is None:
            return batch
        part = mesh_lib.shard_batch(batch, self.mesh)
        _, dp, d = self._data
        k = len(batch["x_len"]) // dp
        return {key: v[d * k:(d + 1) * k] if isinstance(v, list) else v
                for key, v in part.items()}

    def _device_chunk(self, chunk):
        """K same-shape batches as K steps' tensors on the device: each key
        stacked into a ``(K, B, ...)`` array (under a mesh, the rank's rows
        of the second axis) in pinned host memory (on a CUDA device) and
        copied in one asynchronous copy (``trainer.py:467-475``)."""
        arrays = {k: np.stack([np.asarray(b[k]) for b in chunk])
                  for k in self._loss_keys()}
        if self.mesh is not None:
            arrays = mesh_lib.shard_batch(arrays, self.mesh, stacked=True)
        out = {}
        for k, v in arrays.items():
            host = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                host = host.pin_memory()
            out[k] = host.to(self.device, non_blocking=True)
        return [{k: v[i] for k, v in out.items()} for i in range(len(chunk))]

    @staticmethod
    def _batch_shapes(batch):
        return tuple(sorted((k, np.asarray(v).shape)
                            for k, v in batch.items()
                            if not isinstance(v, list)))

    def _clip_grads(self):
        """optax ``clip_by_global_norm``: ``g / |g| * c`` when the global
        norm ``|g|`` of every trained parameter's gradient is at least
        ``c``."""
        c = self.config.grad_clip
        grads = [p.grad for p in self._trained() if p.grad is not None]
        if not c or not grads:
            return
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        for g in grads:
            g.copy_(torch.where(norm < c, g, g / norm * c))

    def _accumulate(self):
        """``optax.MultiSteps`` with ``every_k_schedule=grad_accum``: fold
        this step's gradients into the running mean; True when this is the
        k-th step, with the mean set as the gradients to clip and apply
        (and reset once applied), else False (a zero update)."""
        params = self._trained()
        if self._acc is None:
            self._acc = [torch.zeros_like(p) for p in params]
        n = self._mini_step
        for a, p in zip(self._acc, params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.copy_(a + (g - a) / (n + 1))
        self._mini_step = (n + 1) % self.config.grad_accum
        if self._mini_step:
            return False
        for a, p in zip(self._acc, params):
            p.grad = a.clone()
            a.zero_()
        return True

    def _train_forward(self, b, generator):
        """A training step's expected alignment: LM features (trained with
        ``finetune``) -> heads (dropout from ``generator``) -> DP."""
        hx, hy = self._embeddings(b, train=True)
        aln, _, _ = self.aligner(hx, hy, (b["x_len"], b["y_len"]),
                                 generator=generator)
        return aln

    def _step(self, b, generator):
        """One step on the tensors of :meth:`_loss_batch` (or of a chunk's
        step, :meth:`_device_chunk`), already on the device; returns the
        loss (a 0-d tensor on the device, not yet read back)."""
        self.aligner.train()
        forward = self._train_forward if self._ddp is None else self._ddp
        aln = forward(b, generator)
        loss = self.compute_loss(b, aln)
        self._opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.config.grad_accum == 1 or self._accumulate():
            self._clip_grads()
            self._opt.step()
            self._sched.step()
        self.step += 1
        return loss.detach()

    @torch.no_grad()
    def validation_step(self, batch):
        """``(loss, aln)`` of a batch with the aligner in eval mode."""
        self.aligner.eval()
        b = self._loss_batch(batch)
        hx, hy = self._embeddings(b)
        aln, _, _ = self.aligner(hx, hy, (b["x_len"], b["y_len"]))
        return self.compute_loss(b, aln), aln

    def validation_stats(self, batch, aln):
        """Per-pair traceback accuracy stats ``ROC_COLUMNS`` of the natural
        expected alignment ``aln`` (``trainer.py:668-681``)."""
        stats = []
        aln = aln.detach().cpu().numpy()
        for b in range(len(batch["x_len"])):
            n, mm = int(batch["x_len"][b]), int(batch["y_len"][b])
            pred_states = [s for _, _, s in dp_ops.traceback(aln[b, :n, :mm])]
            true_states = list(np.asarray(batch["states"][b]))
            pred_edges = filter_gaps(pred_states, states2edges(pred_states))
            true_edges = filter_gaps(true_states, states2edges(true_states))
            stats.append(roc_edges(true_edges, pred_edges))
        return stats

    def _dataset(self, path, **kw):
        return TMAlignDataset(path, tokenizer=self.tokenizer,
                              max_len=self.config.max_len, **kw)

    def test(self, test_dataset=None):
        """Per-pair traceback statistics of a test set, one row a pair
        (``trainer.py:683-699``): ``test_<c>`` for each of ``ROC_COLUMNS``,
        and ``query_name`` and ``key_name`` where the batches carry names;
        the batches unshuffled, in eval mode (no dropout), one process
        (no sharding under a process group).  The set defaults to
        ``config.test_pairs`` with names."""
        test_dataset = test_dataset or self._dataset(
            self.config.test_pairs, return_names=True)
        rows = []
        for batch in self._batches(test_dataset, False, 0):
            _, aln = self.validation_step(batch)
            for b, st in enumerate(self.validation_stats(batch, aln)):
                row = {f"test_{c}": v for c, v in zip(ROC_COLUMNS, st)}
                if "names" in batch:
                    row["query_name"], row["key_name"] = batch["names"][b]
                rows.append(row)
        return rows

    def _batches(self, dataset, shuffle, seed):
        return make_batches(dataset, self.config.batch_size, shuffle=shuffle,
                            seed=seed, pad_multiple=self.config.pad_multiple,
                            drop_last=self.mesh is not None)

    def _losses_to_host(self, losses):
        """``(host, ready)``: the copy of a dispatch's losses (a device
        vector) into pinned host memory, started behind the event
        ``ready``, so that reading them after the next dispatch is issued
        waits for this one only; on the CPU the losses themselves and no
        event."""
        if self.device.type != "cuda":
            return losses, None
        host = torch.empty(losses.shape, dtype=losses.dtype, pin_memory=True)
        host.copy_(losses, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _consume_loss(self, pending, losses, logger):
        """Read back ``((loss, ready), step)``: a dispatch's losses whose
        first step is ``step`` (:meth:`_losses_to_host`), in one wait for
        ``ready`` when it is set; raise on a NaN."""
        (loss, ready), step = pending
        if ready is not None:
            ready.synchronize()
        vals = torch.atleast_1d(loss).tolist()
        for i, v in enumerate(vals):
            if math.isnan(v):
                raise FloatingPointError(f"NaN training loss at step "
                                         f"{step + i}")
        for i, v in enumerate(vals):
            losses.append(v)
            if logger:
                logger.log_scalar("train_loss", v, step + i)

    def _data_mean(self, t):
        """The mean of ``t`` over the ranks of the data group (``t``
        itself without a mesh): the global batch's mean of equal shards'
        means."""
        if self._data is None:
            return t
        group, dp, _ = self._data
        t = t.clone()
        dist.all_reduce(t, group=group)     # gloo has no AVG: sum, divide
        return t / dp

    def _gather_validation(self, vlosses, vstats):
        """Every data shard's validation losses and statistics (one list of
        rows a batch), gathered in the global batches' order: the batch
        losses (the mean of its shards') and the rows."""
        if self._data is not None:
            group, dp, _ = self._data
            shards = [None] * dp
            dist.all_gather_object(shards, (vlosses, vstats), group=group)
            vlosses = [float(np.mean(ls)) for ls in
                       zip(*(sh[0] for sh in shards))]
            vstats = [[row for sh in shards for row in sh[1][i]]
                      for i in range(len(vstats))]
        return vlosses, [row for rows in vstats for row in rows]

    def _resolve_mesh(self, mesh):
        """``fit``'s mesh: ``"auto"`` takes the largest divisor ``dp`` of
        ``batch_size`` that fits ``world // tp`` and the first ``dp * tp``
        ranks (``trainer.py:492-505``; None at one rank); an explicit mesh
        must split ``batch_size`` over its ``data`` axis."""
        c = self.config
        if mesh == "auto":
            world = mesh_lib.world_size()
            n = world // max(1, c.tp)
            dp = max((k for k in range(1, n + 1) if c.batch_size % k == 0),
                     default=1)
            mesh = None
            if dp * c.tp > 1:
                mesh = mesh_lib.make_mesh(
                    dp=dp, tp=c.tp, devices=range(min(dp * c.tp, world)),
                    device_type=self.device.type)
        if mesh is not None and c.batch_size % mesh.size(0) != 0:
            raise ValueError("batch_size must divide the data mesh axis")
        return mesh

    def _share_result(self, history):
        """Rank 0's history, step and final weights (the aligner's, and
        with ``finetune`` the LM's) to every rank, for the ranks outside
        the mesh; returns the history."""
        box = [history, self.step]
        dist.broadcast_object_list(box, src=0)
        history, self.step = box
        mods = [self.aligner] + ([self.lm] if self.config.finetune else [])
        for m in mods:
            for t in m.state_dict().values():
                dist.broadcast(t, src=0)
        return history

    def fit(self, train_dataset=None, valid_dataset=None, callbacks=(),
            logger=None, checkpointer=None, mesh=None):
        """Train for ``config.epochs`` epochs; returns ``(state,
        history)`` with one entry per epoch.  Resumes from ``self.state``
        (:meth:`load_train_state`) when set.  With a validation set the
        checkpointer saves when the validation loss improves, else every
        epoch.  ``mesh``: None (this process alone), ``"auto"`` or a
        ``(data, model)`` ``DeviceMesh`` of ``parallel.make_mesh`` (see the
        module docstring)."""
        c = self.config
        self.mesh = mesh = self._resolve_mesh(mesh)
        self._data = None
        coord = mesh.get_coordinate() if mesh is not None else None
        idle = mesh is not None and coord is None
        spare = mesh is not None and mesh.size() < mesh_lib.world_size()
        if idle:                        # outside the mesh: no batches
            history = self._share_result(None)
            self.state = self.train_state()
            return self.state, history
        if mesh is not None:
            self._data = (mesh.get_group("data"), mesh.size(0), coord[0])
        train_dataset = train_dataset or self._dataset(c.train_pairs)
        valid_dataset = valid_dataset or (
            self._dataset(c.valid_pairs) if c.valid_pairs else None)
        self._spe = max(1, len(train_dataset) // max(1, c.batch_size))
        self._build_optimizer()
        if mesh is not None:
            self._ddp = DistributedDataParallel(_Trained(self),
                                                process_group=self._data[0])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(c.seed + 1 + (coord[0] if coord else 0))
        history = []
        best = math.inf
        try:
            for epoch in range(c.epochs):
                entry = self._epoch(epoch, train_dataset, valid_dataset,
                                    gen, logger)
                if valid_dataset is not None:
                    if checkpointer and entry["validation_loss"] < best:
                        best = entry["validation_loss"]
                        checkpointer.save(self.train_state(), entry)
                elif checkpointer:
                    checkpointer.save(self.train_state(), entry)
                history.append(entry)
                for cb in callbacks:
                    cb(self, entry)
        finally:
            self._ddp = None    # its reducer's hooks go with it
        if spare:
            history = self._share_result(history)
        self.state = self.train_state()
        return self.state, history

    def _epoch(self, epoch, train_dataset, valid_dataset, gen, logger):
        """One epoch of :meth:`fit`; returns its history entry."""
        c = self.config
        K = c.steps_per_dispatch
        # the losses of a step (or chunk) are read back after the next is
        # issued, so the host prepares it while the card works; the NaN
        # check fires one step (chunk) late, as in the JAX package
        losses = []
        pending = None

        def issue(batches):
            nonlocal pending
            steps = self._device_chunk(batches) if len(batches) == K > 1 \
                else [self._loss_batch(self._rows(b)) for b in batches]
            first = self.step + 1
            out = torch.stack([self._step(b, gen) for b in steps])
            out = self._losses_to_host(self._data_mean(out))
            if pending is not None:
                self._consume_loss(pending, losses, logger)
            pending = (out, first)

        chunk, shape = [], None
        for batch in self._batches(train_dataset, True, c.seed + epoch):
            if K == 1:
                issue([batch])
                continue
            sh = self._batch_shapes(batch)
            if chunk and sh != shape:
                for b in chunk:     # a shape change: single steps
                    issue([b])
                chunk = []
            chunk.append(batch)
            shape = sh
            if len(chunk) == K:
                issue(chunk)
                chunk = []
        for b in chunk:             # the epoch's tail: single steps
            issue([b])
        if pending is not None:
            self._consume_loss(pending, losses, logger)
        entry = {"epoch": epoch, "train_loss": float(np.mean(losses))}
        if valid_dataset is None:
            return entry
        vlosses, vstats = [], []
        for batch in self._batches(valid_dataset, False, 0):
            part = self._rows(batch)
            vloss, aln = self.validation_step(part)
            vlosses.append(float(vloss))
            vstats.append(self.validation_stats(part, aln))
        vlosses, vstats = self._gather_validation(vlosses, vstats)
        entry["validation_loss"] = float(np.mean(vlosses))
        means = np.mean(np.asarray(vstats, float), axis=0)
        for col, v in zip(ROC_COLUMNS, means):
            entry[f"val_{col}"] = float(v)
            if logger:
                logger.log_scalar(f"val_{col}", v, self.step)
        if logger:
            logger.log_scalar("validation_loss", entry["validation_loss"],
                              self.step)
        return entry


class _Trained(nn.Module):
    """The modules ``fit`` trains under one forward
    (``DeepBLAST._train_forward``), for ``DistributedDataParallel``: the
    aligner, and with ``finetune`` the LM's modules that run.  A BiLM's
    next-token head ``linear`` never gets a gradient (the features come
    from ``encode``), so it is left out, not searched for as an unused
    parameter on every step; the cuDNN LSTMs' frozen second biases do not
    require a gradient, which DDP skips."""

    def __init__(self, model):
        super().__init__()
        self.aligner = model.aligner
        if model.config.finetune:
            lm = model.lm
            self.lm = nn.ModuleList(
                m for n, m in lm.named_children() if n != "linear") \
                if isinstance(lm, BiLM) else lm
        self._model = (model,)      # a tuple: not a registered submodule

    def forward(self, b, generator):
        return self._model[0]._train_forward(b, generator)
