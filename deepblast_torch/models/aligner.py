"""Neural alignment model (``deepblast_tpu/models/aligner.py``).

:class:`NeuralAligner` turns language-model embeddings of two sequences
into DP potentials and serves them:

* ``theta = softplus(zx @ zy^T)`` and ``A = log_sigmoid(gx @ gy^T)``
  (``aligner.py:88-102``), both float32 as the JAX package's
  ``preferred_element_type`` makes them;
* :meth:`forward` — ``(aln, theta, A)`` with ``aln`` the differentiable
  natural-layout expected alignment (``aligner.py:104-111``), the
  training path;
* :meth:`score` — terminal alignment scores (``aligner.py:113-119``).

``backend`` names the DP passes of every call and ``dp_dtypes`` their
storage menu (``ops/dp.py``, ``ops/menu.py``; ``aligner.py:51,56,110,119``).
``matmul_dtype`` (``aligner.py:93-101``; the trainer's ``--precision``)
rounds the head features ``zx, zy, gx, gy`` to that dtype before the two
contractions, which then accumulate and return float32, as JAX's
``preferred_element_type=jnp.float32``: a product of two bf16 or fp16
values is exact in float32, so the rounded features are widened and
contracted in float32.  The heads and the DP stay float32.

``softplus`` is ``logaddexp(x, 0)``, not ``torch.nn.functional.softplus``,
which returns ``x`` itself above its threshold where ``jax.nn.softplus``
does not.  The heads' dropout draws from the ``generator`` passed to
:meth:`forward` and acts only in ``train()`` mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepblast_torch.models.heads import build_head
from deepblast_torch.ops import dp as dp_ops
from deepblast_torch.utils.profiling import span

__all__ = ["NeuralAligner"]

_MODE_ALIASES = {
    "needleman-wunsch": "nw",
    "smith-waterman": "sw",
    "nw": "nw",
    "sw": "sw",
}


class NeuralAligner(nn.Module):
    """Match/gap heads over LM embeddings + DP scoring and decoding."""

    def __init__(self, embedding_dim=1024, hidden_dim=1024, layers=2,
                 k_size=5, dropout=0.0, layer_type="cnn",
                 alignment_mode="needleman-wunsch", operator="softmax",
                 backend=None, matmul_dtype=None, dp_dtypes=None,
                 device=None, dtype=None):
        super().__init__()
        self.mode = _MODE_ALIASES[alignment_mode]
        self.matmul_dtype = matmul_dtype
        self.operator = operator
        self.backend = backend
        self.dp_dtypes = dp_dtypes
        dp_ops.get_backend(backend)     # an unknown name fails here
        kw = dict(embedding_dim=embedding_dim, hidden_dim=hidden_dim,
                  layers=layers, k_size=k_size, dropout=dropout,
                  device=device, dtype=dtype)
        self.match_embedding = build_head(layer_type, **kw)
        self.gap_embedding = build_head(layer_type, **kw)

    def blosum_factor(self, hx, lengths=None, generator=None):
        """Match and gap head features of one side, pad-invariant when
        ``lengths`` is given."""
        return (self.match_embedding(hx, lengths, generator),
                self.gap_embedding(hx, lengths, generator))

    def potentials(self, hx, hy, lengths=None, generator=None):
        """Match and gap potentials ``(B, N, M)`` float32 (in a ``heads``
        span, ``utils/profiling.py``)."""
        ln, lm = lengths if lengths is not None else (None, None)
        with span("heads", device=True):
            zx, gx = self.blosum_factor(hx, ln, generator)
            zy, gy = self.blosum_factor(hy, lm, generator)
            if self.matmul_dtype is not None:
                dt = self.matmul_dtype
                zx, zy, gx, gy = (v.to(dt).float() for v in (zx, zy, gx, gy))
            match = torch.einsum("bid,bjd->bij", zx, zy).float()
            gap = torch.einsum("bid,bjd->bij", gx, gy).float()
            theta = torch.logaddexp(match, torch.zeros(
                (), dtype=match.dtype, device=match.device))
            return theta, F.logsigmoid(gap)

    def forward(self, hx, hy, lengths=None, generator=None):
        """``(aln, theta, A)``: the expected alignment ``(B, N, M)``,
        differentiable in the heads' parameters, and the potentials."""
        theta, A = self.potentials(hx, hy, lengths, generator)
        aln = dp_ops.expected_alignment(theta, A, lengths, mode=self.mode,
                                        operator=self.operator,
                                        backend=self.backend,
                                        dtypes=self.dp_dtypes)
        return aln, theta, A

    def score(self, hx, hy, lengths=None):
        """Terminal alignment scores ``(B,)``."""
        theta, A = self.potentials(hx, hy, lengths)
        return dp_ops.alignment_score(theta, A, lengths, mode=self.mode,
                                      operator=self.operator,
                                      backend=self.backend,
                                      dtypes=self.dp_dtypes)
