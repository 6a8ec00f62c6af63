"""The DP storage-dtype menu (``deepblast_tpu/ops/dp_bm.py:99-191``).

Every DP pass of the default backend (``ops/dp.py``, ``None`` /
``"pallas_bm"``) moves whole ``(B, K, S)`` streams through device memory
and does tens of operations per value, so the bytes a stream takes bound
it.  A :class:`DTypeMenu` names the *storage* type of three kinds of
stream, while every recurrence computes in float32 (or in the input type
where that is wider, :func:`compute_dtype`):

* ``stream`` — the skewed input streams theta and A (and the cotangent
  streams Zt, Za of the VJP): float32, bfloat16, or int16 fixed point,
  ``floor(clip(v * 32767 / stream_range, -32767, 32767) + 0.5)``,
  dequantized on load by ``stream_range / 32767``;
* ``d`` — the difference residuals Dx, Dm (and Dxd, Dmd): float32 or
  bfloat16;
* ``e`` — the expectation streams E, EA (and Ed, EdA): float32, bfloat16,
  or int16 fixed point at scale 32767 (``E`` in ``[0, 1]``), dequantized
  by ``1 / 32767``.

Two rules keep the fixed point out of unbounded values, as in the JAX
package: cotangent streams are never int16 (they take ``stream`` when it is
a float type, else the cotangent's own type, ``dp_bm.py:348-357``), and an
int16 ``e`` applies to the decode's E only; the training passes store E,
Ed and EdA in the compute type instead (``dp_bm.py:628,837``).

``None`` in a field means the compute type.  fp16 is not on the menu: it
does not compile for the TPU (``dp_bm.py:113-114``), so no JAX path uses
it.  The scale constants are float32 of the Python doubles: ``32767 / 16
= 2047.9375`` exactly, ``16 / 32767`` and ``1 / 32767`` rounded once.
"""

from __future__ import annotations

import typing

import torch

__all__ = ["DTypeMenu", "STREAM_RANGE", "E_SCALE", "I16_MAX", "as_menu",
           "compute_dtype", "quantize", "dequantize"]

STREAM_RANGE = 16.0     # int16 saturation range of the input streams
E_SCALE = 32767.0       # int16 fixed-point scale of the expectation streams
I16_MAX = 32767.0

_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int16": torch.int16}
_ALLOWED = {"stream": ("float32", "bfloat16", "int16"),
            "d": ("float32", "bfloat16"),
            "e": ("float32", "bfloat16", "int16")}


def _name(field, x):
    if x is None:
        return None
    if isinstance(x, torch.dtype):
        name = str(x).rsplit(".", 1)[-1]
    else:
        name = str(x)
    if name not in _ALLOWED[field]:
        raise ValueError(f"DTypeMenu.{field} = {x!r} is not supported; the "
                         f"port stores {field} as one of "
                         f"{list(_ALLOWED[field])} (or None: the compute "
                         "type)")
    return name


class DTypeMenu(typing.NamedTuple):
    """Per-call storage types of the default backend's streams; hashable
    (dtype *names*), so an autograd Function can keep it in its context.
    Build it with :meth:`make`."""

    stream: "str | None" = None
    d: "str | None" = None
    e: "str | None" = None
    stream_range: float = STREAM_RANGE

    @classmethod
    def make(cls, stream=None, d=None, e=None, stream_range=None):
        """A menu from dtype names or torch dtypes; raises ``ValueError``
        for a type the port does not store."""
        return cls(_name("stream", stream), _name("d", d), _name("e", e),
                   float(STREAM_RANGE if stream_range is None
                         else stream_range))

    @property
    def stream_dtype(self):
        return _NAMES.get(self.stream)

    @property
    def d_dtype(self):
        return _NAMES.get(self.d)

    @property
    def e_dtype(self):
        return _NAMES.get(self.e)

    @property
    def stream_scale(self):
        """The quantization scale of int16 input streams (else None)."""
        return I16_MAX / self.stream_range if self.stream == "int16" \
            else None

    @property
    def cotangent_dtype(self):
        """Storage of the cotangent streams: ``stream`` when it is a float
        type, else None (the cotangent's own type)."""
        return None if self.stream == "int16" else self.stream_dtype


def as_menu(dtypes):
    """``None`` -> the all-float32 menu; a :class:`DTypeMenu` as it is."""
    if dtypes is None:
        return DTypeMenu()
    if not isinstance(dtypes, DTypeMenu):
        raise TypeError(f"dtypes must be a DTypeMenu, got {type(dtypes)!r}")
    return dtypes


def compute_dtype(*dtypes):
    """In-kernel compute type: float32 unless an input is wider
    (``dp_bm._cdt``)."""
    out = torch.float32
    for dt in dtypes:
        out = torch.promote_types(out, dt)
    return out


def quantize(v, scale):
    """int16 fixed point: ``floor(clip(v * scale, +-32767) + 0.5)``, in the
    type of ``v`` (``skew_bm.py:133-138``, ``dp_bm._eq``)."""
    return torch.floor(torch.clamp(v * scale, -I16_MAX, I16_MAX)
                       + 0.5).to(torch.int16)


def dequantize(q, inv, dtype=torch.float32):
    """``q`` (int16) as ``dtype`` times ``inv`` (a Python float, rounded to
    ``dtype`` once)."""
    return q.to(dtype) * torch.tensor(inv, dtype=dtype)
