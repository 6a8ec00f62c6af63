"""The JAX package's options that the port does not take yet.

:data:`UNPORTED` maps an option (a ``deepblast-train`` flag's destination,
which for most is also a ``DeepBLASTConfig`` field) to the values the port
takes and the ROADMAP.md item that ports the rest.  ``cli.common`` checks
a command line against it and ``DeepBLASTConfig.from_json`` a loaded
``config.json``, so that no option is silently ignored.  The backends the
port takes are read from ``ops.dp.BACKENDS`` at each check, so a backend
registered at run time (``ops.dp.register_backend``) is taken.
"""

from __future__ import annotations

from deepblast_torch.ops import dp as dp_ops

__all__ = ["UNPORTED", "check_ported", "ported_values"]


def _backends():
    return (None, *dp_ops.BACKENDS)


#: option -> (the values the port takes, or a function returning them;
#: ROADMAP.md item)
UNPORTED = {
    "backend": (_backends, "queue A item 10 (the scan backend, "
                           "ops/dp_scan.py)"),
    "visualization_fraction": ((0.0,), "queue A item 7 (visualisations "
                                       "and TensorBoard)"),
}


def ported_values(option):
    """The values of ``option`` the port takes, its default first."""
    ported = UNPORTED[option][0]
    return ported() if callable(ported) else ported


def check_ported(option, value, what):
    """Raise ``ValueError`` naming the ROADMAP.md item when ``value`` of
    ``option`` (described as ``what``, e.g. the flag) is not one the port
    takes."""
    item = UNPORTED[option][1]
    if value not in ported_values(option):
        raise ValueError(f"{what} {value!r} is not ported to deepblast_torch "
                         f"yet: ROADMAP.md {item}")
