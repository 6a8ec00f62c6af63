"""The JAX package's options that the port does not take yet.

:data:`UNPORTED` maps an option (a ``deepblast-train`` flag's destination,
which for most is also a ``DeepBLASTConfig`` field) to the values the port
takes and the ROADMAP.md item that ports the rest.  ``cli.common`` checks
a command line against it and ``DeepBLASTConfig.from_json`` a loaded
``config.json``, so that no option is silently ignored.
"""

from __future__ import annotations

from deepblast_torch.ops.dp import BACKENDS

__all__ = ["UNPORTED", "check_ported"]

#: option -> (the values the port takes, ROADMAP.md item)
UNPORTED = {
    "backend": (tuple(BACKENDS), "queue A item 10 (the scan backend, "
                                 "ops/dp_scan.py)"),
    "nodes": ((1,), "queue A item 5 (data parallel)"),
    "coordinator": ((None,), "queue A item 5 (data parallel)"),
    "process_id": ((None,), "queue A item 5 (data parallel)"),
    "tp": ((1,), "queue A item 5 (data parallel)"),
    "visualization_fraction": ((0.0,), "queue A item 7 (visualisations "
                                       "and TensorBoard)"),
}


def check_ported(option, value, what):
    """Raise ``ValueError`` naming the ROADMAP.md item when ``value`` of
    ``option`` (described as ``what``, e.g. the flag) is not one the port
    takes."""
    ported, item = UNPORTED[option]
    if value not in ported:
        raise ValueError(f"{what} {value!r} is not ported to deepblast_torch "
                         f"yet: ROADMAP.md {item}")
