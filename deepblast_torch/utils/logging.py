"""Metrics logging to JSON lines (the JSONL part of
``deepblast_tpu/utils/logging.py:19-86``; TensorBoard is not ported, see
ROADMAP.md queue A item 7).  Under a process group only rank 0 writes.
:func:`tensorboard_to_csv` exports the scalars of a ``metrics.jsonl``."""

from __future__ import annotations

import datetime
import json
import os
import time

from deepblast_torch.parallel.mesh import is_writer
from deepblast_torch.utils.table import write_csv

__all__ = ["MetricsLogger", "tensorboard_to_csv"]


class MetricsLogger:
    """Appends one JSON object per scalar to
    ``<root_dir>/<logging_path>/metrics.jsonl``, with the wall-clock time
    it was logged at (``wall_time``, seconds since the epoch, as in a
    TensorBoard event).  On a rank other than 0 it writes nothing (its
    ``path`` is None): the ranks of a data parallel run log the same
    values, and one output directory takes one writer."""

    def __init__(self, root_dir="./", logging_path=None):
        self.path = self._jsonl = None
        if not is_writer():
            return
        if logging_path is None:
            suffix = datetime.datetime.now().strftime("%y%m%d_%H%M%S")
            logging_path = f"logdir_{suffix}"
        self.path = os.path.join(root_dir, logging_path)
        os.makedirs(self.path, exist_ok=True)
        self._jsonl = open(os.path.join(self.path, "metrics.jsonl"), "a")

    def log_scalar(self, tag, value, step):
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "wall_time": time.time()}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()


def tensorboard_to_csv(logdir, out_csv, pattern=None):
    """Write the scalar records of ``<logdir>/metrics.jsonl`` (those with a
    ``value``; with ``pattern``, those whose tag contains it) to
    ``out_csv``, one row each, the keys in order of first appearance as
    columns (this logger's ``wall_time`` among them), no index; returns
    the rows.  A logdir without ``metrics.jsonl`` (TensorBoard event
    files only) raises: reading event files is ROADMAP.md queue A item 7."""
    jsonl = os.path.join(logdir, "metrics.jsonl")
    if not os.path.exists(jsonl):
        raise FileNotFoundError(
            f"{jsonl} does not exist: reading TensorBoard event files is "
            "not ported to deepblast_torch yet (ROADMAP.md queue A item 7)")
    rows = []
    with open(jsonl) as f:
        for line in f:
            d = json.loads(line)
            if "value" in d and (pattern is None or pattern in d["tag"]):
                rows.append(d)
    write_csv(out_csv, rows, index=False)
    return rows
