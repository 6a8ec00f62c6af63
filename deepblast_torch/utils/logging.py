"""Metrics logging (``deepblast_tpu/utils/logging.py:19-86``): JSON lines
always, and TensorBoard event files beside them when
``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package).  Under a process group only rank 0 writes.
:func:`tensorboard_to_csv` exports the scalars of a ``metrics.jsonl``, or
of the event files of a logdir without one."""

from __future__ import annotations

import datetime
import json
import os
import time

from deepblast_torch.parallel.mesh import is_writer
from deepblast_torch.utils.table import write_csv

__all__ = ["MetricsLogger", "tensorboard_to_csv"]


class MetricsLogger:
    """Appends one JSON object per scalar or text to
    ``<root_dir>/<logging_path>/metrics.jsonl``, with the wall-clock time
    it was logged at (``wall_time``, seconds since the epoch, as in a
    TensorBoard event), and with ``tensorboard`` writes the same records,
    and the figures, to a ``SummaryWriter`` on that directory when one can
    be made (else the JSONL alone, as the JAX logger).  On a rank other
    than 0 it writes nothing (its ``path`` is None): the ranks of a data
    parallel run log the same values, and one output directory takes one
    writer."""

    def __init__(self, root_dir="./", logging_path=None, tensorboard=True):
        self.path = self._jsonl = self._tb = None
        if not is_writer():
            return
        if logging_path is None:
            suffix = datetime.datetime.now().strftime("%y%m%d_%H%M%S")
            logging_path = f"logdir_{suffix}"
        self.path = os.path.join(root_dir, logging_path)
        os.makedirs(self.path, exist_ok=True)
        self._jsonl = open(os.path.join(self.path, "metrics.jsonl"), "a")
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(self.path)
            except Exception:
                self._tb = None

    def _record(self, **record):
        self._jsonl.write(json.dumps({**record, "wall_time": time.time()})
                          + "\n")
        self._jsonl.flush()

    def log_scalar(self, tag, value, step):
        if self._jsonl is None:
            return
        self._record(tag=tag, value=float(value), step=int(step))
        if self._tb:
            self._tb.add_scalar(tag, value, step)

    def log_text(self, tag, text, step):
        if self._jsonl is None:
            return
        self._record(tag=tag, text=text, step=int(step))
        if self._tb:
            self._tb.add_text(tag, text, step)

    def log_figure(self, tag, fig, step):
        """The matplotlib ``fig`` as an image of the event file, closed
        there; without a writer it is only closed."""
        if self._tb:
            self._tb.add_figure(tag, fig, step, close=True)
        else:
            import matplotlib.pyplot as plt
            plt.close(fig)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


def tensorboard_to_csv(logdir, out_csv, pattern=None):
    """Write the scalar records of ``<logdir>/metrics.jsonl`` (those with a
    ``value``; with ``pattern``, those whose tag contains it) to
    ``out_csv``, one row each, the keys in order of first appearance as
    columns (this logger's ``wall_time`` among them), no index; returns
    the rows.  A logdir without ``metrics.jsonl`` is read from its
    TensorBoard event files (``EventAccumulator``; the ``tensorboard``
    package must be there): ``tag``, ``value`` and ``step`` of each scalar
    event, tag by tag."""
    rows = []
    jsonl = os.path.join(logdir, "metrics.jsonl")
    if os.path.exists(jsonl):
        with open(jsonl) as f:
            for line in f:
                d = json.loads(line)
                if "value" in d and (pattern is None or pattern in d["tag"]):
                    rows.append(d)
    else:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator)
        acc = EventAccumulator(logdir)
        acc.Reload()
        for tag in acc.Tags().get("scalars", []):
            if pattern and pattern not in tag:
                continue
            for ev in acc.Scalars(tag):
                rows.append({"tag": tag, "value": ev.value, "step": ev.step})
    write_csv(out_csv, rows, index=False)
    return rows
