"""Metrics logging to JSON lines (the JSONL part of
``deepblast_tpu/utils/logging.py:19-40``; TensorBoard is not ported).
Under a process group only rank 0 writes."""

from __future__ import annotations

import datetime
import json
import os
import time

from deepblast_torch.parallel.mesh import is_writer

__all__ = ["MetricsLogger"]


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
