"""The least bytes and transcendentals of the differentiable alignment DP
and of the training loss around it.

The DP op of a training step takes ``theta`` and ``A`` and returns ``E``
(forward), then takes ``E``'s cotangent and returns the cotangents of
``theta`` and ``A`` (backward).  Its least traffic reads each input once
and writes each output once: three reads and three writes of a value per
valid cell, at the inputs' storage size.  Its least special-function
count is that of the forward's smoothed max, two exponentials and one
logarithm a valid cell once the largest argument is subtracted; the soft
argmax and every derivative reuse those exponentials.

The masked cross entropy needs ``E`` and the target only where the mask
is set (the path's confident cells, a few per row), so its least traffic
is the mask read and ``E``'s cotangent written over the valid cells; its
logarithms are as few, and are left out.
"""

from __future__ import annotations

from portbench.count.peaks import HBM_BYTES, MUFU_PER_S

__all__ = ["valid_cells", "dp_train_least_s", "loss_least_s"]


def valid_cells(x_len, y_len):
    return sum(int(n) * int(m) for n, m in zip(x_len, y_len))


def dp_train_least_s(cells, value_bytes=4):
    """Least seconds of the DP op's forward and backward over ``cells``
    valid cells: the larger of its bytes over HBM bandwidth and its
    transcendentals over the MUFU rate."""
    return max(6 * value_bytes * cells / HBM_BYTES, 3 * cells / MUFU_PER_S)


def loss_least_s(cells, value_bytes=4, mask_bytes=1):
    """Least seconds of the cross entropy's forward and backward."""
    return cells * (value_bytes + mask_bytes) / HBM_BYTES
