"""Learning-rate schedules (``deepblast_tpu/train/schedules.py``) as plain
``step -> lr`` functions with optax's semantics: the update with count
``t`` (0 for the first update) uses ``schedule(t)``.  The trainer hands
them to ``torch.optim.lr_scheduler.LambdaLR`` over a base rate of 1.

* ``none`` — ``optax.constant_schedule``;
* ``cosine`` — ``optax.cosine_decay_schedule(lr, total)``:
  ``lr * 0.5 * (1 + cos(pi * min(t, total) / total))``;
* ``cosine_restarts`` — ``optax.join_schedules`` of doubling cosine cycles;
* ``triangular`` — triangular2 cyclic rate with the amplitude halved each
  cycle;
* ``steplr`` — ``optax.exponential_decay(lr, step_size, 0.5,
  staircase=True)``.

``total = epochs * steps_per_epoch``.
"""

from __future__ import annotations

import math

__all__ = ["make_schedule"]


def _cosine(lr, decay_steps):
    def sched(t):
        t = min(t, decay_steps)
        return lr * (0.5 * (1.0 + math.cos(math.pi * t / decay_steps)))
    return sched


def make_schedule(name, learning_rate, epochs, steps_per_epoch=1):
    """The named schedule as a function of the update count."""
    total = max(1, epochs * steps_per_epoch)
    if name == "none":
        return lambda t: learning_rate
    if name == "cosine":
        return _cosine(learning_rate, total)
    if name == "cosine_restarts":
        cycles, boundaries = [], []
        t, start = steps_per_epoch, 0
        while start < total:
            cycles.append(_cosine(learning_rate, t))
            start += t
            boundaries.append(start)
            t *= 2
        boundaries = boundaries[:-1]

        def restarts(t):
            out = cycles[0](t)
            for boundary, cycle in zip(boundaries, cycles[1:]):
                if t >= boundary:
                    out = cycle(t - boundary)
            return out
        return restarts
    if name == "triangular":
        base_lr = 1e-8
        steps = max(1, int(math.log2(learning_rate / base_lr)))
        step_size = max(1, (epochs // steps) * steps_per_epoch)

        def triangular(t):
            cycle = math.floor(1 + t / (2 * step_size))
            xx = abs(t / step_size - 2 * cycle + 1)
            scale = 1.0 / (2.0 ** (cycle - 1))
            return base_lr + (learning_rate - base_lr) * \
                max(0.0, 1 - xx) * scale
        return triangular
    if name == "steplr":
        min_lr = 1e-6
        steps = max(1, int(math.log2(learning_rate / min_lr)))
        step_size = max(1, (epochs // steps) * steps_per_epoch)

        def steplr(t):
            if t <= 0:
                return learning_rate
            return learning_rate * 0.5 ** math.floor(t / step_size)
        return steplr
    raise ValueError(f"`{name}` scheduler is not implemented.")
