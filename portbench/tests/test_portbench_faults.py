"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at
a tiny size on the CPU, with each fault the cell can have planted in the
program (one card: no exchange between chips to leave out)."""

import pytest
import torch

import portbench_tiny as tiny
from portbench import run


def _run(cell, seed=2**31 + 3):
    cfg, mix = tiny.cell(cell)
    return run.run_cell(cell, seed, 0.5, 0, "cpu", cfg=cfg, mix=mix)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def _unchanged_step(monkeypatch, after=0):
    """AdamW computes its state, and the weights are put back after (from
    the ``after``-th ``fit`` on)."""
    from deepblast_torch.train.trainer import DeepBLAST
    build = DeepBLAST._build_optimizer
    builds = []

    def patched(self):
        build(self)
        builds.append(1)
        if len(builds) <= after:
            return
        step = self._opt.step

        def keep(*a, **k):
            saved = [p.detach().clone() for p in self._trained()]
            step(*a, **k)
            with torch.no_grad():
                for p, s in zip(self._trained(), saved):
                    p.copy_(s)
        self._opt.step = keep
    monkeypatch.setattr(DeepBLAST, "_build_optimizer", patched)


def _unchanged_step_in_window(monkeypatch):
    """The same, in the window's ``fit`` alone: set-up's epoch trains."""
    _unchanged_step(monkeypatch, after=1)


def _half_batch_fit(monkeypatch):
    from deepblast_torch.train.trainer import DeepBLAST
    loss = DeepBLAST.compute_loss

    def half(self, batch, aln):
        k = aln.shape[0] // 2
        return loss(self, {key: v[:k] for key, v in batch.items()}, aln[:k])
    monkeypatch.setattr(DeepBLAST, "compute_loss", half)


def _altered_answer(monkeypatch):
    from deepblast_torch.train.trainer import DeepBLAST
    align = DeepBLAST.align

    def altered(self, x, y):
        s = align(self, x, y)
        k = len(s) // 2
        return s[:k] + ("1" if s[k] != "1" else "2") + s[k + 1:]
    monkeypatch.setattr(DeepBLAST, "align", altered)


def _half_batch_nw(monkeypatch):
    from deepblast_torch.train import losses
    full = losses.matrix_cross_entropy

    def half(Y, E, xl, yl, G):
        k = E.shape[0] // 2
        return full(Y[:k], E[:k], xl[:k], yl[:k], G[:k])
    monkeypatch.setattr(losses, "matrix_cross_entropy", half)


def _altered_e(monkeypatch):
    from deepblast_torch.ops import dp
    expected = dp.expected_alignment

    def altered(*a, **k):
        return expected(*a, **k) + 1e-2
    monkeypatch.setattr(dp, "expected_alignment", altered)


FAULTS = {
    "pt-l8.train": [_unchanged_step, _unchanged_step_in_window,
                    _half_batch_fit],
    "pt-l8.align": [_altered_answer],
    "nw-layer.train-800": [_half_batch_nw, _altered_e],
    "nw-layer.train-4096": [_half_batch_nw, _altered_e],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]],
                         ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]
