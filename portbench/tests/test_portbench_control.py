"""The control of each cell comes out not correct: the numbers a run
compares, read for the control at the cell's own size on the card
(``portbench.calibrate``), fail at least one limit.  Needs a CUDA card:
the sizes are the cells' own, and the nw-layer controls are the port's
own bf16 kernel paths."""

import pytest
import torch

from portbench import calibrate, manifest

SEED = 2**31 + 77


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' "
                    "own sizes and through the port's kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_control_is_not_correct(card, cell):
    mix = manifest.mix(manifest.workload(manifest.load(), cell)["traffic"])
    limits = mix["limits"]
    controls = [got for kind, _, got in calibrate.readings(
        cell, [], {SEED}, seconds=3.0) if kind == "control"]
    assert controls
    for got in controls:
        assert any(not got[k] <= lim for k, lim in limits.items()), got
