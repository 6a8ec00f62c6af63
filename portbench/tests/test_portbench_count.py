"""The work counts against hand counts at tiny shapes."""

import pytest

from portbench.count import dp, model, peaks

LM = {"d_model": 4, "num_heads": 2, "d_kv": 2, "d_ff": 8, "num_layers": 1}
HEADS = {"embedding_dim": 2, "hidden_dim": 2, "k_size": 3, "layers": 2}


def test_t5_forward():
    # n = 2: q, k, v, o 4 x (2 x 4 x 4) MACs, the feed-forward 2 x (2 x 4 x
    # 8), scores and values 2 x (2 x 2 x 4): 288 MACs
    assert model.t5_forward(2, LM) == 2 * 288
    assert model.t5_forward(2, dict(LM, num_layers=3)) == 3 * 2 * 288


def test_heads():
    # n = 3: embed 3 x 2 x 2 = 12 MACs, each conv 3 x 2 x 2 x 3 = 36
    assert model.heads_forward(3, HEADS) == 2 * 2 * (12 + 36 + 36)
    # forward, every weight's gradient, the convolutions' input gradients
    assert model.heads_train(3, HEADS) == 2 * 2 * (84 + 84 + 72)


def test_potentials_and_pairs():
    assert model.potentials_forward(3, 5, HEADS) == 2 * 2 * 3 * 5 * 2
    assert model.potentials_train(3, 5, HEADS) == 3 * 120
    cfg = {"lm": LM, "heads": HEADS}
    assert model.pair_serve(3, 5, cfg) == (
        model.t5_forward(3, LM) + model.t5_forward(5, LM)
        + model.heads_forward(3, HEADS) + model.heads_forward(5, HEADS) + 120)


def test_dp_least():
    assert dp.valid_cells([3, 2], [4, 5]) == 22
    assert dp.dp_train_least_s(10) == pytest.approx(240 / peaks.HBM_BYTES)
    assert dp.dp_train_least_s(10, value_bytes=0) == pytest.approx(
        30 / peaks.MUFU_PER_S)
    assert dp.loss_least_s(10) == pytest.approx(50 / peaks.HBM_BYTES)
