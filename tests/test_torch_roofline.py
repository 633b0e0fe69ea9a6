"""The port's roofline counts (``kccotgan_tpu_torch/roofline.py``) by hand:
the ConvLSTM backward reads the forward's gate stack and runs two
products, the dense LSTM's backward recomputes its gates (three)."""

import pytest

from kccotgan_tpu_torch.roofline import PEAK_BF16, bound_ms, convlstm_work, lstm_work


@pytest.mark.parametrize("cbytes", [2, 4])
def test_convlstm_work_by_hand(cbytes):
    hw, f, k, b, t = 3, 8, 2, 2, 5
    pix, conv = b * t * hw * hw, 2 * k * k * f * 4 * f
    state, weights = 2 * b * hw * hw * f * 4, (k * k * f * 4 * f + 4 * f) * 4
    layers = {"l": (hw, f, k)}
    assert convlstm_work(layers, b, lambda _: t, cbytes=cbytes) == (
        pix * (conv + 20 * f), pix * (4 * f * cbytes + f * cbytes) + 2 * state + weights)
    # the f32 gate stack in, dx out; y, dy and the c stack in
    assert convlstm_work(layers, b, lambda _: t, backward=True, cbytes=cbytes) == (
        pix * (2 * conv + 40 * f),
        pix * (4 * f * 4 + 4 * f * cbytes + 2 * f * cbytes + f * 4) + 2 * state + 2 * weights)


def test_lstm_backward_counts_its_recompute():
    u, b, t = 16, 4, 6
    ops, nbytes = lstm_work({"lstm": (100, u)}, b, t, backward=True)
    assert ops == b * t * (3 * 2 * u * 4 * u + 40 * u)
    assert nbytes == b * t * (4 * u * 2 * 2 + 2 * u * 2 + u * 4) + 2 * 2 * b * u * 4 + 2 * (u * 4 * u + 4 * u) * 4
    assert bound_ms(ops, nbytes, PEAK_BF16)[1] == "bytes"
