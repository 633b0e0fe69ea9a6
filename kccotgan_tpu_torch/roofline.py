"""The least time an H100 could take for the work of each TPU kernel of the
JAX package, at the shapes a config gives it: the larger of the bytes the
work must move (each input read once, each output written once) over the
HBM rate and its operations over the peak rate for their type.

    python -m kccotgan_tpu_torch.roofline [preset]   # one JSON line a kernel

``chip_smoke.py`` takes the bounds of the kernels it times from here;
the ``table`` rows, at one main-path call each, are for ``PERF.md``'s
table.  Rates are the published peaks of one H100 SXM at its 700 W limit.
"""

from __future__ import annotations

import json
import sys

__all__ = [
    "PEAK_BF16",
    "PEAK_F32",
    "PEAK_HBM",
    "bound_ms",
    "convlstm_layers",
    "convlstm_work",
    "lstm_layers",
    "lstm_work",
    "sinkhorn_work",
    "table",
]

PEAK_BF16 = 989e12  # FLOP/s, tensor cores, dense
PEAK_F32 = 67e12  # FLOP/s, outside the tensor cores
PEAK_HBM = 3.35e12  # bytes/s


def bound_ms(ops: float, nbytes: float, rate: float) -> tuple[float, str]:
    """``(ms, "operations" or "bytes")``: the larger of the two times."""
    t_ops, t_bytes = ops / rate, nbytes / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def convlstm_layers(cfg) -> dict:
    """``name: (H = W, filters, kernel)`` of the 8 ConvLSTM layers (square
    frames): the encoder's four stride-2 levels, then the decoder's."""
    m = cfg.model
    f, hw = m.g_filter_size, m.x_height
    return {
        "enc1": (hw // 2, f * 4, 6), "enc2": (hw // 4, f * 8, 6),
        "enc3": (hw // 8, f * 16, 5), "enc4": (hw // 16, f * 32, 5),
        "dec2": (hw // 8, f * 16, 4), "dec3": (hw // 4, f * 8, 6),
        "dec4": (hw // 2, f * 4, 8), "dec5": (hw, f, 8),
    }


def convlstm_work(layers: dict, b: int, t_of, backward: bool = False, cbytes: int = 2):
    """``(ops, bytes)`` of the recurrences of ``layers`` at batch ``b`` and
    ``t_of(name)`` steps.  Forward: the recurrent conv (2 kh kw f 4f FLOP
    a pixel and step) and the gates (about 20 a channel); reads the x
    stack (compute dtype), h0, c0, kernel and bias (f32) and writes y
    (compute dtype) and h, c (f32).  Backward: the recurrent conv three
    times (gates recomputed, dh, dW) and the gate adjoint (about 40 a
    channel); reads x, y and dy (compute dtype), the c stack, h0, c0, the
    kernel and bias (f32), writes dx (compute dtype), dh0, dc0, dW, db."""
    ops = nbytes = 0
    for name, (hw, f, k) in layers.items():
        t = t_of(name)
        pix = b * t * hw * hw
        conv = 2 * k * k * f * 4 * f
        state = 2 * b * hw * hw * f * 4
        weights = (k * k * f * 4 * f + 4 * f) * 4
        if backward:
            ops += pix * (3 * conv + 40 * f)
            nbytes += pix * (4 * f * cbytes * 2 + 2 * f * cbytes + f * 4) + 2 * state + 2 * weights
        else:
            ops += pix * (conv + 20 * f)
            nbytes += pix * (4 * f * cbytes + f * cbytes) + 2 * state + weights
    return ops, nbytes


def lstm_layers(cfg) -> dict:
    """``name: (in_features, units)`` of the discriminator's three LSTMs."""
    m = cfg.model
    f, s = m.d_filter_size, m.x_height
    for _ in range(3):
        s = -(-s // 2)
    return {"lstm1": (s * s * f * 16, f * 8), "lstm2": (f * 8, f * 4), "lstm3": (f * 4, m.d_state_size)}


def lstm_work(layers: dict, b: int, t: int, backward: bool = False, cbytes: int = 2):
    """``(ops, bytes)`` of the recurrences (the hoisted input projection is
    a plain product outside the kernel), as for the ConvLSTM with the
    recurrent matmul ``2 U 4U`` a row and step in place of the conv."""
    return convlstm_work(
        {name: (1, u, 1) for name, (_, u) in layers.items()}, b, lambda _: t, backward, cbytes
    )


def sinkhorn_work(k: int, b: int, num_iters: int, backward: bool = False):
    """``(ops, bytes)`` of one launch on ``[k, b, b]``, f32.  Forward, per
    dual update and entry: (-c + u + v) / eps (3), the max (1), exp of the
    shifted value (2) and its sum (1); the final cost 6 an entry.
    Backward, per step and entry, for each of the two softmaxes: the
    logits (3), max (1), exp (2), sum (1), normalize (1), scale (1), c_bar
    update (2), row and column sums (2); 10 an entry for the terminal
    cost.  Bytes: c, the [L, K, B] histories and the outputs (costs,
    c_bar) once each, and the cotangent."""
    hist = 2 * num_iters * k * b * 4
    if backward:
        return k * (num_iters * 26 * b * b + 10 * b * b), 2 * k * b * b * 4 + hist + k * 4
    return k * (num_iters * 2 * 7 * b * b + 6 * b * b), k * b * b * 4 + hist + k * 4


def table(cfg) -> list[dict]:
    """Bound of each TPU kernel's work in one call of its main path at
    ``cfg``: the rollout's 8 T=10 layer scans timed by ``chip_smoke.py``
    for the ConvLSTM forward, one training iteration otherwise (the
    ConvLSTM and LSTM kernels as ``kernel_impl='pallas'`` would run them:
    encoder over all frames, decoder over the predicted ones, and 8
    discriminator passes, of which the disc phase differentiates 4 and the
    gen phase the 2 on fake frames)."""
    b, tc, tp = cfg.batch_size, cfg.int_time_steps, cfg.pred_time_steps
    conv = convlstm_layers(cfg)
    lstm = lstm_layers(cfg)

    def train_t(name):
        return tc + tp if name.startswith("enc") else tp

    rows = []

    def row(kernel, where, work, rate, note):
        ops, nbytes = work
        ms, by = bound_ms(ops, nbytes, rate)
        rows.append({"kernel": kernel, "where": where, "ops": ops, "bytes": nbytes,
                     "bound_ms": ms, "bound_by": by, "note": note})

    row("pallas_convlstm.py::_fwd_kernel", "rollout", convlstm_work(conv, b, lambda _: tp), PEAK_BF16,
        "8 layers at T=10 (chip_smoke.py phase 2)")
    row("pallas_convlstm.py::_bwd_kernel", "training iteration",
        convlstm_work(conv, b, train_t, backward=True), PEAK_BF16, "8 layers once (gen phase)")
    row("pallas_lstm.py::_fwd_kernel", "training iteration",
        tuple(8 * x for x in lstm_work(lstm, b, tc + tp)), PEAK_BF16, "3 layers x 8 discriminator passes")
    row("pallas_lstm.py::_bwd_kernel", "training iteration",
        tuple(6 * x for x in lstm_work(lstm, b, tc + tp, backward=True)), PEAK_BF16,
        "3 layers x 6 differentiated passes")
    for backward, name in ((False, "_kernel"), (True, "_bwd")):
        row(f"pallas_sinkhorn.py::{name}", "one launch (2 an iteration)",
            sinkhorn_work(3, b, cfg.sinkhorn_l, backward), PEAK_F32, "[3, B, B], L iterations")
    return rows


if __name__ == "__main__":
    from .config import get_preset

    for r in table(get_preset(sys.argv[1] if len(sys.argv) > 1 else "mmnist_full")):
        print(json.dumps(r))
