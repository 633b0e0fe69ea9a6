"""The least time an H100 needs for the work a cell's recurrences and
Sinkhorn solves require, from the configuration's shapes alone.

The benchmark's own copy of the port's roofline arithmetic, counting only
what the algorithm requires: a ConvLSTM or LSTM step's recurrent product
only where its incoming state is not the zero initial state, a backward
step's two products (dh and dW, no gate recompute), and each input byte
read once and each output byte written once.  Peaks are NVIDIA's
published dense rates of one H100 SXM at its 700 W limit.
"""

from __future__ import annotations

__all__ = ["PEAK_BF16", "PEAK_F32", "PEAK_HBM", "bound_s", "convlstm_layers", "lstm_layers", "rollout_work",
           "train_work"]

PEAK_BF16 = 989e12  # FLOP/s, tensor cores, dense
PEAK_F32 = 67e12  # FLOP/s, CUDA cores
PEAK_HBM = 3.35e12  # bytes/s


def bound_s(ops: float, nbytes: float, rate: float) -> float:
    """The larger of the operations' and the bytes' least times."""
    return max(ops / rate, nbytes / PEAK_HBM)


def convlstm_layers(cfg: dict) -> dict:
    """``name: (H = W, filters, kernel)`` of the 8 ConvLSTM layers."""
    m = cfg["model"]
    f, hw = m["g_filter_size"], m["x_height"]
    return {
        "enc1": (hw // 2, f * 4, 6), "enc2": (hw // 4, f * 8, 6),
        "enc3": (hw // 8, f * 16, 5), "enc4": (hw // 16, f * 32, 5),
        "dec2": (hw // 8, f * 16, 4), "dec3": (hw // 4, f * 8, 6),
        "dec4": (hw // 2, f * 4, 8), "dec5": (hw, f, 8),
    }


def lstm_layers(cfg: dict) -> dict:
    """``name: units`` of a discriminator's three LSTMs."""
    m = cfg["model"]
    f = m["d_filter_size"]
    return {"lstm1": f * 8, "lstm2": f * 4, "lstm3": m["d_state_size"]}


def _recurrence(pixels: int, f: int, prod: int, steps: int, carried_steps: int, backward: bool, cb: int,
                wbytes: int):
    """``(ops, bytes)`` of one recurrence call over ``steps`` steps of
    ``pixels`` positions each, ``carried_steps`` of which start from a
    state that is not zero; ``prod`` is the recurrent product's FLOP a
    position; ``wbytes`` the recurrent weight's and bias's bytes (f32)."""
    pix = pixels * steps
    state = 2 * pixels * f * 4  # h and c, f32
    if backward:
        # dh and dW where h_{t-1} is not zero, the gate adjoint everywhere;
        # reads x, y, dy (compute dtype) and the c stack, writes dx
        ops = 2 * prod * pixels * carried_steps + 40 * f * pix
        nbytes = pix * (4 * f * cb * 2 + 2 * f * cb + f * 4) + 2 * state + 2 * wbytes
    else:
        ops = prod * pixels * carried_steps + 20 * f * pix
        nbytes = pix * (4 * f * cb + f * cb) + 2 * state + wbytes
    return ops, nbytes


def _convlstm_call(cfg, layer, b, steps, carried, backward=False):
    hw, f, k = convlstm_layers(cfg)[layer]
    cb = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    carried_steps = steps if carried else steps - 1
    return _recurrence(b * hw * hw, f, 2 * k * k * f * 4 * f, steps, carried_steps, backward, cb,
                       (k * k * f * 4 * f + 4 * f) * 4)


def _lstm_call(cfg, layer, b, steps, backward=False):
    u = lstm_layers(cfg)[layer]
    cb = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    return _recurrence(b, u, 2 * u * 4 * u, steps, steps - 1, backward, cb, (u * 4 * u + 4 * u) * 4)


def _sinkhorn_launch(k: int, b: int, num_iters: int, backward: bool):
    """``(ops, bytes)`` of one launch on ``[k, b, b]`` in f32: per dual
    update and entry the logits (3), max (1), exp (2) and sum (1) of each
    of the two half-steps, and the final cost (6 an entry); the backward
    about 26 an entry and update.  Bytes: the costs, the dual histories
    and the outputs once each."""
    hist = 2 * num_iters * k * b * 4
    if backward:
        return k * (num_iters * 26 * b * b + 10 * b * b), 2 * k * b * b * 4 + hist + k * 4
    return k * (num_iters * 2 * 7 * b * b + 6 * b * b), k * b * b * 4 + hist + k * 4


def _sum(works):
    ops = nbytes = 0
    for o, n in works:
        ops, nbytes = ops + o, nbytes + n
    return ops, nbytes


def train_work(cfg: dict, b: int, sinkhorn_b: int | None = None) -> dict:
    """``family: (ops, bytes, peak)`` of one training step at batch ``b``
    (the shared context encoding, the decoder in both phases, the backward
    of the generator phase; 8 discriminator passes, 6 differentiated; two
    Sinkhorn launches of three problems of ``sinkhorn_b`` (default ``b``),
    and their backward)."""
    tc, tt = cfg["int_time_steps"], cfg["total_time_steps"]
    tp = tt - tc
    peak = PEAK_BF16 if cfg["compute_dtype"] == "bfloat16" else PEAK_F32
    enc = [n for n in convlstm_layers(cfg) if n.startswith("enc")]
    dec = [n for n in convlstm_layers(cfg) if n.startswith("dec")]
    conv = _sum([_convlstm_call(cfg, n, b, tt, False) for n in enc]
                + [_convlstm_call(cfg, n, b, tp, False) for n in dec] * 2
                + [_convlstm_call(cfg, n, b, tt, False, True) for n in enc]
                + [_convlstm_call(cfg, n, b, tp, False, True) for n in dec])
    lstm = _sum([_lstm_call(cfg, n, b, tt) for n in lstm_layers(cfg)] * 8
                + [_lstm_call(cfg, n, b, tt, True) for n in lstm_layers(cfg)] * 6)
    sb = b if sinkhorn_b is None else sinkhorn_b
    sink = _sum([_sinkhorn_launch(3, sb, cfg["sinkhorn_l"], False)] * 2
                + [_sinkhorn_launch(3, sb, cfg["sinkhorn_l"], True)] * 2)
    return {"convlstm": (*conv, peak), "lstm": (*lstm, peak), "sinkhorn": (*sink, PEAK_F32)}


def rollout_work(cfg: dict, b: int) -> dict:
    """``{"convlstm": (ops, bytes, peak)}`` of one rollout at batch ``b``:
    the encoder over the context from zero states, then for each predicted
    frame the decoder (one step from zero states) and, for every frame but
    the last, the encoder's step on the carries."""
    tc, tp = cfg["int_time_steps"], cfg["total_time_steps"] - cfg["int_time_steps"]
    peak = PEAK_BF16 if cfg["compute_dtype"] == "bfloat16" else PEAK_F32
    layers = convlstm_layers(cfg)
    enc = [n for n in layers if n.startswith("enc")]
    dec = [n for n in layers if n.startswith("dec")]
    conv = _sum([_convlstm_call(cfg, n, b, tc, False) for n in enc]
                + [_convlstm_call(cfg, n, b, 1, False) for n in dec] * tp
                + [_convlstm_call(cfg, n, b, 1, True) for n in enc] * (tp - 1))
    return {"convlstm": (*conv, peak)}
