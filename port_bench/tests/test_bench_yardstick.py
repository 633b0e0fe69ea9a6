"""The yardstick's arithmetic against hand counts at small shapes: the
required work of the recurrences and the Sinkhorn, the model FLOPs, and
the reduction of a trace's device operations."""

import pytest
import torch

from port_bench import flops, roofline
from port_bench.reference import kccot as ref
from port_bench.trace import breakdown, family_of

CFG = {"compute_dtype": "bfloat16", "int_time_steps": 2, "total_time_steps": 4, "sinkhorn_l": 3,
       "model": {"x_height": 16, "x_width": 16, "g_filter_size": 2, "d_filter_size": 1, "d_state_size": 2,
                 "n_channels": 1, "z_channels": 2, "z_height": 1, "z_width": 1, "use_norm": True,
                 "output_activation": "sigmoid", "dropout": 0.0, "rnn_dropout": 0.0},
       "kernel": "none", "share_context_encoding": True, "scaling_coef": 15.0, "sinkhorn_eps": 1.0,
       "reg_penalty": 1.0, "lr": 5e-4, "warmup_steps": 10, "decay_steps": 5, "decay_rate": 0.975,
       "beta1": 0.5, "beta2": 0.9, "adam_eps": 1e-7, "keras_double_step_quirk": True}


def test_convlstm_call_by_hand():
    # dec5 at 16x16: f = 2, k = 8; B = 3, T = 4 from the zero state
    ops, nbytes = roofline._convlstm_call(CFG, "dec5", 3, 4, carried=False)
    pixels, conv = 3 * 16 * 16, 2 * 8 * 8 * 2 * 8
    assert ops == conv * pixels * 3 + 20 * 2 * pixels * 4
    state = 2 * pixels * 2 * 4
    assert nbytes == pixels * 4 * (8 * 2 + 2 * 2) + 2 * state + (8 * 8 * 2 * 8 + 8) * 4
    ops_b, _ = roofline._convlstm_call(CFG, "dec5", 3, 4, carried=True, backward=True)
    assert ops_b == 2 * conv * pixels * 4 + 40 * 2 * pixels * 4


def test_sinkhorn_launch_by_hand():
    ops, nbytes = roofline._sinkhorn_launch(3, 4, 2, backward=False)
    assert ops == 3 * (2 * 14 * 16 + 6 * 16)
    assert nbytes == 3 * 16 * 4 + 2 * 2 * 3 * 4 * 4 + 12


def test_train_work_counts_every_call():
    work = roofline.train_work(CFG, 2)
    enc = sum(roofline._convlstm_call(CFG, n, 2, 4, False)[0] for n in ("enc1", "enc2", "enc3", "enc4"))
    dec = sum(roofline._convlstm_call(CFG, n, 2, 2, False)[0] for n in ("dec2", "dec3", "dec4", "dec5"))
    enc_b = sum(roofline._convlstm_call(CFG, n, 2, 4, False, True)[0] for n in ("enc1", "enc2", "enc3", "enc4"))
    dec_b = sum(roofline._convlstm_call(CFG, n, 2, 2, False, True)[0] for n in ("dec2", "dec3", "dec4", "dec5"))
    assert work["convlstm"][0] == enc + 2 * dec + enc_b + dec_b
    assert work["convlstm"][2] == roofline.PEAK_BF16 and work["sinkhorn"][2] == roofline.PEAK_F32
    assert roofline.bound_s(1e12, 0, roofline.PEAK_BF16) == pytest.approx(1 / 989)


def test_rollout_flops_by_hand():
    """One ConvLSTM at one step: the counter counts the input and the
    recurrent conv, 2 MACs each, and nothing of the gates."""
    p = {"l.kernel": torch.zeros(3, 3, 1, 8), "l.recurrent_kernel": torch.zeros(3, 3, 2, 8)}
    x = torch.zeros(1, 1, 4, 4, 1, device="meta")
    got = flops._count(lambda: ref.convlstm({k: v.to("meta") for k, v in p.items()}, "l", x, ref.Precision("bfloat16")))
    assert got == 2 * 16 * 8 * 9 * 1 + 2 * 16 * 8 * 9 * 2


def test_step_flops_do_not_depend_on_sinkhorn_iterations():
    a = flops.train_step_flops(ref, CFG, 2)
    assert a == flops.train_step_flops(ref, {**CFG, "sinkhorn_l": 7}, 2) and a > 0
    assert flops.rollout_flops(ref, CFG, 2) > 0


def test_family_matching_and_breakdown():
    of = family_of({"lstm": ["lstm_fwd_kernel"], "convlstm": ["convlstm_step_kernel"]})
    assert of("void lstm_fwd_kernel<2>(float*)") == "lstm"
    assert of("void convlstm_step_kernel(int)") == "convlstm"
    assert of("void xlstm_fwd_kernel_v2()") is None
    red = {"ops": [("a", 0, 5.0), ("b", 6, 1.0), ("a", 8, 2.0)], "gaps": [("step", 1.0), ("loop", 3.0)]}
    assert breakdown(red) == {"device_ops": [["a", 7e-6], ["b", 1e-6]], "idle_gaps": [["loop", 3e-6], ["step", 1e-6]]}
