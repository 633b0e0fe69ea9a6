#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from ``kccotgan_tpu_torch/csrc`` and drives the
ported paths at the ``mmnist_full`` preset (B=32, 64x64x1, 10 context +
10 predicted frames, bf16 convs, seeded random weights):

* kernels vs their plain PyTorch versions: the ConvLSTM forward at the 8
  ConvLSTM layer shapes (f32 and bf16), the Sinkhorn forward and
  backward at [3, B, B] with L=100 for B = 32 (the training step), 128,
  161, 240, 512 and 1024 (each of their paths: a block's registers up
  to 64, a thread-block cluster a problem past that, C in its shared
  memory up to about 600, read through L2 past it), and at [1, 8200,
  8200] with L=3 (u and v no longer staged in shared memory), one launch
  a call, traced at B = 32, 240 and 1024, and each Sinkhorn kernel's
  registers and spills
  (``nvcc -Xptxas -v``); the ConvLSTM backward (and the forward's c stack)
  at the 8 layer shapes with the training T, and the LSTM forward and
  backward at lstm1-3, B=32, T=20, f32 and bf16, each wrapper call
  traced for its kernel's own device time (one launch and no other
  device op a call), beside cuDNN's LSTM at lstm1 and lstm2, and at
  U = 128 and 256 (past the kernels' 64-unit staging: bf16 up to 128 on
  the tensor cores, else R read through L2);
* the conditioned rollout through the kernel and the plain path, timed,
  and per path where its device time goes (CUDA-graph replay beside the
  eager rollout, and one rollout under ``torch.profiler``);
* two training iterations (``kernel_impl='scan'``, L=100) through the
  Sinkhorn kernels and two through the plain loop from the same state,
  compared, timed in turns, with peak memory and one iteration of each
  under ``torch.profiler``;
* two training iterations under ``kernel_impl='pallas'`` (every ConvLSTM
  and LSTM recurrence through its forward and backward kernels) against
  two under ``'scan'`` from the same state, video and z, in f32 and in
  bf16, with every kernel's calls and launches counted per iteration;
  then both engines timed in turns and profiled;
* the trainer: ``cli.main`` trains 8 ``'pallas'`` steps at ``mmnist_full``
  on an MMNIST-layout fixture (checkpoints and samples every 4 steps,
  every kernel's launches counted over the run, which the ``kernels``
  line reports); ``Trainer.fit`` run 4 steps, checkpointed, restored into
  a new trainer and run 4 more, against 8 straight, equal to the bit;
  and the loop against the bare step in turns (the ``trainer`` line).

The bf16 engine runs the ConvLSTM's recurrent conv, dh and drk, and the
dense LSTM's step, dh and dR, on the tensor cores: the built library's
LSTM kernels must show HMMA in ``cuobjdump -sass`` (bf16) or none (f32);
each ConvLSTM layer's bf16 backward is profiled and split into its
recompute step, dh and weight-gradient kernels, beside each layer's
achieved TFLOP/s (``roofline.convlstm_work`` over the time); and the
tensor-core kernels must show by name in the bf16 rollout's and
``'pallas'`` iteration's traces.

Each path's kernel launches are counted from zero around its run.  Every
phase raises on failure.  The last lines are the kernels' JSON record,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from kccotgan_tpu_torch._build import _FLAGS, BUILD_DIR, _nvcc, load_library
from kccotgan_tpu_torch.ckpt import latest_step
from kccotgan_tpu_torch.cli.main import main as train_main
from kccotgan_tpu_torch.config import get_preset
from kccotgan_tpu_torch.data import ArrayDataset, load_mmnist, mmnist_paths, write_mmnist_fixture
from kccotgan_tpu_torch.models.cuda_convlstm import (
    convlstm_bwd,
    convlstm_bwd_reference,
    convlstm_fwd,
    convlstm_fwd_reference,
    convlstm_scan,
    convlstm_scan_reference,
)
from kccotgan_tpu_torch.models.cuda_lstm import (
    lstm_bwd,
    lstm_bwd_reference,
    lstm_fwd,
    lstm_scan_reference,
)
from kccotgan_tpu_torch.models.layers import LSTM
from kccotgan_tpu_torch.ot.cuda_sinkhorn import (
    sinkhorn_bwd,
    sinkhorn_bwd_reference,
    sinkhorn_fwd,
    sinkhorn_fwd_reference,
)
from kccotgan_tpu_torch.roofline import (
    PEAK_BF16,
    PEAK_F32,
    bound_ms,
    convlstm_layers,
    convlstm_work,
    lstm_layers,
    lstm_work,
    sinkhorn_work,
)
from kccotgan_tpu_torch.train import Trainer, build_rollout, build_train_step, create_train_state
from kccotgan_tpu_torch.weights import init_generator_params

PRESET = "mmnist_full"
B, T = 32, 10
# name: (spatial H = W, filters f, kernel k) of each ConvLSTM on the rollout path
LAYERS = convlstm_layers(get_preset(PRESET))


def train_t(name):
    """Steps of a ConvLSTM layer in a training iteration: the encoder runs
    over all frames, the decoder over the predicted ones."""
    cfg = get_preset(PRESET)
    return cfg.total_time_steps if name.startswith("enc") else cfg.pred_time_steps
# f32 (TF32 off): only the summation order of the recurrent conv differs.
# bf16: a different summation order can round the recurrent conv or y one
# bf16 ulp apart (2**-8 = 3.9e-3 for y in [0.5, 1)); the gates carry such
# a difference over the T steps.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Whole rollout, kernel path vs plain path on the same weights and z: the
# per-layer differences above, fed back through 10 generated frames and
# divided by each LayerNorm's spread.
ROLLOUT_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
KERNELS = {
    "convlstm_fwd": {
        "name": "convlstm_fwd",
        "route": "cuda",
        "source": "kccotgan_tpu_torch/csrc/convlstm_fwd.cu",
        "replaces": "kccotgan_tpu/models/pallas_convlstm.py:203",
    },
    "sinkhorn_fwd": {
        "name": "sinkhorn_fwd",
        "route": "cuda",
        "source": "kccotgan_tpu_torch/csrc/sinkhorn_fwd.cu",
        "replaces": "kccotgan_tpu/ot/pallas_sinkhorn.py:50",
        "design": "B <= 64 in one block's registers, 16 lanes a row; a cluster a problem past that",
    },
    "sinkhorn_bwd": {
        "name": "sinkhorn_bwd",
        "route": "cuda",
        "source": "kccotgan_tpu_torch/csrc/sinkhorn_bwd.cu",
        "replaces": "kccotgan_tpu/ot/pallas_sinkhorn.py:138",
        "design": "B <= 64 in one block's registers, 16 lanes a row; a cluster a problem past that",
    },
    "convlstm_bwd": {
        "name": "convlstm_bwd",
        "route": "cuda",
        "source": "kccotgan_tpu_torch/csrc/convlstm_bwd.cu",
        "replaces": "kccotgan_tpu/models/pallas_convlstm.py:311",
    },
    "lstm_fwd": {
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "kccotgan_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "kccotgan_tpu/models/pallas_lstm.py:93",
    },
    "lstm_bwd": {
        "name": "lstm_bwd",
        "route": "cuda",
        "source": "kccotgan_tpu_torch/csrc/lstm_bwd.cu",
        "replaces": "kccotgan_tpu/models/pallas_lstm.py:186",
    },
}
# Backward kernels vs their plain versions, each gradient within a share
# of its largest entry.  f32 (TF32 off): the same products summed in
# another order, the longest sums (drk: B*T*H*W = 655,360 terms at enc1)
# in f32 runs whose rounding error grows like sqrt(K) * 2**-24 of the
# terms (~5e-5 at K = 655,360 in the worst case of no cancellation), so
# 1e-4.  bf16: both round the recomputed recurrent conv, y and dz to bf16
# at the same points, but another summation order can put a rounding one
# bf16 ulp (2**-8 = 3.9e-3 relative) apart; that moves a gate, its dz and
# every later step's dh by about as much, so 2e-2 of the largest entry.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The discriminator's LSTMs, B=32, T=20.
LSTM_B, LSTM_T = 32, 20
# Training engines, 'pallas' vs 'scan', same state, video and z.  The
# first iteration's losses, pM and every group's Adam first moment (half
# the first gradient) are compared; parameters are not (Keras Adam turns
# rounding-level gradients into full steps, and the engines round dh_prev
# differently: f32 in the kernels, compute dtype under autograd).
# f32 (TF32 off): only summation orders differ.  Losses and pM at rtol
# 1e-4 (the Sinkhorn divergence's cancellation magnifies a few ulp of its
# three costs).  The generator's moments at 1e-4 of each group's largest:
# gradients through two recurrent stacks summed in another order.  The
# discriminators' at 1e-2: their conv kernels sit behind three
# BatchNorms, whose backward subtracts the batch mean of the incoming
# gradient, so those weight gradients are small differences of large
# sums and carry the upstream ulps magnified (measured on the H100:
# 1.5e-3 at h's conv1 against 3.4e-6 in the generator).
# bf16: the forward recurrences may round a conv or y one ulp (2**-8)
# apart and the scan rounds dz and dh_prev to bf16 where the kernels
# keep f32.  Losses and pM at rtol 1e-3: one ulp of a discriminator
# output moves the ~750 costs by far less than that.  Moments at 2e-2 of
# the largest in the generator (a few ulp carried through the steps),
# 0.2 in the discriminators (the same ulps behind the BatchNorms' magnifier).
ENGINE_TOL = {
    "float32": {"loss_rtol": 1e-4, "pm_rtol": 1e-4,
                "mu_rel": {"enc": 1e-4, "dec": 1e-4, "h": 1e-2, "m": 1e-2}},
    "bfloat16": {"loss_rtol": 1e-3, "pm_rtol": 1e-3,
                 "mu_rel": {"enc": 2e-2, "dec": 2e-2, "h": 0.2, "m": 0.2}},
}
# Per 'pallas' iteration at mmnist_full: (calls, launches) of each kernel.
# ConvLSTM forward: the encoder's 4 layers over 20 steps, the decoder's 4
# over 10 in each phase, one launch a step.  Backward (generator phase
# only): two launches a step and two for the weight gradient.  LSTM: 3
# layers x 8 discriminator passes forward, x 6 differentiated passes
# backward (one launch each: the recurrence, dR and db).  Sinkhorn: one
# forward and one backward a phase.
PALLAS_COUNTS = {
    "convlstm_fwd": (12, 4 * 20 + 8 * 10),
    "convlstm_bwd": (8, 4 * (2 * 20 + 2) + 4 * (2 * 10 + 2)),
    "lstm_fwd": (24, 24),
    "lstm_bwd": (18, 18),
    "sinkhorn_fwd": (2, 2),
    "sinkhorn_bwd": (2, 2),
}
RECURRENCE_KERNELS = ("convlstm_fwd", "convlstm_bwd", "lstm_fwd", "lstm_bwd")
# The training step's Sinkhorn solves: xy, xx, yy at the batch size.
SINK_K, SINK_L, SINK_EPS = 3, 100, 1.0
# Sinkhorn batches checked: the training step's 32, sizes past the
# register path's 64 and past where one block's shared memory once ran
# out (160 backward, 239 forward), up to 1024, whose [3, B, B] costs fill
# a quarter of L2; the traced ones; and (K, B, L) past the B = 8192 up to
# which the cluster path stages u and v in shared memory (one problem of
# 269 MB, few iterations so that autograd through the plain loop fits).
SINK_BATCHES = (32, 128, 161, 240, 512, 1024)
SINK_TRACED = (32, 240, 1024)
SINK_UNSTAGED = (1, 8200, 3)
# LSTM widths past U = 64: 128 (bf16 on the tensor cores at KT = 8, f32
# through L2) and 256 (both through L2), dR and db in a second launch.
LSTM_WIDE = (128, 256)
# Sinkhorn kernel vs plain version, f32: costs at rtol 1e-5 and c_bar at
# rtol 1e-4 / atol 1e-6 (the JAX package's tolerances for its fused
# kernel against its scan); the duals (of order 1 to 10) at 1e-4 abs.
# c_bar's typical entry shrinks like 1 / B^2 and reaches atol near B =
# 1024, so c_bar is also held at 1e-4 of its largest entry, as GRAD_TOL
# holds the LSTM's gradients.
SINK_TOL = {"cost_rtol": 1e-5, "hist_atol": 1e-4, "cbar_rtol": 1e-4, "cbar_atol": 1e-6,
            "cbar_of_largest": 1e-4}
# Training, kernel path vs plain path, same state, video and z, two
# iterations: the paths differ only in how the Sinkhorn solves are
# summed, so losses and pM agree to a few f32 ulp of the three costs,
# magnified by the divergence's cancellation; gradients (read as Adam's
# first moments) to 1e-3 of each group's largest; parameters to 1e-6,
# which bounds two warmup-sized Adam steps whatever the gradients.  These
# limits are set from that argument, not from a reading.  At the flagship
# the comparison is degenerate: the costs are of order 750 against eps 1,
# so the plans are near-permutations and both paths come out equal to the
# bit.  It shows that the kernels sit on the path and keep it finite; the
# check that can fail a wrong kernel is check_sinkhorn, on spread costs.
TRAIN_TOL = {"loss_rtol": 1e-3, "pm_rtol": 1e-4, "mu_rel": 1e-3, "param_atol": 1e-6}
# The trainer phase: the CLI trains TRAINER_STEPS 'pallas' steps at
# mmnist_full on an MMNIST-layout fixture of FIXTURE_VIDEOS videos (two
# batches an epoch), checkpointing and sampling every TRAINER_EVERY steps
# (samples at 1, 4, 8), and every kernel of the iteration launches as
# often as PALLAS_COUNTS says, the ConvLSTM forward also ROLLOUT_LAUNCHES
# a sample.  The resumed run (4 steps, checkpoint, a new Trainer, 4 more)
# must equal the straight 8 to the bit, cuDNN deterministic: every kernel
# of the port sums in a fixed order, the noise comes from the state's
# key, and a checkpoint holds every bit of the state, so no tolerance.
TRAINER_STEPS, TRAINER_EVERY, FIXTURE_VIDEOS = 8, 4, 64
ROLLOUT_LAUNCHES = 4 * 10 + 8 * 10
# Loop against the bare step, in turns (loop, bare, bare, loop), over this
# many batches with no checkpoint or sample in the window.
LOOP_STEPS = 10


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, by CUDA
    events, after one warm-up run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_inputs(hw, f, k, dtype, dev, seed, t=T):
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    xconv = randn(B, t, hw, hw, 4 * f).to(dtype)
    h0, c0 = randn(B, hw, hw, f, scale=0.5), randn(B, hw, hw, f, scale=0.5)
    rk = randn(k, k, f, 4 * f, scale=(k * k * f) ** -0.5)
    bias = randn(4 * f, scale=0.1)
    return xconv, h0, c0, rk, bias


def max_err(a, b):
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def check_layers(dev):
    """Phase 2: kernel vs plain at every layer shape, f32 and bf16."""
    errs, times = {}, {}
    for i, (name, (hw, f, k)) in enumerate(LAYERS.items()):
        for dtype in (torch.float32, torch.bfloat16):
            args = layer_inputs(hw, f, k, dtype, dev, seed=i)
            y_k, (h_k, c_k) = convlstm_scan(*args)
            y_p, (h_p, c_p) = convlstm_scan_reference(*args)
            torch.cuda.synchronize()
            if y_k.dtype != dtype or h_k.dtype != torch.float32:
                raise RuntimeError(f"{name}: kernel returned {y_k.dtype}/{h_k.dtype}")
            err = max_err((y_k, h_k, c_k), (y_p, h_p, c_p))
            tag = f"{name} {str(dtype).removeprefix('torch.')}"
            print(f"[layers] {tag}: max|kernel - plain| = {err:.3e} (tol {TOL[dtype]:.0e})", flush=True)
            if not err <= TOL[dtype]:
                raise RuntimeError(f"{tag}: kernel disagrees with plain version: {err} > {TOL[dtype]}")
            errs[tag] = err
        args = layer_inputs(hw, f, k, torch.bfloat16, dev, seed=i)
        times[name] = {
            "kernel_ms": cuda_ms(lambda: convlstm_scan(*args), reps=5),
            "plain_ms": cuda_ms(lambda: convlstm_scan_reference(*args), reps=5),
        }
        times[name]["kernel_tflops"] = layer_tflops(name, T, times[name]["kernel_ms"])
    return errs, times


def layer_tflops(name, t, ms, backward=False):
    """Achieved TFLOP/s of one layer's recurrence at batch B and t steps:
    the operations ``roofline.convlstm_work`` counts, over ``ms``."""
    ops, _ = convlstm_work({name: LAYERS[name]}, B, lambda _: t, backward=backward)
    return ops / (ms * 1e-3) / 1e12


# The bf16 engine's tensor-core kernels, by the name they show in a
# torch.profiler trace: forward step; backward recompute step, dh, drk.
TC_KERNELS = ("convlstm_step_tc_kernel", "convlstm_bwd_step_tc_kernel", "convlstm_bwd_dh_tc_kernel",
              "recurrent_wgrad_tc_kernel")
# The bf16 LSTM kernels (tensor cores), by their trace names; the f32
# ones are lstm_fwd_kernel and lstm_bwd_kernel (CUDA cores).
LSTM_TC_KERNELS = ("lstm_fwd_tc_kernel", "lstm_bwd_tc_kernel")
# Parts of one ConvLSTM backward call in a trace: the recompute-and-adjoint
# step, the dh transposed conv, and the weight gradient (GEMM + finalize).
BWD_PARTS = {"step": ("bwd_step",), "dh": ("bwd_dh",), "wgrad": ("wgrad", "finalize")}


def check_rollout(cfg, params, context, z, dtype_name):
    """Phase 3: one rollout through the kernel, counted, and the same
    rollout on the plain path."""
    dev = context.device
    rollout_k = build_rollout(cfg, device=dev)
    rollout_p = build_rollout(cfg, device=dev, plain=True)
    reset_counts()
    out = rollout_k(params, context, z=z)
    torch.cuda.synchronize()
    launches = convlstm_fwd.launches
    if convlstm_bwd.launches or lstm_fwd.launches or lstm_bwd.launches:
        raise RuntimeError("the rollout launched a backward or LSTM kernel")
    if sinkhorn_fwd.launches or sinkhorn_bwd.launches:
        raise RuntimeError("the rollout launched a Sinkhorn kernel")
    tc, tp = cfg.int_time_steps, cfg.pred_time_steps
    expected = 4 * tc + 8 * tp
    if launches != expected:
        raise RuntimeError(f"rollout launched the kernel {launches} times, expected {expected}")
    m = cfg.model
    shape = (cfg.batch_size, m.x_height, tc + tp, m.x_width, m.n_channels)
    if tuple(out.shape) != shape:
        raise RuntimeError(f"rollout shape {tuple(out.shape)}, expected {shape}")
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("rollout produced non-finite values")
    if not torch.equal(out[:, :, :tc], context):
        raise RuntimeError("rollout changed the context frames")
    out_p = rollout_p(params, context, z=z)
    torch.cuda.synchronize()
    diff = float((out - out_p).abs().max())
    tol = ROLLOUT_TOL[getattr(torch, dtype_name)]
    print(
        f"[rollout] {dtype_name}: shape {shape}, {launches} kernel launches, "
        f"max|kernel path - plain path| = {diff:.3e} (tol {tol:.0e})", flush=True,
    )
    if not diff <= tol:
        raise RuntimeError(f"rollout {dtype_name}: kernel path disagrees with plain path: {diff}")
    return launches, diff, rollout_k, rollout_p


def profiled(fn, required=(), what="trace", attempts=5):
    """One ``fn()`` under ``torch.profiler`` (CPU and CUDA activity): busy
    time (union of device activity), span and count of its device events,
    device ms by kernel name and device events by kernel name.  ``fn``
    always launches device work, including every kernel named in
    ``required`` (its launch counters say so), so a trace without a
    device event, or without one of those kernels, is CUPTI's loss, not
    ``fn``'s: such a trace is taken again after a second's pause,
    ``attempts`` times in all, with a note on stderr, and then it raises."""
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            found = device_intervals_ms(events)
            missing = [n for n in required if not any(n in k for k in found[3])]
            if not missing:
                return found
            note = f"no {missing} among {len(events)} device events ({sorted(found[3])[:8]})"
        else:
            note = "no device event"
        print(f"[profile] {what}: {note} in the trace, attempt {attempt} of {attempts}",
              file=sys.stderr, flush=True)
        time.sleep(1.0)
    raise RuntimeError(f"{what}: {note} in the trace, {attempts} attempts")


def device_intervals_ms(events):
    """Busy time (union of device activity), span and count of the
    device ``events`` of a ``torch.profiler`` trace, and time and count
    per name."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    by_name, n_by_name = {}, {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
        n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
    return busy / 1e3, (spans[-1][1] - spans[0][0]) / 1e3, len(events), by_name, n_by_name


def profile_rollout(name, fn, tc, reps=5):
    """Phase 5: where one rollout's device time goes."""
    eager_ms = cuda_ms(fn, reps)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    graph_ms = cuda_ms(graph.replay, reps)
    del graph
    busy_ms, span_ms, n_events, by_name, _ = profiled(
        fn, TC_KERNELS[:1] if name == "kernel" and tc else (), f"{name} rollout")
    convlstm_ms = sum(t for n, t in by_name.items() if "convlstm" in n)
    if (convlstm_ms > 0) != (name == "kernel"):
        raise RuntimeError(f"{name} path: {convlstm_ms} ms of ConvLSTM kernel in the trace")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({"profile": {
        "path": name,
        "eager_ms": eager_ms,
        "graph_ms": graph_ms,
        "idle_share_eager": 1.0 - graph_ms / eager_ms,
        "profiled_busy_ms": busy_ms,
        "profiled_span_ms": span_ms,
        "device_events": n_events,
        "convlstm_kernel_ms": convlstm_ms,
        "top_ms": [[n[:80], t] for n, t in top],
    }}), flush=True)


def check_sinkhorn(dev):
    """Sinkhorn forward and backward kernels vs their plain versions at
    [3, B, B], L=100, eps 1, B in ``SINK_BATCHES``, and at
    ``SINK_UNSTAGED``: costs and histories against the plain forward, c_bar
    under a random cotangent against autograd through the plain loop, one
    launch a call.  At the batches in ``SINK_TRACED`` each kernel's own
    device time from the trace, per launch and per iteration, beside the
    CUDA events around the wrapper; the plain versions timed at B = 32."""
    errs = {"fwd": 0.0, "bwd": 0.0}
    times, failed = {}, []
    for k, b, steps in [(SINK_K, b, SINK_L) for b in SINK_BATCHES] + [SINK_UNSTAGED]:
        g = torch.Generator().manual_seed(b)
        c = (torch.randn(k, b, b, generator=g).abs() * 3.0 + 0.1).to(dev)
        cot = torch.randn(k, generator=g).to(dev)
        before = (sinkhorn_fwd.launches, sinkhorn_bwd.launches)
        cost_k, uh_k, vh_k = sinkhorn_fwd(c, SINK_EPS, steps)
        cbar_k = sinkhorn_bwd(c, uh_k, vh_k, cot, SINK_EPS)
        launches = (sinkhorn_fwd.launches - before[0], sinkhorn_bwd.launches - before[1])
        cp = c.clone().requires_grad_(True)
        cost_p, uh_p, vh_p = sinkhorn_fwd_reference(cp, SINK_EPS, steps)
        (cbar_p,) = torch.autograd.grad((cost_p * cot).sum(), cp)
        cost_p, uh_p, vh_p = cost_p.detach(), uh_p.detach(), vh_p.detach()
        torch.cuda.synchronize()
        e_cost = float(((cost_k - cost_p).abs() / cost_p.abs()).max())
        e_hist = max(float((uh_k - uh_p).abs().max()), float((vh_k - vh_p).abs().max()))
        e_cbar = float((cbar_k - cbar_p).abs().max())
        cbar_max = float(cbar_p.abs().max())
        cbar_lim = SINK_TOL["cbar_atol"] + SINK_TOL["cbar_rtol"] * cbar_p.abs()
        print(
            f"[sinkhorn] [{k}, {b}, {b}] L={steps}: launches (fwd, bwd) {launches}, cost rel err "
            f"{e_cost:.3e}, history max err {e_hist:.3e}, c_bar max err {e_cbar:.3e} "
            f"(c_bar max {cbar_max:.3e}, err / largest {e_cbar / cbar_max:.3e}; tol {SINK_TOL})", flush=True,
        )
        if launches != (1, 1):
            failed.append(f"B={b}: {launches} launches")
        if not (e_cost <= SINK_TOL["cost_rtol"] and e_hist <= SINK_TOL["hist_atol"]):
            failed.append(f"sinkhorn_fwd at B={b}")
        if not (bool(((cbar_k - cbar_p).abs() <= cbar_lim).all())
                and e_cbar <= SINK_TOL["cbar_of_largest"] * cbar_max):
            failed.append(f"sinkhorn_bwd at B={b}")
        errs["fwd"] = max(errs["fwd"], float((cost_k - cost_p).abs().max()), e_hist)
        errs["bwd"] = max(errs["bwd"], e_cbar)
        del cp, cbar_p, uh_p, vh_p
        if b in SINK_TRACED:
            path = "reg_kernel<16," if b <= 64 else "band_kernel"
            times[b] = session_trace({
                "fwd": (lambda: sinkhorn_fwd(c, SINK_EPS, SINK_L), sinkhorn_fwd, (f"sinkhorn_fwd_{path}",),
                        SINK_L),
                "bwd": (lambda: sinkhorn_bwd(c, uh_k, vh_k, cot, SINK_EPS), sinkhorn_bwd,
                        (f"sinkhorn_bwd_{path}",), SINK_L),
            })
            print(f"[sinkhorn trace] B={b}: " + json.dumps(times[b]), flush=True)
        if b == 32:
            times["plain"] = {
                "fwd_plain_ms": cuda_ms(lambda: sinkhorn_fwd_reference(c, SINK_EPS, SINK_L), reps=3),
                "bwd_plain_ms": cuda_ms(lambda: sinkhorn_bwd_reference(c, uh_k, vh_k, cot, SINK_EPS), reps=3),
            }
        del c, uh_k, vh_k, cbar_k
    print(json.dumps({"sinkhorn_B_L100": {str(k): v for k, v in times.items()}}), flush=True)
    if failed:
        raise RuntimeError(f"Sinkhorn kernels disagree with their plain versions: {failed}")
    return errs, times


def _all_finite(state, metrics):
    trees = (state.enc_params, state.dec_params, state.h_params, state.m_params, state.h_stats, state.m_stats)
    return all(bool(torch.isfinite(v).all()) for tree in trees for v in tree.values()) and all(
        bool(torch.isfinite(metrics[k])) for k in ("sinkhorn_loss", "pm")
    )


def check_training(cfg, dev):
    """Two flagship training iterations on the kernel path, counted, and
    two on the plain path from the same state, video and z."""
    state0, video, zs = training_inputs(cfg, dev)
    step_k = build_train_step(cfg, device=dev)
    step_p = build_train_step(dataclasses.replace(cfg, sinkhorn_solver="scan"), device=dev)

    reset_counts()
    state_k, mets_k = state0, []
    for i in range(2):
        f0, b0 = sinkhorn_fwd.launches, sinkhorn_bwd.launches
        state_k, met = step_k(state_k, video, z=zs[i])
        torch.cuda.synchronize()
        per_iter = (sinkhorn_fwd.launches - f0, sinkhorn_bwd.launches - b0)
        if per_iter != (2, 2):
            raise RuntimeError(f"iteration {i}: Sinkhorn launches (fwd, bwd) = {per_iter}, expected (2, 2)")
        mets_k.append(met)
    launches = {"sinkhorn_fwd": sinkhorn_fwd.launches, "sinkhorn_bwd": sinkhorn_bwd.launches,
                "convlstm_fwd": convlstm_fwd.launches}
    if any(fn.launches for fn in (convlstm_fwd, convlstm_bwd, lstm_fwd, lstm_bwd)):
        raise RuntimeError(f"the 'scan' iteration launched a recurrence kernel: {launches}")
    state_p, mets_p = state0, []
    for i in range(2):
        state_p, met = step_p(state_p, video, z=zs[i])
        mets_p.append(met)
    torch.cuda.synchronize()
    if (sinkhorn_fwd.launches, sinkhorn_bwd.launches) != (launches["sinkhorn_fwd"], launches["sinkhorn_bwd"]):
        raise RuntimeError("the plain path launched a Sinkhorn kernel")
    for name, st, mets in (("kernel", state_k, mets_k), ("plain", state_p, mets_p)):
        if not all(_all_finite(st, met) for met in mets):
            raise RuntimeError(f"training, {name} path: non-finite loss, pM, parameter or statistic")
    cmp = {
        "sinkhorn_loss": [[float(a["sinkhorn_loss"]), float(b["sinkhorn_loss"])] for a, b in zip(mets_k, mets_p)],
        "pm": [[float(a["pm"]), float(b["pm"])] for a, b in zip(mets_k, mets_p)],
        "max_abs_dparam": {}, "max_rel_dmu": {},
    }
    for group in ("enc", "dec", "h", "m"):
        pk, pp = getattr(state_k, f"{group}_params"), getattr(state_p, f"{group}_params")
        cmp["max_abs_dparam"][group] = max(float((pk[k] - pp[k]).abs().max()) for k in pk)
        mk, mp = getattr(state_k, f"{group}_opt").mu, getattr(state_p, f"{group}_opt").mu
        scale = max(float(v.abs().max()) for v in mp.values()) or 1.0
        cmp["max_rel_dmu"][group] = max(float((mk[k] - mp[k]).abs().max()) for k in mk) / scale
    for key in ("h_stats", "m_stats"):
        sk, sp = getattr(state_k, key), getattr(state_p, key)
        cmp["max_abs_dparam"][key] = max(float((sk[k] - sp[k]).abs().max()) for k in sk)
    print(json.dumps({"training_check": {"launches": launches, "tol": TRAIN_TOL, **cmp}}), flush=True)
    for (lk, lp), (pk, pp) in zip(cmp["sinkhorn_loss"], cmp["pm"]):
        if not (abs(lk - lp) <= TRAIN_TOL["loss_rtol"] * abs(lp) and abs(pk - pp) <= TRAIN_TOL["pm_rtol"] * abs(pp)):
            raise RuntimeError(f"training: kernel path vs plain path: loss {lk} / {lp}, pM {pk} / {pp}")
    if max(cmp["max_abs_dparam"].values()) > TRAIN_TOL["param_atol"] or max(
        cmp["max_rel_dmu"].values()
    ) > TRAIN_TOL["mu_rel"]:
        raise RuntimeError(f"training: kernel path vs plain path: {cmp}")
    return state0, video, zs, step_k, step_p, launches


def time_training(card, cfg, state0, video, zs, paths, marker, what, required=()):
    """ms per iteration (CUDA events, the two paths in turns: reference,
    kernel, kernel, reference), frames/s, peak memory, and one iteration
    per path under ``torch.profiler``.  ``paths`` is ``((reference name,
    step), (kernel name, step))``; device time in kernels whose name holds
    ``marker`` must show in the kernel path's trace and only there, and
    every kernel named in ``required`` in the kernel path's."""
    (ref, _), (kern, _) = paths
    fns = dict(paths)
    ms = {ref: [], kern: []}
    for path in (ref, kern, kern, ref):
        ms[path].append(cuda_ms(lambda: fns[path](state0, video, z=zs[0]), reps=2))
    step_ms = {p: sum(v) / len(v) for p, v in ms.items()}
    frames = cfg.batch_size * cfg.total_time_steps
    peak = {}
    profiles = {}
    for path in (ref, kern):
        fn = fns[path]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn(state0, video, z=zs[0])
        torch.cuda.synchronize()
        peak[path] = torch.cuda.max_memory_allocated() / 2**30
        busy_ms, span_ms, n_events, by_name, _ = profiled(
            lambda: fn(state0, video, z=zs[0]), required if path == kern else (), f"{what}, {path} path")
        marked_ms = sum(t for n, t in by_name.items() if marker in n)
        if (marked_ms > 0) != (path == kern):
            raise RuntimeError(f"{what}, {path} path: {marked_ms} ms of '{marker}' kernels in the trace")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        profiles[path] = {
            "eager_ms": step_ms[path],
            "profiled_busy_ms": busy_ms,
            "profiled_span_ms": span_ms,
            "idle_share_eager": 1.0 - busy_ms / step_ms[path],
            "device_events": n_events,
            f"{marker}_kernel_ms": marked_ms,
            "top_ms": [[n[:80], t] for n, t in top],
        }
        print(json.dumps({"profile_training": {"what": what, "path": path, **profiles[path]}}), flush=True)
    print(json.dumps({what: {
        "card": card,
        "preset": PRESET,
        "compute_dtype": cfg.compute_dtype,
        "sinkhorn_l": cfg.sinkhorn_l,
        "step_ms": step_ms,
        "step_ms_runs": ms,
        "training_frames_per_s": {p: frames / (t / 1e3) for p, t in step_ms.items()},
        "peak_memory_gib": peak,
    }}), flush=True)
    return step_ms, profiles


COUNTED = {
    "convlstm_fwd": convlstm_fwd, "convlstm_bwd": convlstm_bwd, "lstm_fwd": lstm_fwd,
    "lstm_bwd": lstm_bwd, "sinkhorn_fwd": sinkhorn_fwd, "sinkhorn_bwd": sinkhorn_bwd,
}


def reset_counts():
    for fn in COUNTED.values():
        fn.launches = 0
        if hasattr(fn, "calls"):
            fn.calls = 0


def counts():
    return {name: [getattr(fn, "calls", fn.launches), fn.launches] for name, fn in COUNTED.items()}


def rel_err(got, want):
    """max |got - want| over the largest |want|, for each pair."""
    return max(
        float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
        for g, w in zip(got, want)
    )


def check_convlstm_bwd(dev):
    """The ConvLSTM backward kernels (and the forward's c stack) vs their
    plain versions at the 8 layer shapes with the training T (20 encoder,
    10 decoder), nonzero h0, c0, dh_n and dc_n, f32 and bf16; bf16 times
    of each layer's backward, kernel and plain."""
    errs, times, failed = {}, {}, []
    for i, (name, (hw, f, k)) in enumerate(LAYERS.items()):
        t = train_t(name)
        for dtype in (torch.float32, torch.bfloat16):
            args = layer_inputs(hw, f, k, dtype, dev, seed=100 + i, t=t)
            g = torch.Generator().manual_seed(200 + i)
            y_p, cs_p, h_p, c_p = convlstm_fwd_reference(*args)
            y_k, cs_k, h_k, c_k = convlstm_fwd(*args, with_c_stack=True)
            cot = (
                torch.randn(y_p.shape, generator=g).to(dev, dtype),
                torch.randn(h_p.shape, generator=g).to(dev),
                torch.randn(c_p.shape, generator=g).to(dev),
            )
            got = convlstm_bwd(*args, y_p, cs_p, *cot)
            want = convlstm_bwd_reference(*args, y_p, cs_p, *cot)
            torch.cuda.synchronize()
            tag = f"{name} T={t} {str(dtype).removeprefix('torch.')}"
            e_fwd = max_err((y_k, cs_k, h_k, c_k), (y_p, cs_p, h_p, c_p))
            e_bwd = {n: rel_err([a], [b]) for n, a, b in zip(("dx", "dh0", "dc0", "drk", "db"), got, want)}
            print(f"[convlstm_bwd] {tag}: forward+c stack max abs err {e_fwd:.3e} (tol {TOL[dtype]:.0e}); "
                  f"gradients, err / largest: {json.dumps(e_bwd)} (tol {GRAD_TOL[dtype]:.0e}); "
                  f"max abs err {max_err(got, want):.3e}", flush=True)
            if not (e_fwd <= TOL[dtype] and max(e_bwd.values()) <= GRAD_TOL[dtype]):
                failed.append(tag)
            errs[tag] = max_err(got, want)
        args = layer_inputs(hw, f, k, torch.bfloat16, dev, seed=100 + i, t=t)
        y, cs, h, c = convlstm_fwd(*args, with_c_stack=True)
        cot = (torch.ones_like(y), torch.zeros_like(h), torch.zeros_like(c))
        times[name] = {
            "kernel_ms": cuda_ms(lambda: convlstm_bwd(*args, y, cs, *cot), reps=3),
            "plain_ms": cuda_ms(lambda: convlstm_bwd_reference(*args, y, cs, *cot), reps=1),
        }
        times[name]["kernel_tflops"] = layer_tflops(name, t, times[name]["kernel_ms"], backward=True)
        by_name = profiled(lambda: convlstm_bwd(*args, y, cs, *cot), TC_KERNELS[1:],
                           f"{name} bf16 backward")[3]
        for part, keys in BWD_PARTS.items():
            times[name][f"{part}_ms"] = sum(v for n, v in by_name.items() if any(x in n for x in keys))
    print(json.dumps({"convlstm_bwd_ms_bf16_B32": times}), flush=True)
    if failed:
        raise RuntimeError(f"convlstm_bwd disagrees with its plain version: {failed}")
    return errs, times


def lstm_inputs(in_features, u, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    xproj = randn(LSTM_B, LSTM_T, 4 * u).to(dtype)
    h0, c0 = randn(LSTM_B, u, scale=0.5), randn(LSTM_B, u, scale=0.5)
    rk = randn(u, 4 * u, scale=u ** -0.5)
    bias = randn(4 * u, scale=0.1)
    return xproj, h0, c0, rk, bias


def time_cudnn(in_features, u, dtype, dev):
    """cuDNN's LSTM (``torch.nn.LSTM``, batch-first) at one layer's shape:
    forward, the backward call alone, and forward + backward."""
    x = torch.randn(LSTM_B, LSTM_T, in_features, device=dev, dtype=dtype, requires_grad=True)
    cudnn = torch.nn.LSTM(in_features, u, batch_first=True).to(dev, dtype)
    cudnn.flatten_parameters()
    out, _ = cudnn(x)
    gout = torch.ones_like(out)
    params = [x, *cudnn.parameters()]
    with torch.no_grad():
        fwd = cuda_ms(lambda: cudnn(x), reps=10)
    return {
        "cudnn_fwd_ms": fwd,
        "cudnn_bwd_ms": cuda_ms(lambda: torch.autograd.grad(out, params, gout, retain_graph=True), reps=10),
        "cudnn_fwd_bwd_ms": cuda_ms(lambda: cudnn(x)[0].backward(gout), reps=10),
    }


def time_port_layer(in_features, u, dtype, dev):
    """The port's whole ``LSTM`` layer (hoisted product + kernels) at the
    same shape: forward, and forward + backward."""
    port = LSTM(in_features, u, compute_dtype=str(dtype).removeprefix("torch."))
    port.reset_parameters(torch.Generator().manual_seed(0))
    port = port.to(dev)
    x = torch.randn(LSTM_B, LSTM_T, in_features, device=dev, requires_grad=True)

    def fwd_bwd():
        y = port(x)
        y.backward(torch.ones_like(y))

    with torch.no_grad():
        fwd = cuda_ms(lambda: port(x), reps=10)
    return {"port_layer_fwd_ms": fwd, "port_layer_fwd_bwd_ms": cuda_ms(fwd_bwd, reps=10)}


def session_trace(calls, rounds=10):
    """Wrapper calls as the card sees them, from one ``torch.profiler``
    session (few sessions a process: CUPTI drops more events in each later
    one).  ``calls`` maps a label to ``(fn, counter, keys, steps)``, each
    key naming one kernel that a call launches once (the labels' kernels
    distinct); ``rounds`` times every fn runs once, in turn.  Per label:
    each kernel's device µs per recorded event of its own (so a dropped
    event of one kernel does not weigh another's), their sum, the device
    time a call, and that per launch and per step; the launches a call (the
    wrapper's counter) and the share of each kernel's launches the trace
    recorded; the CUDA-events time of one call beside it (host enqueue
    included when the host is slower than the device); and the device ops
    a round that are no label's kernel."""
    out = {label: {"events_ms_per_call": cuda_ms(fn, reps=20)} for label, (fn, *_) in calls.items()}
    before = {label: c.launches for label, (_, c, _, _) in calls.items()}
    made = [0]  # rounds run, a retaken trace's included

    def run():
        for _ in range(rounds):
            for fn, *_ in calls.values():
                fn()
        made[0] += rounds

    required = tuple(k for _, _, keys, _ in calls.values() for k in keys)
    _, _, n_events, by_name, n_by_name = profiled(run, required, f"{'/'.join(calls)} calls")
    matched = 0
    for label, (_, counter, keys, steps) in calls.items():
        by_kernel, share, names = {}, {}, []
        for key in keys:
            kn = [n for n in by_name if key in n]
            n_kernel = sum(n_by_name[n] for n in kn)
            matched += n_kernel
            by_kernel[key] = 1e3 * sum(by_name[n] for n in kn) / n_kernel
            share[key] = n_kernel / rounds
            names += kn
        launches = (counter.launches - before[label]) / made[0]
        call_us = sum(by_kernel.values())
        out[label].update({
            "kernel_us_by_kernel": by_kernel,
            "kernel_us_per_launch": call_us / launches,
            "kernel_us_per_step": call_us / steps,
            "kernel_launches_per_call": launches,
            "recorded_share": share,
            "device_ms_per_call": call_us / 1e3,
            "kernel_names": sorted({n[:60] for n in names}),
        })
    for v in out.values():
        v["other_device_ops_per_call"] = (n_events - matched) / rounds
    return out


def check_lstm(dev):
    """The LSTM forward and backward kernels vs their plain versions at
    lstm1-3 (lstm3 with its sigmoid output), B=32, T=20, nonzero h0, c0
    and cotangents, f32 and bf16; each wrapper call traced in bf16 and f32
    (one kernel launch and no other device op a call, the tensor-core
    kernels in bf16 and only there); bf16 plain times, and cuDNN's LSTM
    at lstm1 and lstm2 (lstm3's sigmoid output has no cuDNN counterpart)."""
    layers = lstm_layers(get_preset(PRESET))
    errs = {"fwd": 0.0, "bwd": 0.0}
    times, failed = {}, []
    for i, (name, (feat, u)) in enumerate(layers.items()):
        act = "sigmoid" if name == "lstm3" else "tanh"
        for dtype in (torch.float32, torch.bfloat16):
            args = lstm_inputs(feat, u, dtype, dev, seed=300 + i)
            g = torch.Generator().manual_seed(400 + i)
            y_p, cs_p, h_p, c_p = lstm_scan_reference(*args, act)
            fwd_k = lstm_fwd(*args, act, with_c_stack=True)
            cot = (
                torch.randn(y_p.shape, generator=g).to(dev, dtype),
                torch.randn(h_p.shape, generator=g).to(dev),
                torch.randn(c_p.shape, generator=g).to(dev),
            )
            got = lstm_bwd(*args, y_p, cs_p, *cot, act)
            want = lstm_bwd_reference(*args, y_p, cs_p, *cot, act)
            torch.cuda.synchronize()
            tag = f"{name} U={u} {act} {str(dtype).removeprefix('torch.')}"
            e_fwd = max_err(fwd_k, (y_p, cs_p, h_p, c_p))
            e_bwd = {n: rel_err([a], [b]) for n, a, b in zip(("dx", "dh0", "dc0", "dR", "db"), got, want)}
            print(f"[lstm] {tag}: forward max abs err {e_fwd:.3e} (tol {TOL[dtype]:.0e}); "
                  f"gradients, err / largest: {json.dumps(e_bwd)} (tol {GRAD_TOL[dtype]:.0e}); "
                  f"max abs err {max_err(got, want):.3e}", flush=True)
            if not (e_fwd <= TOL[dtype] and max(e_bwd.values()) <= GRAD_TOL[dtype]):
                failed.append(tag)
            errs["fwd"] = max(errs["fwd"], e_fwd)
            errs["bwd"] = max(errs["bwd"], max_err(got, want))
        args = lstm_inputs(feat, u, torch.bfloat16, dev, seed=300 + i)
        y, cs, h, c = lstm_fwd(*args, act, with_c_stack=True)
        cot = (torch.ones_like(y), torch.zeros_like(h), torch.zeros_like(c))
        times[name] = {
            "fwd_plain_ms": cuda_ms(lambda: lstm_scan_reference(*args, act), reps=3),
            "bwd_plain_ms": cuda_ms(lambda: lstm_bwd_reference(*args, y, cs, *cot, act), reps=3),
            "fwd_bound_ms": bound_ms(*lstm_work({name: (feat, u)}, LSTM_B, LSTM_T), PEAK_BF16)[0],
            "bwd_bound_ms": bound_ms(*lstm_work({name: (feat, u)}, LSTM_B, LSTM_T, backward=True),
                                     PEAK_BF16)[0],
        }
        for dtype in (torch.bfloat16, torch.float32):
            tag = str(dtype).removeprefix("torch.")
            args = lstm_inputs(feat, u, dtype, dev, seed=300 + i)
            y, cs, h, c = lstm_fwd(*args, act, with_c_stack=True)
            cot = (torch.ones_like(y), torch.zeros_like(h), torch.zeros_like(c))
            times[name][f"trace_{tag}"] = trace = session_trace({
                "fwd": (lambda: lstm_fwd(*args, act, with_c_stack=True), lstm_fwd, ("lstm_fwd",), LSTM_T),
                "bwd": (lambda: lstm_bwd(*args, y, cs, *cot, act), lstm_bwd, ("lstm_bwd",), LSTM_T),
            })
            print(f"[lstm trace] {name} U={u} {tag}: " + json.dumps(trace), flush=True)
            for part, tr in trace.items():
                tc = [n for n in tr["kernel_names"] if "_tc_kernel" in n]
                if (tr["kernel_launches_per_call"], tr["other_device_ops_per_call"]) != (1, 0) or (
                    len(tc) != len(tr["kernel_names"]) if dtype == torch.bfloat16 else tc
                ):
                    failed.append(f"{name} {tag} {part}: a call launched {tr['kernel_names']} "
                                  f"and {tr['other_device_ops_per_call']} other device ops")
        if act == "tanh":
            for dtype in (torch.float32, torch.bfloat16):
                tag = str(dtype).removeprefix("torch.")
                times[name][f"port_layer_{tag}"] = time_port_layer(feat, u, dtype, dev)
                try:  # the yardstick only: cuDNN may not take bf16 RNNs
                    times[name][f"cudnn_{tag}"] = time_cudnn(feat, u, dtype, dev)
                except RuntimeError as err:
                    times[name][f"cudnn_{tag}"] = {"error": str(err)[:300]}
    print(json.dumps({"lstm_ms_B32_T20": times}), flush=True)
    if failed:
        raise RuntimeError(f"LSTM kernels disagree with their plain versions: {failed}")
    return errs, times


def check_lstm_wide(dev):
    """The LSTM kernels past U = 64 (U in ``LSTM_WIDE``: bf16 up to 128 on
    the tensor cores, else R read through L2 at every step; the
    backward's dR and db in a second launch) vs their plain versions,
    B=32, T=20, f32 and bf16, under the same tolerances; each wrapper
    call traced (forward one launch, backward two, no other device op)."""
    times, failed = {}, []
    for u in LSTM_WIDE:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"U={u} {str(dtype).removeprefix('torch.')}"
            args = lstm_inputs(0, u, dtype, dev, seed=500 + u)
            g = torch.Generator().manual_seed(600 + u)
            y_p, cs_p, h_p, c_p = lstm_scan_reference(*args)
            before = (lstm_fwd.launches, lstm_bwd.launches)
            fwd_k = lstm_fwd(*args, with_c_stack=True)
            cot = (
                torch.randn(y_p.shape, generator=g).to(dev, dtype),
                torch.randn(h_p.shape, generator=g).to(dev),
                torch.randn(c_p.shape, generator=g).to(dev),
            )
            got = lstm_bwd(*args, y_p, cs_p, *cot)
            launches = (lstm_fwd.launches - before[0], lstm_bwd.launches - before[1])
            want = lstm_bwd_reference(*args, y_p, cs_p, *cot)
            torch.cuda.synchronize()
            e_fwd = max_err(fwd_k, (y_p, cs_p, h_p, c_p))
            e_bwd = {n: rel_err([a], [b]) for n, a, b in zip(("dx", "dh0", "dc0", "dR", "db"), got, want)}
            path = "tc" if dtype == torch.bfloat16 and u <= 128 else "l2"
            trace = session_trace({
                "fwd": (lambda: lstm_fwd(*args, with_c_stack=True), lstm_fwd, (f"lstm_fwd_{path}_kernel",),
                        LSTM_T),
                "bwd": (lambda: lstm_bwd(*args, y_p, cs_p, *cot), lstm_bwd,
                        (f"lstm_bwd_{path}_kernel", "lstm_wgrad_l2_kernel"), LSTM_T),
            })
            times[tag] = {"fwd_max_abs_err": e_fwd, "grad_err_over_largest": e_bwd, "launches": launches, **trace}
            print(f"[lstm wide] {tag}: " + json.dumps(times[tag]), flush=True)
            calls_ok = [(trace[p]["kernel_launches_per_call"], trace[p]["other_device_ops_per_call"])
                        for p in ("fwd", "bwd")] == [(1, 0), (2, 0)]
            if not (e_fwd <= TOL[dtype] and max(e_bwd.values()) <= GRAD_TOL[dtype] and launches == (1, 2)
                    and calls_ok):
                failed.append(tag)
    print(json.dumps({"lstm_wide_B32_T20": {k: {p: v[p] for p in ("fwd", "bwd")} for k, v in times.items()}}),
          flush=True)
    if failed:
        raise RuntimeError(f"LSTM kernels past U = 64 disagree with their plain versions: {failed}")


def sinkhorn_registers():
    """Registers, stack and spill bytes of each Sinkhorn kernel, from
    ``nvcc -Xptxas -v`` on its source (the build's flags, one nvcc a
    source, in parallel)."""
    csrc = Path(__file__).resolve().parent / "kccotgan_tpu_torch" / "csrc"
    procs = {
        src: subprocess.Popen([_nvcc(), *_FLAGS, "-Xptxas", "-v", "-c", "-o", str(BUILD_DIR / f"ptxas_{src}.o"),
                               str(csrc / src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src in ("sinkhorn_fwd.cu", "sinkhorn_bwd.cu")
    }
    out, name = {}, None
    for src, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        if proc.returncode:
            raise RuntimeError(f"nvcc -Xptxas -v {src} failed:\n{err[-2000:]}")
        for line in err.splitlines():
            if "Compiling entry function" in line:  # ..._reg_kernelILi16ELi32EE... -> reg_kernel<16, 32>
                m = re.search(r"(sinkhorn_(?:fwd|bwd)_(?:reg|band)_kernel)(?:ILi(\d+)ELi(\d+)E)?", line)
                name = m[1] + (f"<{m[2]}, {m[3]}>" if m[2] else "")
                out[name] = {}
            elif name and "spill stores" in line:
                out[name]["stack_spill_bytes"] = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            elif name and "Used" in line and "registers" in line:
                out[name]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
    print(json.dumps({"sinkhorn_ptxas": out}), flush=True)
    return out


def check_sass(lib):
    """HMMA instructions of each LSTM kernel in the built library
    (``cuobjdump -sass``): the bf16 kernels must run on the tensor cores,
    the f32 ones on the CUDA cores."""
    sass = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "-sass", lib._name],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    hmma = {}
    for section in sass.split("Function : ")[1:]:
        # mangled: ...lstm_fwd_tc_kernelILi4EE... -> lstm_fwd_tc_kernel<4>
        m = re.search(r"(lstm_(?:fwd|bwd)(?:_tc)?_kernel)ILi(\d+)E", section.split(None, 1)[0])
        if m:
            hmma[f"{m[1]}<{m[2]}>"] = section.count("HMMA")
    print(json.dumps({"lstm_sass_hmma": hmma}), flush=True)
    wrong = [n for n, c in hmma.items() if (c > 0) != ("_tc_kernel" in n)]
    if len(hmma) != 16 or wrong:  # 4 + 4 tensor-core, 4 + 4 CUDA-core instantiations
        raise RuntimeError(f"LSTM kernels' HMMA counts: {hmma}")


def check_engines(base, dev):
    """Two flagship iterations under 'pallas' against two under 'scan'
    from the same state, video and z, in f32 and in the preset's bf16;
    every kernel's calls and launches counted per 'pallas' iteration."""
    results = {}
    for cdt in ("float32", base.compute_dtype):
        cfg = dataclasses.replace(base, compute_dtype=cdt)
        state0, video, zs = training_inputs(cfg, dev)
        steps = {impl: build_train_step(dataclasses.replace(cfg, kernel_impl=impl), device=dev)
                 for impl in ("pallas", "scan")}
        runs, per_iter, totals = {}, [], None
        for impl, step in steps.items():
            reset_counts()
            st, mets, before = state0, [], counts()
            for i in range(2):
                st, met = step(st, video, z=zs[i])
                torch.cuda.synchronize()
                now = counts()
                mets.append((met, st))
                if impl == "pallas":
                    per_iter.append({n: [a - b for a, b in zip(now[n], before[n])] for n in now})
                before = now
            if impl == "pallas":
                totals = counts()
            elif any(counts()[n][1] for n in RECURRENCE_KERNELS):
                raise RuntimeError(f"the 'scan' iteration launched a recurrence kernel: {counts()}")
            if not all(_all_finite(s, m) for m, s in mets):
                raise RuntimeError(f"{cdt} {impl}: non-finite loss, pM, parameter or statistic")
            runs[impl] = mets
        for i, it in enumerate(per_iter):
            want = {n: list(c) for n, c in PALLAS_COUNTS.items()}
            if it != want:
                raise RuntimeError(f"{cdt} 'pallas' iteration {i}: (calls, launches) {it}, expected {want}")
        (mp_, sp), (ms_, ss) = runs["pallas"][0], runs["scan"][0]
        cmp = {
            "sinkhorn_loss": [float(mp_["sinkhorn_loss"]), float(ms_["sinkhorn_loss"])],
            "pm": [float(mp_["pm"]), float(ms_["pm"])],
            "max_rel_dmu": {},
            "second_iteration_loss": [float(runs[i][1][0]["sinkhorn_loss"]) for i in ("pallas", "scan")],
        }
        cmp["worst_dmu"] = {}
        for group in ("enc", "dec", "h", "m"):
            mk, mq = getattr(sp, f"{group}_opt").mu, getattr(ss, f"{group}_opt").mu
            scale = max(float(v.abs().max()) for v in mq.values())
            per = {k: float((mk[k] - mq[k]).abs().max()) / scale for k in mq}
            cmp["max_rel_dmu"][group] = max(per.values())
            cmp["worst_dmu"][group] = sorted(per.items(), key=lambda kv: -kv[1])[:3]
        tol = ENGINE_TOL[cdt]
        print(json.dumps({"engines_check": {"compute_dtype": cdt, "per_iteration": per_iter[0],
                                            "tol": tol, **cmp}}), flush=True)
        (lp, ls), (pp, ps) = cmp["sinkhorn_loss"], cmp["pm"]
        if not (abs(lp - ls) <= tol["loss_rtol"] * abs(ls) and abs(pp - ps) <= tol["pm_rtol"] * abs(ps)
                and all(cmp["max_rel_dmu"][g] <= tol["mu_rel"][g] for g in tol["mu_rel"])):
            raise RuntimeError(f"{cdt}: 'pallas' and 'scan' iterations disagree: {cmp}")
        results[cdt] = (state0, video, zs, steps, per_iter, totals)
    return results[base.compute_dtype]


def training_inputs(cfg, dev):
    """The seeded state, video and the two iterations' (z1, z2)."""
    state0 = create_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    m = cfg.model
    video = torch.from_numpy(
        np.random.default_rng(1).uniform(
            size=(cfg.batch_size, m.x_height, cfg.total_time_steps, m.x_width, m.n_channels)
        ).astype(np.float32)
    ).to(dev)
    zg = torch.Generator(device=dev).manual_seed(2)
    z_shape = (cfg.batch_size, cfg.pred_time_steps, m.z_height, m.z_width, m.z_channels)
    zs = [tuple(torch.randn(z_shape, generator=zg, device=dev) for _ in range(2)) for _ in range(2)]
    return state0, video, zs


def read_metrics(run_dir):
    """``{tag: {step: value}}`` from a run's ``metrics.jsonl``."""
    out = {}
    with open(Path(run_dir) / "log" / "metrics.jsonl") as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r["tag"], {})[r["step"]] = r["value"]
    return out


def write_fixture(root):
    """The MMNIST layout under ``root``: train and test files of
    FIXTURE_VIDEOS videos, 20 frames, where ``mmnist_paths`` looks."""
    train_path, test_path = mmnist_paths(str(root))
    Path(train_path).parent.mkdir(parents=True)
    write_mmnist_fixture(train_path, num_videos=FIXTURE_VIDEOS, time_steps=20, seed=0)
    write_mmnist_fixture(test_path, num_videos=FIXTURE_VIDEOS, time_steps=20, seed=1)
    return train_path


def check_trainer_cli(tmp, data):
    """Phase 9a: the trainer's command line, counted: TRAINER_STEPS
    'pallas' steps at mmnist_full on the fixture, checkpoints and samples
    every TRAINER_EVERY steps."""
    argv = ["--preset", PRESET, "--dname", "mmnist", "--data_path", str(data), "--kernel_impl", "pallas",
            "--max_steps", str(TRAINER_STEPS), "--ckpt_freq", str(TRAINER_EVERY),
            "--save_freq", str(TRAINER_EVERY), "--out_dir", str(tmp), "--run_name", "cli"]
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = train_main(argv, device="cuda")
    torch.cuda.synchronize()
    launched = counts()
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    run_dir = Path(tmp) / "cli"
    mets = read_metrics(run_dir)
    samples = [1] + list(range(TRAINER_EVERY, TRAINER_STEPS + 1, TRAINER_EVERY))
    losses = mets.get("Sinkhorn Loss", {})
    ckpts = sorted(int(p.stem.split("_")[1]) for p in (run_dir / "ckpt").glob("step_*.pt"))
    want = {n: TRAINER_STEPS * c[1] + (len(samples) * ROLLOUT_LAUNCHES if n == "convlstm_fwd" else 0)
            for n, c in PALLAS_COUNTS.items()}
    got = {n: c[1] for n, c in launched.items()}
    print(json.dumps({"trainer_cli": {"argv": argv, "rc": rc, "summary": summary, "losses": losses,
                                      "eval_psnr": mets.get("eval/psnr"), "eval_ssim": mets.get("eval/ssim"),
                                      "checkpoints": ckpts, "launches": got, "expected_launches": want}}),
          flush=True)
    if rc != 0 or summary["status"] != "completed" or summary["steps"] != TRAINER_STEPS:
        raise RuntimeError(f"trainer CLI: rc {rc}, summary {summary}")
    if sorted(losses) != list(range(1, TRAINER_STEPS + 1)) or not all(np.isfinite(list(losses.values()))):
        raise RuntimeError(f"trainer CLI: Sinkhorn losses {losses}")
    for tag in ("eval/psnr", "eval/ssim"):
        if sorted(mets.get(tag, {})) != samples or not all(np.isfinite(list(mets[tag].values()))):
            raise RuntimeError(f"trainer CLI: {tag} {mets.get(tag)}, expected finite values at steps {samples}")
    if ckpts != [s for s in samples if s % TRAINER_EVERY == 0] or latest_step(str(run_dir / "ckpt")) != TRAINER_STEPS:
        raise RuntimeError(f"trainer CLI: checkpoints at {ckpts}")
    if got != want:
        raise RuntimeError(f"trainer CLI: kernel launches {got}, expected {want}")
    return summary, launched


def check_resume(tmp, train_path, base):
    """Phase 9b: 4 steps, checkpoint, restore into a new Trainer, 4 more,
    against 8 straight on the same batches, cuDNN deterministic: the
    losses and every tensor of the state equal to the bit."""
    data = load_mmnist(train_path, base.total_time_steps)
    batches = list(ArrayDataset(data, base.batch_size, seed=0).repeat(TRAINER_STEPS // 2))
    half = TRAINER_STEPS // 2
    cfg = dataclasses.replace(base, kernel_impl="pallas", out_dir=str(tmp), ckpt_freq=half, save_freq=half)
    torch.backends.cudnn.deterministic = True
    try:
        straight = Trainer(dataclasses.replace(cfg, run_name="straight"))
        s_state, _ = straight.fit(iter(batches), max_steps=TRAINER_STEPS)
        first = Trainer(dataclasses.replace(cfg, run_name="first"))
        first.fit(iter(batches[:half]), max_steps=half, test_batch=data[: base.batch_size])
        resumed = Trainer(dataclasses.replace(
            cfg, run_name="resumed", checkpoint=True, ckpt_path=str(Path(first.run_dir) / "ckpt")))
        r_state, _ = resumed.fit(iter(batches[half:]), max_steps=TRAINER_STEPS)
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    s_loss = read_metrics(straight.run_dir)["Sinkhorn Loss"]
    r_loss = read_metrics(resumed.run_dir)["Sinkhorn Loss"]
    diff = {}
    for name in ("enc_params", "dec_params", "h_params", "m_params", "h_stats", "m_stats"):
        a, b = getattr(s_state, name), getattr(r_state, name)
        diff[name] = max(float((a[k] - b[k]).abs().max()) for k in a)
    for g in ("enc", "dec", "h", "m"):
        a, b = getattr(s_state, f"{g}_opt"), getattr(r_state, f"{g}_opt")
        diff[f"{g}_opt"] = max(float((x[k] - y[k]).abs().max()) for x, y in ((a.mu, b.mu), (a.nu, b.nu)) for k in x)
    same_losses = [s_loss[i] for i in range(half + 1, TRAINER_STEPS + 1)] == [
        r_loss.get(i) for i in range(half + 1, TRAINER_STEPS + 1)]
    resume = {"max_abs_diff": diff, "losses_straight": s_loss, "losses_resumed": r_loss,
              "same_step_rng": [s_state.step, r_state.step, s_state.rng == r_state.rng]}
    print(json.dumps({"trainer_resume": resume}), flush=True)
    if not (same_losses and max(diff.values()) == 0.0 and s_state.step == r_state.step == TRAINER_STEPS
            and s_state.rng == r_state.rng):
        raise RuntimeError(f"resumed run differs from the straight run: {resume}")
    return first.timings, batches


def time_loop(tmp, batches, base):
    """Phase 9c: the loop (Trainer.fit, no checkpoint or sample in the
    window, its summary's rates) against the bare step on the same
    batches staged on the card beforehand (host clock around the steps
    and a final synchronize), in turns: loop, bare, bare, loop.  Per
    loop window, the mean and the largest wait for a batch."""
    cfg = dataclasses.replace(base, kernel_impl="pallas", ckpt_freq=10**9, save_freq=10**9,
                              out_dir=str(tmp), run_name="loop")
    batches = (batches * LOOP_STEPS)[:LOOP_STEPS]
    trainer = Trainer(cfg)
    state0 = create_train_state(cfg)
    on_card = [torch.from_numpy(b).cuda() for b in batches]
    runs = {"loop": [], "bare": []}
    waits = {"mean_ms": [], "max_ms": []}
    for kind in ("loop", "bare", "bare", "loop"):
        torch.cuda.synchronize()
        if kind == "loop":
            _, summary = trainer.fit(iter(batches), state=state0)
            if summary["steps"] != LOOP_STEPS:
                raise RuntimeError(f"loop window: {summary}")
            runs["loop"].append(summary["frames_per_sec"])
            wait = trainer.timings["prefetch_wait"]
            waits["mean_ms"].append(wait["sum_ms"] / LOOP_STEPS)
            waits["max_ms"].append(wait["max_ms"])
        else:
            t0 = time.perf_counter()
            state = state0
            for batch in on_card:
                state, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            runs["bare"].append(LOOP_STEPS * cfg.batch_size * cfg.total_time_steps / (time.perf_counter() - t0))
    return {k: sum(v) / len(v) for k, v in runs.items()}, runs, waits


def check_trainer(card, base, bare_pallas_ms):
    """Phase 9: the trainer's path, through the CLI and through Trainer."""
    with tempfile.TemporaryDirectory() as tmp:
        train_path = write_fixture(Path(tmp) / "data")
        summary, launched = check_trainer_cli(Path(tmp) / "runs", Path(tmp) / "data")
        timings, batches = check_resume(Path(tmp) / "resume", train_path, base)
        fps, fps_runs, waits = time_loop(Path(tmp) / "loop", batches, base)
    ckpt = timings["checkpoints"][0]
    frames = base.batch_size * base.total_time_steps
    print(json.dumps({"trainer": {
        "card": card,
        "preset": PRESET,
        "kernel_impl": "pallas",
        "cli_summary": summary,
        "loop_frames_per_s": fps["loop"],
        "bare_step_frames_per_s": fps["bare"],
        "loop_over_bare": fps["loop"] / fps["bare"],
        "frames_per_s_runs": fps_runs,
        "frames_per_s_of_bare_pallas_iteration": frames / bare_pallas_ms * 1e3,
        "bare_pallas_iteration_ms": bare_pallas_ms,
        "loop_steps_per_s": fps["loop"] / frames,
        "checkpoint": {"host_copy_ms": ckpt["copy_ms"], "write_ms": ckpt["write_ms"], "mb": ckpt["bytes"] / 1e6},
        "sample_ms": timings["sample_ms"],
        "prefetch_wait_ms_per_step": waits["mean_ms"],
        "prefetch_wait_max_ms": waits["max_ms"],
    }}), flush=True)
    return launched


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    kind = torch.cuda.get_device_name(0)
    if "H100" not in kind:
        raise SystemExit(f"chip_smoke: expected an H100, found {kind!r}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, {card}", flush=True)

    t0 = time.perf_counter()
    lib = load_library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    check_sass(lib)
    sinkhorn_registers()

    errs, layer_times = check_layers(dev)
    sink_errs, sink_times = check_sinkhorn(dev)

    base = get_preset(PRESET)
    m = base.model
    params = init_generator_params(base, torch.Generator().manual_seed(0))
    params = {part: {k: v.to(dev) for k, v in p.items()} for part, p in params.items()}
    context = torch.from_numpy(
        np.random.default_rng(0).uniform(
            size=(base.batch_size, m.x_height, base.int_time_steps, m.x_width, m.n_channels)
        ).astype(np.float32)
    ).to(dev)
    z = torch.randn(
        base.pred_time_steps, base.batch_size, 1, m.z_height, m.z_width, m.z_channels,
        generator=torch.Generator(device=dev).manual_seed(0), device=dev,
    )
    check_rollout(dataclasses.replace(base, compute_dtype="float32"), params, context, z, "float32")
    launches, rollout_diff, rollout_k, rollout_p = check_rollout(
        base, params, context, z, base.compute_dtype
    )

    # Phase 4: timings, plain and kernel in turns.
    ms = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        fn = rollout_k if path == "kernel" else rollout_p
        ms[path].append(cuda_ms(lambda: fn(params, context, z=z), reps=3))
    frames = base.batch_size * base.pred_time_steps
    rollout_ms = {p: sum(v) / len(v) for p, v in ms.items()}
    timings = {
        "card": card,
        "preset": PRESET,
        "compute_dtype": base.compute_dtype,
        "rollout_ms": rollout_ms,
        "rollout_ms_runs": ms,
        "generated_frames_per_s": {p: frames / (t / 1e3) for p, t in rollout_ms.items()},
        "layer_scan_ms_bf16_B32_T10": layer_times,
        "max_abs_err_kernel_vs_plain": errs,
        "rollout_max_abs_diff_kernel_vs_plain": rollout_diff,
    }
    print(json.dumps({"timings": timings}))
    # Phase 5: per path, where the rollout's device time goes.
    for path, fn in (("plain", rollout_p), ("kernel", rollout_k)):
        profile_rollout(path, lambda: fn(params, context, z=z), tc=base.compute_dtype == "bfloat16")

    # Phase 6: the 'scan' training path, through the Sinkhorn kernels and plain.
    state0, video, zs, step_k, step_p, train_launches = check_training(base, dev)
    time_training(card, base, state0, video, zs, (("plain", step_p), ("kernel", step_k)),
                  "sinkhorn", "training_timings")

    # Phase 7: the recurrence kernels' backward and the LSTM kernels alone.
    bwd_errs, bwd_times = check_convlstm_bwd(dev)
    lstm_errs, lstm_times = check_lstm(dev)
    check_lstm_wide(dev)

    # Phase 8: the 'pallas' training path (every recurrence through its
    # kernels) against 'scan', counted per iteration, then timed.
    state0, video, zs, steps, per_iter, pallas_counts = check_engines(base, dev)
    engine_ms, _ = time_training(
        card, base, state0, video, zs, (("scan", steps["scan"]), ("pallas", steps["pallas"])),
        "lstm", "engine_timings",
        required=TC_KERNELS + LSTM_TC_KERNELS if base.compute_dtype == "bfloat16" else ())

    # Phase 9: the trainer's path (CLI, resume, loop against the bare step),
    # every kernel counted over the CLI's run.
    trainer_counts = check_trainer(card, base, engine_ms["pallas"])

    # Bounds of the work timed: the 8 T=10 layer scans of phase 2, one
    # Sinkhorn launch at the training step's [3, B, B], L, the 8 layer
    # backwards at the training T, and lstm1 + lstm2 at B=32, T=20.
    c_bound, c_by = bound_ms(*convlstm_work(LAYERS, B, lambda _: T), PEAK_BF16)
    f_bound, f_by = bound_ms(*sinkhorn_work(SINK_K, base.batch_size, base.sinkhorn_l), PEAK_F32)
    b_bound, b_by = bound_ms(
        *sinkhorn_work(SINK_K, base.batch_size, base.sinkhorn_l, backward=True), PEAK_F32
    )
    cb_bound, cb_by = bound_ms(*convlstm_work(LAYERS, B, train_t, backward=True), PEAK_BF16)
    tanh_layers = {n: v for n, v in lstm_layers(base).items() if n != "lstm3"}
    lf_bound, lf_by = bound_ms(*lstm_work(tanh_layers, LSTM_B, LSTM_T), PEAK_BF16)
    lb_bound, lb_by = bound_ms(*lstm_work(tanh_layers, LSTM_B, LSTM_T, backward=True), PEAK_BF16)

    def tanh_sum(key):
        return sum(lstm_times[n][key] for n in tanh_layers)

    def trace_sum(part):  # device time of a wrapper call, from the trace (bf16)
        return sum(lstm_times[n]["trace_bfloat16"][part]["device_ms_per_call"] for n in tanh_layers)

    def cudnn_sum(key):
        runs = [lstm_times[n]["cudnn_bfloat16"] for n in tanh_layers]
        return sum(r[key] for r in runs) if all(key in r for r in runs) else None

    n_samples = len([1] + list(range(TRAINER_EVERY, TRAINER_STEPS + 1, TRAINER_EVERY)))
    launches_over = f"trainer_cli: {TRAINER_STEPS} 'pallas' iterations + {n_samples} sampling rollouts"

    def entry(name, ms, plain_ms, bound, by, library_ms, max_abs_err):
        return dict(KERNELS[name], launches=trainer_counts[name][1], launches_over=launches_over,
                    max_abs_err=max_abs_err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=library_ms)

    kernels = [
        entry("convlstm_fwd", sum(t["kernel_ms"] for t in layer_times.values()),
              sum(t["plain_ms"] for t in layer_times.values()), c_bound, c_by, None, max(errs.values())),
        entry("convlstm_bwd", sum(t["kernel_ms"] for t in bwd_times.values()),
              sum(t["plain_ms"] for t in bwd_times.values()), cb_bound, cb_by, None, max(bwd_errs.values())),
        entry("lstm_fwd", trace_sum("fwd"), tanh_sum("fwd_plain_ms"), lf_bound, lf_by,
              cudnn_sum("cudnn_fwd_ms"), lstm_errs["fwd"]),
        entry("lstm_bwd", trace_sum("bwd"), tanh_sum("bwd_plain_ms"), lb_bound, lb_by,
              cudnn_sum("cudnn_bwd_ms"), lstm_errs["bwd"]),
        entry("sinkhorn_fwd", sink_times[32]["fwd"]["kernel_us_per_launch"] / 1e3,
              sink_times["plain"]["fwd_plain_ms"], f_bound, f_by, None, sink_errs["fwd"]),
        entry("sinkhorn_bwd", sink_times[32]["bwd"]["kernel_us_per_launch"] / 1e3,
              sink_times["plain"]["bwd_plain_ms"], b_bound, b_by, None, sink_errs["bwd"]),
    ]
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise RuntimeError(f"the trainer's run launched no {missing}")
    print(json.dumps({"pallas_iteration_counts": {"two_iterations": pallas_counts, "first": per_iter[0]},
                      "rollout_convlstm_fwd_launches": launches,
                      "scan_iteration_sinkhorn_launches": train_launches}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
