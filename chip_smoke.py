#!/usr/bin/env python3
"""Card checks of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from ``kccotgan_tpu_torch/csrc`` and checks the
ported paths at the ``mmnist_full`` preset (B=32, 64x64x1, 10 context +
10 predicted frames, bf16 convs, seeded random weights) and beyond.  It
measures no time: the benchmark (``python3 -m port_bench.run``, with
``--trace 1`` for each kernel's device time) does that.

* kernels vs their plain PyTorch versions: the ConvLSTM forward at the 8
  ConvLSTM layer shapes (f32 and bf16), the Sinkhorn forward and
  backward at [3, B, B] with L=100 for B = 32 (the training step), 128,
  161, 240, 512 and 1024 (each of their paths: a block's registers up
  to 64, a thread-block cluster a problem past that, C in its shared
  memory up to about 600, read through L2 past it), and at [1, 8200,
  8200] with L=3 (u and v no longer staged in shared memory), one launch
  a call, each path's kernel by name in a trace at B = 32, 240 and 1024,
  and each Sinkhorn kernel's registers and spills (``nvcc -Xptxas -v``);
  the ConvLSTM backward (and the forward's c and gate stacks) at the 8
  layer shapes with the training T, the bf16 backward's tensor-core
  kernels by name in its trace; the LSTM forward and backward at
  lstm1-3, B=32, T=20, f32 and bf16, each wrapper call traced (one
  launch and no other device op a call, the tensor-core kernels in bf16
  and only there), and at U = 128 and 256 (past the kernels' 64-unit
  staging: bf16 up to 128 on the tensor cores, else R read through L2);
* the conditioned rollout through the kernel and the plain path, counted,
  and one rollout of each path traced (the ConvLSTM kernels in the kernel
  path's trace alone, its tensor-core kernel by name in bf16);
* two training iterations (``kernel_impl='scan'``, L=100) through the
  Sinkhorn kernels and two through the plain loop from the same state,
  compared, and one iteration of each traced (the Sinkhorn kernels in
  the kernel path's trace alone);
* two training iterations under ``kernel_impl='pallas'`` (every ConvLSTM
  and LSTM recurrence through its forward and backward kernels) against
  two under ``'scan'`` from the same state, video and z, in f32 and in
  bf16, with every kernel's calls and launches counted per iteration;
  then one iteration of each engine traced (the LSTM kernels in the
  'pallas' trace alone, every tensor-core kernel there by name);
* the trainer: ``cli.main`` trains 8 ``'pallas'`` steps at ``mmnist_full``
  on an MMNIST-layout fixture (checkpoints and samples every 4 steps,
  every kernel's launches counted over the run, which the ``kernels``
  line reports); ``Trainer.fit`` run 4 steps, checkpointed, restored into
  a new trainer and run 4 more, against 8 straight, equal to the bit;
* the training options: the separable Gaussian smoothing ('1d', '2d',
  '3d') against the dense conv1d / conv2d / conv3d it stands for, outputs
  and VJPs, at mmnist_full's video and a 3-channel one; 'pallas'
  iterations with each mode and decaying sigma, counted (the kernels'
  launches those of ``kernel='none'``), '3d' under both engines in f32;
  the ConvLSTM kernels' recurrent-dropout mode (gate g's conv over
  h_{t-1} * mask_g) against the plain versions at the 8 layer shapes,
  forward and backward, f32 and bf16; 'pallas' iterations with dropout
  alone and with dropout and recurrent dropout, counted (every kernel's
  launches those of an iteration without dropout but for the context's
  second encoding) and held against 'scan' on the same masks in f32; and
  the CLI with ``--kernel 3d --decaying_sigma --dropout 0.1 --rnn_dropout
  0.1``, counted, its logged sigma the annealed one, and a resumed run
  equal to the straight one to the bit;
* the datasets: fixtures written on the host in each reader's format (a
  BAIR set of 64 + 16 RGB videos, a flat-float ``animation`` set and,
  where PIL is installed, a GQN mazes set of 84x84 JPEG frames; a line
  says whether PIL and cv2 are present and what was not run); the native
  TFRecord reader built and byte-identical to the Python one; then at
  the RGB presets ``robot_push`` and ``mazes`` (B=8, 64x64x3, 5 + 10
  frames): the CLI through ``'pallas'`` with every kernel's calls and
  launches derived from the preset's T, ``'pallas'`` against ``'scan'``
  on the reader's first batch in f32 and bf16, each kernel against its
  plain version at B=8 and T=15/10, and one bf16 iteration of each
  engine traced;
* serving, from a checkpoint of the seeded ``mmnist_full`` state:
  ``cli.sample`` (32 videos, best-of-4, the rollouts replayed from a CUDA
  graph; without matplotlib its functions, all but the PNG) and
  ``cli.export --check`` (the ``torch.export`` artifact equal to the live
  rollout to the bit), counted; the sample's rollout and best-of-K through
  the eager rollout, counted and equal to the graph's; the graph rollout,
  the rollout without the registered operator and the loaded artifact
  equal to the eager rollout to the bit, and the artifact within the
  rollout's tolerance of the plain one, at B = 32 and 7; the ConvLSTM
  forward's tensor-core kernel in a trace of the artifact's graph
  replay, once a step;
* the fused discriminators (``fused_discriminators=True``): the LSTM
  kernels with an instance axis (4 instances, each its own weights, in
  one launch) against their plain versions and, to the bit, against
  one-instance calls on each slice, at lstm1-3 and at U = 128 and 256, f32
  and bf16; one fused 'pallas' iteration against one sequential from the
  same state in f32 and bf16, counted from zero around each (LSTM 6 + 6
  calls against 24 + 18), then one bf16 iteration of each traced (the
  LSTM tensor-core kernels by name);
* the meshes (``kccotgan_tpu_torch/parallel``): the exact mode on a
  1-rank NCCL mesh equal to the one-device step to the bit (NCCL across
  several cards is not run: one card); 2 ranks sharing the card over
  gloo (NCCL refuses two ranks on one device; each rank's compute on the
  card, only the transport through the host): the exact mode in f32
  (within ``ENGINE_TOL``) and bf16 (losses within 1e-3) against the
  one-device step, the per-shard mode, the seq mode at S = 2 (f32 and
  bf16, each against the one-device step), every rank's kernels counted
  from zero (``PALLAS_COUNTS`` at B = 16 a rank; ``seq_counts`` under
  seq) with its collectives' calls and bytes, the ranks' states equal to
  the bit, and ``Trainer`` 2 + checkpoint + restore + 2 against 4
  straight on the mesh, to the bit; 4 ranks on the data 2 x seq 2 mesh,
  checked alike; ``cli.main --num_devices 2`` for 4 steps (the
  ``parallel`` line).

The bf16 engine runs the ConvLSTM's recurrent conv, dh and drk, and the
dense LSTM's step, dh and dR, on the tensor cores: the built library's
LSTM kernels must show HMMA in ``cuobjdump -sass`` (bf16) or none (f32),
and the tensor-core kernels must show by name in the traces above.

Each path's kernel launches are counted from zero around its run.  Every
phase raises on failure.  The last lines are the kernels' JSON record,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from kccotgan_tpu_torch._build import _FLAGS, BUILD_DIR, _nvcc, load_library
from kccotgan_tpu_torch.ckpt import latest_step, save_checkpoint
from kccotgan_tpu_torch.cli import export as export_cli
from kccotgan_tpu_torch.cli import sample as sample_cli
from kccotgan_tpu_torch.cli.main import main as train_main
from kccotgan_tpu_torch.config import get_preset
from kccotgan_tpu_torch.data import (
    ArrayDataset,
    bouncing_blobs,
    encode_example,
    encode_sequence_example,
    load_mmnist,
    make_dataset,
    mmnist_paths,
    native_io,
    tfrecord,
    write_mmnist_fixture,
    write_tfrecord,
)
from kccotgan_tpu_torch.data import io as data_io
from kccotgan_tpu_torch.data.bair import robot_push_samples
from kccotgan_tpu_torch.data.generic import flat_feature_samples
from kccotgan_tpu_torch.data.gqn import GQN_DATASETS, gqn_record_files
from kccotgan_tpu_torch.export import load_rollout
from kccotgan_tpu_torch.models import layers as model_layers
from kccotgan_tpu_torch.models.cuda_convlstm import (
    _fwd_plain,
    convlstm_bwd,
    convlstm_bwd_reference,
    convlstm_fwd,
    convlstm_scan,
    convlstm_scan_reference,
)
from kccotgan_tpu_torch.models.cuda_lstm import (
    lstm_bwd,
    lstm_bwd_reference,
    lstm_fwd,
    lstm_scan_reference,
)
from kccotgan_tpu_torch.ot.cuda_sinkhorn import sinkhorn_bwd, sinkhorn_fwd, sinkhorn_fwd_reference
from kccotgan_tpu_torch.smoothing import annealing_sigma, apply_smoothing
from kccotgan_tpu_torch.parallel import comm, data_seq_mesh, make_mesh, seq_mesh
from kccotgan_tpu_torch.parallel.launch import run_ranks
from kccotgan_tpu_torch.parallel.mesh import init_distributed
from kccotgan_tpu_torch.parallel.seqtrain import build_seq_train_step
from kccotgan_tpu_torch.parallel.sharding import build_sharded_train_step, replicate_state
from kccotgan_tpu_torch.train import Trainer, build_rollout, build_train_step, create_train_state
from kccotgan_tpu_torch.train.rollout import graph_rollout
from kccotgan_tpu_torch.train.state import state_tensors
from kccotgan_tpu_torch.train.steps import Placement
from kccotgan_tpu_torch.weights import init_generator_params

PRESET = "mmnist_full"
B, T = 32, 10


def convlstm_layers(cfg) -> dict:
    """``name: (H = W, filters f, kernel k)`` of the 8 ConvLSTM layers
    (square frames): the encoder's four stride-2 levels, then the
    decoder's."""
    m = cfg.model
    f, hw = m.g_filter_size, m.x_height
    return {
        "enc1": (hw // 2, f * 4, 6), "enc2": (hw // 4, f * 8, 6),
        "enc3": (hw // 8, f * 16, 5), "enc4": (hw // 16, f * 32, 5),
        "dec2": (hw // 8, f * 16, 4), "dec3": (hw // 4, f * 8, 6),
        "dec4": (hw // 2, f * 4, 8), "dec5": (hw, f, 8),
    }


def lstm_layers(cfg) -> dict:
    """``name: (in_features, units)`` of the discriminator's three LSTMs."""
    m = cfg.model
    f, s = m.d_filter_size, m.x_height
    for _ in range(3):
        s = -(-s // 2)
    return {"lstm1": (s * s * f * 16, f * 8), "lstm2": (f * 8, f * 4), "lstm3": (f * 4, m.d_state_size)}


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
# 1e-4.  bf16: both round the recurrent conv's gates, y and dz to bf16
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


def pallas_counts(cfg):
    """(calls, launches) of each kernel in one 'pallas' iteration of
    ``cfg`` (shared context, no dropout), from its T frames of which T_p
    are predicted.  ConvLSTM forward: the encoder's 4 layers once over the
    T frames, the decoder's 4 over T_p in each phase, one launch a step.
    Backward (generator phase only): two launches a step and two for the
    weight gradient.  LSTM: 3 layers x 8 discriminator passes forward, x 6
    differentiated passes backward (one launch each: the recurrence, dR
    and db).  Sinkhorn: one forward and one backward a phase."""
    t, tp = cfg.total_time_steps, cfg.pred_time_steps
    return {
        "convlstm_fwd": (12, 4 * t + 8 * tp),
        "convlstm_bwd": (8, 4 * (2 * t + 2) + 4 * (2 * tp + 2)),
        "lstm_fwd": (24, 24),
        "lstm_bwd": (18, 18),
        "sinkhorn_fwd": (2, 2),
        "sinkhorn_bwd": (2, 2),
    }


# At mmnist_full (T = 20, T_p = 10): ConvLSTM 12 / 160 and 8 / 256.
PALLAS_COUNTS = pallas_counts(get_preset(PRESET))
# With dropout the context is not shared (each phase encodes it under its
# own masks): the discriminator phase adds the encoder's 4 forward calls
# over the 20 frames; nothing else changes.
DROPOUT_COUNTS = {**PALLAS_COUNTS, "convlstm_fwd": (12 + 4, 4 * 20 + 8 * 10 + 4 * 20)}
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
# (samples at 1, 4, 8), and every kernel of the iteration is called and
# launched as often as PALLAS_COUNTS says, the ConvLSTM forward also as
# often as a rollout calls and launches it (``rollout_counts``: 4 T_c +
# 8 T_p launches) a sample.  The resumed run (4 steps, checkpoint, a new Trainer, 4 more)
# must equal the straight 8 to the bit, cuDNN deterministic: every kernel
# of the port sums in a fixed order, the noise comes from the state's
# key, and a checkpoint holds every bit of the state, so no tolerance.
TRAINER_STEPS, TRAINER_EVERY, FIXTURE_VIDEOS = 8, 4, 64
# Phase 10, the training options.  Smoothing, separable (the port) vs the
# dense kernels (``dense_smoothing``), f32, TF32 off, at mmnist_full's
# video and a 3-channel one: outputs in [0, 1] at 1e-5 abs; VJPs at 1e-5
# of max(1, |entry|), since the global-max normalization puts one large
# entry (the sum of the cotangent times the output over the batch) at the
# maximum's position.  The two differ in the order of their sums and in
# their taps (float32 against float64 rounded), a few ulp each.
SMOOTH_MODES = ("1d", "2d", "3d")
SMOOTH_SHAPES = ((32, 64, 20, 64, 1), (8, 64, 15, 64, 3))
SMOOTH_SIGMA, SMOOTH_TOL = 5.0, 1e-5
DROPOUT = 0.1


def layer_inputs(hw, f, k, dtype, dev, seed, t=T, b=B):
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    xconv = randn(b, t, hw, hw, 4 * f).to(dtype)
    h0, c0 = randn(b, hw, hw, f, scale=0.5), randn(b, hw, hw, f, scale=0.5)
    rk = randn(k, k, f, 4 * f, scale=(k * k * f) ** -0.5)
    bias = randn(4 * f, scale=0.1)
    return xconv, h0, c0, rk, bias


def max_err(a, b):
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def check_layers(dev):
    """Phase 2: kernel vs plain at every layer shape, f32 and bf16."""
    errs = {}
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
    return errs


# The bf16 engine's tensor-core kernels, by the name they show in a
# torch.profiler trace: forward step; backward dh, drk (the backward's
# adjoint step, convlstm_bwd_step_kernel, runs no product).
TC_KERNELS = ("convlstm_step_tc_kernel", "convlstm_bwd_dh_tc_kernel", "recurrent_wgrad_tc_kernel")
# The bf16 LSTM kernels (tensor cores), by their trace names; the f32
# ones are lstm_fwd_kernel and lstm_bwd_kernel (CUDA cores).
LSTM_TC_KERNELS = ("lstm_fwd_tc_kernel", "lstm_bwd_tc_kernel")


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
    return launches, rollout_k, rollout_p


def profiled(fn, required=(), what="trace", attempts=5):
    """One ``fn()`` under ``torch.profiler`` (CPU and CUDA activity): the
    count of its device events and their count by kernel name.  ``fn``
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
            n_by_name = {}
            for e in events:
                n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
            missing = [n for n in required if not any(n in k for k in n_by_name)]
            if not missing:
                return len(events), n_by_name
            note = f"no {missing} among {len(events)} device events ({sorted(n_by_name)[:8]})"
        else:
            note = "no device event"
        print(f"[profile] {what}: {note} in the trace, attempt {attempt} of {attempts}",
              file=sys.stderr, flush=True)
        time.sleep(1.0)
    raise RuntimeError(f"{what}: {note} in the trace, {attempts} attempts")


def check_rollout_trace(name, fn, tc):
    """Phase 5: one rollout of the ``name`` path traced: the ConvLSTM
    kernels on the kernel path alone, its tensor-core kernel by name
    under ``tc``."""
    n_by_name = profiled(fn, TC_KERNELS[:1] if name == "kernel" and tc else (), f"{name} rollout")[1]
    convlstm = sum(n for k, n in n_by_name.items() if "convlstm" in k)
    if (convlstm > 0) != (name == "kernel"):
        raise RuntimeError(f"{name} path: {convlstm} ConvLSTM kernel events in the trace")


def check_sinkhorn(dev):
    """Sinkhorn forward and backward kernels vs their plain versions at
    [3, B, B], L=100, eps 1, B in ``SINK_BATCHES``, and at
    ``SINK_UNSTAGED``: costs and histories against the plain forward, c_bar
    under a random cotangent against autograd through the plain loop, one
    launch a call.  At the batches in ``SINK_TRACED`` each kernel's path
    (``reg_kernel<16, ...>`` up to B = 64, ``band_kernel`` past it) by name
    in a trace."""
    errs = {"fwd": 0.0, "bwd": 0.0}
    traces, failed = {}, []
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
            traces[b] = session_trace({
                "fwd": (lambda: sinkhorn_fwd(c, SINK_EPS, SINK_L), sinkhorn_fwd, (f"sinkhorn_fwd_{path}",)),
                "bwd": (lambda: sinkhorn_bwd(c, uh_k, vh_k, cot, SINK_EPS), sinkhorn_bwd,
                        (f"sinkhorn_bwd_{path}",)),
            })
            print(f"[sinkhorn trace] B={b}: " + json.dumps(traces[b]), flush=True)
        del c, uh_k, vh_k, cbar_k
    print(json.dumps({"sinkhorn_B_L100": {str(k): v for k, v in traces.items()}}), flush=True)
    if failed:
        raise RuntimeError(f"Sinkhorn kernels disagree with their plain versions: {failed}")
    return errs


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


def check_traces(state0, video, zs, paths, marker, what, required=()):
    """One iteration of each path under ``torch.profiler``.  ``paths`` is
    ``((reference name, step), (kernel name, step))``; kernels whose name
    holds ``marker`` must show in the kernel path's trace and only there,
    and every kernel named in ``required`` in the kernel path's."""
    kern = paths[1][0]
    for path, fn in paths:
        n_events, n_by_name = profiled(lambda: fn(state0, video, z=zs[0]), required if path == kern else (),
                                       f"{what}, {path} path")
        marked = sum(n for k, n in n_by_name.items() if marker in k)
        print(f"[trace] {what}, {path} path: {n_events} device events, {marked} of '{marker}' kernels", flush=True)
        if (marked > 0) != (path == kern):
            raise RuntimeError(f"{what}, {path} path: {marked} device events of '{marker}' kernels in the trace")


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
    10 decoder), nonzero h0, c0, dh_n and dc_n, f32 and bf16; each layer's
    bf16 backward traced, its tensor-core kernels (dh, drk) by name."""
    errs, failed = {}, []
    for i, (name, (hw, f, k)) in enumerate(LAYERS.items()):
        t = train_t(name)
        for dtype in (torch.float32, torch.bfloat16):
            args = layer_inputs(hw, f, k, dtype, dev, seed=100 + i, t=t)
            g = torch.Generator().manual_seed(200 + i)
            y_p, cs_p, h_p, c_p, _, gs_p = _fwd_plain(*args, None, with_gates=True)
            fwd_k = convlstm_fwd(*args, with_c_stack=True)
            cot = (
                torch.randn(y_p.shape, generator=g).to(dev, dtype),
                torch.randn(h_p.shape, generator=g).to(dev),
                torch.randn(c_p.shape, generator=g).to(dev),
            )
            got = convlstm_bwd(gs_p, *args[1:4], y_p, cs_p, *cot)
            want = convlstm_bwd_reference(*args, y_p, cs_p, *cot)
            torch.cuda.synchronize()
            tag = f"{name} T={t} {str(dtype).removeprefix('torch.')}"
            e_fwd = max_err(fwd_k, (y_p, cs_p, h_p, c_p, gs_p))
            e_bwd = {n: rel_err([a], [b]) for n, a, b in zip(("dx", "dh0", "dc0", "drk", "db"), got, want)}
            print(f"[convlstm_bwd] {tag}: forward+c and gate stacks max abs err {e_fwd:.3e} (tol {TOL[dtype]:.0e}); "
                  f"gradients, err / largest: {json.dumps(e_bwd)} (tol {GRAD_TOL[dtype]:.0e}); "
                  f"max abs err {max_err(got, want):.3e}", flush=True)
            if not (e_fwd <= TOL[dtype] and max(e_bwd.values()) <= GRAD_TOL[dtype]):
                failed.append(tag)
            errs[tag] = max_err(got, want)
        args = layer_inputs(hw, f, k, torch.bfloat16, dev, seed=100 + i, t=t)
        y, cs, h, c, gs = convlstm_fwd(*args, with_c_stack=True)
        cot = (torch.ones_like(y), torch.zeros_like(h), torch.zeros_like(c))
        profiled(lambda: convlstm_bwd(gs, *args[1:4], y, cs, *cot), TC_KERNELS[1:], f"{name} bf16 backward")
    if failed:
        raise RuntimeError(f"convlstm_bwd disagrees with its plain version: {failed}")
    return errs


def lstm_inputs(in_features, u, dtype, dev, seed, b=LSTM_B, t=LSTM_T):
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    xproj = randn(b, t, 4 * u).to(dtype)
    h0, c0 = randn(b, u, scale=0.5), randn(b, u, scale=0.5)
    rk = randn(u, 4 * u, scale=u ** -0.5)
    bias = randn(4 * u, scale=0.1)
    return xproj, h0, c0, rk, bias


def session_trace(calls, rounds=10):
    """Wrapper calls as the card sees them, from one ``torch.profiler``
    session (few sessions a process: CUPTI drops more events in each later
    one).  ``calls`` maps a label to ``(fn, counter, keys)``, each key
    naming one kernel that a call launches once (the labels' kernels
    distinct); ``rounds`` times every fn runs once, in turn.  Per label:
    the launches a call (the wrapper's counter), the share of each
    kernel's launches the trace recorded, the kernels' names, and the
    device ops a round that are no label's kernel."""
    out = {}
    before = {label: c.launches for label, (_, c, _) in calls.items()}
    made = [0]  # rounds run, a retaken trace's included

    def run():
        for _ in range(rounds):
            for fn, *_ in calls.values():
                fn()
        made[0] += rounds

    required = tuple(k for _, _, keys in calls.values() for k in keys)
    n_events, n_by_name = profiled(run, required, f"{'/'.join(calls)} calls")
    matched = 0
    for label, (_, counter, keys) in calls.items():
        share, names = {}, []
        for key in keys:
            kn = [n for n in n_by_name if key in n]
            n_kernel = sum(n_by_name[n] for n in kn)
            matched += n_kernel
            share[key] = n_kernel / rounds
            names += kn
        out[label] = {
            "kernel_launches_per_call": (counter.launches - before[label]) / made[0],
            "recorded_share": share,
            "kernel_names": sorted({n[:60] for n in names}),
        }
    for v in out.values():
        v["other_device_ops_per_call"] = (n_events - matched) / rounds
    return out


def check_lstm(dev):
    """The LSTM forward and backward kernels vs their plain versions at
    lstm1-3 (lstm3 with its sigmoid output), B=32, T=20, nonzero h0, c0
    and cotangents, f32 and bf16; each wrapper call traced in bf16 and f32
    (one kernel launch and no other device op a call, the tensor-core
    kernels in bf16 and only there)."""
    layers = lstm_layers(get_preset(PRESET))
    errs = {"fwd": 0.0, "bwd": 0.0}
    failed = []
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
        for dtype in (torch.bfloat16, torch.float32):
            tag = str(dtype).removeprefix("torch.")
            args = lstm_inputs(feat, u, dtype, dev, seed=300 + i)
            y, cs, h, c = lstm_fwd(*args, act, with_c_stack=True)
            cot = (torch.ones_like(y), torch.zeros_like(h), torch.zeros_like(c))
            trace = session_trace({
                "fwd": (lambda: lstm_fwd(*args, act, with_c_stack=True), lstm_fwd, ("lstm_fwd",)),
                "bwd": (lambda: lstm_bwd(*args, y, cs, *cot, act), lstm_bwd, ("lstm_bwd",)),
            })
            print(f"[lstm trace] {name} U={u} {tag}: " + json.dumps(trace), flush=True)
            for part, tr in trace.items():
                tc = [n for n in tr["kernel_names"] if "_tc_kernel" in n]
                if (tr["kernel_launches_per_call"], tr["other_device_ops_per_call"]) != (1, 0) or (
                    len(tc) != len(tr["kernel_names"]) if dtype == torch.bfloat16 else tc
                ):
                    failed.append(f"{name} {tag} {part}: a call launched {tr['kernel_names']} "
                                  f"and {tr['other_device_ops_per_call']} other device ops")
    if failed:
        raise RuntimeError(f"LSTM kernels disagree with their plain versions: {failed}")
    return errs


def check_lstm_wide(dev):
    """The LSTM kernels past U = 64 (U in ``LSTM_WIDE``: bf16 up to 128 on
    the tensor cores, else R read through L2 at every step; the
    backward's dR and db in a second launch) vs their plain versions,
    B=32, T=20, f32 and bf16, under the same tolerances; each wrapper
    call traced (forward one launch, backward two, no other device op)."""
    checks, failed = {}, []
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
                "fwd": (lambda: lstm_fwd(*args, with_c_stack=True), lstm_fwd, (f"lstm_fwd_{path}_kernel",)),
                "bwd": (lambda: lstm_bwd(*args, y_p, cs_p, *cot), lstm_bwd,
                        (f"lstm_bwd_{path}_kernel", "lstm_wgrad_l2_kernel")),
            })
            checks[tag] = {"fwd_max_abs_err": e_fwd, "grad_err_over_largest": e_bwd, "launches": launches, **trace}
            print(f"[lstm wide] {tag}: " + json.dumps(checks[tag]), flush=True)
            calls_ok = [(trace[p]["kernel_launches_per_call"], trace[p]["other_device_ops_per_call"])
                        for p in ("fwd", "bwd")] == [(1, 0), (2, 0)]
            if not (e_fwd <= TOL[dtype] and max(e_bwd.values()) <= GRAD_TOL[dtype] and launches == (1, 2)
                    and calls_ok):
                failed.append(tag)
    print(json.dumps({"lstm_wide_B32_T20": {k: {p: v[p] for p in ("fwd", "bwd")} for k, v in checks.items()}}),
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


def check_engines(base, dev, per_step=PALLAS_COUNTS, video=None, preset=PRESET):
    """Two iterations of ``base`` under 'pallas' against two under 'scan'
    from the same state, video (``video`` if given, else a seeded uniform
    one) and z, in f32 and in the preset's bf16; every kernel's calls and
    launches counted per 'pallas' iteration against ``per_step``.  Both
    steps replay a CUDA graph from their second call, whose counts are
    what the capture counted (``tests/test_torch_cuda.py`` holds those
    against a trace of a replay); ``graph`` in the line says so."""
    results = {}
    for cdt in ("float32", base.compute_dtype):
        cfg = dataclasses.replace(base, compute_dtype=cdt)
        state0, video_in, zs = training_inputs(cfg, dev, video)
        steps = {impl: build_train_step(dataclasses.replace(cfg, kernel_impl=impl), device=dev)
                 for impl in ("pallas", "scan")}
        runs, per_iter, totals = {}, [], None
        for impl, step in steps.items():
            reset_counts()
            st, mets, before = state0, [], counts()
            for i in range(2):
                st, met = step(st, video_in, z=zs[i])
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
            want = {n: list(c) for n, c in per_step.items()}
            if it != want:
                raise RuntimeError(f"{cdt} 'pallas' iteration {i}: (calls, launches) {it}, expected {want}")
        cmp, ok = compare_engines(runs["pallas"][0], runs["scan"][0], ENGINE_TOL[cdt])
        cmp["second_iteration_loss"] = [float(runs[i][1][0]["sinkhorn_loss"]) for i in ("pallas", "scan")]
        print(json.dumps({"engines_check": {"preset": preset, "compute_dtype": cdt, "per_iteration": per_iter[0],
                                            "graph": {impl: dict(step.counts) for impl, step in steps.items()},
                                            "tol": ENGINE_TOL[cdt], **cmp}}), flush=True)
        if not ok:
            raise RuntimeError(f"{cdt}: 'pallas' and 'scan' iterations disagree: {cmp}")
        results[cdt] = (state0, video_in, zs, steps, per_iter, totals)
    return results[base.compute_dtype]


def compare_engines(pallas_run, scan_run, tol):
    """One iteration's ``(metrics, state)`` under 'pallas' against
    'scan' from the same inputs: ``(comparison, within tol)``."""
    (mp_, sp), (ms_, ss) = pallas_run, scan_run
    cmp = {
        "sinkhorn_loss": [float(mp_["sinkhorn_loss"]), float(ms_["sinkhorn_loss"])],
        "pm": [float(mp_["pm"]), float(ms_["pm"])],
        "max_rel_dmu": {},
        "worst_dmu": {},
    }
    for group in ("enc", "dec", "h", "m"):
        mk, mq = getattr(sp, f"{group}_opt").mu, getattr(ss, f"{group}_opt").mu
        scale = max(float(v.abs().max()) for v in mq.values())
        per = {k: float((mk[k] - mq[k]).abs().max()) / scale for k in mq}
        cmp["max_rel_dmu"][group] = max(per.values())
        cmp["worst_dmu"][group] = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    (lp, ls), (pp, ps) = cmp["sinkhorn_loss"], cmp["pm"]
    ok = (abs(lp - ls) <= tol["loss_rtol"] * abs(ls) and abs(pp - ps) <= tol["pm_rtol"] * abs(ps)
          and all(cmp["max_rel_dmu"][g] <= tol["mu_rel"][g] for g in tol["mu_rel"]))
    return cmp, ok


def training_inputs(cfg, dev, video=None):
    """The seeded state, the video (``video``, a host batch, if given, else
    a seeded uniform one) on the card and the two iterations' (z1, z2)."""
    state0 = create_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    m = cfg.model
    if video is None:
        video = np.random.default_rng(1).uniform(
            size=(cfg.batch_size, m.x_height, cfg.total_time_steps, m.x_width, m.n_channels)
        ).astype(np.float32)
    video = torch.from_numpy(np.ascontiguousarray(video, dtype=np.float32)).to(dev)
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


def check_trainer_cli(tmp, data, options=(), tag="trainer_cli", per_step=PALLAS_COUNTS, preset=PRESET,
                      dname="mmnist"):
    """Phase 9a (10e with ``options``, 11 with another ``preset`` and
    ``dname``): the trainer's command line, counted: TRAINER_STEPS
    'pallas' steps of ``preset`` on the fixture under ``data``,
    checkpoints and samples every TRAINER_EVERY steps, every kernel's
    calls and launches those of the steps (``per_step``) and the sampling
    rollouts (``rollout_counts``).  With ``--decaying_sigma`` among the
    options, each step's logged sigma must be the annealed one.  Printed
    as ``tag``.  Without decaying smoothing the steps after the first
    replay a CUDA graph, and count what its capture counted."""
    per_sample = rollout_counts(get_preset(preset), torch.device("cuda", 0))
    argv = ["--preset", preset, "--dname", dname, "--data_path", str(data), "--kernel_impl", "pallas",
            *options, "--max_steps", str(TRAINER_STEPS), "--ckpt_freq", str(TRAINER_EVERY),
            "--save_freq", str(TRAINER_EVERY), "--out_dir", str(tmp), "--run_name", tag]
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = train_main(argv, device="cuda")
    torch.cuda.synchronize()
    launched = counts()
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    run_dir = Path(tmp) / tag
    mets = read_metrics(run_dir)
    samples = [1] + list(range(TRAINER_EVERY, TRAINER_STEPS + 1, TRAINER_EVERY))
    losses = mets.get("Sinkhorn Loss", {})
    ckpts = sorted(int(p.stem.split("_")[1]) for p in (run_dir / "ckpt").glob("step_*.pt"))
    want = {n: [TRAINER_STEPS * c + len(samples) * r for c, r in zip(per_step[n], per_sample[n])]
            for n in per_step}
    got = {n: list(c) for n, c in launched.items()}
    sigma = None
    if "--decaying_sigma" in options:
        sigma = {s: annealing_sigma(get_preset(preset).init_sigma, s) for s in range(1, TRAINER_STEPS + 1)}
    print(json.dumps({tag: {"argv": argv, "rc": rc, "summary": summary, "losses": losses,
                            "eval_psnr": mets.get("eval/psnr"), "eval_ssim": mets.get("eval/ssim"),
                            "sigma_logged": mets.get("sigma"), "checkpoints": ckpts, "launches": got,
                            "expected_launches": want, "per_sample": per_sample}}), flush=True)
    if rc != 0 or summary["status"] != "completed" or summary["steps"] != TRAINER_STEPS:
        raise RuntimeError(f"trainer CLI: rc {rc}, summary {summary}")
    if sigma is not None and mets.get("sigma") != sigma:
        raise RuntimeError(f"trainer CLI: logged sigma {mets.get('sigma')}, expected {sigma}")
    if sorted(losses) != list(range(1, TRAINER_STEPS + 1)) or not all(np.isfinite(list(losses.values()))):
        raise RuntimeError(f"trainer CLI: Sinkhorn losses {losses}")
    for tag in ("eval/psnr", "eval/ssim"):
        if sorted(mets.get(tag, {})) != samples or not all(np.isfinite(list(mets[tag].values()))):
            raise RuntimeError(f"trainer CLI: {tag} {mets.get(tag)}, expected finite values at steps {samples}")
    if ckpts != [s for s in samples if s % TRAINER_EVERY == 0] or latest_step(str(run_dir / "ckpt")) != TRAINER_STEPS:
        raise RuntimeError(f"trainer CLI: checkpoints at {ckpts}")
    if got != want:
        raise RuntimeError(f"trainer CLI: kernel (calls and) launches {got}, expected {want}")
    return summary, launched


def check_resume(tmp, train_path, base, tag="trainer_resume"):
    """Phase 9b: 4 steps, checkpoint, restore into a new Trainer, 4 more,
    against 8 straight on the same batches, cuDNN deterministic: the
    losses and every tensor of the state equal to the bit.  Printed as
    ``tag``."""
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
    print(json.dumps({tag: resume}), flush=True)
    if not (same_losses and max(diff.values()) == 0.0 and s_state.step == r_state.step == TRAINER_STEPS
            and s_state.rng == r_state.rng):
        raise RuntimeError(f"resumed run differs from the straight run: {resume}")


def check_trainer(base):
    """Phase 9: the trainer's path, through the CLI and through Trainer."""
    with tempfile.TemporaryDirectory() as tmp:
        train_path = write_fixture(Path(tmp) / "data")
        _, launched = check_trainer_cli(Path(tmp) / "runs", Path(tmp) / "data")
        check_resume(Path(tmp) / "resume", train_path, base)
    return launched


def dense_smoothing(video, sigma, mode, kernel_size=6):
    """Phase 10a's reference: the smoothing as the original dense kernels,
    built here from float64 taps: for '1d' a length-(2r+1) ``conv1d``
    over the REFLECT-padded T, for '2d' a (2r+1)^2 ``conv2d`` with VALID
    padding, for '3d' a (2r+1)^3 ``conv3d`` over the REFLECT-padded (T,
    H, W); each divided by the global maximum."""
    r = kernel_size // 2
    x = torch.arange(-r, r + 1, dtype=torch.float64)
    g = torch.exp(-x * x / (2.0 * sigma * sigma))
    g = (g / g.sum()).float().to(video.device)
    b, h, t, w, c = video.shape
    if mode == "1d":
        # padded as [B*C, H*W, T]: a grid dimension of the padding's CUDA
        # kernel takes at most 65,535 rows
        seq = F.pad(video.permute(0, 4, 1, 3, 2).reshape(b * c, h * w, t), (r, r), mode="reflect")
        out = F.conv1d(seq.reshape(b * c * h * w, 1, t + 2 * r), g.view(1, 1, -1))
        out = out.reshape(b, c, h, w, t).permute(0, 2, 4, 3, 1)
    elif mode == "2d":
        frames = video.permute(0, 2, 4, 1, 3).reshape(b * t * c, 1, h, w)
        out = F.conv2d(frames, (g[:, None] * g[None, :])[None, None])
        out = out.reshape(b, t, c, h - 2 * r, w - 2 * r).permute(0, 3, 1, 4, 2)
    else:
        vol = F.pad(video.permute(0, 4, 2, 1, 3).reshape(b * c, 1, t, h, w), (r,) * 6, mode="reflect")
        out = F.conv3d(vol, (g[:, None, None] * g[None, :, None] * g[None, None, :])[None, None])
        out = out.reshape(b, c, t, h, w).permute(0, 3, 2, 4, 1)
    return out / out.amax()


def check_smoothing(dev):
    """Phase 10a: the port's separable smoothing against the dense
    reference, outputs and VJPs for one seeded cotangent, in f32."""
    errs = {}
    for i, shape in enumerate(SMOOTH_SHAPES):
        video = torch.from_numpy(np.random.default_rng(10 + i).uniform(size=shape).astype(np.float32)).to(dev)
        for mode in SMOOTH_MODES:
            outs, vjps = [], []
            for fn in (apply_smoothing, lambda v, s, m: dense_smoothing(v, s, m)):
                x = video.clone().requires_grad_()
                y = fn(x, SMOOTH_SIGMA, mode)
                ct = torch.randn(y.shape, generator=torch.Generator(device=dev).manual_seed(i), device=dev)
                (vjp,) = torch.autograd.grad(y, x, ct)
                outs.append(y.detach())
                vjps.append(vjp)
            (got, want), (got_v, want_v) = outs, vjps
            if got.shape != want.shape:
                raise RuntimeError(f"smoothing {mode} {shape}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
            errs[f"{mode} {list(shape)}"] = {
                "out_max_abs_err": float((got - want).abs().max()),
                "vjp_max_abs_err": float((got_v - want_v).abs().max()),
                "vjp_err": float(((got_v - want_v).abs() / want_v.abs().clamp_min(1.0)).max()),
                "vjp_largest": float(want_v.abs().max()),
            }
    print(json.dumps({"smoothing_check": {"sigma": SMOOTH_SIGMA, "tol": SMOOTH_TOL, "errors": errs}}), flush=True)
    bad = {k: e for k, e in errs.items() if e["out_max_abs_err"] > SMOOTH_TOL or e["vjp_err"] > SMOOTH_TOL}
    if bad:
        raise RuntimeError(f"separable smoothing vs dense: {bad}")


def check_options_training(base, dev):
    """Phase 10b: 'pallas' iterations with each smoothing mode and
    decaying sigma, counted per iteration; '3d' under both engines in
    f32."""
    state0, video, zs = training_inputs(base, dev)
    steps = {mode: build_train_step(dataclasses.replace(
        base, kernel_impl="pallas", kernel=mode, decaying_sigma=True), device=dev) for mode in SMOOTH_MODES}
    want = {n: list(c) for n, c in PALLAS_COUNTS.items()}
    losses = {}
    for mode in SMOOTH_MODES:
        reset_counts()
        st, before = state0, counts()
        for i in range(2):
            st, met = steps[mode](st, video, z=zs[i])
            torch.cuda.synchronize()
            now = counts()
            it = {n: [a - b for a, b in zip(now[n], before[n])] for n in now}
            before = now
            if it != want:
                raise RuntimeError(f"'pallas' {mode} iteration {i}: (calls, launches) {it}, expected {want}")
            if not _all_finite(st, met) or float(met["sigma"]) != annealing_sigma(base.init_sigma, i + 1):
                raise RuntimeError(f"'pallas' {mode} iteration {i}: non-finite, or sigma {float(met['sigma'])}")
            losses.setdefault(mode, []).append(float(met["sinkhorn_loss"]))

    cfg32 = dataclasses.replace(base, compute_dtype="float32", kernel="3d", decaying_sigma=True)
    s32, v32, z32 = training_inputs(cfg32, dev)
    runs = {impl: build_train_step(dataclasses.replace(cfg32, kernel_impl=impl), device=dev)(s32, v32, z=z32[0])
            for impl in ("pallas", "scan")}
    runs = {impl: (met, st) for impl, (st, met) in runs.items()}
    cmp, ok = compare_engines(runs["pallas"], runs["scan"], ENGINE_TOL["float32"])
    print(json.dumps({"options_check": {"preset": PRESET, "kernel_impl": "pallas", "decaying_sigma": True,
                                        "per_iteration_counts": want, "losses": losses,
                                        "engines_3d_float32": cmp, "tol": ENGINE_TOL["float32"]}}), flush=True)
    if not ok:
        raise RuntimeError(f"'3d' f32: 'pallas' and 'scan' iterations disagree: {cmp}")


def check_convlstm_dropout(dev):
    """Phase 10c: the ConvLSTM kernels' recurrent-dropout mode against the
    plain versions with the same masks (``[4, B, H, W, f]``, keep 0.9, gate
    g's conv over h_{t-1} * mask_g), forward with its hm stack and
    backward, at the 8 layer shapes with the training T, f32 and bf16."""
    errs, failed = {}, []
    for i, (name, (hw, f, k)) in enumerate(LAYERS.items()):
        t = train_t(name)
        g = torch.Generator().manual_seed(300 + i)
        masks = ((torch.rand(4, B, hw, hw, f, generator=g) < 1 - DROPOUT).float() / (1 - DROPOUT)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            args = layer_inputs(hw, f, k, dtype, dev, seed=300 + i, t=t)
            y_p, cs_p, h_p, c_p, hm_p, gs_p = _fwd_plain(*args, masks, with_gates=True)
            got_f = convlstm_fwd(*args, with_c_stack=True, rec_masks=masks)
            cot = (torch.randn(y_p.shape, generator=g).to(dev, dtype), torch.randn(h_p.shape, generator=g).to(dev),
                   torch.randn(c_p.shape, generator=g).to(dev))
            got = convlstm_bwd(gs_p, *args[1:4], y_p, cs_p, *cot, rec_masks=masks, hm=hm_p)
            want = convlstm_bwd_reference(*args, y_p, cs_p, *cot, rec_masks=masks, hm=hm_p)
            torch.cuda.synchronize()
            tag = f"{name} T={t} {str(dtype).removeprefix('torch.')}"
            e_fwd = max_err((*got_f[:5], got_f[5][0], got_f[5][1][:, :-1]),
                            (y_p, cs_p, h_p, c_p, gs_p, hm_p[0], hm_p[1][:, :-1]))
            e_bwd = {n: rel_err([a], [b]) for n, a, b in zip(("dx", "dh0", "dc0", "drk", "db"), got, want)}
            errs[tag] = {"forward_max_abs_err": e_fwd, "grad_err_of_largest": e_bwd,
                         "grad_max_abs_err": max_err(got, want)}
            # hm is cdt(h * mask): one rounding of a value up to 1 / keep, so
            # the forward's bf16 tolerance is that of y times 1 / keep
            if not (e_fwd <= TOL[dtype] / (1 - DROPOUT) and max(e_bwd.values()) <= GRAD_TOL[dtype]):
                failed.append(tag)
    tol = {str(d).removeprefix("torch."): {"forward_abs": TOL[d] / (1 - DROPOUT), "grad_of_largest": GRAD_TOL[d]}
           for d in TOL}
    print(json.dumps({"convlstm_dropout_check": {"keep": 1 - DROPOUT, "tol": tol, "errors": errs}}), flush=True)
    if failed:
        raise RuntimeError(f"the ConvLSTM kernels' masked mode disagrees with its plain version: {failed}")


def check_dropout_training(base, dev):
    """Phase 10d: 'pallas' iterations with dropout alone and with dropout
    and recurrent dropout: every kernel's calls and launches those of an
    iteration without dropout but for the context's second encoding
    (``DROPOUT_COUNTS``; the ConvLSTM kernels take the masks), held
    against 'scan' from the same state and masks in f32."""
    variants = {"dropout": (DROPOUT, 0.0), "dropout_rnn_dropout": (DROPOUT, DROPOUT)}

    def with_dropout(cfg, name):
        p, q = variants[name]
        return dataclasses.replace(cfg, kernel_impl="pallas",
                                   model=dataclasses.replace(cfg.model, dropout=p, rnn_dropout=q))

    want = {n: list(c) for n, c in DROPOUT_COUNTS.items()}
    losses, engines = {}, {}
    for name in variants:
        cfg = with_dropout(base, name)
        state0, video, _ = training_inputs(cfg, dev)
        step = build_train_step(cfg, device=dev)
        reset_counts()
        st, before = state0, counts()
        for i in range(2):
            st, met = step(st, video)
            torch.cuda.synchronize()
            now = counts()
            it = {n: [a - b for a, b in zip(now[n], before[n])] for n in now}
            before = now
            if it != want:
                raise RuntimeError(f"{name} iteration {i}: (calls, launches) {it}, expected {want}")
            if not _all_finite(st, met):
                raise RuntimeError(f"{name} iteration {i}: non-finite loss, pM, parameter or statistic")
            losses.setdefault(name, []).append(float(met["sinkhorn_loss"]))
        cfg32 = with_dropout(dataclasses.replace(base, compute_dtype="float32"), name)
        s32, v32, _ = training_inputs(cfg32, dev)
        runs = {impl: build_train_step(dataclasses.replace(cfg32, kernel_impl=impl), device=dev)(s32, v32)
                for impl in ("pallas", "scan")}
        cmp, ok = compare_engines(*((runs[i][1], runs[i][0]) for i in ("pallas", "scan")), ENGINE_TOL["float32"])
        engines[name] = cmp
        if not ok:
            raise RuntimeError(f"{name} f32: 'pallas' and 'scan' iterations disagree: {cmp}")
    print(json.dumps({"dropout_training": {
        "preset": PRESET, "compute_dtype": base.compute_dtype, "kernel_impl": "pallas",
        "variants": variants, "per_iteration_counts": want, "losses": losses,
        "engines_float32": engines, "tol": ENGINE_TOL["float32"],
    }}), flush=True)


def check_options(base, dev):
    """Phase 10: the paper's training options (smoothing, annealing,
    dropout) through the step, the CLI and a resume."""
    check_smoothing(dev)
    check_options_training(base, dev)
    check_convlstm_dropout(dev)
    check_dropout_training(base, dev)
    opts = dataclasses.replace(base, kernel="3d", decaying_sigma=True, model=dataclasses.replace(
        base.model, dropout=DROPOUT, rnn_dropout=DROPOUT))
    with tempfile.TemporaryDirectory() as tmp:
        train_path = write_fixture(Path(tmp) / "data")
        check_trainer_cli(Path(tmp) / "runs", Path(tmp) / "data", tag="options_cli", per_step=DROPOUT_COUNTS,
                          options=("--kernel", "3d", "--decaying_sigma", "--dropout", str(DROPOUT),
                                   "--rnn_dropout", str(DROPOUT)))
        check_resume(Path(tmp) / "resume", train_path, opts, tag="options_resume")


# Phase 11, the datasets: the paper's RGB presets (B=8, 64x64x3, 5 context
# + 10 predicted frames) on fixtures written here in each reader's format.
# BAIR: BAIR_TRAIN + BAIR_TEST videos of 30 frames, the train split over
# BAIR_SHARDS shards; flat-float 'animation': FLAT_RECORDS records over two
# shards; GQN mazes (with PIL): GQN_FILES shards of GQN_RECORDS records of
# GQN_FRAMES 84x84 JPEG frames, and the np_mazes_test.npy batch (with an
# alpha channel).  The loaders' samples compared over READER_VIDEOS
# flat-float videos.
DATA_PRESETS = ("robot_push", "mazes")
BAIR_TRAIN, BAIR_TEST, BAIR_SHARDS = 64, 16, 4
FLAT_RECORDS = 32
GQN_FILES, GQN_RECORDS, GQN_FRAMES = 4, 16, 16
READER_VIDEOS = 64
TINT = np.array([1.0, 0.6, 0.3], np.float32)  # each channel its own share of the blobs


def tinted_strips(n, t, hw, seed):
    """``n`` bouncing-blob film-strips ``[n, hw, t, hw, 3]`` in [0, 1], the
    channels unequal."""
    return bouncing_blobs(n, t, hw, hw, channels=3, seed=seed) * TINT


def frames_u8(strip):
    """A film-strip ``[H, T, W, C]`` in [0, 1] as ``[T, H, W, C]`` uint8."""
    return (np.transpose(strip, (1, 0, 2, 3)) * 255).astype(np.uint8)


def write_data_fixtures(root, have_pil):
    """The fixtures of phase 11 under ``root``: BAIR's
    ``softmotion30_44k/{train,test}/``, ``animation/`` and, with PIL, GQN's
    ``mazes/train/`` and ``mazes/np_mazes_test.npy``.  Returns each set's
    shard paths."""
    shards = {}
    strips = tinted_strips(BAIR_TRAIN + BAIR_TEST, 30, 64, seed=3)
    recs = [encode_sequence_example({f"{i}/image_aux1/encoded": [f.tobytes()] for i, f in enumerate(frames_u8(s))})
            for s in strips]
    per = BAIR_TRAIN // BAIR_SHARDS
    base = root / "softmotion30_44k"
    shards["bair"] = [base / "train" / f"traj_{k}.tfrecords" for k in range(BAIR_SHARDS)] + [
        base / "test" / "traj_0.tfrecords"]
    for k, path in enumerate(shards["bair"]):
        write_tfrecord(str(path), recs[k * per:(k + 1) * per] if k < BAIR_SHARDS else recs[BAIR_TRAIN:])
    cfg = get_preset("robot_push")
    t = cfg.total_time_steps
    flat = tinted_strips(FLAT_RECORDS, t, 64, seed=4)
    shards["animation"] = [root / "animation" / f"part_{k}.tfrecord" for k in range(2)]
    for k, path in enumerate(shards["animation"]):
        write_tfrecord(str(path), [encode_example({"x": v.ravel().tolist()}) for v in flat[k::2]])
    if have_pil:
        from PIL import Image

        def jpeg(frame):
            buf = io.BytesIO()
            Image.fromarray(frame).save(buf, format="JPEG", quality=95)
            return buf.getvalue()

        strips = tinted_strips(GQN_FILES * GQN_RECORDS, GQN_FRAMES, 84, seed=5)
        shards["mazes"] = [Path(p) for p in gqn_record_files(GQN_DATASETS["mazes"], "train", str(root))[:GQN_FILES]]
        for k, path in enumerate(shards["mazes"]):
            write_tfrecord(str(path), [encode_example({"frames": [jpeg(f) for f in frames_u8(s)]})
                                       for s in strips[k * GQN_RECORDS:(k + 1) * GQN_RECORDS]])
        test = tinted_strips(cfg.batch_size, t, 64, seed=6)
        np.save(root / "mazes" / "np_mazes_test.npy",
                np.concatenate([test, np.ones_like(test[..., :1])], axis=-1).astype(np.float32))
    return shards


def same_values(a, b):
    """Equal values of equal types, through dicts, lists and arrays."""
    if isinstance(b, dict):
        return isinstance(a, dict) and list(a) == list(b) and all(same_values(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(same_values(x, y) for x, y in zip(a, b))
    if isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@contextlib.contextmanager
def io_backend(name):
    """``data.io`` pinned to the backend ``name`` (``KCCOT_FORCE_PY_IO``)."""
    before = os.environ.pop("KCCOT_FORCE_PY_IO", None)
    if name == "python":
        os.environ["KCCOT_FORCE_PY_IO"] = "1"
    try:
        if data_io.backend() != name:
            raise RuntimeError(f"data.io backend {data_io.backend()!r}, wanted {name!r}")
        yield
    finally:
        os.environ.pop("KCCOT_FORCE_PY_IO", None)
        if before is not None:
            os.environ["KCCOT_FORCE_PY_IO"] = before


def check_readers(root, shards):
    """Phase 11b: the native backend on the card's host, byte-identical to
    the Python one on every fixture shard (records under verify_crc, each
    record's masked CRC32C, and the parse each loader uses) and in the
    loaders' samples."""
    if data_io.backend() != "native":
        raise RuntimeError(f"data.io backend {data_io.backend()!r}: the native reader did not load")
    parse_of = {"bair": "parse_sequence_example", "animation": "parse_example_arrays", "mazes": "parse_example"}
    n_records = {}
    for kind, paths in shards.items():
        n_records[kind] = 0
        for path in paths:
            recs = list(native_io.iter_tfrecord(str(path), verify_crc=True))
            if recs != list(tfrecord.iter_tfrecord(str(path), verify_crc=True)) or not recs:
                raise RuntimeError(f"{path}: the backends' records differ")
            for rec in recs:
                if native_io.masked_crc32c(rec) != tfrecord.masked_crc32c(rec) or not same_values(
                        getattr(native_io, parse_of[kind])(rec), getattr(tfrecord, parse_of[kind])(rec)):
                    raise RuntimeError(f"{path}: the backends' {parse_of[kind]} differ")
            n_records[kind] += len(recs)
    cfg = get_preset("robot_push")
    t, m = cfg.total_time_steps, cfg.model
    bair_root = str(root / "softmotion30_44k")
    pattern = str(root / "animation" / "*.tfrecord")
    samples = {}
    for name in ("native", "python"):
        with io_backend(name):
            bair_videos = list(robot_push_samples(bair_root, t))
            flat = list(itertools.islice(flat_feature_samples(pattern, m.x_height, m.x_width, t, m.n_channels,
                                                              seed=1), READER_VIDEOS))
        samples[name] = (bair_videos, flat)
    if len(samples["native"][0]) != BAIR_TRAIN or not same_values(samples["native"], samples["python"]):
        raise RuntimeError("the loaders' samples differ between the backends")
    return {"backend": data_io.backend(), "records_checked": n_records}


def rollout_counts(cfg, dev):
    """(calls, launches) of each kernel in one rollout of ``cfg`` (seeded
    weights, a uniform context), the ConvLSTM forward's launches checked
    against 4 T_c + 8 T_p and no other kernel launched."""
    params = init_generator_params(cfg, torch.Generator().manual_seed(0))
    params = {part: {k: v.to(dev) for k, v in p.items()} for part, p in params.items()}
    m = cfg.model
    context = torch.rand(cfg.batch_size, m.x_height, cfg.int_time_steps, m.x_width, m.n_channels,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    reset_counts()
    build_rollout(cfg, device=dev)(params, context, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    got = counts()
    if got["convlstm_fwd"][1] != 4 * cfg.int_time_steps + 8 * cfg.pred_time_steps or any(
            c[1] for n, c in got.items() if n != "convlstm_fwd"):
        raise RuntimeError(f"a rollout at {cfg.dname}: {got}")
    return got


def check_kernels_at(cfg, dev):
    """Phase 11d: each kernel against its plain version at ``cfg``'s batch
    and T, with the tolerances of mmnist_full: the ConvLSTM forward (and
    its c stack) and backward at the 8 layer shapes (encoder over T,
    decoder over T_p; enc4's M = B H W = 128 rows at B=8), the LSTM
    forward and backward at lstm1-3 over T, and the Sinkhorn at [3, B,
    B], L; f32 and bf16 (the Sinkhorn f32)."""
    b, errs, failed = cfg.batch_size, {}, []
    for i, (name, (hw, f, k)) in enumerate(convlstm_layers(cfg).items()):
        t = cfg.total_time_steps if name.startswith("enc") else cfg.pred_time_steps
        for dtype in (torch.float32, torch.bfloat16):
            args = layer_inputs(hw, f, k, dtype, dev, seed=700 + i, t=t, b=b)
            g = torch.Generator().manual_seed(800 + i)
            y_p, cs_p, h_p, c_p, _, gs_p = _fwd_plain(*args, None, with_gates=True)
            got_f = convlstm_fwd(*args, with_c_stack=True)
            cot = (torch.randn(y_p.shape, generator=g).to(dev, dtype), torch.randn(h_p.shape, generator=g).to(dev),
                   torch.randn(c_p.shape, generator=g).to(dev))
            got = convlstm_bwd(gs_p, *args[1:4], y_p, cs_p, *cot)
            want = convlstm_bwd_reference(*args, y_p, cs_p, *cot)
            torch.cuda.synchronize()
            tag = f"{name} B={b} T={t} {str(dtype).removeprefix('torch.')}"
            e_fwd = max_err(got_f, (y_p, cs_p, h_p, c_p, gs_p))
            e_bwd = max(rel_err([a], [w]) for a, w in zip(got, want))
            errs[tag] = {"forward_max_abs_err": e_fwd, "grad_err_of_largest": e_bwd}
            if not (e_fwd <= TOL[dtype] and e_bwd <= GRAD_TOL[dtype]):
                failed.append(tag)
    t = cfg.total_time_steps
    for i, (name, (feat, u)) in enumerate(lstm_layers(cfg).items()):
        act = "sigmoid" if name == "lstm3" else "tanh"
        for dtype in (torch.float32, torch.bfloat16):
            args = lstm_inputs(feat, u, dtype, dev, seed=900 + i, b=b, t=t)
            g = torch.Generator().manual_seed(950 + i)
            y_p, cs_p, h_p, c_p = lstm_scan_reference(*args, act)
            got_f = lstm_fwd(*args, act, with_c_stack=True)
            cot = (torch.randn(y_p.shape, generator=g).to(dev, dtype), torch.randn(h_p.shape, generator=g).to(dev),
                   torch.randn(c_p.shape, generator=g).to(dev))
            got = lstm_bwd(*args, y_p, cs_p, *cot, act)
            want = lstm_bwd_reference(*args, y_p, cs_p, *cot, act)
            torch.cuda.synchronize()
            tag = f"{name} U={u} B={b} T={t} {str(dtype).removeprefix('torch.')}"
            e_fwd = max_err(got_f, (y_p, cs_p, h_p, c_p))
            e_bwd = max(rel_err([a], [w]) for a, w in zip(got, want))
            errs[tag] = {"forward_max_abs_err": e_fwd, "grad_err_of_largest": e_bwd}
            if not (e_fwd <= TOL[dtype] and e_bwd <= GRAD_TOL[dtype]):
                failed.append(tag)
    g = torch.Generator().manual_seed(b)
    c = (torch.randn(SINK_K, b, b, generator=g).abs() * 3.0 + 0.1).to(dev)
    cot = torch.randn(SINK_K, generator=g).to(dev)
    cost_k, uh_k, vh_k = sinkhorn_fwd(c, SINK_EPS, cfg.sinkhorn_l)
    cbar_k = sinkhorn_bwd(c, uh_k, vh_k, cot, SINK_EPS)
    cp = c.clone().requires_grad_(True)
    cost_p, uh_p, vh_p = sinkhorn_fwd_reference(cp, SINK_EPS, cfg.sinkhorn_l)
    (cbar_p,) = torch.autograd.grad((cost_p * cot).sum(), cp)
    cost_p, uh_p, vh_p = cost_p.detach(), uh_p.detach(), vh_p.detach()
    torch.cuda.synchronize()
    e_cost = float(((cost_k - cost_p).abs() / cost_p.abs()).max())
    e_hist = max(float((uh_k - uh_p).abs().max()), float((vh_k - vh_p).abs().max()))
    e_cbar = float((cbar_k - cbar_p).abs().max())
    tag = f"sinkhorn [{SINK_K}, {b}, {b}] L={cfg.sinkhorn_l} float32"
    errs[tag] = {"cost_rel_err": e_cost, "history_max_err": e_hist, "c_bar_max_err": e_cbar}
    if not (e_cost <= SINK_TOL["cost_rtol"] and e_hist <= SINK_TOL["hist_atol"]
            and bool(((cbar_k - cbar_p).abs() <= SINK_TOL["cbar_atol"] + SINK_TOL["cbar_rtol"] * cbar_p.abs()).all())
            and e_cbar <= SINK_TOL["cbar_of_largest"] * float(cbar_p.abs().max())):
        failed.append(tag)
    print(json.dumps({"kernels_at_preset": {"preset": cfg.dname, "tol": {
        "forward_abs": {str(d).removeprefix("torch."): v for d, v in TOL.items()},
        "grad_of_largest": {str(d).removeprefix("torch."): v for d, v in GRAD_TOL.items()}, "sinkhorn": SINK_TOL},
        "errors": errs}}), flush=True)
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions at {cfg.dname}: {failed}")


def check_data_preset(name, root, tmp, dev, check_kernels):
    """Phase 11c-e at the preset ``name`` on the fixtures under ``root``:
    the CLI (TRAINER_STEPS 'pallas' steps, samples with PSNR/SSIM on the
    test batch, every kernel's calls and launches those of the steps and
    the samples, derived from the preset's T); 'pallas' against 'scan'
    from one state, z and the first batch the reader yields, f32 and bf16,
    counted; with ``check_kernels`` each kernel against its plain version
    at this batch and T; one bf16 iteration of each engine traced."""
    cfg = dataclasses.replace(get_preset(name), data_path=str(root))
    per_step = pallas_counts(cfg)
    batches, test = make_dataset(cfg)
    first = next(batches)
    if test is None or test.shape != first.shape or first.shape[-1] != 3:
        raise RuntimeError(f"{name}: batch {first.shape}, test batch {None if test is None else test.shape}")
    summary, launched = check_trainer_cli(tmp / "runs", root, tag=f"{name}_cli", per_step=per_step, preset=name,
                                          dname=name)
    state0, video, zs, steps, per_iter, _ = check_engines(cfg, dev, per_step=per_step, video=first, preset=name)
    if check_kernels:
        check_kernels_at(cfg, dev)
    check_traces(state0, video, zs, (("scan", steps["scan"]), ("pallas", steps["pallas"])), "lstm",
                 f"{name} bf16 iteration", required=TC_KERNELS + LSTM_TC_KERNELS)
    print(json.dumps({f"{name}_dataset": {
        "preset": name, "batch": list(first.shape), "kernel_impl": "pallas", "compute_dtype": cfg.compute_dtype,
        "cli_launches": launched, "expected_per_iteration": per_step, "per_iteration": per_iter[0],
        "cli_summary": summary,
    }}), flush=True)


def check_datasets(dev):
    """Phase 11: the readers and the RGB presets on the card."""
    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2")}
    print(f"[datasets] on this host: PIL {'present' if have['PIL'] else 'absent'}, "
          f"cv2 {'present' if have['cv2'] else 'absent'}", flush=True)
    presets = DATA_PRESETS if have["PIL"] else DATA_PRESETS[:1]
    if not have["PIL"]:
        print("[datasets] mazes not run: its reader decodes JPEG frames with PIL, which this host lacks",
              flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        shards = write_data_fixtures(root, have["PIL"])
        readers = check_readers(root, shards)
        for i, name in enumerate(presets):
            check_data_preset(name, root, Path(tmp) / name, dev, check_kernels=i == 0)
    print(json.dumps({"datasets": {"have": have, "readers": readers,
                                   "not_run": [] if have["PIL"] else ["mazes: no PIL on this host"]}}), flush=True)


# Phase 12, serving: cli.sample draws SERVING_NUM videos with best-of-K
# over SERVING_K rollouts; the graph rollout, the loaded artifact and the
# live rollout are compared at each of SERVING_BATCHES.
SERVING_NUM, SERVING_K = 32, 4
SERVING_BATCHES = (32, 7)


def direct_scan(xconv, h0, c0, rec_kernel, bias, rec_masks=None):
    """The inference recurrence as it ran before the registered operator:
    ``convlstm_fwd`` called straight from the layer."""
    y, _, h, c, *_ = convlstm_fwd(xconv, h0, c0, rec_kernel, bias, rec_masks=rec_masks)
    return y, (h, c)


@contextlib.contextmanager
def recurrence(scan):
    """``ConvLSTM2D`` runs ``scan`` in place of ``convlstm_scan`` inside."""
    saved = model_layers.convlstm_scan
    model_layers.convlstm_scan = scan
    try:
        yield
    finally:
        model_layers.convlstm_scan = saved


def run_quiet(fn, *args, **kwargs):
    """``(fn's result, its stdout lines)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue().splitlines()


def sample_without_png(argv, dev):
    """cli.sample's steps but its film-strip PNG (matplotlib): load,
    rollout and best-of-K through the graph rollout, the metrics line, the
    GIF (PIL)."""
    args = sample_cli.build_parser().parse_args(argv)
    cfg, state, params, test_batch = sample_cli.load(args, dev)
    video, metrics = sample_cli.predict(graph_rollout(cfg, params, device=dev), params, test_batch, cfg,
                                        seed=args.seed, metrics_k=args.metrics_k, device=dev)
    print(sample_cli.metrics_line(metrics, args.metrics_k))
    os.makedirs(args.out, exist_ok=True)
    print(f"wrote {sample_cli.write_gif(video.cpu().numpy(), args.out, args.fps)} (step {state.step})")
    return 0


def check_serving(base, dev):
    """Phase 12, the serving entry points at mmnist_full, B=32, bf16, from a
    checkpoint of the seeded state: cli.sample (--num 32 --metrics_k 4,
    the graph rollout) and cli.export --check (difference exactly 0),
    counted from zero as the main path; the same sample's rollout and
    best-of-K through the eager rollout, counted (5 x 120 launches) and
    equal to the graph's; the graph rollout bit-equal to eager, the loaded
    artifact bit-equal to the live rollout and within ROLLOUT_TOL of the
    plain one, at B = 32 and 7; the ConvLSTM forward's tensor-core kernel
    in a trace of the artifact's replay, once a step.  Returns the main
    path's counts."""
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    print(f"[serving] matplotlib {'present' if have_mpl else 'absent: cli.sample driven through its functions, no PNG'}",
          flush=True)
    calls = 4 + 8 * base.pred_time_steps
    launches = 4 * base.int_time_steps + 8 * base.pred_time_steps
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_fixture(tmp / "data")
        state = create_train_state(base, device=dev)
        save_checkpoint(str(tmp / "ckpt"), state)
        sample_argv = ["--preset", PRESET, "--ckpt", str(tmp / "ckpt"), "--data_path", str(tmp / "data"),
                       "--out", str(tmp / "samples"), "--num", str(SERVING_NUM), "--metrics_k", str(SERVING_K)]
        export_argv = ["--preset", PRESET, "--ckpt", str(tmp / "ckpt"), "--out", str(tmp / "model.kccot"),
                       "--check"]

        # The main path, counted: the sampler (a graph's warm-up and capture
        # at B = 32, then replays) and the exporter's check (the artifact's
        # warm-up and capture at B = 2, and one live rollout).
        reset_counts()
        if have_mpl:
            rc, sample_lines = run_quiet(sample_cli.main, sample_argv, device=dev)
        else:
            rc, sample_lines = run_quiet(sample_without_png, sample_argv, dev)
        rc_export, export_lines = run_quiet(export_cli.main, export_argv, device=dev)
        torch.cuda.synchronize()
        main_counts = counts()
        images = sorted(p.name for p in (tmp / "samples").iterdir())
        want_images = ["rollout.gif", "rollout_strips.png"] if have_mpl else ["rollout.gif"]
        best = json.loads(sample_lines[0])
        check = [line for line in export_lines if line.startswith("check:")]
        print(json.dumps({"serving_cli": {"sample_rc": rc, "sample_lines": sample_lines, "images": images,
                                          "export_rc": rc_export, "export_lines": export_lines,
                                          "launches": main_counts}}), flush=True)
        if rc != 0 or images != want_images or best["best_of_k"] != SERVING_K:
            raise RuntimeError(f"cli.sample: rc {rc}, images {images}, line {sample_lines[:1]}")
        if not all(np.isfinite([best["psnr"], best["ssim"], *best["psnr_per_step"], *best["ssim_per_step"]])):
            raise RuntimeError(f"cli.sample: best-of-K not finite: {best}")
        if rc_export != 0 or len(check) != 1 or not check[0].startswith("check: max|artifact - live rollout| = 0.0 "):
            raise RuntimeError(f"cli.export --check: rc {rc_export}, {export_lines}")
        want = {n: [0, 0] for n in COUNTED}
        want["convlstm_fwd"] = [5 * calls, 5 * launches]
        if main_counts != want:
            raise RuntimeError(f"serving main path: (calls, launches) {main_counts}, expected {want}")

        # The sampler's rollout and best-of-K through the eager rollout:
        # 1 + K rollouts, each counted, and the same line as the graph's.
        args = sample_cli.build_parser().parse_args(sample_argv)
        cfg, _, params, test_batch = sample_cli.load(args, dev)
        eager = build_rollout(cfg, device=dev)
        reset_counts()
        _, metrics = sample_cli.predict(eager, params, test_batch, cfg, seed=args.seed, metrics_k=SERVING_K,
                                        device=dev)
        torch.cuda.synchronize()
        eager_counts = counts()
        want["convlstm_fwd"] = [(1 + SERVING_K) * calls, (1 + SERVING_K) * launches]
        if eager_counts != want or sample_cli.metrics_line(metrics, SERVING_K) != sample_lines[0]:
            raise RuntimeError(f"eager sample: {eager_counts} (expected {want}), "
                               f"{sample_cli.metrics_line(metrics, SERVING_K)} against {sample_lines[0]}")

        # The graph and the artifact against the live and the plain rollouts.
        serve = load_rollout(str(tmp / "model.kccot"))
        artifact_mb = (tmp / "model.kccot").stat().st_size / 1e6
        graphed = graph_rollout(cfg, params, device=dev)
        plain = build_rollout(cfg, device=dev, plain=True)
        m = cfg.model
        diffs, inputs = {}, {}
        for b in SERVING_BATCHES:
            context = torch.rand(b, m.x_height, cfg.int_time_steps, m.x_width, m.n_channels,
                                 generator=torch.Generator().manual_seed(b)).to(dev)
            z = serve.noise(b, seed=b)
            inputs[b] = context, z
            live = eager(params, context, z=z)
            with recurrence(direct_scan):
                direct = eager(params, context, z=z)
            via_graph = graphed(params, context, z=z)
            via_artifact = serve(context, seed=b)
            via_program = serve.run(context, z)
            reference = plain(params, context, z=z)
            torch.cuda.synchronize()
            shape = (b, m.x_height, cfg.int_time_steps + cfg.pred_time_steps, m.x_width, m.n_channels)
            diffs[b] = {
                "graph_equals_eager": bool(torch.equal(via_graph, live)),
                "direct_equals_eager": bool(torch.equal(direct, live)),
                "artifact_equals_live": bool(torch.equal(via_artifact, live)),
                "artifact_program_equals_live": bool(torch.equal(via_program, live)),
                "artifact_vs_plain_max_abs": float((via_artifact - reference).abs().max()),
            }
            bad = [k for k, v in diffs[b].items() if v is False]
            if bad or tuple(via_artifact.shape) != shape or not bool(torch.isfinite(via_artifact).all()):
                raise RuntimeError(f"serving at B={b}: {diffs[b]}, shape {tuple(via_artifact.shape)}")
            if not torch.equal(via_artifact[:, :, : cfg.int_time_steps], context):
                raise RuntimeError(f"serving at B={b}: the artifact changed the context frames")
            if not diffs[b]["artifact_vs_plain_max_abs"] <= ROLLOUT_TOL[torch.bfloat16]:
                raise RuntimeError(f"serving at B={b}: artifact vs plain rollout {diffs[b]}")

        # The artifact's replay in a trace: the forward kernel, once a step.
        context, _ = inputs[SERVING_BATCHES[0]]
        serve(context, seed=0)
        n_events, n_by_name = profiled(lambda: serve(context, seed=0), TC_KERNELS[:1], "artifact replay")
        replay_launches = sum(n for name, n in n_by_name.items() if "convlstm" in name)
    out = {
        "preset": PRESET, "compute_dtype": cfg.compute_dtype, "batches": list(SERVING_BATCHES),
        "best_of_k_line": best, "main_path_launches": main_counts, "eager_sample_launches": eager_counts,
        "per_rollout": {"calls": calls, "launches": launches}, "checks": diffs,
        "artifact_replay_trace": {"convlstm_kernel_events": replay_launches, "device_events": n_events},
        "artifact_mb": artifact_mb,
    }
    print(json.dumps({"serving": out}), flush=True)
    if replay_launches != launches:
        raise RuntimeError(f"the artifact's replay traced {replay_launches} ConvLSTM kernels, expected {launches}")
    return main_counts


# Phase 13, the fused discriminators (``fused_discriminators=True``).  The
# LSTM kernels' instance axis first: FUSED_N instances (the four
# discriminator passes), each its own R and b, at lstm1-3 (B=32, T=20)
# and at the widths past 64 units, f32 and bf16; each instance must equal
# the one-instance call on its slice to the bit (a block computes its
# instance as that call does), and all within TOL / GRAD_TOL of the plain
# versions.
FUSED_N = 4


def fused_counts(cfg):
    """(calls, launches) of each kernel in one fused 'pallas' iteration:
    ``pallas_counts``' but the LSTM's, whose 3 layers run once for the
    four passes in each phase, forward and backward (6 and 6, one launch
    each at U <= 64, against 24 and 18)."""
    return {**pallas_counts(cfg), "lstm_fwd": (6, 6), "lstm_bwd": (6, 6)}


FUSED_COUNTS = fused_counts(get_preset(PRESET))
# Fused against sequential 'pallas' iterations, same state, video and z.
# They differ only in summation order: the stacked convs run as one
# grouped conv (other algorithms; conv1's four single-channel instances
# make a depthwise conv), the input products as one batched product, and
# the statistics chain is rebuilt as mu*first + second - mu*old instead
# of chained.  f32 (TF32 off): ENGINE_TOL's float32 limits,
# argued there for the same magnifier (the BatchNorms' backward), and the
# new state's statistics at rtol 1e-4 / atol 1e-5, the tolerances of the
# JAX package's own fused-against-sequential test.  bf16: the losses
# within ENGINE_TOL's bf16 rtol, and pM at 1e-2: pM sums |the batch mean
# of m's increments| / std_j over 19 x 8 (t, j), each mean a small
# difference of bf16-rounded sigmoid outputs, so one output rounded one
# ulp apart (2**-8 = 3.9e-3 in [0.5, 1)) moves two terms by 3.9e-3 / (32
# std_j) each: 1.3e-3 of pM measured on the H100, so a few such
# roundings are 1e-2.  The rest is reported.
FUSED_TOL = {
    "float32": {**ENGINE_TOL["float32"], "stats_rtol": 1e-4, "stats_atol": 1e-5},
    "bfloat16": {"loss_rtol": ENGINE_TOL["bfloat16"]["loss_rtol"], "pm_rtol": 1e-2},
}


def check_lstm_instanced(dev):
    """The instanced LSTM kernels (FUSED_N instances in one call) against
    their plain versions and against one-instance calls on each slice, to
    the bit; launches a call (forward 1, backward 1 up to U = 64, else 2)."""
    layers = [(n, u, "sigmoid" if n == "lstm3" else "tanh") for n, (_, u) in lstm_layers(get_preset(PRESET)).items()]
    layers += [(f"wide{u}", u, "tanh") for u in LSTM_WIDE]
    out, failed = {}, []
    for name, u, act in layers:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name} U={u} {act} {str(dtype).removeprefix('torch.')}"
            args = [torch.stack(a).contiguous() for a in zip(*(
                lstm_inputs(0, u, dtype, dev, seed=700 + u + i) for i in range(FUSED_N)))]
            g = torch.Generator().manual_seed(800 + u)
            y_p, cs_p, h_p, c_p = lstm_scan_reference(*args, act)
            cot = (torch.randn(y_p.shape, generator=g).to(dev, dtype), torch.randn(h_p.shape, generator=g).to(dev),
                   torch.randn(c_p.shape, generator=g).to(dev))
            bwd_args = (*args, y_p, cs_p, *cot)
            before = (lstm_fwd.launches, lstm_bwd.launches)
            fwd_k = lstm_fwd(*args, act, with_c_stack=True)
            bwd_k = lstm_bwd(*bwd_args, act)
            launches = [lstm_fwd.launches - before[0], lstm_bwd.launches - before[1]]
            want = lstm_bwd_reference(*bwd_args, act)
            single_f = [lstm_fwd(*(a[i] for a in args), act, with_c_stack=True) for i in range(FUSED_N)]
            single_b = [lstm_bwd(*(a[i] for a in bwd_args), act) for i in range(FUSED_N)]
            torch.cuda.synchronize()
            differ = [f"{part}[{i}].{j}" for part, got, single in (("fwd", fwd_k, single_f), ("bwd", bwd_k, single_b))
                      for i in range(FUSED_N) for j, t in enumerate(got) if not torch.equal(t[i], single[i][j])]
            e_fwd = max_err(fwd_k, (y_p, cs_p, h_p, c_p))
            e_bwd = {n: rel_err([a], [b]) for n, a, b in zip(("dx", "dh0", "dc0", "dR", "db"), bwd_k, want)}
            out[tag] = {"launches": launches, "fwd_max_abs_err": e_fwd, "grad_err_over_largest": e_bwd,
                        "bitwise_equal_to_single": not differ}
            print(f"[lstm instanced] {tag}: " + json.dumps(out[tag]), flush=True)
            if differ or launches != [1, 1 if u <= 64 else 2] or not (
                    e_fwd <= TOL[dtype] and max(e_bwd.values()) <= GRAD_TOL[dtype]):
                failed.append(f"{tag}: launches {launches}, not bitwise {differ[:6]}")
    if failed:
        raise RuntimeError(f"instanced LSTM kernels: {failed}")
    return out


def check_fused(base, dev):
    """Phase 13: the instanced LSTM kernels, then one fused 'pallas'
    iteration against one sequential from the same state, video and z in
    f32 and bf16 (losses, pM, every group's Adam first moment, i.e. half
    the gradient, and both statistics chains), each counted from zero
    around its run; then one iteration of each traced in the preset's
    dtype (in bf16 the LSTM tensor-core kernels by name).  Prints the
    ``fused_discriminators`` line."""
    instanced = check_lstm_instanced(dev)
    checks, counted = {}, {}
    for cdt in ("float32", base.compute_dtype):
        cfg = dataclasses.replace(base, compute_dtype=cdt, kernel_impl="pallas")
        state0, video, zs = training_inputs(cfg, dev)
        steps = {name: build_train_step(dataclasses.replace(cfg, fused_discriminators=name == "fused"), device=dev)
                 for name in ("sequential", "fused")}
        runs = {}
        for name, step in steps.items():
            reset_counts()
            st, met = step(state0, video, z=zs[0])
            torch.cuda.synchronize()
            counted[name] = counts()
            if not _all_finite(st, met):
                raise RuntimeError(f"{cdt} {name}: non-finite loss, pM, parameter or statistic")
            runs[name] = (met, st)
        for name, per in (("fused", FUSED_COUNTS), ("sequential", PALLAS_COUNTS)):
            if counted[name] != {n: list(c) for n, c in per.items()}:
                raise RuntimeError(f"{cdt} {name} iteration: (calls, launches) {counted[name]}, expected {per}")
        cmp, engines_ok = compare_engines(runs["fused"], runs["sequential"], ENGINE_TOL[cdt])
        tol = FUSED_TOL[cdt]
        stats_ok, cmp["max_abs_dstats"] = True, {}
        for key in ("h_stats", "m_stats"):
            a, b = getattr(runs["fused"][1], key), getattr(runs["sequential"][1], key)
            cmp["max_abs_dstats"][key] = max(float((a[k] - b[k]).abs().max()) for k in b)
            if "stats_rtol" in tol:
                stats_ok &= all(bool(((a[k] - b[k]).abs() <= tol["stats_atol"] + tol["stats_rtol"] * b[k].abs()).all())
                                for k in b)
        (lf, ls), (pf, ps) = cmp["sinkhorn_loss"], cmp["pm"]
        ok = abs(lf - ls) <= tol["loss_rtol"] * abs(ls) and abs(pf - ps) <= tol["pm_rtol"] * abs(ps)
        if cdt == "float32":
            ok = ok and engines_ok and stats_ok
        checks[cdt] = {"tol": tol, **cmp}
        print(json.dumps({"fused_check": {"compute_dtype": cdt, **checks[cdt]}}), flush=True)
        if not ok:
            raise RuntimeError(f"{cdt}: fused and sequential iterations disagree: {cmp}")

    # One iteration of each traced, the preset's dtype (the last loop's steps).
    traced = {}
    for name, step in steps.items():
        n_events, n_by_name = profiled(
            lambda: step(state0, video, z=zs[0]), LSTM_TC_KERNELS if base.compute_dtype == "bfloat16" else (),
            f"fused_discriminators, {name}")
        traced[name] = {"device_events": n_events,
                        "lstm_kernel_events": sum(n for k, n in n_by_name.items()
                                                  if re.search(r"\blstm_(fwd|bwd|wgrad)", k))}
    lstm_counts = {name: {k: counted[name][k] for k in ("lstm_fwd", "lstm_bwd")} for name in counted}
    print(json.dumps({"fused_discriminators": {
        "preset": PRESET, "compute_dtype": base.compute_dtype, "instances": FUSED_N,
        "lstm_calls_launches": lstm_counts, "counts": counted, "checks": checks,
        "instanced_lstm": instanced, "traced": traced,
    }}), flush=True)


# Phase 14: the meshes.  Ranks share the one card, so they talk over gloo
# (NCCL refuses two ranks on one device); NCCL runs at world 1.
PAR_WORLDS = (2, 4)
# bf16 against the one-device step: the losses only, at ENGINE_TOL's bf16
# rtol (the ranks' convs and products at half the batch may take other
# algorithms, rounding a bf16 value one ulp apart).
PAR_BF16_LOSS_RTOL = 1e-3
PAR_STEPS = 4  # the trainer's resume on the mesh: 2 + checkpoint + 2 against 4


def seq_counts(cfg, s):
    """(calls, launches) of each kernel on one rank of a seq mesh of ``s``
    ranks: ``pallas_counts`` with each ConvLSTM over T / s of its steps
    (the encoder 10 of 20, the decoder 5 of 10 at mmnist_full); the
    discriminators and the Sinkhorn solves run whole on every rank."""
    t, tp = cfg.total_time_steps // s, cfg.pred_time_steps // s
    return pallas_counts(dataclasses.replace(cfg, total_time_steps=t, int_time_steps=t - tp))


def state_checksum(state):
    """CRC of every tensor and integer of a train state (equal states,
    equal sums; compared across ranks)."""
    crc = zlib.crc32(np.asarray([state.step, state.rng], np.int64).tobytes())
    for v in state_tensors(state).values():
        crc = zlib.crc32(v.detach().cpu().numpy().tobytes(), crc)
    return crc


def comm_counts():
    return {op: dict(c) for op, c in comm.COUNTERS.items() if c["calls"]}


def rows_of(video, mesh):
    n = video.shape[0] // mesh.data
    return video[mesh.data_rank * n : (mesh.data_rank + 1) * n]


def mesh_mode(rank, dev, inputs, cfg, build, mesh, want_counts, inject_z=True):
    """One iteration of a mesh mode on this rank from ``inputs``, the
    seeded state, video and z of phase 8, counted from zero; on rank 0 the
    one-device step's iteration too (eager, as the mode's), and their comparison (f32:
    ENGINE_TOL; bf16: the losses at PAR_BF16_LOSS_RTOL).  Returns the
    record."""
    state0, video, zs = inputs
    step = build(cfg, mesh)
    state = replicate_state(state0, mesh)
    rows = rows_of(video, mesh)
    z = zs[0] if inject_z else None
    reset_counts()
    comm.reset_counters()
    st, met = step(state, rows, z=z)
    torch.cuda.synchronize()
    rec = {"counts": counts(), "comm_one_iteration": comm_counts(), "loss": float(met["sinkhorn_loss"]),
           "pm": float(met["pm"]), "finite": _all_finite(st, met), "checksum": state_checksum(st)}
    rec["counts_ok"] = want_counts is None or rec["counts"] == {n: list(c) for n, c in want_counts.items()}
    if rank == 0 and inject_z:
        one = build_train_step(cfg, device=dev, placement=Placement())  # eager, as the mesh steps are
        st1, met1 = one(state0, video, z=zs[0])
        torch.cuda.synchronize()
        cmp, ok = compare_engines((met, st), (met1, st1), ENGINE_TOL[cfg.compute_dtype])
        if cfg.compute_dtype != "float32":
            (lm, l1), (pm, p1) = cmp["sinkhorn_loss"], cmp["pm"]
            ok = abs(lm - l1) <= PAR_BF16_LOSS_RTOL * abs(l1)
        rec["vs_one_device"] = {**cmp, "ok": ok}
        del st1, met1
    del st, met
    return rec


def parallel_ranks(rank, dev, tmp):
    """Phase 14, one rank of a job whose ranks share the card over gloo:
    at 2 ranks the exact mode and the seq mode at S = 2 (f32 and bf16,
    each against the one-device step), the per-shard mode (bf16) and the
    trainer's resume on the data mesh; at 4 ranks the data 2 x seq 2 mesh
    (f32 and bf16, each against the one-device step)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    world = dist.get_world_size()
    base = dataclasses.replace(get_preset(PRESET), kernel_impl="pallas")
    f32 = dataclasses.replace(base, compute_dtype="float32")
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(), "modes": {}}
    if world == 2:
        data, seq = make_mesh(2, device=dev), seq_mesh(2, device=dev)
        plans = [
            ("exact_f32", f32, build_sharded_train_step, data, PALLAS_COUNTS, True),
            ("exact_bf16", base, build_sharded_train_step, data, PALLAS_COUNTS, True),
            ("local_bf16", dataclasses.replace(base, global_batch_sinkhorn=False), build_sharded_train_step, data,
             PALLAS_COUNTS, False),
            ("seq_f32", f32, build_seq_train_step, seq, seq_counts(base, 2), True),
            ("seq_bf16", base, build_seq_train_step, seq, seq_counts(base, 2), True),
        ]
    else:
        mesh = data_seq_mesh(2, 2, device=dev)
        plans = [
            ("data2_seq2_f32", f32, build_seq_train_step, mesh, seq_counts(base, 2), True),
            ("data2_seq2_bf16", base, build_seq_train_step, mesh, seq_counts(base, 2), True),
        ]
    inputs = training_inputs(base, dev)  # the state's parameters are f32 under either compute dtype
    for name, cfg, build, mesh, want, inject_z in plans:
        out["modes"][name] = mesh_mode(rank, dev, inputs, cfg, build, mesh, want, inject_z)
        torch.cuda.empty_cache()
    if world == 2:
        out["trainer_resume"] = mesh_resume(rank, dev, tmp, base, inputs[0])
    return out


def mesh_resume(rank, dev, tmp, base, state0):
    """``Trainer`` on the 2-rank data mesh: 2 steps, rank 0's checkpoint,
    a new trainer restored on every rank, 2 more, against 4 straight on the
    same batches, cuDNN deterministic: this rank's state's checksum for
    each, and the steps' losses (rank 0 logs them)."""
    mesh = make_mesh(2, device=dev)
    data = bouncing_blobs(base.batch_size * PAR_STEPS, base.total_time_steps, seed=5)
    batches = [data[i * base.batch_size : (i + 1) * base.batch_size] for i in range(PAR_STEPS)]
    half = PAR_STEPS // 2
    cfg = dataclasses.replace(base, out_dir=str(tmp), ckpt_freq=half, save_freq=10**9)
    torch.backends.cudnn.deterministic = True
    try:
        state0 = replicate_state(state0, mesh)
        straight, s_sum = Trainer(dataclasses.replace(cfg, run_name="straight"), mesh=mesh).fit(
            iter(batches), state=state0, max_steps=PAR_STEPS)
        Trainer(dataclasses.replace(cfg, run_name="first"), mesh=mesh).fit(
            iter(batches[:half]), state=state0, max_steps=half)
        dist.barrier()  # rank 0's checkpoint is on disk
        resumed, r_sum = Trainer(dataclasses.replace(
            cfg, run_name="resumed", checkpoint=True, ckpt_path=str(Path(tmp) / "first" / "ckpt")), mesh=mesh).fit(
            iter(batches[half:]), max_steps=PAR_STEPS)
    finally:
        torch.backends.cudnn.deterministic = False
    out = {"straight": state_checksum(straight), "resumed": state_checksum(resumed),
           "steps": [s_sum["steps"], r_sum["steps"]], "status": [s_sum["status"], r_sum["status"]]}
    if rank == 0:
        out["losses"] = [read_metrics(Path(tmp) / n)["Sinkhorn Loss"] for n in ("straight", "resumed")]
    return out


def check_nccl_world1(dev):
    """The NCCL code path at world 1 (the one card): the exact mode's
    step in bf16 'pallas' on a 1-rank NCCL mesh (its gradient all-reduce
    and the state's broadcast and checksum gather through NCCL) equal to
    the one-device step to the bit."""
    cfg = dataclasses.replace(get_preset(PRESET), kernel_impl="pallas")
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(0, 1, f"file://{tmp}/store", local_world_size=1, device="cuda")
        try:
            backend = dist.get_backend()
            mesh = make_mesh(1, device=dev)
            state0, video, zs = training_inputs(cfg, dev)
            comm.reset_counters()
            st, met = build_sharded_train_step(cfg, mesh)(replicate_state(state0, mesh), video, z=zs[0])
            torch.cuda.synchronize()
            used = comm_counts()
        finally:
            dist.destroy_process_group()
    st1, met1 = build_train_step(cfg, device=dev)(state0, video, z=zs[0])
    same = state_checksum(st) == state_checksum(st1) and float(met["sinkhorn_loss"]) == float(met1["sinkhorn_loss"])
    out = {"backend": backend, "equal_to_the_bit": same, "collectives": used}
    if backend != "nccl" or not same or "all_reduce" not in used:
        raise RuntimeError(f"mesh at world 1: {out}")
    return out


def check_cli_mesh(tmp):
    """``cli.main --num_devices 2`` on the card: 2 spawned ranks (gloo),
    4 'pallas' steps, checkpoints at 2 and 4 by rank 0, one loss logged a
    step; the summary names the mesh."""
    argv = ["--preset", PRESET, "--dname", "synthetic", "--kernel_impl", "pallas", "--num_devices", "2",
            "--max_steps", str(PAR_STEPS), "--ckpt_freq", str(PAR_STEPS // 2), "--save_freq", str(10**9),
            "--out_dir", str(tmp), "--run_name", "cli_mesh"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_main(argv, device="cuda")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    run_dir = Path(tmp) / "cli_mesh"
    losses = read_metrics(run_dir).get("Sinkhorn Loss", {})
    ckpts = sorted(int(p.stem.split("_")[1]) for p in (run_dir / "ckpt").glob("step_*.pt"))
    rec = {"argv": argv, "rc": rc, "summary": summary, "losses": losses, "checkpoints": ckpts}
    if (rc != 0 or summary["status"] != "completed" or summary["steps"] != PAR_STEPS
            or summary["dist_backend"] != "gloo" or sorted(losses) != list(range(1, PAR_STEPS + 1))
            or not all(np.isfinite(list(losses.values()))) or ckpts != [PAR_STEPS // 2, PAR_STEPS]):
        raise RuntimeError(f"cli.main --num_devices 2: {rec}")
    return rec


def check_parallel(dev):
    """Phase 14: NCCL at world 1, the 2- and 4-rank gloo jobs on the card
    (``parallel_ranks``), the CLI on a 2-rank mesh.  Fails if any rank or
    check fails.  Prints the ``parallel`` line."""
    torch.cuda.empty_cache()
    nccl = check_nccl_world1(dev)
    jobs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for world in PAR_WORLDS:
            jobs[world] = run_ranks(parallel_ranks, world, (str(Path(tmp) / f"w{world}"),), device="cuda",
                                    timeout=600)
        cli = check_cli_mesh(Path(tmp) / "cli")
    failed = []
    for world, ranks in jobs.items():
        for name in ranks[0]["modes"]:
            recs = [r["modes"][name] for r in ranks]
            if not all(r["finite"] and r["counts_ok"] for r in recs):
                failed.append(f"{world} ranks {name}: finite / counts {[(r['finite'], r['counts']) for r in recs]}")
            if len({r["checksum"] for r in recs}) != 1:
                failed.append(f"{world} ranks {name}: the ranks' states differ")
            check = recs[0].get("vs_one_device")
            if check is not None and not check["ok"]:
                failed.append(f"{world} ranks {name}: against the one-device step {check}")
        if "trainer_resume" in ranks[0]:
            res = [r["trainer_resume"] for r in ranks]
            losses = res[0]["losses"]
            if not all(r["straight"] == r["resumed"] and r["steps"] == [PAR_STEPS, PAR_STEPS] for r in res) or (
                    [losses[0][s] for s in range(PAR_STEPS // 2 + 1, PAR_STEPS + 1)]
                    != [losses[1].get(s) for s in range(PAR_STEPS // 2 + 1, PAR_STEPS + 1)]):
                failed.append(f"trainer resume on the mesh: {res}")
    line = {"note": "N ranks share one H100: gloo through the host, each rank's compute on the card; "
                    "NCCL at world 1 only, NCCL across several cards is not run",
            "preset": PRESET, "nccl_world1": nccl, "cli": cli}
    for world, ranks in jobs.items():
        line[f"{world}_ranks"] = {
            "backend": ranks[0]["backend"],
            "checks": {n: {"counts": rec["counts"], "comm_one_iteration": rec["comm_one_iteration"],
                           "loss": rec["loss"], "pm": rec["pm"], "vs_one_device": rec.get("vs_one_device"),
                           "ranks_equal": len({r["modes"][n]["checksum"] for r in ranks}) == 1}
                       for n, rec in ranks[0]["modes"].items()},
            "trainer_resume": ranks[0].get("trainer_resume"),
        }
    print(json.dumps({"parallel": line}), flush=True)
    if failed:
        raise RuntimeError(f"phase 14: {failed}")


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

    lib = load_library()
    print("[build] kernels built and loaded", flush=True)

    def done(phase):
        print(f"[phase] {phase} passed", flush=True)

    check_sass(lib)
    sinkhorn_registers()
    done("sass_and_registers")
    errs = check_layers(dev)
    done("2_layers")
    sink_errs = check_sinkhorn(dev)
    done("sinkhorn")

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
    launches, rollout_k, rollout_p = check_rollout(base, params, context, z, base.compute_dtype)
    # Phase 5: per path, the rollout's kernels in its trace.
    for path, fn in (("plain", rollout_p), ("kernel", rollout_k)):
        check_rollout_trace(path, lambda: fn(params, context, z=z), tc=base.compute_dtype == "bfloat16")
    done("3-5_rollout")

    # Phase 6: the 'scan' training path, through the Sinkhorn kernels and plain.
    state0, video, zs, step_k, step_p, train_launches = check_training(base, dev)
    check_traces(state0, video, zs, (("plain", step_p), ("kernel", step_k)), "sinkhorn", "scan iteration")
    done("6_scan_training")

    # Phase 7: the recurrence kernels' backward and the LSTM kernels alone.
    bwd_errs = check_convlstm_bwd(dev)
    lstm_errs = check_lstm(dev)
    check_lstm_wide(dev)
    done("7_backward_and_lstm")

    # Phase 8: the 'pallas' training path (every recurrence through its
    # kernels) against 'scan', counted per iteration, then traced.
    state0, video, zs, steps, per_iter, pallas_counts = check_engines(base, dev)
    check_traces(state0, video, zs, (("scan", steps["scan"]), ("pallas", steps["pallas"])), "lstm",
                 "'pallas' iteration",
                 required=TC_KERNELS + LSTM_TC_KERNELS if base.compute_dtype == "bfloat16" else ())
    done("8_pallas_training")

    # Phase 9: the trainer's path (CLI, resume), every kernel counted over
    # the CLI's run.
    trainer_counts = check_trainer(base)
    done("9_trainer")

    # Phase 10: the training options (smoothing, sigma annealing, dropout),
    # each path counted from zero around its run.
    check_options(base, dev)
    done("10_options")

    # Phase 11: the readers and the RGB presets robot_push (and mazes, with
    # PIL) through the CLI, each path counted from zero around its run.
    check_datasets(dev)
    done("11_datasets")

    # Phase 12: the serving entry points (cli.sample with best-of-K, the
    # graph rollout, cli.export and the loaded artifact), counted from zero
    # around cli.sample and cli.export --check.
    serving_counts = check_serving(base, dev)
    done("12_serving")

    # Phase 13: the fused discriminators (the LSTM kernels' instance axis,
    # then the fused iteration against the sequential one, each counted
    # from zero around its run, and both traced).
    check_fused(base, dev)
    done("13_fused_discriminators")

    # Phase 14: the meshes (NCCL at world 1, 2 and 4 gloo ranks sharing the
    # card, the CLI on a 2-rank mesh), every rank counted from zero.
    check_parallel(dev)
    done("14_parallel")

    n_samples = len([1] + list(range(TRAINER_EVERY, TRAINER_STEPS + 1, TRAINER_EVERY)))
    launches_over = (f"trainer_cli: {TRAINER_STEPS} 'pallas' iterations + {n_samples} sampling rollouts; "
                     f"serving: cli.sample (--num {SERVING_NUM} --metrics_k {SERVING_K}, a CUDA graph's "
                     "warm-up and capture) + cli.export --check (the artifact's warm-up and capture, "
                     "one live rollout)")

    def entry(name, max_abs_err):
        return dict(KERNELS[name], launches=trainer_counts[name][1] + serving_counts[name][1],
                    launches_over=launches_over, max_abs_err=max_abs_err)

    kernels = [
        entry("convlstm_fwd", max(errs.values())),
        entry("convlstm_bwd", max(bwd_errs.values())),
        entry("lstm_fwd", lstm_errs["fwd"]),
        entry("lstm_bwd", lstm_errs["bwd"]),
        entry("sinkhorn_fwd", sink_errs["fwd"]),
        entry("sinkhorn_bwd", sink_errs["bwd"]),
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
