#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from ``kccotgan_tpu_torch/csrc`` and drives both
ported paths at the ``mmnist_full`` preset (B=32, 64x64x1, 10 context +
10 predicted frames, bf16 convs, seeded random weights):

* kernels vs their plain PyTorch versions: the ConvLSTM forward at the 8
  ConvLSTM layer shapes (f32 and bf16), the Sinkhorn forward and
  backward at [3, 32, 32] and [3, 128, 128] with L=100;
* the conditioned rollout through the kernel and the plain path, timed,
  and per path where its device time goes (CUDA-graph replay beside the
  eager rollout, and one rollout under ``torch.profiler``);
* two training iterations (``kernel_impl='scan'``, L=100) through the
  Sinkhorn kernels and two through the plain loop from the same state,
  compared, timed in turns, with peak memory and one iteration of each
  under ``torch.profiler``.

Each path's kernel launches are counted from zero around its run.  Every
phase raises on failure.  The last lines are the kernels' JSON record,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from kccotgan_tpu_torch._build import load_library
from kccotgan_tpu_torch.config import get_preset
from kccotgan_tpu_torch.models.cuda_convlstm import convlstm_scan, convlstm_scan_reference
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
    sinkhorn_work,
)
from kccotgan_tpu_torch.train import build_rollout, build_train_step, create_train_state
from kccotgan_tpu_torch.weights import init_generator_params

PRESET = "mmnist_full"
B, T = 32, 10
# name: (spatial H = W, filters f, kernel k) of each ConvLSTM on the rollout path
LAYERS = convlstm_layers(get_preset(PRESET))
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
    },
    "sinkhorn_bwd": {
        "name": "sinkhorn_bwd",
        "route": "cuda",
        "source": "kccotgan_tpu_torch/csrc/sinkhorn_bwd.cu",
        "replaces": "kccotgan_tpu/ot/pallas_sinkhorn.py:138",
    },
}
# The training step's Sinkhorn solves: xy, xx, yy at the batch size.
SINK_K, SINK_L, SINK_EPS = 3, 100, 1.0
# Sinkhorn kernel vs plain version, f32: costs at rtol 1e-5 and c_bar at
# rtol 1e-4 / atol 1e-6 (the JAX package's tolerances for its fused
# kernel against its scan); the duals (of order 1 to 10) at 1e-4 abs.
SINK_TOL = {"cost_rtol": 1e-5, "hist_atol": 1e-4, "cbar_rtol": 1e-4, "cbar_atol": 1e-6}
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


def layer_inputs(hw, f, k, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    xconv = randn(B, T, hw, hw, 4 * f).to(dtype)
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
    return errs, times


def check_rollout(cfg, params, context, z, dtype_name):
    """Phase 3: one rollout through the kernel, counted, and the same
    rollout on the plain path."""
    dev = context.device
    rollout_k = build_rollout(cfg, device=dev)
    rollout_p = build_rollout(cfg, device=dev, plain=True)
    convlstm_scan.launches = sinkhorn_fwd.launches = sinkhorn_bwd.launches = 0
    out = rollout_k(params, context, z=z)
    torch.cuda.synchronize()
    launches = convlstm_scan.launches
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


def device_intervals_ms(prof):
    """Busy time (union of device activity), span and count of the
    device events in a ``torch.profiler`` trace, and time per name."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return busy / 1e3, (spans[-1][1] - spans[0][0]) / 1e3, len(events), by_name


def profile_rollout(name, fn, reps=5):
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
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        fn()
        torch.cuda.synchronize()
    busy_ms, span_ms, n_events, by_name = device_intervals_ms(prof)
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
    the training step's [3, 32, 32] and at B=128, L=100, eps 1: costs and
    histories against the plain forward, c_bar under a random cotangent
    against autograd through the plain loop.  Times both at B=32."""
    errs = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for b in (32, 128):
        g = torch.Generator().manual_seed(b)
        c = (torch.randn(SINK_K, b, b, generator=g).abs() * 3.0 + 0.1).to(dev)
        cot = torch.randn(SINK_K, generator=g).to(dev)
        cost_k, uh_k, vh_k = sinkhorn_fwd(c, SINK_EPS, SINK_L)
        cbar_k = sinkhorn_bwd(c, uh_k, vh_k, cot, SINK_EPS)
        cp = c.clone().requires_grad_(True)
        cost_p, uh_p, vh_p = sinkhorn_fwd_reference(cp, SINK_EPS, SINK_L)
        (cbar_p,) = torch.autograd.grad((cost_p * cot).sum(), cp)
        cost_p, uh_p, vh_p = cost_p.detach(), uh_p.detach(), vh_p.detach()
        torch.cuda.synchronize()
        e_cost = float(((cost_k - cost_p).abs() / cost_p.abs()).max())
        e_hist = max(float((uh_k - uh_p).abs().max()), float((vh_k - vh_p).abs().max()))
        e_cbar = float((cbar_k - cbar_p).abs().max())
        cbar_lim = SINK_TOL["cbar_atol"] + SINK_TOL["cbar_rtol"] * cbar_p.abs()
        print(
            f"[sinkhorn] [{SINK_K}, {b}, {b}] L={SINK_L}: cost rel err {e_cost:.3e}, "
            f"history max err {e_hist:.3e}, c_bar max err {e_cbar:.3e} "
            f"(c_bar max {float(cbar_p.abs().max()):.3e}; tol {SINK_TOL})", flush=True,
        )
        if not (e_cost <= SINK_TOL["cost_rtol"] and e_hist <= SINK_TOL["hist_atol"]):
            raise RuntimeError(f"sinkhorn_fwd disagrees with its plain version at B={b}")
        if not bool(((cbar_k - cbar_p).abs() <= cbar_lim).all()):
            raise RuntimeError(f"sinkhorn_bwd disagrees with autograd through the plain loop at B={b}")
        errs["fwd"] = max(errs["fwd"], float((cost_k - cost_p).abs().max()), e_hist)
        errs["bwd"] = max(errs["bwd"], e_cbar)
        if b == 32:
            times = {
                "fwd_ms": cuda_ms(lambda: sinkhorn_fwd(c, SINK_EPS, SINK_L), reps=20),
                "fwd_plain_ms": cuda_ms(lambda: sinkhorn_fwd_reference(c, SINK_EPS, SINK_L), reps=3),
                "bwd_ms": cuda_ms(lambda: sinkhorn_bwd(c, uh_k, vh_k, cot, SINK_EPS), reps=20),
                "bwd_plain_ms": cuda_ms(lambda: sinkhorn_bwd_reference(c, uh_k, vh_k, cot, SINK_EPS), reps=3),
            }
    print(json.dumps({"sinkhorn_ms_B32_L100": times}), flush=True)
    return errs, times


def _all_finite(state, metrics):
    trees = (state.enc_params, state.dec_params, state.h_params, state.m_params, state.h_stats, state.m_stats)
    return all(bool(torch.isfinite(v).all()) for tree in trees for v in tree.values()) and all(
        bool(torch.isfinite(metrics[k])) for k in ("sinkhorn_loss", "pm")
    )


def check_training(cfg, dev):
    """Two flagship training iterations on the kernel path, counted, and
    two on the plain path from the same state, video and z."""
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
    step_k = build_train_step(cfg, device=dev)
    step_p = build_train_step(dataclasses.replace(cfg, sinkhorn_solver="scan"), device=dev)

    sinkhorn_fwd.launches = sinkhorn_bwd.launches = convlstm_scan.launches = 0
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
                "convlstm_fwd": convlstm_scan.launches}
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


def time_training(card, cfg, state0, video, zs, step_k, step_p):
    """ms per iteration (CUDA events, paths in turns), frames/s, peak
    memory, and one iteration per path under ``torch.profiler``."""
    ms = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        fn = step_k if path == "kernel" else step_p
        ms[path].append(cuda_ms(lambda: fn(state0, video, z=zs[0]), reps=2))
    step_ms = {p: sum(v) / len(v) for p, v in ms.items()}
    frames = cfg.batch_size * cfg.total_time_steps
    peak = {}
    profiles = {}
    for path, fn in (("plain", step_p), ("kernel", step_k)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn(state0, video, z=zs[0])
        torch.cuda.synchronize()
        peak[path] = torch.cuda.max_memory_allocated() / 2**30
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            fn(state0, video, z=zs[0])
            torch.cuda.synchronize()
        busy_ms, span_ms, n_events, by_name = device_intervals_ms(prof)
        sink_ms = sum(t for n, t in by_name.items() if "sinkhorn" in n)
        if (sink_ms > 0) != (path == "kernel"):
            raise RuntimeError(f"training, {path} path: {sink_ms} ms of Sinkhorn kernel in the trace")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        profiles[path] = {
            "eager_ms": step_ms[path],
            "profiled_busy_ms": busy_ms,
            "profiled_span_ms": span_ms,
            "idle_share_eager": 1.0 - busy_ms / step_ms[path],
            "device_events": n_events,
            "sinkhorn_kernel_ms": sink_ms,
            "top_ms": [[n[:80], t] for n, t in top],
        }
        print(json.dumps({"profile_training": {"path": path, **profiles[path]}}), flush=True)
    print(json.dumps({"training_timings": {
        "card": card,
        "preset": PRESET,
        "compute_dtype": cfg.compute_dtype,
        "sinkhorn_l": cfg.sinkhorn_l,
        "step_ms": step_ms,
        "step_ms_runs": ms,
        "training_frames_per_s": {p: frames / (t / 1e3) for p, t in step_ms.items()},
        "peak_memory_gib": peak,
    }}), flush=True)
    return step_ms


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
    load_library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

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
        profile_rollout(path, lambda: fn(params, context, z=z))

    # Phase 6: the training path, through the Sinkhorn kernels and plain.
    state0, video, zs, step_k, step_p, train_launches = check_training(base, dev)
    time_training(card, base, state0, video, zs, step_k, step_p)

    # Bounds of the work timed below: the 8 T=10 layer scans of phase 2,
    # and one Sinkhorn launch at the training step's [3, B, B], L.
    c_bound, c_by = bound_ms(*convlstm_work(LAYERS, B, lambda _: T), PEAK_BF16)
    f_bound, f_by = bound_ms(*sinkhorn_work(SINK_K, base.batch_size, base.sinkhorn_l), PEAK_F32)
    b_bound, b_by = bound_ms(
        *sinkhorn_work(SINK_K, base.batch_size, base.sinkhorn_l, backward=True), PEAK_F32
    )
    kernels = [
        dict(
            KERNELS["convlstm_fwd"],
            launches=launches,
            max_abs_err=max(errs.values()),
            ms=sum(t["kernel_ms"] for t in layer_times.values()),
            plain_ms=sum(t["plain_ms"] for t in layer_times.values()),
            bound_ms=c_bound, bound_by=c_by, library_ms=None,
        ),
        dict(
            KERNELS["sinkhorn_fwd"],
            launches=train_launches["sinkhorn_fwd"],
            max_abs_err=sink_errs["fwd"],
            ms=sink_times["fwd_ms"], plain_ms=sink_times["fwd_plain_ms"],
            bound_ms=f_bound, bound_by=f_by, library_ms=None,
        ),
        dict(
            KERNELS["sinkhorn_bwd"],
            launches=train_launches["sinkhorn_bwd"],
            max_abs_err=sink_errs["bwd"],
            ms=sink_times["bwd_ms"], plain_ms=sink_times["bwd_plain_ms"],
            bound_ms=b_bound, bound_by=b_by, library_ms=None,
        ),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
