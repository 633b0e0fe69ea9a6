#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from ``kccotgan_tpu_torch/csrc``, checks the
ConvLSTM kernel against its plain PyTorch version at the 8 ConvLSTM
layer shapes of the ``mmnist_full`` preset (f32 and bf16), drives the
conditioned rollout at that preset (B=32, 64x64x1, 10 context + 10
predicted frames, bf16, seeded random weights) through the kernel and
through the plain path, times both, and shows per path where the
rollout's device time goes: the rollout replayed as a CUDA graph (device
time without host gaps) beside the eager rollout, and one eager rollout
under ``torch.profiler`` (busy time, span, device kernel count, time per
kernel name).  Every phase raises on failure.
The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Imports neither JAX nor
the JAX package.
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
from kccotgan_tpu_torch.train import build_rollout
from kccotgan_tpu_torch.weights import init_generator_params

PRESET = "mmnist_full"
B, T = 32, 10
# name: (spatial H = W, filters f, kernel k) of each ConvLSTM on the rollout path
LAYERS = {
    "enc1": (32, 32, 6), "enc2": (16, 64, 6), "enc3": (8, 128, 5), "enc4": (4, 256, 5),
    "dec2": (8, 128, 4), "dec3": (16, 64, 6), "dec4": (32, 32, 8), "dec5": (64, 8, 8),
}
# f32 (TF32 off): only the summation order of the recurrent conv differs.
# bf16: a different summation order can round the recurrent conv or y one
# bf16 ulp apart (2**-8 = 3.9e-3 for y in [0.5, 1)); the gates carry such
# a difference over the T steps.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Whole rollout, kernel path vs plain path on the same weights and z: the
# per-layer differences above, fed back through 10 generated frames and
# divided by each LayerNorm's spread.
ROLLOUT_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
KERNEL = {
    "name": "convlstm_fwd",
    "route": "cuda",
    "source": "kccotgan_tpu_torch/csrc/convlstm_fwd.cu",
    "replaces": "kccotgan_tpu/models/pallas_convlstm.py:203",
}


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
    convlstm_scan.launches = 0
    out = rollout_k(params, context, z=z)
    torch.cuda.synchronize()
    launches = convlstm_scan.launches
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
    kernel = dict(
        KERNEL,
        launches=launches,
        max_abs_err=max(errs.values()),
        ms=sum(t["kernel_ms"] for t in layer_times.values()),
        plain_ms=sum(t["plain_ms"] for t in layer_times.values()),
    )
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
