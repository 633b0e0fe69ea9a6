"""Sampling traffic: requests to the program's ``cli.sample.predict`` over
``train.rollout.graph_rollout``, as the sampler serves them, one at a time
in the order they are due.

With ``rate_per_s`` the requests arrive on a fixed schedule, one every
``1 / rate_per_s`` seconds (an open loop: a slow request delays the ones
due after it), and a request's latency runs from when it was due until its
frames are on the host.  Without it one closed-loop client sends the next
request when the last is back (a batch job such as an evaluation).

A request is ``contexts`` seeded videos sent from the host; it asks for
one conditioned rollout and, with ``metrics_k > 0``, the best-of-K PSNR and
SSIM of ``metrics_k`` more rollouts against the videos' future frames.
Its frames and scores are read back to the host, where the request ends.
Each rollout's noise is drawn by the benchmark's wrapper of the rollout
callable, in one call from the request's generator, so the reference can
take the same.  Set-up makes the weights on the device from the seed and
serves one request of the same shapes with ``warmup_k`` rollouts scored,
which captures the CUDA graph.  The window serves the requests due (in
the closed loop: issued) before ``--seconds`` have passed and ends when
the last one is back.  Requests
whose index is ``r`` modulo ``check_every`` (``r`` drawn from the seed)
are kept for the check: their inputs, noise and answers; with best-of-K
only the first ``checked_max`` of them, whose futures are copied on the
card into a buffer made at set-up, so that the window allocates nothing
for the check.  ``memory_peak_bytes`` is the program's own peak, that
buffer left out.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..blobs import bouncing_blobs
from ..spec import port_config, sub_seed
from .common import make_weights, ranges, rows_of, sync

__all__ = ["run"]


def run(cell, seed: int, seconds: float, trace: bool, device, window=None) -> dict:
    """Set up, serve through the window (or, with ``trace``,
    ``traffic["trace_requests"]`` requests timed and as many inside
    ``window``) and return what the check and the metric readers need
    (``run.py``)."""
    from kccotgan_tpu_torch.cli.sample import predict
    from kccotgan_tpu_torch.train.rollout import graph_rollout

    cfg, tr, ref = cell.cfg, cell.traffic, cell.reference
    m = cfg["model"]
    tc = cfg["int_time_steps"]
    tp = cfg["total_time_steps"] - tc
    b, k = tr["contexts"], tr["metrics_k"]
    videos = bouncing_blobs(tr["videos"], tc + tp if k else tc, m["x_height"], m["x_width"], m["n_channels"],
                            seed=sub_seed(seed, "videos"))
    order = np.random.default_rng(sub_seed(seed, "order")).permutation(len(videos))
    # each request's videos, made contiguous at set-up (the cycled order repeats)
    cycle = [np.ascontiguousarray(videos[rows_of(order, i, b)])
             for i in range(len(videos) // math.gcd(len(videos), b))]
    pcfg = port_config(cfg)
    params, _ = make_weights(ref, cfg, seed, device, ("enc", "dec"))
    mine = {"encoder": {n: v.clone() for n, v in params["enc"].items()},
            "decoder": {n: v.clone() for n, v in params["dec"].items()}}
    graphed = graph_rollout(pcfg, mine, device=device)
    z_shape = (tp, b, 1, m["z_height"], m["z_width"], m["z_channels"])
    span = ranges(trace)
    kept = {"on": False, "z": [], "slot": 0}
    store = {"futures": None}
    future = {}  # a future's shape and type, from the first rollout
    timed = {"on": False, "rollouts": [], "requests": []}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def rollout(p, context, generator=None, z=None):
        z = torch.randn(z_shape, generator=generator, device=device)
        begin = event() if timed["on"] else None
        with span("rollout"):
            video = graphed(p, context, z=z)
        if begin is not None:
            timed["rollouts"][-1].append((begin, event()))
        if not future:
            future.update(shape=tuple(video[:, :, tc:].shape), dtype=video.dtype)
        if kept["on"]:
            kept["z"].append(z)
            if k:
                store["futures"][kept["slot"], len(kept["z"]) - 1].copy_(video[:, :, tc:])
        return video

    def request(i, metrics_k):
        host = cycle[i % len(cycle)]
        begin = None
        if timed["on"]:
            timed["rollouts"].append([])
            begin = event()
        with span("request"):
            batch = torch.from_numpy(host).to(device)
            video, metrics = predict(rollout, mine, batch, pcfg, seed=sub_seed(seed, f"request{i}"),
                                     metrics_k=metrics_k, device=device)
            with span("copy out"):
                frames = video.cpu().numpy()
                scores = None if metrics is None else {"psnr": float(metrics["psnr"]), "ssim": float(metrics["ssim"])}
        if begin is not None:
            timed["requests"].append((begin, event()))
        return host, frames, scores

    request(0, min(k, tr["warmup_k"]))
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    slots = tr["checked_max"] if k else 0
    if slots:  # the kept requests' futures: 1 + K rollouts each
        store["futures"] = torch.empty((slots, 1 + k) + future["shape"], dtype=future["dtype"], device=device)
    sync(device)
    setup_end = time.perf_counter()

    every = tr["check_every"]
    n_trace = tr["trace_requests"]
    r = sub_seed(seed, "check") % (min(every, n_trace) if trace else every)
    latencies, checks, failed = [], [], 0

    def serve(i, due=None):
        nonlocal failed
        kept.update(on=i % every == r and (not k or len(checks) < slots), z=[], slot=len(checks))
        t0 = time.perf_counter()
        host, frames, scores = request(i, k)
        latencies.append(time.perf_counter() - (t0 if due is None else due))
        finite = np.isfinite(frames.sum()) and (scores is None or np.isfinite(list(scores.values())).all())
        failed += int(not finite)
        if kept["on"]:
            checks.append({"index": i, "inputs": host, "frames": frames, "scores": scores, "z": kept["z"],
                           "futures": store["futures"][kept["slot"]] if k else None})

    out = {"setup_end": setup_end}
    rate = tr.get("rate_per_s")
    if not trace:
        i, late = 0, 0.0
        while True:
            if rate:  # the i-th request is due at i / rate; those due in the window are served
                due = setup_end + i / rate
                if due >= setup_end + seconds:
                    break
                time.sleep(max(0.0, due - time.perf_counter()))
                late = max(late, time.perf_counter() - due)
                serve(i, due)
            elif i == 0 or time.perf_counter() < setup_end + seconds:
                serve(i)
            else:
                break
            i += 1
        sync(device)
        elapsed = time.perf_counter() - setup_end
        out["end_to_end"] = {
            "sample_frames_per_s": i * (1 + k) * b * tp / elapsed,
            "sample_p95_ms": float(np.percentile(np.asarray(latencies) * 1e3, 95)),
        }
        out["late_s"] = late  # how far behind its schedule the open loop started a request
    else:
        # the same requests untraced first, timed by the host's clock: the
        # FLOP share reads these, since the profiler slows the host.  Both
        # serve their requests back to back, whatever the arrival schedule,
        # so that they time the service alone
        t0 = time.perf_counter()
        for i in range(n_trace):
            serve(i)
        sync(device)
        timed_s = time.perf_counter() - t0
        red = None
        for attempt in range(1, 4):  # a trace with no device event is CUPTI's loss: trace again
            timed.update(on=True, rollouts=[], requests=[])
            w = window(("request", "rollout", "copy out"))
            t0 = time.perf_counter()
            with w:
                for i in range(attempt * n_trace, (attempt + 1) * n_trace):
                    serve(i)
            elapsed = time.perf_counter() - t0
            red = w.reduce()
            if red is not None:
                break
        events = [(req[0].elapsed_time(req[1]), [s.elapsed_time(e) for s, e in rolls])
                  for req, rolls in zip(timed["requests"], timed["rollouts"])]
        i = n_trace
        out["record"] = {"driver": "sample", "units": n_trace * (1 + k), "batch": b, "window_s": elapsed,
                         "trace": red, "requests": events, "timed_units": n_trace * (1 + k), "timed_s": timed_s}
    out["attempted"], out["failed"] = i, failed
    if cuda:  # the program's peak: set-up's, or the window's without the check's buffer
        held = 0 if store["futures"] is None else store["futures"].numel() * store["futures"].element_size()
        out["memory_peak_bytes"] = max(setup_peak, torch.cuda.max_memory_allocated(device) - held)
    out["evidence"] = {"kind": "sample", "params0": params, "metrics_k": k, "requests": checks,
                       "check_rollouts": tr["check_rollouts"], "seed": seed}
    del graphed, mine
    return out
