"""Training traffic: the program's ``Trainer.fit`` over seeded videos held
in host memory, cycled in a seeded order, through its ``device_prefetch``.

Set-up makes the weights on the device from the seed, builds one
``Trainer`` and drives its first ``CHECK_STEPS`` steps through ``fit``
on rows that all differ: those steps warm every shape and are the ones
the reference follows.  The same trainer and state then train through
the measured window, a second ``fit``; it ends when the last of its steps
is done.  The noise of each step is drawn by the benchmark (the step's
``z``) from a generator seeded by the run's seed, so the reference can
take the same.  No checkpoint or sample falls in the window; the logs go
under TMPDIR.

On one device the window's batches are issued until ``--seconds`` have
passed.  A configuration with ``num_devices > 1`` trains as that many
ranks of a data mesh (``Trainer(mesh=...)``, one process and card each,
spawned by the program's ``parallel.launch.run_ranks``): every rank makes
the same global batches and noise from the seed and keeps its rows, and
the ranks' window is a number of steps they agree on from the time of two
more warm-up steps, so that it lasts about ``--seconds``.  Rank 0 traces,
counts the collectives' bytes and hands back the evidence; every rank
hands back the forbidden modules its process holds after its window
(``guard``), which the harness reads as it reads its own.
"""

from __future__ import annotations

import contextlib
import math
import tempfile
import time

import numpy as np
import torch

from ..blobs import bouncing_blobs
from ..guard import forbidden_loaded
from ..spec import load_benchmark, load_cell, port_config, sub_seed
from .common import make_weights, ranges, rows_of, sync

__all__ = ["CHECK_STEPS", "GROUPS", "run"]

CHECK_STEPS = 3
GROUPS = ("enc", "dec", "h", "m")


def run(cell, seed: int, seconds: float, trace: bool, device, window=None) -> dict:
    """Set up, train through the window (or, with ``trace``, through
    ``traffic["trace_steps"]`` steps timed and as many inside ``window``)
    and return what the check and the metric readers need (``run.py``)."""
    if cell.cfg["num_devices"] > 1:
        return _run_ranks(cell, seed, seconds, trace, device)
    return _train(cell, seed, seconds, trace, device, window)


def _train(cell, seed, seconds, trace, device, window, mesh=None) -> dict:
    from kccotgan_tpu_torch.train.loop import Trainer
    from kccotgan_tpu_torch.train.state import TrainState, key_from_seed, make_optimizers

    cfg, tr, ref = cell.cfg, cell.traffic, cell.reference
    m = cfg["model"]
    b, t = cfg["batch_size"], cfg["total_time_steps"]
    tp = t - cfg["int_time_steps"]
    videos = bouncing_blobs(tr["videos"], t, m["x_height"], m["x_width"], m["n_channels"],
                            seed=sub_seed(seed, "videos"))
    order = np.random.default_rng(sub_seed(seed, "order")).permutation(len(videos))
    # the batches of one pass over the cycled order, each made contiguous at
    # set-up, so that the window's producer thread only hands them over
    cycle = [np.ascontiguousarray(videos[rows_of(order, i, b)])
             for i in range(len(videos) // math.gcd(len(videos), b))]
    if len(cycle) < CHECK_STEPS:
        raise ValueError(f"{len(videos)} videos give {len(cycle)} distinct batches of {b}; the check needs {CHECK_STEPS}")

    def batch(i):
        return cycle[i % len(cycle)]

    def batches(start, n):
        return iter([batch(i) for i in range(start, start + n)])

    tmp = tempfile.TemporaryDirectory(prefix="port_bench_")
    pcfg = port_config(cfg, out_dir=tmp.name, run_name="train")
    params, stats = make_weights(ref, cfg, seed, device, GROUPS)
    opts = make_optimizers(pcfg)

    def copy(d):
        return {k: v.clone() for k, v in d.items()}

    mine = {g: copy(params[g]) for g in GROUPS}
    state = TrainState(
        step=0, rng=key_from_seed(pcfg.seed),
        enc_params=mine["enc"], dec_params=mine["dec"], h_params=mine["h"], m_params=mine["m"],
        h_stats=copy(stats["h"]), m_stats=copy(stats["m"]),
        enc_opt=opts["enc"].init(mine["enc"]), dec_opt=opts["dec"].init(mine["dec"]),
        h_opt=opts["h"].init(mine["h"]), m_opt=opts["m"].init(mine["m"]),
    )
    trainer = Trainer(pcfg, device=device, mesh=mesh)
    inner = trainer.train_step
    noise = torch.Generator(device=device)
    noise.manual_seed(sub_seed(seed, "noise"))
    z_shape = (b, tp, m["z_height"], m["z_width"], m["z_channels"])  # the global batch's, on a mesh too
    span = ranges(trace and window is not None)
    seen = {"steps": 0, "loss": [], "pm": [], "z": []}

    def step(state, real):
        i = seen["steps"]
        seen["steps"] += 1
        z = (torch.randn(z_shape, generator=noise, device=device), torch.randn(z_shape, generator=noise, device=device))
        with span("train_step"):
            new, metrics = inner(state, real, z=z)
        if i < CHECK_STEPS:
            seen["loss"].append(metrics["sinkhorn_loss"])
            seen["pm"].append(metrics["pm"])
            seen["z"].append(z)
            if i == 0:  # the first gradient as the optimizer got it, in its first moment
                seen["mu1"] = {g: getattr(new, f"{g}_opt").mu for g in GROUPS}
            if i == CHECK_STEPS - 1:
                seen["params3"] = {g: getattr(new, f"{g}_params") for g in GROUPS}
        return new, metrics

    trainer.train_step = step
    state, _ = trainer.fit(batches(0, CHECK_STEPS), state=state)
    start = CHECK_STEPS
    if mesh is not None:  # the window's steps, agreed from two more warm-up steps
        sync(device)
        t0 = time.perf_counter()
        state, _ = trainer.fit(batches(start, 2), state=state)
        sync(device)
        start += 2
        n = torch.tensor([math.ceil(seconds * 2 / (time.perf_counter() - t0))], device=device)
        torch.distributed.all_reduce(n, op=torch.distributed.ReduceOp.MAX, group=mesh.world)
        window_steps = int(n.item())
    sync(device)
    setup_end = time.perf_counter()

    out = {"setup_end": setup_end, "failed": 0}
    if not trace:
        deadline = setup_end + seconds

        def until_deadline():
            i = start
            while time.perf_counter() < deadline:
                yield batch(i)
                i += 1

        state, summary = trainer.fit(until_deadline() if mesh is None else batches(start, window_steps), state=state)
        sync(device)
        elapsed = time.perf_counter() - setup_end
        steps = summary["steps"] - start
        out["attempted"] = steps
        out["failed"] = int(summary["status"] != "completed")
        out["end_to_end"] = {"train_frames_per_s": steps * b * t / elapsed}
    else:
        from kccotgan_tpu_torch.parallel import comm

        n, red = tr["trace_steps"], None
        # the same steps untraced first, timed by the host's clock: the
        # profiler slows a host-bound step, so the FLOP share reads these
        comm.reset_counters()
        t0 = time.perf_counter()
        state, _ = trainer.fit(batches(start, n), state=state)
        sync(device)
        timed_s = time.perf_counter() - t0
        collective_bytes = sum(c["bytes"] for c in comm.COUNTERS.values())
        start += n
        for _ in range(3):  # a trace with no device event is CUPTI's loss: trace again
            w = window(("train_step",)) if window is not None else None
            t0 = time.perf_counter()
            with w if w is not None else contextlib.nullcontext():
                state, summary = trainer.fit(batches(start, n), state=state)
            elapsed = time.perf_counter() - t0
            start += n
            red = w.reduce() if w is not None else None
            agree = torch.tensor([int(red is not None or w is None)], device=device)
            if mesh is not None:  # every rank traces again, or none does
                torch.distributed.all_reduce(agree, op=torch.distributed.ReduceOp.MIN, group=mesh.world)
            if agree.item():
                break
        wait = trainer.timings["prefetch_wait"]
        out["attempted"] = n
        out["failed"] = int(summary["status"] != "completed")
        out["record"] = {"driver": "train", "units": n, "batch": b, "window_s": elapsed, "trace": red,
                         "prefetch_wait_ms": wait["sum_ms"], "timed_units": n, "timed_s": timed_s,
                         "collective_bytes": collective_bytes, "mesh": mesh is not None,
                         "ranks": 1 if mesh is None else mesh.data}
    if torch.device(device).type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["evidence"] = {
        "kind": "train",
        "batches": [batch(i) for i in range(CHECK_STEPS)],
        "z": seen["z"],
        "params0": params,
        "stats0": stats,
        "loss": [float(x) for x in seen["loss"]],
        "pm": [float(x) for x in seen["pm"]],
        "mu1": seen["mu1"],
        "params3": seen["params3"],
    }
    del trainer, state, inner, mine
    tmp.cleanup()
    return out


def _rank(rank, device, workload, bench, root, seed, seconds, trace):
    """One rank of the mesh (``run_ranks`` calls it in its own process)."""
    from kccotgan_tpu_torch.parallel.mesh import make_mesh

    from ..trace import Window

    cell = load_cell(workload, bench, root)
    mesh = make_mesh(cell.cfg["num_devices"], device=device)
    window = Window if trace and rank == 0 and device.type == "cuda" else None
    out = _train(cell, seed, seconds, trace, device, window, mesh)
    # the rank's window has closed: what its process holds now, the harness reads
    out["forbidden"] = [f"rank {rank}: {m}" for m in forbidden_loaded()]
    if rank != 0:
        return {"memory_peak_bytes": out.get("memory_peak_bytes", 0), "forbidden": out["forbidden"]}
    return out


def _run_ranks(cell, seed, seconds, trace, device) -> dict:
    from kccotgan_tpu_torch.parallel.launch import run_ranks

    world = cell.cfg["num_devices"]
    bench = load_benchmark(cell.root / "BENCHMARK.json")
    cpu = torch.device(device).type == "cpu"
    outs = run_ranks(_rank, world, (cell.name, bench, cell.root, seed, seconds, trace), device=device,
                     timeout=900, threads=1 if cpu else None)
    out = outs[0]
    out["forbidden"] = [m for o in outs for m in o["forbidden"]]
    if not cpu:
        out["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs)

    def tensors(x):  # the ranks hand back numpy arrays
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(device)
        if isinstance(x, dict):
            return {k: tensors(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(tensors(v) for v in x)
        return x

    ev = out["evidence"]
    for key in ("z", "params0", "stats0", "mu1", "params3"):
        ev[key] = tensors(ev[key])
    return out
