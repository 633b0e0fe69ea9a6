"""Spawning the ranks of a job on one host.

``run_ranks(fn, world, args)`` starts ``world`` processes (``spawn``),
each of which joins the job as its rank (``mesh.init_distributed``, over
a file store in a temporary directory), calls ``fn(rank, device, *args)``
and sends back what it returns, its tensors as numpy arrays.  A rank
that raises, or a job that outlives ``timeout``, ends every rank and
raises in the caller with the rank's traceback.  The CLI trains through
it when ``--num_devices`` times ``--seq_devices`` is above 1 and no
launcher (torchrun) started the job.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import init_distributed

__all__ = ["run_ranks"]


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, world, init_method, device, threads, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = init_distributed(rank, world, init_method, device=device)
        try:
            out = fn(rank, dev, *args)
            results.put((rank, "ok", _to_host(out)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, world: int, args=(), *, device="cuda", timeout: float = 600.0, threads: int | None = None,
              store_dir: str | None = None):
    """``[fn(rank, device, *args) for rank in range(world)]``, each in its
    own process and rank of one job (module docstring).  ``fn`` must be
    importable by name.  ``threads`` sets each rank's intra-op threads;
    ``store_dir`` holds the job's file store (default: a temporary
    directory)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="kccot_job_", dir=store_dir) as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank_main, args=(r, world, init_method, device, threads, fn, args, results),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: {world - len(got)} of {world} ranks not done after {timeout} s")
                try:
                    rank, status, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(f"run_ranks: rank {dead[0]} exited with code {procs[dead[0]].exitcode}")
                    continue
                if status == "error":
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
                got[rank] = value
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [got[r] for r in range(world)]
