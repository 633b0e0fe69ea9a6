"""A tiny copy of the benchmark for the CPU tests: the configurations cut
to 16x16 frames and the narrowest layers, the traffic mixes to a few
videos, written under a temporary root beside a ``BENCHMARK.json`` whose
cells name them, so that ``run.run_cell`` drives the whole of a run on the
CPU (the program's kernels then run their plain versions). The cells held
back in ``held/*.json`` are merged in, so their paths stay tested."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from port_bench.spec import BENCH_DIR, load_benchmark

__all__ = ["TINY_MODEL", "tiny_root", "with_held"]

TINY_MODEL = {"x_height": 16, "x_width": 16, "g_filter_size": 2, "d_filter_size": 1, "d_state_size": 2,
              "z_channels": 2, "z_height": 1, "z_width": 1}
TINY_FIELDS = {"batch_size": 4, "total_time_steps": 4, "int_time_steps": 2, "sinkhorn_l": 3}
TINY_TRAFFIC = {"videos": 12, "contexts": 2, "check_every": 1, "trace_requests": 2, "trace_steps": 2}


def with_held(bench: dict) -> dict:
    """``bench`` with each held-back cell's entries added, and the cell
    joined to the metrics its file names under ``join``."""
    for path in sorted((BENCH_DIR / "held").glob("*.json")):
        with open(path) as f:
            held = json.load(f)
        for section in ("configs", "workloads", "per_layer"):
            bench[section] += held[section]
        names = [w["name"] for w in held["workloads"]]
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if metric["name"] in held["join"]:
                metric["workloads"] += names
    return bench


def tiny_root(tmp: Path, limits: dict | None = None) -> Path:
    """A root holding the benchmark's files with every configuration and
    traffic mix cut to the tiny sizes; ``limits`` replaces a workload's
    limits."""
    bench = with_held(load_benchmark())
    for sub in ("metrics", "kernels"):
        shutil.copytree(BENCH_DIR / sub, tmp / "port_bench" / sub)
    for sub in ("configs", "traffic", "limits"):
        (tmp / "port_bench" / sub).mkdir(parents=True, exist_ok=True)
    for entry in bench["configs"]:
        with open(BENCH_DIR.parent / entry["file"]) as f:
            conf = json.load(f)
        conf["config"].update(TINY_FIELDS)
        conf["config"]["model"].update(TINY_MODEL)
        with open(tmp / entry["file"], "w") as f:
            json.dump(conf, f)
    for path in (BENCH_DIR / "traffic").glob("*.json"):
        with open(path) as f:
            mix = json.load(f)
        mix.update({k: v for k, v in TINY_TRAFFIC.items() if k in mix})
        mix["metrics_k"] = min(mix.get("metrics_k", 0), 3)
        with open(tmp / "port_bench" / "traffic" / path.name, "w") as f:
            json.dump(mix, f)
    for path in (BENCH_DIR / "limits").glob("*.json"):
        with open(path) as f:
            lim = json.load(f)
        if limits and path.stem in limits:
            lim = copy.deepcopy(lim)
            lim["limits"] = limits[path.stem]
        with open(tmp / "port_bench" / "limits" / path.name, "w") as f:
            json.dump(lim, f)
    with open(tmp / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return tmp
