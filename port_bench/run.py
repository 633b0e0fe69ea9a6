"""Run one cell of the benchmark once.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding the card(s) the cell asks for.  With
``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` window of a fixed amount of work.  Either run checks
what its timed path produced against the plain reference and prints each
number compared beside its limit, last on standard error and last in the
result's line (``checks``).  It exits non-zero, with no result, without
the cards it needs, when the program cannot be loaded, or when JAX or the
JAX package is loaded, once the window has closed, in this process or in
any rank it spawned.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from .guard import Forbidden, forbidden_loaded, refuse  # noqa: E402
from .spec import REPO, load_cell, load_metric_reader  # noqa: E402

__all__ = ["main", "run_cell"]


def _environment(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into ``build/kccotgan_tpu_torch``),
    and one intra-op thread, set before torch is imported: the steps are
    host-bound, and idle OpenMP workers spinning beside the launching
    thread would only add noise."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"


def _power_limit() -> str | None:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout.strip() else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda", bench=None, root=None,
             t0: float | None = None) -> dict:
    """One run of ``workload``: the result line as a dict."""
    import torch

    from . import check
    from .trace import Window, breakdown, family_of, load_families

    root = root or REPO
    cell = load_cell(workload, bench, root)
    driver = importlib.import_module(f"port_bench.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, seed, seconds, trace, device, Window)
    refuse(out.pop("forbidden", []))  # the ranks' processes, read after their windows
    setup_s = out["setup_end"] - (_T0 if t0 is None else t0)

    metrics = {}
    result = {"correct": False, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics}
    if not trace:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        for name, value in out["end_to_end"].items():
            if name in units:
                metrics[name] = {"value": value, "unit": units[name]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device_info = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu", "count": cell.chips}
    if device_info["platform"] == "gpu":
        device_info["kind"] = torch.cuda.get_device_name(device)
        device_info["memory_peak_bytes"] = out["memory_peak_bytes"]
        device_info["power_limit"] = _power_limit()
    result["device"] = device_info

    record = out.get("record")
    if record is not None and record["trace"] is not None:
        red = record["trace"]
        w0, w1 = red["window_us"]
        device_info["busy_s"] = red["busy_us"] / 1e6
        device_info["window_s"] = (w1 - w0) / 1e6
        families = load_families(root)
        record.update(cfg=cell.cfg, traffic=cell.traffic, reference=cell.reference, families=families,
                      family_of=family_of(families))
        for m in cell.per_layer:
            value = load_metric_reader(m["name"], root)(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = breakdown(red)

    if cell.traffic.get("rate_per_s") and "late_s" in out:
        result["late_s"] = out["late_s"]
    evidence = out.pop("evidence")
    del out
    numbers = getattr(check, f"{evidence['kind']}_numbers")(cell.reference, cell.cfg, evidence, device)
    result["correct"], result["checks"] = check.judge(numbers, cell.limits)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment(REPO)

    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
        refuse([f"harness: {m}" for m in forbidden_loaded()])
    except Forbidden as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3
    if "late_s" in result:  # how far behind its schedule an open loop started a request
        print(f"late_s {result.pop('late_s')}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
