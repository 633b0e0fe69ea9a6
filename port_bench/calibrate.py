"""Readings that a cell's limits are set from, many seeds in one process.

    python3 -m port_bench.calibrate --workload <name> --seeds 1-12 --control 1-3 --seconds 3

For each seed: set up as a run does, serve or train a short window, and
print one JSON line with the numbers the check compares for the program
against the plain reference (``program``); for the seeds of
``--control``, the same numbers for the reference computed in the next
precision below the configuration's (``control``: float8 operands for the
bfloat16 convs and products; the best-of-K PSNR and SSIM in bfloat16)
and, in training, for the reference with half of each batch left out and
the mean taken over the rest (``half_batch``, a fault), and the seconds
the reference took.  The check restores the TF32 flags after the
reference, so every seed runs the program as a run of its own does.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from .run import _environment
from .spec import REPO, load_cell

__all__ = ["main", "readings"]


def _seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def readings(cell, seed: int, seconds: float, control: bool, device) -> dict:
    import torch

    from . import check

    driver = importlib.import_module(f"port_bench.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, seed, seconds, False, device)
    ev, ref, cfg = out["evidence"], cell.reference, cell.cfg
    del out
    line = {"seed": seed}
    t0 = time.perf_counter()
    if ev["kind"] == "train":
        want = check.reference_train(ref, cfg, ev, device)
        line["reference_s"] = time.perf_counter() - t0
        got = check.train_outputs(cfg, ev["loss"], ev["pm"], ev["mu1"], ev["params3"], ev["params0"])
        line["program"] = check.compare_train(got, want)
        if control:
            line["control"] = check.compare_train(check.reference_train(ref, cfg, ev, device, "float8"), want)
            line["half_batch"] = check.compare_train(check.reference_train(ref, cfg, ev, device, half_batch=True), want)
    else:
        line["program"] = check.sample_numbers(ref, cfg, ev, device)
        line["reference_s"] = time.perf_counter() - t0
        line["requests_checked"] = len(ev["requests"])
        if control:
            line["control"] = check.control_numbers(ref, cfg, ev, device)
    del ev
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="readings for a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,9")
    p.add_argument("--control", default="", help="seeds that also read the control and the faults")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    _environment(REPO)
    import torch

    if not torch.cuda.is_available():
        print("port_bench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    control = set(_seeds(args.control)) if args.control else set()
    for seed in _seeds(args.seeds):
        print(json.dumps(readings(cell, seed, args.seconds, seed in control, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
