"""Reading a ``torch.profiler`` window: the device's busy time (the union
of its operations' intervals), the device time and count of each kernel
family, the top device operations, and the longest idle gaps named by the
benchmark's host range they fall in.

``Window`` opens one profiler session (CPU and CUDA activity) around the
traced calls, inside which the drivers mark their calls into a layer with
``record_function`` ranges; ``reduce()`` turns the session into plain
numbers.  A trace in which the device recorded nothing is CUPTI's loss,
never a reading of 0: ``reduce`` then returns None and the caller traces
again.  The profiler slows a host-bound step (it records every operation
the host issues), so the traced window runs longer than an untraced one.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import torch

__all__ = ["WINDOW", "Window", "breakdown", "family_of", "is_copy", "load_families"]

WINDOW = "port_bench.window"


def load_families(root: Path) -> dict:
    """``family: [kernel names]`` from ``kernels/<family>.json``."""
    out = {}
    for path in sorted((root / "port_bench" / "kernels").glob("*.json")):
        with open(path) as f:
            out[path.stem] = json.load(f)["kernels"]
    return out


def _pattern(names):
    return re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names)) + r")(?![A-Za-z0-9_])")


def family_of(families: dict):
    """``op name -> family or None``, matching a kernel name as a whole
    identifier inside the demangled name."""
    patterns = {fam: _pattern(names) for fam, names in families.items()}

    def of(name: str):
        for fam, pat in patterns.items():
            if pat.search(name):
                return fam
        return None

    return of


def _annotation(e) -> bool:
    """A host range's shadow on the device's timeline (``record_function``
    ranges appear there too): no device operation."""
    return getattr(e, "is_user_annotation", False) or e.name == WINDOW


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


class Window:
    """One profiler session around ``with window:``; ``ranges`` are the
    names of the drivers' host ranges that name the idle gaps."""

    def __init__(self, ranges: tuple):
        self.ranges = ranges  # the names of the host ranges that name idle gaps, innermost last
        self.prof = None

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._window.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def reduce(self):
        """``{"window_us": (start, end), "busy_us", "ops": [(name, start,
        dur)], "gaps": [(range name, us)]}`` or None if no device op
        was recorded in the window."""
        events = self.prof.events()
        win = [e for e in events if e.name == WINDOW and e.device_type == torch.autograd.DeviceType.CPU]
        if not win:
            return None
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not _annotation(e) and w0 <= e.time_range.start < w1]
        if not dev:
            return None
        ops = sorted((e.name, e.time_range.start, min(e.time_range.end, w1) - e.time_range.start) for e in dev)
        spans = sorted((s, s + d) for _, s, d in ops)
        busy, merged = 0.0, []
        lo, hi = spans[0]
        for s, e in spans[1:]:
            if s > hi:
                merged.append((lo, hi))
                lo = s
            hi = max(hi, e)
        merged.append((lo, hi))
        busy = sum(e - s for s, e in merged)
        host = [(e.name, e.time_range.start, e.time_range.end) for e in events
                if e.device_type == torch.autograd.DeviceType.CPU and e.name in self.ranges]
        gaps, prev = [], w0
        for s, e in merged + [(w1, w1)]:
            if s > prev:
                gaps.append((self._name_at(host, prev), s - prev))
            prev = max(prev, e)
        return {"window_us": (w0, w1), "busy_us": busy, "ops": ops, "gaps": gaps}

    def _name_at(self, host, t):
        """The innermost benchmark range open at ``t`` (by the order of
        ``self.ranges``), else ``"outside the benchmark's calls"``."""
        best = None
        for name, s, e in host:
            if s <= t < e and (best is None or self.ranges.index(name) > self.ranges.index(best)):
                best = name
        return best or "outside the benchmark's calls"


def breakdown(red: dict, n: int = 10) -> dict:
    """The top device operations by total time and the longest idle gaps,
    in seconds."""
    by_name = {}
    for name, _, dur in red["ops"]:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(red["gaps"], key=lambda g: -g[1])[:n]
    return {"device_ops": [[name[:160], us / 1e6] for name, us in ops],
            "idle_gaps": [[name, us / 1e6] for name, us in gaps]}
