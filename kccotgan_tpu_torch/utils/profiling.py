"""Profiling hooks: a ``torch.profiler`` trace window.

Counterpart of ``kccotgan_tpu/utils/profiling.py``.
``start_trace(log_dir)`` starts ``torch.profiler`` with CPU activity, and
CUDA activity where a card is present, and returns the running profiler;
``stop_trace(profiler)`` stops it and writes a Chrome trace
(``<host>_<pid>.<ms>.pt.trace.json``, open it in Perfetto or
``chrome://tracing``) into ``log_dir``.  The training loop opens and
closes such a window under ``--profile_steps``.
"""

from __future__ import annotations

import torch

__all__ = ["start_trace", "stop_trace"]


def start_trace(log_dir: str) -> torch.profiler.profile:
    """Start a trace whose Chrome file goes to ``log_dir``; returns the
    running profiler for ``stop_trace``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    )
    profiler.start()
    return profiler


def stop_trace(profiler: torch.profiler.profile) -> None:
    """Stop the trace ``start_trace`` returned and write its file."""
    profiler.stop()
