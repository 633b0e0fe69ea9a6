"""Profiling hooks: a ``torch.profiler`` trace window and per-step timing.

Counterpart of ``kccotgan_tpu/utils/profiling.py``:

* ``trace(log_dir)``: context manager around ``torch.profiler`` with CPU
  activity, and CUDA activity where a card is present, writing a Chrome
  trace (``<host>_<pid>.<ms>.pt.trace.json``, open it in Perfetto or
  ``chrome://tracing``) into ``log_dir`` when it ends.
  ``start_trace(log_dir)`` / ``stop_trace(profiler)`` are its imperative
  form for a window that a loop opens and closes: ``start_trace``
  returns the running profiler, which ``stop_trace`` takes.
* ``annotate(name)``: a named region on the trace's host timeline
  (``torch.profiler.record_function``), so host phases (data loading,
  checkpointing) show beside device work.
* ``StepTimer``: a low-overhead EMA of step latency that never waits
  for the card itself (the caller decides when to read back).
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["trace", "start_trace", "stop_trace", "annotate", "StepTimer"]


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


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace what runs inside into ``log_dir``."""
    profiler = start_trace(log_dir)
    try:
        yield log_dir
    finally:
        stop_trace(profiler)


def annotate(name: str):
    """Named region on the profiler timeline (host annotation)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Exponential-moving-average step timer.

    ``tick()`` each step; ``ema_ms``/``last_ms`` report latency.  Does not
    synchronize the device: pair it with an explicit readback when exact
    per-step numbers are needed.
    """

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema_ms: float | None = None
        self.last_ms: float | None = None
        self._t: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._t is not None:
            self.last_ms = (now - self._t) * 1e3
            self.ema_ms = (
                self.last_ms
                if self.ema_ms is None
                else self.alpha * self.last_ms + (1 - self.alpha) * self.ema_ms
            )
        self._t = now
