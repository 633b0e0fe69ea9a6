"""Run logging: scalar and image streams, throughput counters, run notes.

Counterpart of ``kccotgan_tpu/utils/logging.py``.  ``MetricsLogger``
always writes ``metrics.jsonl`` (one ``{"tag", "value", "step"}`` line a
scalar) and, where ``tensorboardX`` is installed, TensorBoard scalars and
the rollout image grids as well; it is imported when a logger is made,
never when this module is.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time

import numpy as np

__all__ = ["MetricsLogger", "Throughput", "write_run_notes"]


class MetricsLogger:
    """JSONL scalars, plus TensorBoard where ``tensorboardX`` is installed."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._writer = None
        if importlib.util.find_spec("tensorboardX") is not None:
            from tensorboardX import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")

    def image_grid(self, tag: str, film_strips: np.ndarray, step: int, max_rows: int = 10) -> None:
        """``[B, H, T, W, C]`` -> one tall image of per-sample strips
        (TensorBoard only)."""
        b, h, t, w, c = film_strips.shape
        n = min(max_rows, b)
        if self._writer is not None:
            self._writer.add_image(tag, film_strips[:n].reshape(n * h, t * w, c), step, dataformats="HWC")

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._writer is not None:
            self._writer.close()
        self._jsonl.close()


class Throughput:
    """Steps/s, frames/s and Sinkhorn iterations/s since ``reset``, on the
    host's clock."""

    def __init__(self, frames_per_step: int, sinkhorn_iters_per_step: int):
        self.frames_per_step = frames_per_step
        self.sinkhorn_iters_per_step = sinkhorn_iters_per_step
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def rates(self) -> dict[str, float]:
        dt = max(self.elapsed, 1e-9)
        return {
            "steps_per_sec": self._steps / dt,
            "frames_per_sec": self._steps * self.frames_per_step / dt,
            "sinkhorn_iters_per_sec": self._steps * self.sinkhorn_iters_per_step / dt,
        }


def write_run_notes(run_dir: str, cfg) -> None:
    """The run's configuration as ``train_notes.txt``."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "train_notes.txt"), "w") as f:
        f.write("kccotgan_tpu_torch run configuration\n\n")
        f.write(cfg.to_json())
        f.write("\n")
