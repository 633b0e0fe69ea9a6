"""Training loop: batches, the NaN sentinel and its recovery, logging,
checkpoints and periodic rollout sampling.

Counterpart of ``kccotgan_tpu/train/loop.py`` on one device.  The host
never waits for the step it has just enqueued: each step's loss and pM
go to pinned memory with a non-blocking copy and an event, and are read
after the next step has been enqueued, one step behind.  The host waits
for the card only where it needs a value at once: before a checkpoint
(its own loss must be finite), to copy the state out for it, and to
score a rollout.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import numpy as np
import torch

from ..ckpt import CheckpointWriter, restore_checkpoint
from ..data import device_prefetch
from ..eval import video_metrics
from ..utils.logging import MetricsLogger, Throughput, write_run_notes
from .rollout import build_rollout
from .state import TrainState, create_train_state, fold_in
from .steps import build_train_step

__all__ = ["Trainer"]


class _Pending:
    """A step's loss and pM on their way to the host."""

    def __init__(self, metrics: dict):
        vals = torch.stack([metrics["sinkhorn_loss"].float(), metrics["pm"].float()])
        self._event = None
        if vals.device.type == "cpu":
            self._host = vals
        else:
            self._host = torch.empty(2, pin_memory=True)
            self._host.copy_(vals, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def read(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        loss, pm = self._host.tolist()
        return {"sinkhorn_loss": loss, "pm": pm}


class Trainer:
    """``Trainer(cfg, device="cuda").fit(batches)``: trains on ``device``,
    the card unless the caller asks for the CPU.

    ``timings`` is filled by ``fit``: the loop's waits for a batch (their
    count, sum and largest, in milliseconds), each rollout sample's
    milliseconds, and each checkpoint's
    host copy and write (``CheckpointWriter.records``).
    """

    def __init__(self, cfg, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device")
        self.cfg = cfg
        self.train_step = build_train_step(cfg, device=self.device)
        self.rollout = build_rollout(cfg, device=self.device)
        self.run_dir = os.path.join(cfg.out_dir, cfg.run_name or self._default_run_name())
        self.logger: MetricsLogger | None = None
        self.timings: dict = {}

    def _default_run_name(self) -> str:
        c = self.cfg
        return f"{c.dname}_lr{c.lr}_lam{c.reg_penalty}_{c.kernel}kernel_sig{c.init_sigma}"

    def init_state(self) -> TrainState:
        """A fresh state from ``cfg.seed``, or, with ``cfg.checkpoint``,
        the newest checkpoint under ``cfg.ckpt_path``."""
        if self.cfg.checkpoint and self.cfg.ckpt_path:
            return restore_checkpoint(self.cfg.ckpt_path, self.cfg, device=self.device)
        return create_train_state(self.cfg, device=self.device)

    def fit(
        self,
        batches: Iterator[np.ndarray],
        *,
        state: TrainState | None = None,
        max_steps: int | None = None,
        test_batch: np.ndarray | None = None,
        log_every: int = 1,
    ) -> tuple[TrainState, dict]:
        """Train on ``batches`` (film-strips ``[B, H, T, W, C]``; a batch
        of another size is skipped) until they run out or ``max_steps``.
        Returns the last state and the summary: ``status`` ("completed" or
        "failed"), ``steps``, ``wall_time_sec``, ``recoveries`` and the
        three rates."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        os.makedirs(self.run_dir, exist_ok=True)
        write_run_notes(self.run_dir, cfg)
        notes = os.path.join(self.run_dir, "train_notes.txt")
        self.logger = MetricsLogger(os.path.join(self.run_dir, "log"))
        ckpt_dir = os.path.join(self.run_dir, "ckpt")
        ckpt_writer = CheckpointWriter(ckpt_dir)
        if test_batch is not None:
            test_batch = torch.as_tensor(np.asarray(test_batch, dtype=np.float32)).to(self.device)
        wait = {"n": 0, "sum_ms": 0.0, "max_ms": 0.0}
        self.timings = {"prefetch_wait": wait, "sample_ms": [], "checkpoints": ckpt_writer.records}
        # 3 Sinkhorn solves x L iterations x 2 phases a step
        thru = Throughput(cfg.batch_size * cfg.total_time_steps, 6 * cfg.sinkhorn_l)
        t_start = time.time()
        pending = None
        status = "completed"
        step = int(state.step)
        retries_left = cfg.nan_recovery_retries
        recoveries = 0

        def note(text: str) -> None:
            with open(notes, "a") as f:
                f.write(text)

        def log(vals: dict, at: int) -> None:
            self.logger.scalar("Sinkhorn Loss", vals["sinkhorn_loss"], at)
            self.logger.scalar("pM", vals["pm"], at)

        try:
            if retries_left > 0:
                ckpt_writer.save(state, step)  # a restore point before any step runs

            with contextlib.closing(device_prefetch(batches, device=self.device)) as prefetched:
                while True:
                    t0 = time.perf_counter()
                    batch = next(prefetched, None)
                    waited = (time.perf_counter() - t0) * 1e3
                    wait["n"] += 1
                    wait["sum_ms"] += waited
                    wait["max_ms"] = max(wait["max_ms"], waited)
                    if batch is None:
                        break
                    if batch.shape[0] != cfg.batch_size:
                        continue  # ragged tail
                    state, metrics = self.train_step(state, batch)
                    step += 1
                    thru.tick()

                    # The previous step's metrics, read now that this step is
                    # enqueued: the host does not wait for the card here.
                    if pending is not None:
                        vals = pending.read()
                        if (step - 1) % log_every == 0:
                            log(vals, step - 1)
                        if not np.isfinite(vals["sinkhorn_loss"]):
                            if retries_left <= 0:
                                note("\nTraining failed! (non-finite loss at step %d)" % (step - 1))
                                status = "failed"
                                pending = None
                                break
                            # Restore the last verified checkpoint, take
                            # another noise path, and go on past the batch.
                            retries_left -= 1
                            recoveries += 1
                            ckpt_writer.wait()
                            state = restore_checkpoint(ckpt_dir, state, device=self.device)
                            state.rng = fold_in(state.rng, recoveries)
                            step = state.step
                            pending = None
                            note(
                                "\nNon-finite loss; restored step %d checkpoint and re-seeded (retry %d/%d)"
                                % (step, recoveries, cfg.nan_recovery_retries)
                            )
                            continue
                    pending = _Pending(metrics)

                    # A checkpoint only of a step whose own loss is finite, so
                    # that a divergence at this very step cannot become the
                    # restore point.
                    if step % cfg.ckpt_freq == 0 and np.isfinite(float(metrics["sinkhorn_loss"])):
                        ckpt_writer.save(state, step)
                    if test_batch is not None and (step % cfg.save_freq == 0 or step == 1):
                        self._sample_and_log(state, test_batch, step)
                    if max_steps is not None and step >= max_steps:
                        break

            if pending is not None:
                vals = pending.read()
                log(vals, step)
                if not np.isfinite(vals["sinkhorn_loss"]):
                    note("\nTraining failed! (non-finite loss at step %d)" % step)
                    status = "failed"

            rates = thru.rates()
            summary = {
                "status": status,
                "steps": step,
                "wall_time_sec": time.time() - t_start,
                "recoveries": recoveries,
                **rates,
            }
            for k, v in rates.items():
                self.logger.scalar(f"throughput/{k}", v, step)
        finally:
            self.logger.close()
            ckpt_writer.close()
        return state, summary

    def _sample_and_log(self, state: TrainState, test_batch: torch.Tensor, step: int) -> None:
        """One rollout from the test batch's context, noise seeded by
        ``cfg.seed + step``: its image grid, and its PSNR and SSIM against
        the test batch's future frames."""
        cfg = self.cfg
        t0 = time.perf_counter()
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed + step)
        params = {"encoder": state.enc_params, "decoder": state.dec_params}
        video = self.rollout(params, test_batch[:, :, : cfg.int_time_steps], generator)
        self.logger.image_grid("Training data", video.cpu().numpy(), step)
        t_pred = min(video.shape[2], test_batch.shape[2]) - cfg.int_time_steps
        if t_pred > 0:
            sl = slice(cfg.int_time_steps, cfg.int_time_steps + t_pred)
            m = video_metrics(video[:, :, sl], test_batch[:, :, sl])
            self.logger.scalar("eval/psnr", float(m["psnr"]), step)
            self.logger.scalar("eval/ssim", float(m["ssim"]), step)
        self.logger.flush()
        self.timings["sample_ms"].append((time.perf_counter() - t0) * 1e3)
