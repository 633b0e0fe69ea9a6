"""Training loop: batches, the NaN sentinel and its recovery, logging,
checkpoints and periodic rollout sampling.

Counterpart of ``kccotgan_tpu/train/loop.py``, on one device or, given a
mesh, as one rank of it (``Trainer(cfg, mesh=...)`` for data parallelism,
``seq_mesh=...`` for sequence or 2-D data x seq parallelism): every rank
reads the same seeded batch stream and keeps its rows
(``parallel.sharding.shard_batch``); rank 0 alone writes the logs, the
notes, the samples and the checkpoints, and every rank restores.  The
NaN sentinel decides from the loss, which is the same on every rank in
every mode, so the ranks stop or recover together.  The host
never waits for the step it has just enqueued: each step's loss and pM
go to pinned memory with a non-blocking copy and an event, and are read
after the next step has been enqueued, one step behind.  The host waits
for the card only where it needs a value at once: before a checkpoint
(its own loss must be finite), to copy the state out for it, and to
score a rollout.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Iterator

import numpy as np
import torch

from ..ckpt import CheckpointWriter, restore_checkpoint
from ..data import device_prefetch
from ..eval import video_metrics
from ..utils import profiling
from ..utils.logging import MetricsLogger, Throughput, write_run_notes
from .rollout import build_rollout
from .state import TrainState, create_train_state, fold_in
from .steps import build_train_step

__all__ = ["Trainer"]


class _Pending:
    """A step's loss and pM on their way to the host, beside its sigma
    (a host value)."""

    def __init__(self, metrics: dict):
        self._sigma = float(metrics["sigma"])
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
        return {"sinkhorn_loss": loss, "pm": pm, "sigma": self._sigma}


class Trainer:
    """``Trainer(cfg, device="cuda").fit(batches)``: trains on ``device``,
    the card unless the caller asks for the CPU; with ``mesh`` (a data
    mesh) or ``seq_mesh`` (a seq or data x seq mesh) as this rank of it,
    on the mesh's device.

    ``timings`` is filled by ``fit``: the loop's waits for a batch (their
    count, sum and largest, in milliseconds), each rollout sample's
    milliseconds, each checkpoint's
    host copy and write (``CheckpointWriter.records``), and ``graph``, the
    step's counts of eager calls, CUDA-graph captures and replays so far
    (``build_train_step``).
    """

    def __init__(self, cfg, *, device="cuda", mesh=None, seq_mesh=None):
        if mesh is not None and seq_mesh is not None:
            raise ValueError("Trainer: pass mesh or seq_mesh, not both (a 2-D data x seq mesh is a seq_mesh)")
        self.mesh = mesh if mesh is not None else seq_mesh
        self.device = torch.device(device) if self.mesh is None else self.mesh.device
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device")
        self.cfg = cfg
        self.lead = self.mesh is None or self.mesh.rank == 0
        if seq_mesh is not None:
            from ..parallel.seqtrain import build_seq_train_step

            self.train_step = build_seq_train_step(cfg, seq_mesh)
        elif mesh is not None:
            from ..parallel.sharding import build_sharded_train_step

            self.train_step = build_sharded_train_step(cfg, mesh)
        else:
            self.train_step = build_train_step(cfg, device=self.device)
        self._step_counts = self.train_step.counts
        self.rollout = build_rollout(cfg, device=self.device)
        self.run_dir = os.path.join(cfg.out_dir, cfg.run_name or self._default_run_name())
        self.logger: MetricsLogger | None = None
        self.timings: dict = {}

    def _default_run_name(self) -> str:
        c = self.cfg
        return f"{c.dname}_lr{c.lr}_lam{c.reg_penalty}_{c.kernel}kernel_sig{c.init_sigma}"

    def init_state(self) -> TrainState:
        """A fresh state from ``cfg.seed``, or, with ``cfg.checkpoint``,
        the newest checkpoint under ``cfg.ckpt_path``; on a mesh, rank 0's
        on every rank (``replicate_state``)."""
        if self.cfg.checkpoint and self.cfg.ckpt_path:
            state = restore_checkpoint(self.cfg.ckpt_path, self.cfg, device=self.device)
        else:
            state = create_train_state(self.cfg, device=self.device)
        return self._replicated(state)

    def _replicated(self, state: TrainState) -> TrainState:
        if self.mesh is None:
            return state
        from ..parallel.sharding import replicate_state

        return replicate_state(state, self.mesh)

    def fit(
        self,
        batches: Iterator[np.ndarray],
        *,
        state: TrainState | None = None,
        max_steps: int | None = None,
        test_batch: np.ndarray | None = None,
        log_every: int = 1,
        profile_steps: tuple[int, int] | None = None,
    ) -> tuple[TrainState, dict]:
        """Train on ``batches`` (film-strips ``[B, H, T, W, C]``; a batch
        of another size is skipped) until they run out or ``max_steps``.
        Returns the last state and the summary: ``status`` ("completed" or
        "failed"), ``steps``, ``wall_time_sec``, ``recoveries``, the
        smoothing ``kernel`` and the last step's ``sigma``, and the three
        rates.  Each step's loss, pM and sigma are logged.  ``profile_steps
        (a, b)`` traces steps a to b into ``<run_dir>/profile/``
        (``utils.profiling``), the trace stopped once step b's loss is
        computed."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        lead, mesh = self.lead, self.mesh
        notes = os.path.join(self.run_dir, "train_notes.txt")
        ckpt_dir = os.path.join(self.run_dir, "ckpt")
        self.logger = ckpt_writer = None
        if lead:
            os.makedirs(self.run_dir, exist_ok=True)
            write_run_notes(self.run_dir, cfg)
            self.logger = MetricsLogger(os.path.join(self.run_dir, "log"))
            ckpt_writer = CheckpointWriter(ckpt_dir)
        else:
            test_batch = profile_steps = None
        if test_batch is not None:
            test_batch = torch.as_tensor(np.asarray(test_batch, dtype=np.float32)).to(self.device)
        rows, sharding = cfg.batch_size, None
        if mesh is not None:
            from ..parallel.sharding import shard_batch

            # a ragged batch is dropped before it is split, on every rank alike
            batches = (b for b in batches if b.shape[0] == cfg.batch_size)
            rows, sharding = cfg.batch_size // mesh.data, functools.partial(shard_batch, mesh=mesh)
        wait = {"n": 0, "sum_ms": 0.0, "max_ms": 0.0}
        self.timings = {"prefetch_wait": wait, "sample_ms": [],
                        "checkpoints": ckpt_writer.records if lead else []}
        # 3 Sinkhorn solves x L iterations x 2 phases a step
        thru = Throughput(cfg.batch_size * cfg.total_time_steps, 6 * cfg.sinkhorn_l)
        t_start = time.time()
        pending = None
        status = "completed"
        step = int(state.step)
        retries_left = cfg.nan_recovery_retries
        recoveries = 0
        sigma = None
        profiler = None

        def note(text: str) -> None:
            if lead:
                with open(notes, "a") as f:
                    f.write(text)

        def save(at: int) -> None:
            if lead:
                ckpt_writer.save(state, at)

        def log(vals: dict, at: int) -> None:
            if not lead:
                return
            self.logger.scalar("Sinkhorn Loss", vals["sinkhorn_loss"], at)
            self.logger.scalar("pM", vals["pm"], at)
            self.logger.scalar("sigma", vals["sigma"], at)

        try:
            if retries_left > 0:
                save(step)  # a restore point before any step runs

            with contextlib.closing(device_prefetch(batches, device=self.device, sharding=sharding)) as prefetched:
                while True:
                    t0 = time.perf_counter()
                    batch = next(prefetched, None)
                    waited = (time.perf_counter() - t0) * 1e3
                    wait["n"] += 1
                    wait["sum_ms"] += waited
                    wait["max_ms"] = max(wait["max_ms"], waited)
                    if batch is None:
                        break
                    if batch.shape[0] != rows:
                        continue  # ragged tail
                    if profiler is None and profile_steps is not None and step + 1 == profile_steps[0]:
                        profiler = profiling.start_trace(os.path.join(self.run_dir, "profile"))
                    state, metrics = self.train_step(state, batch)
                    step += 1
                    thru.tick()
                    if profiler is not None and step == profile_steps[1]:
                        float(metrics["sinkhorn_loss"])  # wait for step b: its device work is in the window
                        profiling.stop_trace(profiler)
                        profiler = profile_steps = None

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
                            if lead:
                                ckpt_writer.wait()
                            if mesh is not None:  # rank 0's checkpoint is on disk for every rank
                                torch.distributed.barrier(group=mesh.world)
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
                    sigma = float(metrics["sigma"])

                    # A checkpoint only of a step whose own loss is finite, so
                    # that a divergence at this very step cannot become the
                    # restore point.
                    if step % cfg.ckpt_freq == 0 and np.isfinite(float(metrics["sinkhorn_loss"])):
                        save(step)
                    if test_batch is not None and (step % cfg.save_freq == 0 or step == 1):
                        self._sample_and_log(state, test_batch, step)
                    if max_steps is not None and step >= max_steps:
                        break

            self.timings["graph"] = dict(self._step_counts)
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
                "kernel": cfg.kernel,
                "sigma": sigma,
                **rates,
            }
            if lead:
                for k, v in rates.items():
                    self.logger.scalar(f"throughput/{k}", v, step)
        finally:
            if profiler is not None:  # the run ended inside the window
                profiling.stop_trace(profiler)
            if lead:
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
