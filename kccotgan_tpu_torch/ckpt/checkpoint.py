"""Checkpoints of the whole train state, for an exact resume.

Counterpart of ``kccotgan_tpu/ckpt/checkpoint.py`` (Orbax there).  A
checkpoint is one file ``<ckpt_dir>/step_<N>.pt``: ``torch.save`` of a
plain nested dict of CPU tensors and ints (the four parameter groups,
the two BatchNorm statistics, the four Adam states as count, mu and nu,
the step and the noise key), read back with ``torch.load(...,
weights_only=True)``.  Each file is written under a temporary name and
then renamed over, so a reader never sees half a checkpoint; the newest
``max_to_keep`` (3) are kept.
"""

from __future__ import annotations

import os
import re
import time
from concurrent.futures import Future, ThreadPoolExecutor

import torch

__all__ = ["CheckpointWriter", "latest_step", "restore_checkpoint", "save_checkpoint"]

_NAME = re.compile(r"step_(\d+)\.pt")
_MAX_TO_KEEP = 3


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}.pt")


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m[1]) for name in os.listdir(ckpt_dir) if (m := _NAME.fullmatch(name)))


# ``train.loop`` imports this module, so the train state's layout and
# classes are imported where they are used.


def _to_host(state) -> dict:
    """The state as a nested dict of CPU tensors and ints.  From the card
    every tensor is copied into pinned memory on the current stream, and
    the host waits for those copies alone."""
    from ..train.state import GROUPS, STATS

    on_card = []

    def host(tree):
        out = {}
        for k, v in tree.items():
            if v.device.type == "cpu":
                out[k] = v.clone()
            else:
                out[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                out[k].copy_(v, non_blocking=True)
                on_card.append(v.device)
        return out

    d = {"step": int(state.step), "rng": int(state.rng)}
    for g in GROUPS:
        opt = getattr(state, f"{g}_opt")
        d[f"{g}_params"] = host(getattr(state, f"{g}_params"))
        d[f"{g}_opt"] = {"count": int(opt.count), "mu": host(opt.mu), "nu": host(opt.nu)}
    for name in STATS:
        d[name] = host(getattr(state, name))
    if on_card:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(on_card[0]))
        done.synchronize()
    return d


def _write(ckpt_dir: str, host: dict, step: int, max_to_keep: int) -> int:
    """Write ``host`` as the checkpoint of ``step``, drop the oldest past
    ``max_to_keep``, and return the file's size in bytes."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(host, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))
    return os.path.getsize(path)


def save_checkpoint(ckpt_dir: str, state, step: int | None = None) -> None:
    """Write ``state`` as the checkpoint of ``step`` (default
    ``state.step``) and return when it is on disk."""
    _write(ckpt_dir, _to_host(state), int(state.step) if step is None else step, _MAX_TO_KEEP)


class CheckpointWriter:
    """Checkpoints of a training run, written in a background thread.

    ``save`` copies the state to the host before it returns, so the card
    may go on with the next steps at once; the file is written in the
    background.  ``wait`` and ``close`` drain the writes and raise the
    first error of any.  ``records`` holds, for each save, the step, the
    host copy's and the write's milliseconds and the file's bytes.
    """

    def __init__(self, ckpt_dir: str, max_to_keep: int = _MAX_TO_KEEP):
        self.ckpt_dir = ckpt_dir
        self.max_to_keep = max_to_keep
        self.records: list[dict] = []
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: list[Future] = []

    def save(self, state, step: int | None = None) -> None:
        step = int(state.step) if step is None else step
        t0 = time.perf_counter()
        host = _to_host(state)
        record = {"step": step, "copy_ms": (time.perf_counter() - t0) * 1e3}
        self.records.append(record)

        def write():
            t1 = time.perf_counter()
            record["bytes"] = _write(self.ckpt_dir, host, step, self.max_to_keep)
            record["write_ms"] = (time.perf_counter() - t1) * 1e3

        self._pending.append(self._pool.submit(write))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _shapes(template_or_cfg):
    """A state holding the expected shapes: ``template_or_cfg`` itself if
    it is a state, else one made on the meta device from the config."""
    from ..models.video import discriminator_modules, generator_modules
    from ..train.keras_adam import KerasAdamState
    from ..train.state import GROUPS, TrainState

    if isinstance(template_or_cfg, TrainState):
        return template_or_cfg

    cfg = template_or_cfg
    with torch.device("meta"):
        encoder, decoder = generator_modules(cfg)
        disc_h, disc_m = discriminator_modules(cfg)
        trees = {"enc": encoder.state_dict(), "dec": decoder.state_dict(),
                 "h": disc_h.state_dict(), "m": disc_m.state_dict()}
        stats = {"h_stats": disc_h.init_stats(), "m_stats": disc_m.init_stats()}
    opts = {f"{g}_opt": KerasAdamState(0, trees[g], trees[g]) for g in GROUPS}
    return TrainState(step=0, rng=0, **{f"{g}_params": trees[g] for g in GROUPS}, **stats, **opts)


def restore_checkpoint(ckpt_dir: str, template_or_cfg, step: int | None = None, *, device="cuda"):
    """The checkpoint of ``step`` (default: the newest) as a ``TrainState``
    on ``device``.  Every tensor must have the key and shape that
    ``template_or_cfg`` (a state, or the config of the run) gives it."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    from ..train.keras_adam import KerasAdamState
    from ..train.state import GROUPS, STATS, TrainState

    d = torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True)
    want = _shapes(template_or_cfg)

    def tree(got: dict, ref: dict, what: str) -> dict:
        shapes = {k: tuple(v.shape) for k, v in got.items()}
        expected = {k: tuple(v.shape) for k, v in ref.items()}
        if shapes != expected:
            raise ValueError(f"checkpoint {step} in {ckpt_dir}: {what} does not match the run's shapes")
        return {k: v.to(device) for k, v in got.items()}

    fields = {}
    for g in GROUPS:
        ref = getattr(want, f"{g}_params")
        fields[f"{g}_params"] = tree(d[f"{g}_params"], ref, f"{g}_params")
        o = d[f"{g}_opt"]
        fields[f"{g}_opt"] = KerasAdamState(
            count=int(o["count"]), mu=tree(o["mu"], ref, f"{g}_opt.mu"), nu=tree(o["nu"], ref, f"{g}_opt.nu"),
        )
    for name in STATS:
        fields[name] = tree(d[name], getattr(want, name), name)
    return TrainState(step=int(d["step"]), rng=int(d["rng"]), **fields)
