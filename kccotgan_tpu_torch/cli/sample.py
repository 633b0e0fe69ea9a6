"""Sampling CLI: conditioned rollouts from a trained checkpoint.

Counterpart of ``kccotgan_tpu/cli/sample.py``, with its flags: restores
the port's checkpoint, takes the context from the preset's dataset
(``data.make_dataset``: its test batch, else the first training batch),
rolls out ``--num`` videos, prints the best-of-K PSNR/SSIM line with
``--metrics_k``, and writes ``rollout_strips.png`` (film strips) and
``rollout.gif`` (a sample grid).  On the card every rollout replays one
CUDA graph (``train.rollout.graph_rollout``); ``main(argv,
device="cpu")`` runs on the CPU.

  python -m kccotgan_tpu_torch.cli.sample --preset mmnist_full \\
      --ckpt trained/run/ckpt --out samples/ --metrics_k 4

The steps are functions of their own, in order: ``load`` (checkpoint
and context), ``predict`` (the rollout and best-of-K, through any
rollout callable), ``metrics_line``, then the drawing, ``write_strips``
(matplotlib) and ``write_gif`` (PIL).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

__all__ = ["build_parser", "load", "main", "metrics_line", "predict", "write_gif", "write_strips"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="kccotgan_tpu_torch sampler")
    p.add_argument("--preset", type=str, default="mmnist_small")
    p.add_argument("--ckpt", type=str, required=True, help="checkpoint dir written by the trainer")
    p.add_argument("--data_path", type=str, default="../data")
    p.add_argument("--out", type=str, default="samples")
    p.add_argument("--num", type=int, default=4, help="videos to sample")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--metrics_k", type=int, default=0,
                   help="if > 0, also report best-of-K PSNR/SSIM of the "
                        "predicted future vs the ground truth (standard "
                        "stochastic video-prediction protocol)")
    return p


def load(args: argparse.Namespace, device):
    """``(cfg, state, params, test_batch)``: the preset with ``--data_path``
    and ``--seed``, the newest checkpoint under ``--ckpt`` on ``device``,
    its generator's parameters, and the first ``--num`` videos of the test
    batch (full length) on ``device``."""
    from ..ckpt import restore_checkpoint
    from ..config import get_preset
    from ..data import make_dataset

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cli.sample: no CUDA device")
    cfg = dataclasses.replace(get_preset(args.preset), data_path=args.data_path, seed=args.seed)
    state = restore_checkpoint(args.ckpt, cfg, device=device)
    batches, test_batch = make_dataset(cfg)
    if test_batch is None:  # fall back to the train stream for context
        test_batch = next(iter(batches))
    test_batch = torch.from_numpy(np.asarray(test_batch[: args.num], dtype=np.float32)).to(device)
    return cfg, state, {"encoder": state.enc_params, "decoder": state.dec_params}, test_batch


def predict(rollout, params, test_batch, cfg, *, seed: int, metrics_k: int, device):
    """``(video [N, H, Tc + Tp, W, C], metrics or None)``: one rollout of the
    test batch's context, its noise seeded by ``seed``, and, with
    ``metrics_k > 0`` and future frames to score, ``eval.best_of_k`` over
    ``metrics_k`` rollouts seeded by ``seed + 1``.  ``rollout`` has
    ``build_rollout``'s signature."""
    from ..eval import best_of_k

    tc = cfg.int_time_steps
    video = rollout(params, test_batch[:, :, :tc], torch.Generator(device).manual_seed(seed))
    metrics = None
    if metrics_k > 0 and test_batch.shape[2] > tc:
        metrics = best_of_k(rollout, params, test_batch, tc, torch.Generator(device).manual_seed(seed + 1),
                            k=metrics_k)
    return video, metrics


def metrics_line(metrics: dict, k: int) -> str:
    """The best-of-K JSON line, rounded as the JAX CLI rounds it."""
    return json.dumps({
        "best_of_k": k,
        "psnr": round(float(metrics["psnr"]), 4),
        "ssim": round(float(metrics["ssim"]), 4),
        "psnr_per_step": [round(float(v), 3) for v in metrics["psnr_per_step"]],
        "ssim_per_step": [round(float(v), 4) for v in metrics["ssim_per_step"]],
    })


def write_strips(video: np.ndarray, out: str, seed: int) -> str:
    """``<out>/rollout_strips.png``: up to 4 film strips (matplotlib)."""
    from ..utils.viz import display_frames

    return display_frames(video, os.path.join(out, "rollout_strips.png"), rows=min(video.shape[0], 4), seed=seed)


def write_gif(video: np.ndarray, out: str, fps: int) -> str:
    """``<out>/rollout.gif``: the largest nx x ny grid of the videos (PIL)."""
    from ..utils.viz import save_video_gif

    n, h, t, w, c = video.shape
    nx = max(int(np.floor(np.sqrt(n))), 1)
    ny = max(n // nx, 1)
    return save_video_gif(
        video[: nx * ny].reshape(nx * ny, h, t * w, c), os.path.join(out, "rollout.gif"),
        nx, ny, time_steps=t, x_height=h, x_width=w, fps=fps,
    )


def main(argv: list[str] | None = None, *, device="cuda") -> int:
    """Sample as the flags say on ``device``; returns 0."""
    from ..train.rollout import graph_rollout

    args = build_parser().parse_args(argv)
    cfg, state, params, test_batch = load(args, device)
    rollout = graph_rollout(cfg, params, device=device)
    video, metrics = predict(rollout, params, test_batch, cfg, seed=args.seed, metrics_k=args.metrics_k,
                             device=device)
    if metrics is not None:
        print(metrics_line(metrics, args.metrics_k))
    video = video.cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    strip_png = write_strips(video, args.out, args.seed)
    gif = write_gif(video, args.out, args.fps)
    print(f"wrote {strip_png} and {gif} (step {state.step})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
