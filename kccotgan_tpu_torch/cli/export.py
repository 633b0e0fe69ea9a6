"""Export CLI: package a trained checkpoint as a serving artifact.

Counterpart of ``kccotgan_tpu/cli/export.py``, with its flags: restores
the port's checkpoint and writes ONE self-contained file through
``torch.export`` (``kccotgan_tpu_torch/export.py``): weights baked in,
the batch symbolic unless ``--batch`` bakes one.  ``--platforms`` is
refused: the artifact runs on the device it was exported on, the card
unless ``main`` is given ``device="cpu"``.  ``--check`` reloads the
artifact and requires it to reproduce the live rollout bit for bit on
the same device, context and noise.

  python -m kccotgan_tpu_torch.cli.export --preset mmnist_full \\
      --ckpt trained/run/ckpt --out model.kccot --check
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .main import _Refused

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="kccotgan_tpu_torch exporter")
    p.add_argument("--preset", type=str, default="mmnist_small")
    p.add_argument("--ckpt", type=str, required=True, help="checkpoint dir written by the trainer")
    p.add_argument("--out", type=str, default="model.kccot")
    p.add_argument("--batch", type=int, default=None,
                   help="bake a static batch size (default: symbolic, so that "
                        "one artifact serves any batch)")
    p.add_argument("--platforms", action=_Refused,
                   reason="a torch.export program runs on the device it was exported on "
                          "(the card, or the CPU when asked); jax.export's multi-platform "
                          "lowering has no counterpart")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and verify it reproduces "
                        "the live rollout bit-for-bit on a synthetic batch")
    return p


def main(argv: list[str] | None = None, *, device="cuda") -> int:
    """Export as the flags say on ``device``; returns 0, or 1 if the check
    failed."""
    from ..ckpt import restore_checkpoint
    from ..config import get_preset
    from ..export import load_rollout, save_rollout
    from ..train.rollout import build_rollout

    args = build_parser().parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cli.export: no CUDA device")
    cfg = get_preset(args.preset)
    state = restore_checkpoint(args.ckpt, cfg, device=device)
    header = save_rollout(args.out, cfg, state, batch_polymorphic=args.batch is None,
                          batch_size=args.batch, device=device)
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({size_mb:.1f} MB): {header}")

    if args.check:
        m = cfg.model
        b = args.batch or 2
        ctx = np.random.RandomState(0).rand(
            b, m.x_height, cfg.int_time_steps, m.x_width, m.n_channels
        ).astype("float32")
        ctx = torch.from_numpy(ctx).to(device)
        serve = load_rollout(args.out)
        got = serve(ctx, seed=0)
        params = {"encoder": state.enc_params, "decoder": state.dec_params}
        want = build_rollout(cfg, device=device)(params, ctx, z=serve.noise(b, seed=0))
        err = float((got - want).abs().max())
        print(f"check: max|artifact - live rollout| = {err} on batch {b}")
        if err != 0.0:
            print("CHECK FAILED", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
