"""Autoregressive rollout (conditional video prediction) in PyTorch.

Counterpart of ``kccotgan_tpu/train/rollout.py``: the encoder runs over
the context once and keeps its ConvLSTM carries; each predicted frame is
decoded from the last frame's features and noise, then encoded onto the
carries, so the rollout does O(T) encoder work.  Both run with
``training=False``, so a model trained with dropout samples without it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from ..models.layers import ConvLSTM2D
from ..models.video import generator_modules

__all__ = ["build_rollout"]


def build_rollout(cfg, *, device="cuda", plain=False) -> Callable:
    """Returns ``rollout(params, context, generator=None, z=None)``.

    ``params`` is ``{"encoder": ..., "decoder": ...}``, each a mapping of
    ``state_dict`` keys to tensors on ``device`` (``weights.py``).
    ``context`` is the film-strip ``[B, H, Tc, W, C]``; the result is
    ``[B, H, Tc + pred_time_steps, W, C]`` with the context unchanged.
    ``z``, if given, is ``[pred_time_steps, B, 1, z_h, z_w, z_c]``;
    otherwise each step draws ``torch.randn`` from ``generator``.
    ``context`` and ``z`` live on ``device``, the card unless the caller
    asks for the CPU.  ``plain=True`` runs the ConvLSTM recurrences'
    plain PyTorch version on any device instead of the CUDA kernel: the
    kernel path's reference.
    """
    m = cfg.model
    num_steps = cfg.pred_time_steps
    # The modules only describe the computation: every parameter comes
    # from ``params`` at call time, so they hold no storage.
    with torch.device("meta"):
        encoder, decoder = generator_modules(cfg)
    for module in (*encoder.modules(), *decoder.modules()):
        if isinstance(module, ConvLSTM2D):
            module.plain = plain

    @torch.inference_mode()
    def rollout(params, context, generator=None, z=None):
        enc_p, dec_p = params["encoder"], params["decoder"]

        def encode(video, **kw):
            return functional_call(
                encoder, enc_p, (video,), dict(return_carry=True, training=False, **kw), strict=True
            )

        pyramid, carry = encode(context)
        feats = [p[:, -1:] for p in pyramid]
        z_shape = (context.shape[0], 1, m.z_height, m.z_width, m.z_channels)
        frames = []
        for s in range(num_steps):
            zs = z[s] if z is not None else torch.randn(
                z_shape, generator=generator, device=device
            )
            frame = functional_call(decoder, dec_p, (feats, zs), {"training": False}, strict=True)
            pyramid, carry = encode(frame, carry=carry, slice_time=False)
            feats = [p[:, -1:] for p in pyramid]
            frames.append(frame)
        return torch.cat([context, *frames], dim=2)

    return rollout
