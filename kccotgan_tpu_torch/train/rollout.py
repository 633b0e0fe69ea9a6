"""Autoregressive rollout (conditional video prediction) in PyTorch.

Counterpart of ``kccotgan_tpu/train/rollout.py``: the encoder runs over
the context once and keeps its ConvLSTM carries; each predicted frame is
decoded from the last frame's features and noise, then encoded onto the
carries, so the rollout does O(T) encoder work.  Both run with
``training=False``, so a model trained with dropout samples without it.

The computation is one module, ``RolloutModule`` (``forward(context,
z)``).  ``build_rollout`` calls it with the weights of each call, so the
trainer samples with the parameters of its step; ``graph_rollout`` fixes
the weights and, on the card, replays one CUDA graph per batch size and
dtype (``graph.GraphReplay``); ``export.py`` exports it with the weights
baked in.  Noise comes from ``draw_noise``, outside any graph.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from ..models.layers import ConvLSTM2D
from ..models.video import generator_modules
from .graph import GraphReplay

__all__ = ["RolloutModule", "build_rollout", "draw_noise", "graph_rollout", "module_weights"]


def draw_noise(generator, steps: int, shape, device) -> torch.Tensor:
    """``z [steps, *shape]``: one ``torch.randn(shape)`` a predicted frame,
    in order, from ``generator`` (the default generator if None)."""
    return torch.stack([torch.randn(shape, generator=generator, device=device) for _ in range(steps)])


def _z_shape(cfg, batch: int) -> tuple:
    m = cfg.model
    return (batch, 1, m.z_height, m.z_width, m.z_channels)


class RolloutModule(nn.Module):
    """The rollout of ``cfg``'s generator: ``forward(context [B, H, Tc, W,
    C], z [Tp, B, 1, z_h, z_w, z_c]) -> [B, H, Tc + Tp, W, C]``, the
    context unchanged.  Its ``state_dict`` keys are the encoder's and the
    decoder's prefixed by ``encoder.`` and ``decoder.``.  ``plain=True``
    runs the ConvLSTM recurrences' plain PyTorch version on any device
    instead of the CUDA kernel: the kernel path's reference."""

    def __init__(self, cfg, *, plain: bool = False):
        super().__init__()
        self.encoder, self.decoder = generator_modules(cfg)
        for module in self.modules():
            if isinstance(module, ConvLSTM2D):
                module.plain = plain

    def forward(self, context, z):
        def encode(video, **kw):
            return self.encoder(video, return_carry=True, training=False, **kw)

        pyramid, carry = encode(context)
        feats = [p[:, -1:] for p in pyramid]
        frames = []
        for s in range(z.shape[0]):
            frame = self.decoder(feats, z[s], training=False)
            pyramid, carry = encode(frame, carry=carry, slice_time=False)
            feats = [p[:, -1:] for p in pyramid]
            frames.append(frame)
        return torch.cat([context, *frames], dim=2)


def module_weights(params) -> dict:
    """``RolloutModule`` weights from ``{"encoder": ..., "decoder": ...}``."""
    return {f"{part}.{k}": v for part in ("encoder", "decoder") for k, v in params[part].items()}


def build_rollout(cfg, *, device="cuda", plain=False) -> Callable:
    """Returns ``rollout(params, context, generator=None, z=None)``.

    ``params`` is ``{"encoder": ..., "decoder": ...}``, each a mapping of
    ``state_dict`` keys to tensors on ``device`` (``weights.py``).
    ``context`` is the film-strip ``[B, H, Tc, W, C]``; the result is
    ``[B, H, Tc + pred_time_steps, W, C]`` with the context unchanged.
    ``z``, if given, is ``[pred_time_steps, B, 1, z_h, z_w, z_c]``;
    otherwise it is ``draw_noise`` from ``generator``.  ``context`` and
    ``z`` live on ``device``, the card unless the caller asks for the CPU.
    ``plain=True``: ``RolloutModule``'s reference path.
    """
    # The module only describes the computation: every weight comes from
    # ``params`` at call time, so it holds no storage.
    with torch.device("meta"):
        module = RolloutModule(cfg, plain=plain)

    @torch.inference_mode()
    def rollout(params, context, generator=None, z=None):
        if z is None:
            z = draw_noise(generator, cfg.pred_time_steps, _z_shape(cfg, context.shape[0]), device)
        return functional_call(module, module_weights(params), (context, z), strict=True)

    return rollout


def graph_rollout(cfg, params, *, device="cuda") -> Callable:
    """``build_rollout``'s ``rollout(params, context, generator=None,
    z=None)`` for these ``params`` alone: on the card the rollout of each
    (batch size, dtype) is captured once into a CUDA graph and replayed
    (``GraphReplay``), the noise drawn outside the graph; on the CPU it is
    the eager rollout.  Either gives the eager rollout's result to the bit.
    A call with other ``params`` raises: the graph reads the weights it
    was captured with."""
    rollout = build_rollout(cfg, device=device)
    replay = None
    if torch.device(device).type == "cuda":
        replay = GraphReplay(lambda context, z: rollout(params, context, z=z))

    def graphed(p, context, generator=None, z=None):
        if p is not params:
            raise ValueError("graph_rollout: called with other parameters than it holds")
        if z is None:
            z = draw_noise(generator, cfg.pred_time_steps, _z_shape(cfg, context.shape[0]), device)
        return rollout(params, context, z=z) if replay is None else replay(context, z)

    return graphed
