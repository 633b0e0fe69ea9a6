"""Sequence parallelism of the generator: its encoder and decoder with
the time axis split over a seq group.

Counterpart of ``kccotgan_tpu/parallel/seqmodel.py``.  The modules are
built with ``seq_axis`` set to the group (``models/video.py``), so their
ConvLSTM recurrences run as ring relays (``seqpar.py``); the per-frame
work (the hoisted input convs, LayerNorm, the decoder's ConvTranspose)
runs on the rank's own frames.  The slices in global time, the
pyramid's ``[:, Tc-1:]`` followed by the decoder's ``[:, :-1]``, cannot
be taken from one chunk: each level is gathered over the group
(``gather_resharded``: every rank goes on with its own chunk of the
slice) and the rank's chunk of the slice taken.  Dropout masks must be
the same on every rank of the group (Keras shares them over time): the
train step draws them from the same key everywhere.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.func import functional_call

from .comm import gather_resharded

__all__ = ["time_sharded_decode", "time_sharded_encode"]


def _place(group) -> tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def time_sharded_encode(encoder, params, video, group, *, masks=None):
    """The encoder's training pyramid on this rank's chunk of frames of
    ``video [B, H, T, W, C]`` (every frame of the rank's rows), not yet
    sliced in time: 5 levels ``[B, T / S, h, w, c]``.  ``encoder`` is a
    ``VideoEncoder`` built with ``seq_axis=group``."""
    r, s = _place(group)
    t = video.shape[2]
    if t % s:
        raise ValueError(f"{t} frames do not split over {s} seq ranks")
    n = t // s
    return functional_call(encoder, params, (video[:, :, r * n : (r + 1) * n],),
                           {"training": True, "masks": masks, "slice_time": False})


def time_sharded_decode(decoder, params, pyramid, z, group, *, int_time_steps, masks=None):
    """This rank's chunk of the decoder's training frames ``[B, H, T_z /
    S, W, C]`` from the encoder's time-sharded ``pyramid``
    (``time_sharded_encode``) and the noise ``z [B, T_z, ...]`` of the
    whole predicted time: teacher forcing on the skips ``[:, Tc-1 : -1]``
    in global time."""
    r, s = _place(group)
    t = z.shape[1]
    if t % s:
        raise ValueError(f"{t} predicted frames do not split over {s} seq ranks")
    n = t // s
    skips = []
    for level in pyramid:
        whole = gather_resharded(level, 1, group) if group is not None else level
        skips.append(whole[:, int_time_steps - 1 : -1][:, r * n : (r + 1) * n])
    return functional_call(decoder, params, (skips, z[:, r * n : (r + 1) * n]),
                           {"training": True, "masks": masks, "pre_sliced": True})
