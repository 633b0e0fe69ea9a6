"""Sequence-parallel training: the train step with the generator's time
axis split over a mesh's ``seq`` axis, alone or on a 2-D ``data x seq``
mesh.

Counterpart of ``kccotgan_tpu/parallel/seqtrain.py``.  The generator
runs time-sharded through ``build_train_step``'s ``encode`` / ``decode``
hooks (``seqmodel.py``): each rank encodes its chunk of the frames and
decodes its chunk of the predicted frames, the recurrences relayed
around the ring.  The decoder's frames are gathered over ``seq``
(``gather_replicated``), so the smoothing over global time, both
discriminators, the Sinkhorn divergence and pM run on the whole time
axis, replicated over ``seq``: the discriminators' activations are not
split over time, where GSPMD splits them in JAX.  On a 2-D mesh the batch
is split over ``data`` too, with the exact mode's placement
(``sharding.MeshPlacement``): synced BatchNorm, gathered loss inputs.
The discriminators' gradients are summed over ``data`` and averaged over
``seq`` (every seq rank holds the same ones, up to the card's
nondeterministic kernels), the generator's summed over the whole mesh.

Divisibility: ``total_time_steps`` and ``pred_time_steps`` by the seq
size, ``batch_size`` by the data size.  JAX refuses bf16, and dropout on
a 2-D mesh, on its CPU mesh, for deadlocks of XLA:CPU's collectives; the
port runs both.  With dropout on a 2-D mesh the masks are the whole
batch's, each data rank keeping its rows, so the step equals the
one-device step.
"""

from __future__ import annotations

from ..train.steps import GanModules, build_train_step
from .comm import gather_replicated
from .mesh import Mesh
from .seqmodel import time_sharded_decode, time_sharded_encode
from .sharding import MeshPlacement, check_data_config

__all__ = ["build_seq_train_step", "check_seq_config"]


def check_seq_config(cfg, seq: int, data: int = 1) -> None:
    """``ValueError`` unless a ``data x seq`` mesh divides the config's
    times and batch."""
    if cfg.total_time_steps % seq or cfg.pred_time_steps % seq:
        raise ValueError(
            f"seq mesh size {seq} must divide total_time_steps ({cfg.total_time_steps}) "
            f"and pred_time_steps ({cfg.pred_time_steps})"
        )
    check_data_config(cfg, data)


def build_seq_train_step(cfg, mesh: Mesh):
    """``train_step(state, rows, ...) -> (state, metrics)`` on this rank of
    a seq (or data x seq) mesh: ``rows`` is the rank's ``shard_batch``
    (every frame), the state the same on every rank; the arguments are
    ``build_train_step``'s step's."""
    check_seq_config(cfg, mesh.seq, mesh.data)
    group = mesh.seq_group
    sp = GanModules(cfg, seq_axis=group)

    def encode(params, video, masks):
        return time_sharded_encode(sp.encoder, params, video, group, masks=masks)

    def decode(params, pyramid, z, masks):
        frames = time_sharded_decode(sp.decoder, params, pyramid, z, group,
                                     int_time_steps=cfg.int_time_steps, masks=masks)
        return gather_replicated(frames, 2, group) if group is not None else frames

    return build_train_step(cfg, device=mesh.device, encode=encode, decode=decode, placement=MeshPlacement(mesh))
