"""Data-parallel training over a mesh's ``data`` axis.

Counterpart of ``kccotgan_tpu/parallel/sharding.py``, with its two modes:

* **Exact** (``cfg.global_batch_sinkhorn``, the default): each rank runs
  the generator and both discriminators on its ``B / N`` rows, the
  discriminators' BatchNorm statistics taken over the whole batch
  (``BatchNorm`` over ``data_group``); the four feature stacks and the
  two smoothed videos are gathered (``gather_replicated``), so every rank
  computes the same mixed Sinkhorn divergence and pM on the global batch;
  each phase's gradients are summed over the ranks in one flattened
  all-reduce, and the four Adams run alike on every rank.  The noise and
  the dropout masks are drawn for the whole batch, from the same key on
  every rank, and each rank keeps its rows, so the step is the one-device
  step up to the order of sums.  JAX runs this mode through GSPMD and,
  since GSPMD cannot partition a Mosaic call, on its scan engine; the
  port keeps its kernels on every rank.
* **Per shard** (``--local_sinkhorn``): JAX's ``axis_name`` mode.  Each
  rank draws its noise and masks from keys folded with its rank, solves
  the Sinkhorn problems and pM on its shard, and the gradients, pM, the
  loss and the statistics are averaged over the ranks.  The objective is
  then the mean of the shards' divergences.

``MeshPlacement`` carries the exact modes into ``build_train_step``; the
sequence-parallel step (``seqtrain.py``) uses it too, on a 2-D mesh.  On
a data mesh over NCCL the exact step replays one CUDA graph a step, its
collectives in it (``MeshPlacement.graphable``); the per-shard mode, gloo
and meshes with a seq axis run eagerly.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.distributed as dist

from ..train.state import GROUPS, TrainState, state_tensors, state_with_tensors
from ..train.steps import Placement, build_train_step
from .comm import all_reduce_sum_flat, broadcast_, gather_replicated
from .mesh import Mesh

__all__ = ["MeshPlacement", "build_sharded_train_step", "replicate_state", "shard_batch"]


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's state on every rank: every tensor and integer broadcast
    from rank 0, then a checksum of the whole gathered from every rank,
    which must be the same everywhere (else ``RuntimeError``)."""
    if mesh.world is None:
        return state
    tensors = list(state_tensors(state).values())
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    ints = [state.step, state.rng] + [getattr(state, f"{g}_opt").count for g in GROUPS]
    ints_t = torch.tensor(ints, dtype=torch.int64, device=flat.device)
    broadcast_(flat, 0, mesh.world)
    broadcast_(ints_t, 0, mesh.world)
    ints = [int(v) for v in ints_t.tolist()]
    host = flat.cpu().numpy()
    check = zlib.crc32(np.asarray(ints, np.int64).tobytes(), zlib.crc32(host.tobytes()))
    sums = [torch.zeros(1, dtype=torch.int64, device=flat.device) for _ in range(mesh.size)]
    dist.all_gather(sums, torch.tensor([check], dtype=torch.int64, device=flat.device), group=mesh.world)
    if len({int(s) for s in sums}) != 1:
        raise RuntimeError(f"replicate_state: the ranks' checksums differ: {[int(s) for s in sums]}")
    parts = [p.view(t.shape).to(t.dtype) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]
    return state_with_tensors(state, parts, step=ints[0], rng=ints[1], counts=ints[2:])


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a host batch ``[B, H, T, W, C]`` (every frame:
    under sequence parallelism the discriminators read them all, and the
    encoder takes its frames itself)."""
    b = batch.shape[0]
    if b % mesh.data:
        raise ValueError(f"a batch of {b} rows does not split over {mesh.data} data ranks")
    n = b // mesh.data
    return batch[mesh.data_rank * n : (mesh.data_rank + 1) * n]


class MeshPlacement(Placement):
    """The exact modes' placement on ``mesh`` (``train.steps.Placement``):
    rows over ``data``; BatchNorm, the smoothing's maximum and the loss's
    inputs over ``data_group``; the generator's gradients summed over the
    whole mesh, the discriminators' summed over ``data`` and averaged over
    ``seq``.  Every seq rank runs the discriminators on the same inputs,
    so their gradients agree but for the card's nondeterministic kernels
    (cuDNN's weight gradients may add in any order); the average over the
    replicas keeps them, and so the state, equal on every rank to the
    bit."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.bn_group = mesh.data_group
        self.rows = mesh.data

    @property
    def graphable(self) -> bool:
        """A data mesh over NCCL: the synced BatchNorm's all-reduces, the
        gathers, the smoothing's maximum and the gradients' all-reduces
        are captured in the step's CUDA graph.  gloo's collectives run on
        the host, and a seq axis brings the ring relay's hooks: eager."""
        return self.mesh.seq == 1 and self.mesh.backend == "nccl"

    def _rows(self, x, n):
        i = self.mesh.data_rank
        return x[i * n : (i + 1) * n]

    def noise(self, z):
        return self._rows(z, z.shape[0] // self.rows) if self.rows > 1 else z

    def masks(self, source):
        if self.rows == 1:
            return source

        def draw(keep, shape):
            return self._rows(source(keep, (shape[0] * self.rows, *shape[1:])), shape[0])

        return draw

    def loss_inputs(self, xs):
        if self.mesh.data_group is None:
            return xs
        return tuple(gather_replicated(x, 0, self.mesh.data_group) for x in xs)

    def sum_grads(self, phase, grads):
        if self.mesh.world is None:
            return grads
        replicas = self.mesh.seq if phase == "disc" else 1
        sums = iter(all_reduce_sum_flat([v for g in grads for v in g.values()], self.mesh.world))
        return [{k: next(sums) / replicas for k in g} for g in grads]


def check_data_config(cfg, data: int) -> None:
    """``ValueError`` unless ``data`` ranks divide the config's batch."""
    if cfg.batch_size % data:
        raise ValueError(f"data mesh size {data} must divide batch_size ({cfg.batch_size})")


def build_sharded_train_step(cfg, mesh: Mesh):
    """``train_step(state, rows, ...) -> (state, metrics)`` on this rank of
    a data mesh, ``rows`` its ``shard_batch`` of the global batch; the
    state must be the same on every rank (``replicate_state``).  The mode
    comes from ``cfg.global_batch_sinkhorn`` (module docstring); the
    arguments are ``build_train_step``'s step's."""
    check_data_config(cfg, mesh.data)
    if cfg.global_batch_sinkhorn:
        return build_train_step(cfg, device=mesh.device, placement=MeshPlacement(mesh))
    return build_train_step(cfg, device=mesh.device, group=mesh.data_group)
