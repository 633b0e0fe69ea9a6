"""Process groups of the port's meshes.

Counterpart of ``kccotgan_tpu/parallel/mesh.py`` and of the mesh
constructors of ``kccotgan_tpu/parallel/seqmodel.py``.  A mesh is a
``torch.distributed`` job of ``data * seq`` ranks, one process each:
rank ``r`` holds data index ``r // seq`` and seq index ``r % seq`` (seq
is the minor axis, as in JAX, so the ring relay's neighbours are
adjacent ranks).  ``Mesh`` carries the rank, its device, the backend and
three groups: the world, ``data_group`` (the ranks of one seq index,
over which the batch is sharded) and ``seq_group`` (the ranks of one data
index, over which the generator's time axis is sharded).

The backend comes from the placement alone (``choose_backend``): NCCL
when every rank on a host has a card of its own, gloo when ranks share a
card (NCCL refuses two ranks on one device) or run on the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = [
    "Mesh", "choose_backend", "data_seq_mesh", "init_distributed", "initialize_multihost", "make_mesh",
    "rank_device", "seq_mesh",
]

# A collective that waits longer than this raises instead of hanging.
TIMEOUT = timedelta(seconds=60)


def rank_device(local_rank: int, device="cuda") -> torch.device:
    """The device of a rank: ``cuda:(local_rank % device_count)``, or the
    CPU when the caller asks for it."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("mesh: no CUDA device")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device, local_world_size: int) -> str:
    """``'nccl'`` when the ranks run on cards and each rank of this host
    has one of its own, else ``'gloo'`` (ranks sharing a card, or on the
    CPU)."""
    if torch.device(device).type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(rank: int, world_size: int, init_method: str, *, local_rank: int | None = None,
                     local_world_size: int | None = None, device="cuda") -> torch.device:
    """Join the job as ``rank`` of ``world_size`` at ``init_method``, on
    the backend ``choose_backend`` gives for this placement (printed by
    rank 0); returns the rank's device.  Collectives time out after
    ``TIMEOUT``."""
    local_rank = rank if local_rank is None else local_rank
    local_world_size = world_size if local_world_size is None else local_world_size
    dev = rank_device(local_rank, device)
    backend = choose_backend(dev, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if rank == 0:
        print(f"[mesh] {world_size} rank(s), {local_world_size} on this host, device {dev.type}: {backend}",
              flush=True)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, timeout=TIMEOUT)
    return dev


def initialize_multihost(device="cuda") -> int:
    """Join a job that torchrun started (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``
    in the environment) and return its world size; without that
    environment, or when the process has joined already, nothing is done
    (1, or the joined world's size)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 1
    world = int(os.environ["WORLD_SIZE"])
    init_distributed(
        int(os.environ["RANK"]), world, "env://", local_rank=int(os.environ.get("LOCAL_RANK", 0)),
        local_world_size=int(os.environ.get("LOCAL_WORLD_SIZE", world)), device=device,
    )
    return world


@dataclass(frozen=True)
class Mesh:
    """A ``data x seq`` mesh as seen from one rank (module docstring).
    A group is None where its axis has one rank, so code on it runs as on
    one device; ``world`` is None for a mesh of one rank without a job."""

    data: int
    seq: int
    rank: int
    device: torch.device
    backend: str | None
    world: object
    data_group: object
    seq_group: object

    @property
    def size(self) -> int:
        return self.data * self.seq

    @property
    def data_rank(self) -> int:
        return self.rank // self.seq


def _mesh(data: int, seq: int, device) -> Mesh:
    if data < 1 or seq < 1:
        raise ValueError(f"mesh {data} x {seq}: each axis needs at least one rank")
    n = data * seq
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs a job: init_distributed or initialize_multihost first")
        return Mesh(1, 1, 0, torch.device(device), None, None, None, None)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {data} x {seq} needs {n} ranks, the job has {world}")
    rank = dist.get_rank()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    whole = dist.group.WORLD
    # every rank creates every group, in the same order
    data_groups = [[d * seq + s for d in range(data)] for s in range(seq)]
    seq_groups = [[d * seq + s for s in range(seq)] for d in range(data)]
    data_group = seq_group = None
    if 1 < data < n:
        data_group = [dist.new_group(g) for g in data_groups][rank % seq]
    elif data == n > 1:
        data_group = whole
    if 1 < seq < n:
        seq_group = [dist.new_group(g) for g in seq_groups][rank // seq]
    elif seq == n > 1:
        seq_group = whole
    return Mesh(data, seq, rank, dev, dist.get_backend(), whole, data_group, seq_group)


def make_mesh(n_devices: int = 1, *, device="cuda") -> Mesh:
    """A 1-D data mesh over the job's ``n_devices`` ranks; ``device`` is
    this rank's (``init_distributed`` returns it)."""
    return _mesh(n_devices, 1, device)


def seq_mesh(n_devices: int = 1, *, device="cuda") -> Mesh:
    """A 1-D seq mesh: the generator's time axis over ``n_devices`` ranks."""
    return _mesh(1, n_devices, device)


def data_seq_mesh(data: int, seq: int, *, device="cuda") -> Mesh:
    """A 2-D ``data x seq`` mesh, seq the minor axis."""
    return _mesh(data, seq, device)
