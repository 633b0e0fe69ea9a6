"""Multi-device training of the port over ``torch.distributed`` process
groups: the counterpart of ``kccotgan_tpu/parallel``.

``mesh`` (jobs, meshes and the backend), ``comm`` (collectives with their
gradients), ``seqpar`` (the ring relay), ``sharding`` (data parallelism:
the exact global-batch step and the per-shard one), ``seqmodel`` and
``seqtrain`` (sequence parallelism of the generator), ``launch``
(spawning a job's ranks).  The modules that build train steps import the
model layers, which import ``comm`` and ``seqpar``, so they are loaded
when first named here.
"""

import importlib

from .comm import all_reduce_sum, gather_replicated, gather_resharded
from .mesh import Mesh, data_seq_mesh, initialize_multihost, make_mesh, seq_mesh
from .seqpar import time_sharded_scan

_LAZY = {
    "MeshPlacement": "sharding", "build_sharded_train_step": "sharding", "replicate_state": "sharding",
    "shard_batch": "sharding", "time_sharded_decode": "seqmodel", "time_sharded_encode": "seqmodel",
    "build_seq_train_step": "seqtrain", "run_ranks": "launch",
}

__all__ = [
    "Mesh", "all_reduce_sum", "data_seq_mesh", "gather_replicated", "gather_resharded", "initialize_multihost",
    "make_mesh", "seq_mesh", "time_sharded_scan", *_LAZY,
]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
