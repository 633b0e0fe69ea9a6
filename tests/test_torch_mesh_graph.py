"""The exact data-parallel step replayed from one CUDA graph, its
collectives in it, on the ranks of an NCCL job on the card.

Needs NVIDIA GPUs: every test skips without one, and a world of W ranks
skips where the machine has fewer than W cards (NCCL takes a card a
rank).  Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_mesh_graph.py

One job a world (``parallel.launch.run_ranks``), started by the first
test that needs it, runs every scenario; the tests read its ranks'
results.  W = 1 is a job of one rank whose data group is the whole job,
so that every collective of the exact step (the synced BatchNorm's
all-reduces, the gathers of the loss's inputs, the smoothing's global
maximum, the gradients' all-reduces) runs on one card; W = 2 and 4 split
the batch's rows (4 a rank).

* Under cuDNN's deterministic algorithms, in f32 and bf16 under
  ``'pallas'``, without smoothing and with '3d' smoothing at one sigma:
  three runs of four steps from one replicated state, batches and noise,
  two eager (the same placement, which the gate is told to leave eager)
  and one graphed.  Every loss, pM, parameter, moment and statistic of
  the graphed run equals the eager runs' to the bit where the two eager
  runs agree to the bit, and lies within twice their gap elsewhere; one
  eager call, one capture and three replays; the graphed state the same
  on every rank to the bit.
* Each step, replayed or not, advances ``comm.COUNTERS``' calls and
  bytes of each collective, and the kernels' counters, as an eager step
  does.
* The per-shard mode, a seq mesh (W = 2; a 2 x 2 data x seq mesh at
  W = 4) and the exact mode over gloo run eagerly on the card.
"""

import dataclasses
import zlib

import pytest
import torch
import torch.distributed as dist

from kccotgan_tpu_torch.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch.data import bouncing_blobs
from kccotgan_tpu_torch.parallel import comm
from kccotgan_tpu_torch.parallel.launch import run_ranks
from kccotgan_tpu_torch.parallel.mesh import Mesh, data_seq_mesh, make_mesh, seq_mesh
from kccotgan_tpu_torch.parallel.seqtrain import build_seq_train_step
from kccotgan_tpu_torch.parallel.sharding import MeshPlacement, build_sharded_train_step, replicate_state, shard_batch
from kccotgan_tpu_torch.train import build_train_step, create_train_state
from kccotgan_tpu_torch.train.state import state_tensors
from kccotgan_tpu_torch.train.steps import _KERNEL_COUNTERS

pytestmark = pytest.mark.cuda

ROWS = 4  # a rank's rows
STEP_CFG = TrainConfig(
    dname="synthetic", batch_size=ROWS, total_time_steps=4, int_time_steps=2, sinkhorn_l=5, warmup_steps=1,
    kernel_impl="pallas",
    model=ModelConfig(x_height=16, x_width=16, g_filter_size=2, d_filter_size=1, d_state_size=2,
                      z_channels=2, z_height=1, z_width=1),
)
VARIANTS = {"pallas": {}, "smooth_3d": {"kernel": "3d"}}
DTYPES = ("float32", "bfloat16")
GAP_FACTOR = 2
EAGER_MODES = ("per_shard", "seq", "gloo")


class _EagerPlacement(MeshPlacement):
    """The same placement, which the gate leaves eager."""

    graphable = False


def _data_mesh(world, dev):
    if world > 1:
        return make_mesh(world, device=dev)
    whole = dist.group.WORLD
    return Mesh(1, 1, 0, dev, dist.get_backend(), whole, whole, None)


def _counters():
    return ([c[k] for c in comm.COUNTERS.values() for k in ("calls", "bytes")]
            + [getattr(obj, name) for obj, name in _KERNEL_COUNTERS])


def _run(step, cfg, mesh, dev, inject=True):
    """Four steps from the seeded state, replicated, with the whole
    batch's noise injected (else drawn by the step): per step the leaves
    returned (by name) and the counters' advance."""
    state = replicate_state(create_train_state(cfg, generator=torch.Generator().manual_seed(0), device=dev), mesh)
    b = cfg.batch_size
    data = bouncing_blobs(4 * b, cfg.total_time_steps, 16, 16, seed=3)
    gen = torch.Generator(device=dev).manual_seed(7)
    zshape = (b, cfg.pred_time_steps, 1, 1, cfg.model.z_channels)
    out = []
    for i in range(4):
        rows = torch.from_numpy(shard_batch(data[i * b: (i + 1) * b], mesh)).to(dev)
        z = tuple(torch.randn(zshape, generator=gen, device=dev) for _ in range(2)) if inject else None
        before = _counters()
        state, met = step(state, rows, z=z)
        torch.cuda.synchronize()
        leaves = {k: v.clone() for k, v in state_tensors(state).items()}
        leaves.update(loss=met["sinkhorn_loss"].clone(), pm=met["pm"].clone())
        out.append((leaves, [a - n for a, n in zip(_counters(), before)]))
    return out, state


def _largest_gap(a, b):
    return {k: max(float((x[k].double() - y[k].double()).abs().max()) for (x, _), (y, _) in zip(a, b))
            for k in a[0][0]}


def _graphed_against_eager(dev, world):
    """Per variant and dtype: the gaps between the runs, the counters'
    advance a step, the graphed step's counts and a checksum of its
    final state."""
    mesh = _data_mesh(world, dev)
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for variant, over in VARIANTS.items():
            for dtype in DTYPES:
                cfg = dataclasses.replace(STEP_CFG, batch_size=ROWS * world, compute_dtype=dtype, **over)
                e1, _ = _run(build_train_step(cfg, device=dev, placement=_EagerPlacement(mesh)), cfg, mesh, dev)
                e2, _ = _run(build_train_step(cfg, device=dev, placement=_EagerPlacement(mesh)), cfg, mesh, dev)
                step = build_sharded_train_step(cfg, mesh)
                graphed, state = _run(step, cfg, mesh, dev)
                final = torch.cat([v.detach().float().reshape(-1) for v in state_tensors(state).values()])
                out[f"{variant}-{dtype}"] = {
                    "eager_gap": _largest_gap(e1, e2),
                    "graph_gap": {k: max(a, b) for (k, a), b in
                                  zip(_largest_gap(graphed, e1).items(), _largest_gap(graphed, e2).values())},
                    "moved": [m for _, m in graphed], "eager_moved": [m for _, m in e1],
                    "counts": dict(step.counts), "checksum": zlib.crc32(final.cpu().numpy().tobytes()),
                }
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def _eager_modes(rank, dev, world):
    """The counts of the steps the gate leaves eager, on the card."""
    cfg = dataclasses.replace(STEP_CFG, batch_size=ROWS * world)
    mesh = _data_mesh(world, dev)
    step = build_sharded_train_step(dataclasses.replace(cfg, global_batch_sinkhorn=False), mesh)
    _run(step, cfg, mesh, dev, inject=False)
    out = {"per_shard": dict(step.counts)}
    if world > 1:
        sp = seq_mesh(world, device=dev) if world == 2 else data_seq_mesh(world // 2, 2, device=dev)
        step = build_seq_train_step(dataclasses.replace(cfg, batch_size=ROWS * sp.data), sp)
        _run(step, dataclasses.replace(cfg, batch_size=ROWS * sp.data), sp, dev, inject=False)
        out["seq"] = dict(step.counts)
    gloo = dist.new_group(backend="gloo")
    gm = Mesh(world, 1, rank, dev, "gloo", gloo, gloo, None)
    step = build_sharded_train_step(cfg, gm)
    _run(step, cfg, gm, dev, inject=False)
    out["gloo"] = dict(step.counts)
    return out


def run_world(rank, dev, world):
    torch.backends.cudnn.allow_tf32 = False
    return {"backend": dist.get_backend(), "graphed": _graphed_against_eager(dev, world),
            "eager_modes": _eager_modes(rank, dev, world)}


_JOBS: dict = {}


def _job(world):
    """The ranks' results of the job of ``world`` ranks, run once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if torch.cuda.device_count() < world:
        pytest.skip(f"{world} NCCL ranks need {world} cards, the machine has {torch.cuda.device_count()}")
    if world not in _JOBS:
        _JOBS[world] = run_ranks(run_world, world, (world,), device="cuda", timeout=900)
    return _JOBS[world]


WORLDS = (1, 2, 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("world", WORLDS)
def test_graphed_mesh_step_equals_the_eager_mesh_step(world, variant, dtype):
    results = _job(world)
    assert all(r["backend"] == "nccl" for r in results)
    for rank, res in enumerate(results):
        got = res["graphed"][f"{variant}-{dtype}"]
        assert got["counts"] == {"eager": 1, "captures": 1, "replays": 3}, rank
        over = {k: (g, got["eager_gap"][k]) for k, g in got["graph_gap"].items()
                if g > GAP_FACTOR * got["eager_gap"][k]}
        assert not over, (rank, over)
    assert len({r["graphed"][f"{variant}-{dtype}"]["checksum"] for r in results}) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_a_mesh_replay_counts_the_collectives_as_an_eager_step(world):
    for res in _job(world):
        for name, got in res["graphed"].items():
            n_comm = 2 * len(comm.COUNTERS)
            assert all(sum(m[:n_comm]) > 0 for m in got["eager_moved"]), name
            assert got["moved"] == got["eager_moved"], name


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_steps_the_gate_leaves_out_run_eagerly_on_the_card(world):
    for res in _job(world):
        modes = res["eager_modes"]
        assert set(modes) == set(EAGER_MODES if world > 1 else ("per_shard", "gloo"))
        for mode, counts in modes.items():
            assert counts == {"eager": 4, "captures": 0, "replays": 0}, mode
