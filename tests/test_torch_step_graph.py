"""The training step's CUDA-graph path, on the CPU (no JAX).

``build_train_step`` replays the step from a captured CUDA graph
(``train/graph.py::StepGraph``) where ``replays_graph`` says so: the
one-device step on the card, and the exact mode on a data mesh over
NCCL, when they draw no dropout masks and smooth at one sigma every
step.  Here: that gate, case by case, the meshes' on stand-in meshes
(the gate reads a mesh's axes and backend alone); every step the CPU
runs, and every step the gate leaves out, runs eagerly and its counts
say so (``Trainer.timings["graph"]`` too); Keras Adam given its step size
as a tensor, as the graph's replays give it, equals the update as it was
written before, to the bit; and the graph path's host side (the state in
and out through the graph's buffers, the noise drawn into its buffers, each
Adam's step size, the counts, nothing the caller keeps overwritten by a
later call) equals the eager step to the bit over four steps, with
``StepGraph``'s capture replaced by running the step's function itself.
The capture and replay themselves need the card:
``tests/test_torch_cuda.py::test_graphed_step_equals_the_eager_step``,
and on a mesh ``tests/test_torch_mesh_graph.py``.

The geometry is ``tests/test_torch_loop.py``'s (B=2, 16x16, 2 + 1
frames, g_filter_size 2, L=3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from kccotgan_tpu_torch.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch.data import bouncing_blobs
from kccotgan_tpu_torch.train import Trainer, build_train_step, create_train_state
from kccotgan_tpu_torch.train import steps
from kccotgan_tpu_torch.train.keras_adam import KerasAdam
from kccotgan_tpu_torch.train.schedule import warmup_staircase_exponential_decay
from kccotgan_tpu_torch.train.state import GROUPS, state_tensors
from kccotgan_tpu_torch.parallel.mesh import Mesh
from kccotgan_tpu_torch.parallel.sharding import MeshPlacement
from kccotgan_tpu_torch.train.steps import Placement, replays_graph
from tests._torch_dist import EagerStepGraph

torch.set_num_threads(1)

CFG = TrainConfig(
    dname="synthetic", batch_size=2, total_time_steps=3, int_time_steps=2, sinkhorn_l=3,
    warmup_steps=1, save_freq=10_000, ckpt_freq=10_000,
    model=ModelConfig(x_height=16, x_width=16, g_filter_size=2, d_filter_size=1, d_state_size=2,
                      z_channels=2, z_height=1, z_width=1),
)
EAGER_ONLY = {"eager": 2, "captures": 0, "replays": 0}


def _with(**over):
    model = {k: over.pop(k) for k in ("dropout", "rnn_dropout") if k in over}
    return dataclasses.replace(CFG, model=dataclasses.replace(CFG.model, **model), **over)


def _mesh(data, seq, backend):
    """A stand-in ``Mesh`` of ``data x seq`` ranks on the card: its groups
    are placeholders, since the gate reads the mesh's axes and backend."""
    group = object()
    return Mesh(data, seq, 0, torch.device("cuda", 0), backend, group,
                group if data > 1 else None, group if seq > 1 else None)


DATA4 = _mesh(4, 1, "nccl")


@pytest.mark.parametrize("device,over,hooks,graphed", [
    ("cuda", {}, {}, True),
    ("cuda", {"kernel_impl": "pallas"}, {}, True),
    ("cuda", {"kernel_impl": "pallas", "fused_discriminators": True}, {}, True),
    ("cuda", {"kernel": "3d"}, {}, True),  # smoothing at one sigma
    ("cuda", {"decaying_sigma": True}, {}, True),  # sigma unread: smoothing off
    ("cpu", {}, {}, False),
    ("cuda", {"dropout": 0.1}, {}, False),
    ("cuda", {"rnn_dropout": 0.1}, {}, False),
    ("cuda", {"kernel": "1d", "decaying_sigma": True}, {}, False),
    ("cuda", {}, {"group": object()}, False),
    ("cuda", {}, {"placement": Placement()}, False),
    ("cuda", {}, {"encode": print}, False),
    ("cuda", {}, {"decode": print}, False),
    # the meshes, on stand-ins: the exact mode on a data mesh over NCCL
    # replays a graph, under the one-device step's conditions
    ("cuda", {}, {"placement": MeshPlacement(DATA4)}, True),
    ("cuda", {"kernel_impl": "pallas"}, {"placement": MeshPlacement(DATA4)}, True),
    ("cuda", {"kernel": "3d"}, {"placement": MeshPlacement(DATA4)}, True),  # the global maximum, one sigma
    ("cuda", {}, {"placement": MeshPlacement(_mesh(1, 1, "nccl"))}, True),  # a job of one rank
    ("cuda", {}, {"placement": MeshPlacement(_mesh(1, 4, "nccl"))}, False),
    ("cuda", {}, {"placement": MeshPlacement(_mesh(2, 2, "nccl"))}, False),
    ("cuda", {}, {"placement": MeshPlacement(_mesh(4, 1, "gloo"))}, False),
    ("cuda", {}, {"group": DATA4.data_group}, False),  # the per-shard mode
    ("cuda", {"dropout": 0.1}, {"placement": MeshPlacement(DATA4)}, False),
    ("cuda", {"rnn_dropout": 0.1}, {"placement": MeshPlacement(DATA4)}, False),
    ("cuda", {"kernel": "1d", "decaying_sigma": True}, {"placement": MeshPlacement(DATA4)}, False),
    ("cpu", {}, {"placement": MeshPlacement(DATA4)}, False),
], ids=["base", "pallas", "fused", "3d", "decaying_unread", "cpu", "dropout", "rnn_dropout",
        "decaying_1d", "group", "placement", "encode", "decode",
        "mesh_data", "mesh_data_pallas", "mesh_data_3d", "mesh_world1", "mesh_seq", "mesh_data_seq", "mesh_gloo",
        "mesh_per_shard", "mesh_dropout", "mesh_rnn_dropout", "mesh_decaying_1d", "mesh_cpu"])
def test_which_steps_replay_a_graph(device, over, hooks, graphed):
    assert replays_graph(_with(**over), device, **hooks) is graphed


def _batches(n):
    data = torch.from_numpy(bouncing_blobs(2 * n, CFG.total_time_steps, 16, 16, seed=3))
    return [data[2 * i: 2 * i + 2] for i in range(n)]


@pytest.mark.parametrize("over,hooks", [
    ({}, {}),
    ({"kernel_impl": "pallas"}, {}),
    ({"dropout": 0.1, "rnn_dropout": 0.1}, {}),
    ({"kernel": "1d", "decaying_sigma": True}, {}),
    ({}, {"placement": Placement()}),
], ids=["cpu", "cpu_pallas", "dropout", "decaying_1d", "placement"])
def test_steps_off_the_graph_run_eagerly_and_count_so(over, hooks):
    cfg = _with(**over)
    step = build_train_step(cfg, device="cpu", **hooks)
    state = create_train_state(cfg, device="cpu")
    for batch in _batches(2):
        state, metrics = step(state, batch)
    assert step.counts == EAGER_ONLY
    assert state.step == 2 and np.isfinite(float(metrics["sinkhorn_loss"]))


def test_trainer_reports_the_step_counts(tmp_path):
    trainer = Trainer(dataclasses.replace(CFG, out_dir=str(tmp_path)), device="cpu")
    trainer.fit(iter([b.numpy() for b in _batches(2)]))
    assert trainer.timings["graph"] == EAGER_ONLY


def _update_as_written(opt, grads, state, params):
    """``KerasAdam.update`` as written before its step size could come in
    as a tensor: computed inline on the host."""
    it = opt.keras_iter(state.count)
    lr = torch.as_tensor(opt.learning_rate(it), dtype=torch.float32)
    t = torch.tensor(it + 1, dtype=torch.float32)
    b1p = torch.tensor(opt.b1, dtype=torch.float32) ** t
    b2p = torch.tensor(opt.b2, dtype=torch.float32) ** t
    alpha = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    out = {}
    for k, p in params.items():
        g = grads[k]
        m = state.mu[k] + (g - state.mu[k]) * (1.0 - opt.b1)
        v = state.nu[k] + (torch.square(g) - state.nu[k]) * (1.0 - opt.b2)
        out[k] = (p + (-(m * alpha) / (torch.sqrt(v) + opt.eps)), m, v)
    return out


@pytest.mark.parametrize("double_step,offset", [(False, 0), (True, 0), (True, 1)])
def test_adam_step_size_as_a_tensor_equals_the_host_form(double_step, offset):
    """Over six counts, through the warmup and one decay: the update given
    ``alpha(count)`` as a 0-d view of a buffer of four (as the graph's
    replays give it) and the update computing its own both equal the
    update as written before, to the bit."""
    sched = warmup_staircase_exponential_decay(5e-4, 3, 2, 0.9)
    opt = KerasAdam(sched, b1=0.5, b2=0.9, eps=1e-7, double_step=double_step, offset=offset)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(7, 5, generator=gen), "b": torch.randn(5, generator=gen)}
    state = opt.init(params)
    for _ in range(6):
        grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
        want = _update_as_written(opt, grads, state, params)
        buf = torch.stack([torch.zeros(()), opt.alpha(state.count), torch.zeros(()), torch.zeros(())])
        for alpha in (None, buf.unbind()[1]):
            new, st = opt.update(grads, state, params, alpha)
            assert st.count == state.count + 1
            for k, (p, m, v) in want.items():
                assert torch.equal(new[k], p) and torch.equal(st.mu[k], m) and torch.equal(st.nu[k], v), k
        params, state = new, st


def _tensors(state, metrics):
    return [*state_tensors(state).values(), metrics["sinkhorn_loss"], metrics["pm"], metrics["sigma"]]


@pytest.mark.parametrize("over,inject", [
    ({}, False), ({}, True), ({"kernel_impl": "pallas", "fused_discriminators": True}, True),
    ({"kernel": "2d"}, False), ({"decaying_sigma": True}, False),
], ids=["drawn", "injected", "fused_injected", "2d", "decaying_unread"])
def test_graph_path_equals_the_eager_step(monkeypatch, over, inject):
    cfg = _with(**over)
    eager = build_train_step(cfg, device="cpu")
    monkeypatch.setattr(steps, "replays_graph", lambda *a, **k: True)
    monkeypatch.setattr(steps, "StepGraph", EagerStepGraph)
    graphed = build_train_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    zshape = (2, cfg.pred_time_steps, 1, 1, 2)
    s_e = s_g = create_train_state(cfg, device="cpu")
    kept = []
    for batch in _batches(4):
        z = (torch.randn(zshape, generator=gen), torch.randn(zshape, generator=gen)) if inject else None
        s_e, m_e = eager(s_e, batch, z=z)
        s_g, m_g = graphed(s_g, batch, z=z)
        assert (s_g.step, s_g.rng) == (s_e.step, s_e.rng)
        assert [getattr(s_g, f"{g}_opt").count for g in GROUPS] == \
            [getattr(s_e, f"{g}_opt").count for g in GROUPS]
        got, want = _tensors(s_g, m_g), _tensors(s_e, m_e)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        kept.append((got, [t.clone() for t in got]))
    assert graphed.counts == {"eager": 1, "captures": 1, "replays": 3}
    for got, then in kept:  # what each call returned is the caller's: no later call wrote it
        assert all(torch.equal(a, b) for a, b in zip(got, then))
