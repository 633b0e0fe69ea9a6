"""The port's data parallelism (``kccotgan_tpu_torch/parallel``) on CPU
ranks of a gloo job.

Ranks are spawned once per world size for this file (a module fixture
runs every scenario and hands back each rank's results,
``tests/_torch_dist.py``); the references run in the test process
meanwhile.

* The collectives at W = 2 and 4: values, and gradients against the
  unsharded function (the distributed maximum's split among ties too); BatchNorm synced over the ranks against BatchNorm
  over the whole batch, under ``torch.func.vmap`` too (f32, rtol 1e-6:
  sums in another order).
* The exact global-batch step at W = 2 (``'scan'``, ``'pallas'`` through
  the kernels' plain versions, ``fused_discriminators``, dropout with the
  '3d' kernel) and W = 4, two iterations from the seeded state, against
  the port's one-device step (held against JAX in
  ``tests/test_torch_train*.py``): the noise and masks are drawn from the
  state's key in both, at the tolerances ``assert_states_match`` argues
  (the first iteration's losses and pM at rtol 1e-5; parameters at rtol
  1e-4 / atol 1e-6 wherever the gradient stood above rounding noise, the
  rule of ``tests/test_torch_train.py``); the state equal on every rank
  to the bit.
* The exact step's CUDA-graph path at W = 2 on the CPU, the capture
  replaced by running the step (``_torch_dist.EagerStepGraph``), with the
  noise drawn and injected, against the eager exact step: states and
  metrics to the bit on every rank, and each step's advance of the
  collectives' calls and bytes (``comm.COUNTERS``) the same.
* The per-shard mode at W = 2 against JAX's
  ``build_sharded_train_step(global_batch_sinkhorn=False)`` on
  ``make_mesh(2)``, each rank's noise drawn from JAX's folded keys, at
  ``tests/test_torch_train.py``'s tolerances; the port's own folding gives
  each rank its own noise.
* ``Trainer`` on a 2-rank mesh: 3 steps; 2, a checkpoint, a restore and
  2 more equal to 4 straight, to the bit; rank 0 alone writes.
* ``cli.main`` with ``--num_devices 2`` and ``--local_sinkhorn``, and
  the mesh flags' validation.
"""

import contextlib
import dataclasses
import io
import json
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kccotgan_tpu_torch.cli.main import main
from kccotgan_tpu_torch.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch.data import bouncing_blobs
from kccotgan_tpu_torch.models.layers import BatchNorm
from kccotgan_tpu_torch.parallel import all_reduce_sum, gather_replicated, gather_resharded, make_mesh
from kccotgan_tpu_torch.parallel import comm
from kccotgan_tpu_torch.parallel.comm import global_amax, recv_carry, send_carry, tag_of
from kccotgan_tpu_torch.parallel.sharding import build_sharded_train_step, replicate_state, shard_batch
from kccotgan_tpu_torch.train import Trainer, build_train_step, create_train_state
from kccotgan_tpu_torch.train import steps
from kccotgan_tpu_torch.train.state import fold_in, split_key
from tests import _torch_dist
from tests._torch_dist import GROUPS

torch.set_num_threads(1)

CFG = TrainConfig(
    dname="synthetic", batch_size=4, total_time_steps=3, int_time_steps=2, sinkhorn_l=3, warmup_steps=1,
    compute_dtype="float32", save_freq=10_000, ckpt_freq=10_000,
    model=ModelConfig(x_height=16, x_width=16, g_filter_size=2, d_filter_size=1, d_state_size=2,
                      z_channels=2, z_height=1, z_width=1),
)
EXACT_CASES = {
    "scan": {},
    "pallas": {"kernel_impl": "pallas"},
    "fused": {"kernel_impl": "pallas", "fused_discriminators": True},
    "dropout_3d": {"kernel": "3d", "model": dataclasses.replace(CFG.model, dropout=0.1, rnn_dropout=0.1)},
}
STEPS = 2


def _cfg(case):
    return dataclasses.replace(CFG, **EXACT_CASES[case])


def _video(cfg, seed=1):
    return np.random.default_rng(seed).uniform(
        size=(cfg.batch_size, 16, cfg.total_time_steps, 16, 1)).astype(np.float32)


# ---------------------------------------------------------------- scenarios


def _collectives(rank, world):
    """Values and gradients of each collective and of the synced
    BatchNorm on this rank's part of seeded full inputs."""
    rng = np.random.default_rng(0)
    full = torch.from_numpy(rng.normal(size=(2 * world, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(world, 2, 3)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(2 * world, 3)).astype(np.float32))
    out = {}
    x = full[2 * rank : 2 * rank + 2].clone().requires_grad_()
    y = all_reduce_sum(x, dist.group.WORLD)
    (y * w[rank]).sum().backward()
    out["all_reduce"], out["all_reduce_grad"] = y.detach(), x.grad
    x = full[2 * rank : 2 * rank + 2].clone().requires_grad_()
    g = gather_replicated(x, 0, dist.group.WORLD)
    (c * g * g).sum().backward()  # the same loss on every rank
    out["gather"], out["gather_replicated_grad"] = g.detach(), x.grad
    x = full[2 * rank : 2 * rank + 2].clone().requires_grad_()
    g = gather_resharded(x, 0, dist.group.WORLD)
    (c[rank] * g[rank + 1] ** 3).sum().backward()  # each rank its own row of the whole
    out["gather_resharded_grad"] = x.grad
    # the whole's largest element, tied between rank 0 and rank 1
    tied = full.clone()
    tied[0, 0] = tied[3, 1] = 10.0
    x = tied[2 * rank : 2 * rank + 2].clone().requires_grad_()
    top = global_amax(x, dist.group.WORLD)
    (top * (rank + 1)).backward()  # each rank its own use of the maximum
    out["amax"], out["amax_grad"] = top.detach(), x.grad
    if rank == 0:
        send_carry((full[:2], full[2:4]), 1, dist.group.WORLD, tag_of("probe", "fwd"))
    elif rank == 1:
        out["received"] = torch.cat(recv_carry((full[:2], full[:2]), 0, dist.group.WORLD, tag_of("probe", "fwd")))
    # BatchNorm synced over the ranks, each holding 2 of the batch's rows
    xb = torch.from_numpy(rng.normal(size=(2 * world, 3, 5)).astype(np.float32)) * 3 + 1
    gb = torch.from_numpy(rng.normal(size=(2 * world, 3, 5)).astype(np.float32))
    bn = BatchNorm(5, dist.group.WORLD)
    bn.reset_parameters(None)
    with torch.no_grad():
        bn.scale.mul_(1.5)
        bn.bias.add_(0.25)
    x = xb[2 * rank : 2 * rank + 2].clone().requires_grad_()
    y, (mean, var) = bn(x, torch.zeros(5), torch.ones(5))
    dx, ds, db = torch.autograd.grad(y, (x, bn.scale, bn.bias), gb[2 * rank : 2 * rank + 2])
    out["bn"] = (y.detach(), mean, var, dx, ds, db)
    # under vmap: 4 instances, each its own scale
    scales = torch.from_numpy(rng.uniform(0.5, 2.0, size=(4, 5)).astype(np.float32)).requires_grad_()
    xs = xb[None, 2 * rank : 2 * rank + 2].expand(4, -1, -1, -1) * torch.arange(1.0, 5.0)[:, None, None, None]
    xs = xs.clone().requires_grad_()

    def one(scale, xi):
        return torch.func.functional_call(bn, {"scale": scale, "bias": bn.bias}, (xi, torch.zeros(5), torch.ones(5)))

    ys, (means, _) = torch.func.vmap(one)(scales, xs)
    dxs, dss = torch.autograd.grad(ys, (xs, scales), gb[None, 2 * rank : 2 * rank + 2].expand(4, -1, -1, -1))
    out["bn_vmap"] = (ys.detach(), means, dxs, dss)
    return out


def _exact(rank, dev, case, world):
    cfg = _cfg(case)
    mesh = make_mesh(world, device=dev)
    step = build_sharded_train_step(cfg, mesh)
    state = replicate_state(create_train_state(cfg, device=dev), mesh)
    rows = torch.from_numpy(shard_batch(_video(cfg), mesh))
    mets, states = [], []
    for _ in range(STEPS):
        state, met = step(state, rows)
        mets.append((float(met["sinkhorn_loss"]), float(met["pm"])))
        states.append(_torch_dist.state_np(state))
    return {"metrics": mets, "states": states}


def _graph_path(rank, dev):
    """The exact step at W = 2 on the graph path, ``StepGraph``'s capture
    replaced by running the step itself (``EagerStepGraph``), against the
    eager exact step, four steps each from one state, with the noise drawn
    from the state's key and injected: each step's state and metrics, and
    the collectives' counters' advance."""
    cfg = dataclasses.replace(CFG, kernel="3d")
    mesh = make_mesh(2, device=dev)
    rows = torch.from_numpy(shard_batch(_video(cfg), mesh))
    zshape = (cfg.batch_size, cfg.pred_time_steps, 1, 1, cfg.model.z_channels)
    out = {}
    for inject in (False, True):
        runs = {}
        for name in ("eager", "graph"):
            state = replicate_state(create_train_state(cfg, device=dev), mesh)
            gen = torch.Generator().manual_seed(11)
            got = []
            graph_path = mock.patch.multiple(steps, replays_graph=lambda *a, **k: True,
                                             StepGraph=_torch_dist.EagerStepGraph)
            with graph_path if name == "graph" else contextlib.nullcontext():
                step = build_sharded_train_step(cfg, mesh)
                for _ in range(4):
                    z = tuple(torch.randn(zshape, generator=gen) for _ in range(2)) if inject else None
                    before = {op: dict(c) for op, c in comm.COUNTERS.items()}
                    state, met = step(state, rows, z=z)
                    moved = {op: (c["calls"] - before[op]["calls"], c["bytes"] - before[op]["bytes"])
                             for op, c in comm.COUNTERS.items()}
                    got.append((_torch_dist.state_np(state), [float(met[k]) for k in ("sinkhorn_loss", "pm")],
                                moved))
            runs[name] = (got, dict(step.counts))
        out["injected" if inject else "drawn"] = runs
    return out



def _local(rank, dev, jax_inputs):
    """JAX's per-shard mode on the port: the JAX state converted, each
    rank's rows and its z from JAX's folded keys; then one step with the
    port's own keys, recording the z it draws."""
    state0, video, zs = jax_inputs
    state0 = _torch_dist.state_from_np(state0)
    cfg = dataclasses.replace(_local_cfg(), global_batch_sinkhorn=False)
    mesh = make_mesh(2, device=dev)
    step = build_sharded_train_step(cfg, mesh)
    state = replicate_state(state0, mesh)
    rows = torch.from_numpy(shard_batch(video, mesh))
    runs = []
    for z in zs:
        state, met = step(state, rows, z=tuple(torch.from_numpy(a[rank]) for a in z))
        runs.append(({k: float(v) for k, v in met.items()}, _torch_dist.state_np(state)))
    drawn = []
    randn = torch.randn

    def recording(*args, **kwargs):
        drawn.append(randn(*args, **kwargs))
        return drawn[-1]

    torch.randn = recording
    try:
        step(state0, rows)
    finally:
        torch.randn = randn
    return {"runs": runs, "z1": drawn[0], "rng": state0.rng}


def _trainer(rank, dev, tmp):
    mesh = make_mesh(2, device=dev)
    data = bouncing_blobs(16, CFG.total_time_steps, 16, 16, seed=3)
    batches = [data[4 * i : 4 * i + 4] for i in range(4)]
    out = {}
    cfg = dataclasses.replace(CFG, out_dir=str(tmp), global_batch_sinkhorn=False)
    trainer = Trainer(dataclasses.replace(cfg, run_name="three"), mesh=mesh)
    _, out["three"] = trainer.fit(iter(batches), max_steps=3)
    cfg = dataclasses.replace(CFG, out_dir=str(tmp), ckpt_freq=2)
    straight, out["straight_summary"] = Trainer(dataclasses.replace(cfg, run_name="straight"), mesh=mesh).fit(
        iter(batches), max_steps=4)
    first = Trainer(dataclasses.replace(cfg, run_name="first"), mesh=mesh)
    first.fit(iter(batches[:2]), max_steps=2)
    dist.barrier()  # rank 0's checkpoint is written
    resumed = Trainer(dataclasses.replace(cfg, run_name="resumed", checkpoint=True,
                                          ckpt_path=str(tmp / "first" / "ckpt")), mesh=mesh)
    r_state, out["resumed_summary"] = resumed.fit(iter(batches[2:]), max_steps=4)
    out["straight"], out["resumed"] = _torch_dist.state_np(straight), _torch_dist.state_np(r_state)
    return out


def run_w2(rank, dev, tmp, jax_inputs):
    out = {"collectives": _collectives(rank, 2)}
    out["exact"] = {case: _exact(rank, dev, case, 2) for case in EXACT_CASES}
    out["graph_path"] = _graph_path(rank, dev)
    out["local"] = _local(rank, dev, jax_inputs)
    out["trainer"] = _trainer(rank, dev, tmp)
    return out


def run_w4(rank, dev):
    return {"collectives": _collectives(rank, 4), "exact": {"scan": _exact(rank, dev, "scan", 4)}}


# ---------------------------------------------------------------- references


def _one_device(case):
    cfg = _cfg(case)
    step = build_train_step(cfg, device="cpu")
    state, mets, states = create_train_state(cfg, device="cpu"), [], []
    for _ in range(STEPS):
        state, met = step(state, torch.from_numpy(_video(cfg)))
        mets.append((float(met["sinkhorn_loss"]), float(met["pm"])))
        states.append(_torch_dist.state_np(state))
    return mets, states


def _local_cfg():
    from tests._torch_port import port_cfg, tiny_train_cfg

    return dataclasses.replace(port_cfg(tiny_train_cfg()), batch_size=4)


def _jax_local():
    """The JAX state (the port's seeded one, its Adam states initialized by
    JAX), the video and each rank's z of two per-shard iterations, from
    the keys alone: ``split(rng, 3)``, then ``fold_in(k, rank)``."""
    import jax
    import jax.numpy as jnp

    from kccotgan_tpu.train.state import TrainState as JaxTrainState
    from kccotgan_tpu.train.state import make_optimizers as jax_optimizers
    from tests._torch_port import flax_tree, tiny_train_cfg

    cfg = dataclasses.replace(tiny_train_cfg(), batch_size=4)
    port_state = create_train_state(_local_cfg(), device="cpu")
    opts = jax_optimizers(cfg)
    def tree(flat):  # copies: JAX on the CPU may alias a numpy buffer
        return jax.tree_util.tree_map(np.array, flax_tree(flat))

    trees = {g: tree(getattr(port_state, f"{g}_params")) for g in GROUPS}
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        **{f"{g}_params": trees[g] for g in GROUPS},
        h_stats=tree(port_state.h_stats), m_stats=tree(port_state.m_stats),
        **{f"{g}_opt": opts[g].init(trees[g]) for g in GROUPS},
    )
    video = np.random.default_rng(3).uniform(size=(4, 16, 5, 16, 1)).astype(np.float32)
    m = cfg.model
    shape = (2, cfg.pred_time_steps, m.z_height, m.z_width, m.z_channels)
    rng, zs = state.rng, []
    for _ in range(STEPS):
        rng, k_disc, k_gen = jax.random.split(rng, 3)
        zs.append(tuple(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, r), shape))
                                  for r in range(2)]) for k in (k_disc, k_gen)))
    return cfg, state, video, zs, port_state


def _jax_local_runs(cfg, state, video):
    import jax
    import jax.numpy as jnp

    from kccotgan_tpu.parallel import build_sharded_train_step as jax_sharded, make_mesh as jax_mesh
    from kccotgan_tpu.parallel import replicate_state as replicate_state_jax, shard_batch as shard_batch_jax
    from kccotgan_tpu.train import GanModules
    from kccotgan_tpu_torch.weights import train_state_from_jax
    from tests._torch_port import compile_o0

    cfg = dataclasses.replace(cfg, global_batch_sinkhorn=False, donate_buffers=False)
    mesh = jax_mesh(2)
    state, video = replicate_state_jax(state, mesh), shard_batch_jax(jnp.asarray(video), mesh)
    jstep = compile_o0(jax_sharded(cfg, GanModules(cfg), mesh), state, video)
    runs = []
    for _ in range(STEPS):
        state, met = jstep(state, video)
        runs.append(({k: float(v) for k, v in met.items()}, train_state_from_jax(jax.tree_util.tree_map(np.asarray, state))))
    return runs


CLI_FLAGS = ["--dname", "synthetic", "-bs", "4", "-tts", "4", "-its", "2", "-sinkl", "3", "-xh", "16", "-xw", "16",
             "-gfs", "2", "-dfs", "1", "-dss", "2", "-nz", "2", "-ne", "1", "--max_steps", "2", "--ckpt_freq", "2",
             "--compute_dtype", "float32"]
CLI_CASES = {"exact": ["--num_devices", "2"], "local": ["--num_devices", "2", "--local_sinkhorn"]}


def _run_cli(tmp):
    """``cli.main`` with each of ``CLI_CASES``' flags, one after the other:
    ``{case: (rc, printed lines, run dir)}``."""
    out = {}
    for case, flags in CLI_CASES.items():
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = main([*CLI_FLAGS, *flags, "--out_dir", str(tmp), "--run_name", case], device="cpu")
        out[case] = (rc, printed.getvalue().strip().splitlines(), tmp / case)
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both jobs' ranks' results, beside the references computed while
    they ran: ``(w2, w4, cli)``, each job's ``(results, one-device runs,
    ...)`` and the CLI's runs (``_run_cli``, which spawn their own ranks
    meanwhile)."""
    tmp2, tmp4 = tmp_path_factory.mktemp("w2"), tmp_path_factory.mktemp("w4")
    cfg, jstate, video, zs, port_state = _jax_local()
    job2 = _torch_dist.start(run_w2, 2, tmp2, (_torch_dist.state_np(port_state), video, zs), store_dir=tmp2)
    job4 = _torch_dist.start(run_w4, 4, store_dir=tmp4)
    with ThreadPoolExecutor(1) as pool:
        cli = pool.submit(_run_cli, tmp_path_factory.mktemp("cli"))
        refs = {case: _one_device(case) for case in EXACT_CASES}
        jax_runs = _jax_local_runs(cfg, jstate, video)
        w2 = (job2.result(), refs, jax_runs, port_state, tmp2)
        return w2, (job4.result(), {"scan": refs["scan"]}), cli.result(timeout=_torch_dist.TIMEOUT)


@pytest.fixture(scope="module")
def w2(jobs):
    return jobs[0]


@pytest.fixture(scope="module")
def w4(jobs):
    return jobs[1]


# ---------------------------------------------------------------- checks


def _check_collectives(results, world):
    rng = np.random.default_rng(0)
    full = rng.normal(size=(2 * world, 3)).astype(np.float32)
    w = rng.normal(size=(world, 2, 3)).astype(np.float32)
    c = rng.normal(size=(2 * world, 3)).astype(np.float32)
    xt = torch.from_numpy(full).requires_grad_()
    total = sum((torch.from_numpy(c[r]) * xt[r + 1] ** 3).sum() for r in range(world))
    (resharded,) = torch.autograd.grad(total, xt)
    for r, res in enumerate(results):
        out = res["collectives"]
        want = full.reshape(world, 2, 3).sum(0)
        np.testing.assert_allclose(out["all_reduce"], want, rtol=1e-6)
        np.testing.assert_allclose(out["all_reduce_grad"], w.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(out["gather"], full)
        # the rank's slice of d(sum c x^2)/dx, not world times it
        np.testing.assert_allclose(out["gather_replicated_grad"], (2 * c * full)[2 * r : 2 * r + 2], rtol=1e-6)
        np.testing.assert_allclose(out["gather_resharded_grad"], resharded.numpy()[2 * r : 2 * r + 2], rtol=1e-6)
    np.testing.assert_array_equal(results[1]["collectives"]["received"], full[:4])
    tied = torch.from_numpy(full).clone()
    tied[0, 0] = tied[3, 1] = 10.0
    tied.requires_grad_()
    (tied.amax() * sum(r + 1 for r in range(world))).backward()  # amax splits among ties
    for r, res in enumerate(results):
        assert float(res["collectives"]["amax"]) == 10.0
        np.testing.assert_allclose(res["collectives"]["amax_grad"], tied.grad[2 * r : 2 * r + 2], rtol=1e-6)


def _check_bn(results, world):
    rng = np.random.default_rng(0)
    rng.normal(size=(2 * world, 3)), rng.normal(size=(world, 2, 3)), rng.normal(size=(2 * world, 3))
    xb = torch.from_numpy(rng.normal(size=(2 * world, 3, 5)).astype(np.float32)) * 3 + 1
    gb = torch.from_numpy(rng.normal(size=(2 * world, 3, 5)).astype(np.float32))
    scales = torch.from_numpy(rng.uniform(0.5, 2.0, size=(4, 5)).astype(np.float32)).requires_grad_()
    bn = BatchNorm(5)
    bn.reset_parameters(None)
    with torch.no_grad():
        bn.scale.mul_(1.5)
        bn.bias.add_(0.25)
    x = xb.clone().requires_grad_()
    y, (mean, var) = bn(x, torch.zeros(5), torch.ones(5))
    dx, ds, db = torch.autograd.grad(y, (x, bn.scale, bn.bias), gb)
    xs = (xb[None].expand(4, -1, -1, -1) * torch.arange(1.0, 5.0)[:, None, None, None]).clone().requires_grad_()

    def one(scale, xi):
        return torch.func.functional_call(bn, {"scale": scale, "bias": bn.bias}, (xi, torch.zeros(5), torch.ones(5)))

    ys, (means, _) = torch.func.vmap(one)(scales, xs)
    dxs, dss = torch.autograd.grad(ys, (xs, scales), gb[None].expand(4, -1, -1, -1))
    sum_ds, sum_db, sum_dss = 0, 0, 0
    for r, res in enumerate(results):
        gy, gmean, gvar, gdx, gds, gdb = res["collectives"]["bn"]
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(gy, y.detach()[rows], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gmean, mean, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(gvar, var, rtol=1e-6)
        np.testing.assert_allclose(gdx, dx[rows], rtol=1e-6, atol=1e-6)
        sum_ds, sum_db = sum_ds + gds, sum_db + gdb
        vy, vmeans, vdx, vds = res["collectives"]["bn_vmap"]
        np.testing.assert_allclose(vy, ys.detach()[:, rows], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(vmeans, means, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(vdx, dxs[:, rows], rtol=1e-6, atol=1e-6)
        sum_dss = sum_dss + vds
    # each rank's parameter gradient is its rows' part: summed, the whole's
    np.testing.assert_allclose(sum_ds, ds, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sum_db, db, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sum_dss, dss, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_values_and_gradients(world, w2, w4):
    results = (w2 if world == 2 else w4)[0]
    _check_collectives(results, world)


@pytest.mark.parametrize("world", [2, 4])
def test_synced_batchnorm_equals_full_batch(world, w2, w4):
    _check_bn((w2 if world == 2 else w4)[0], world)


@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_exact_mode_equals_one_device_step(case, w2):
    results, refs = w2[0], w2[1]
    want_metrics, wants = refs[case]
    got = results[0]["exact"][case]
    _torch_dist.assert_states_match(got["states"], wants, got["metrics"], want_metrics, CFG.lr)
    _torch_dist.assert_ranks_equal(results, lambda r: r["exact"][case]["states"][-1])
    for res in results[1:]:
        assert res["exact"][case]["metrics"] == got["metrics"]


@pytest.mark.parametrize("noise", ["drawn", "injected"])
def test_exact_mode_graph_path_equals_the_eager_step(noise, w2):
    """On every rank: the same states and metrics to the bit, one eager
    call, one capture and three replays, and each replay advancing the
    collectives' calls and bytes as an eager step does."""
    results = w2[0]
    for res in results:
        (eager, eager_counts), (graph, graph_counts) = (res["graph_path"][noise][k] for k in ("eager", "graph"))
        assert eager_counts == {"eager": 4, "captures": 0, "replays": 0}
        assert graph_counts == {"eager": 1, "captures": 1, "replays": 3}
        for i, ((st_g, met_g, moved_g), (st_e, met_e, moved_e)) in enumerate(zip(graph, eager)):
            assert met_g == met_e, f"step {i + 1}"
            assert moved_g == moved_e, f"step {i + 1}"
            assert moved_e["all_reduce"][0] > 0 and moved_e["all_gather"][0] > 0
            _torch_dist.assert_ranks_equal([{"graph_path": st_e}, {"graph_path": st_g}], lambda r: r["graph_path"])


def test_exact_mode_at_four_ranks(w4):
    results, refs = w4
    want_metrics, wants = refs["scan"]
    got = results[0]["exact"]["scan"]
    _torch_dist.assert_states_match(got["states"], wants, got["metrics"], want_metrics, CFG.lr)
    _torch_dist.assert_ranks_equal(results, lambda r: r["exact"]["scan"]["states"][-1])


def test_local_mode_matches_jax_shard_map(w2):
    from tests._torch_port import assert_iterations_match

    results, _, jax_runs, port_state, _ = w2
    runs = [(met, _torch_dist.state_from_np(st)) for met, st in results[0]["local"]["runs"]]
    assert_iterations_match(runs, [(None, met, st) for met, st in jax_runs], port_state)
    _torch_dist.assert_ranks_equal(results, lambda r: r["local"]["runs"][-1][1])


def test_local_mode_folds_each_ranks_noise(w2):
    results, _, _, port_state, _ = w2
    cfg = _local_cfg()
    _, seed = split_key(port_state.rng)
    shape = (cfg.batch_size // 2, cfg.pred_time_steps, 1, 1, cfg.model.z_channels)
    for r, res in enumerate(results):
        want = torch.randn(shape, generator=torch.Generator().manual_seed(fold_in(seed, r)))
        np.testing.assert_array_equal(res["local"]["z1"], want.numpy())
    assert not np.array_equal(results[0]["local"]["z1"], results[1]["local"]["z1"])


def _metrics(run_dir):
    logged = {}
    with open(run_dir / "log" / "metrics.jsonl") as f:
        for line in f:
            r = json.loads(line)
            logged.setdefault(r["tag"], []).append(r["step"])
    return logged


def test_trainer_on_a_mesh_trains_and_resumes_to_the_bit(w2):
    results, *_, tmp = w2
    out = results[0]["trainer"]
    assert out["three"]["status"] == "completed" and out["three"]["steps"] == 3
    assert _metrics(tmp / "three")["Sinkhorn Loss"] == [1, 2, 3]  # rank 0 alone logs
    for key in ("straight_summary", "resumed_summary"):
        assert out[key]["status"] == "completed" and out[key]["steps"] == 4
    assert out["straight"]["step"] == out["resumed"]["step"] == 4
    _torch_dist.assert_ranks_equal([{"s": out["straight"]}, {"s": out["resumed"]}], lambda r: r["s"])
    _torch_dist.assert_ranks_equal(results, lambda r: r["trainer"]["resumed"])
    assert results[1]["trainer"]["three"]["steps"] == 3


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_trains_on_a_data_mesh(case, jobs):
    rc, printed, run_dir = jobs[2][case]
    summary = json.loads(printed[-1])
    assert rc == 0 and summary["status"] == "completed" and summary["steps"] == 2
    assert (summary["num_devices"], summary["seq_devices"], summary["dist_backend"]) == (2, 1, "gloo")
    assert summary["global_batch_sinkhorn"] is (case == "exact")
    assert _metrics(run_dir)["Sinkhorn Loss"] == [1, 2]  # rank 0 alone logs
    assert [p.name for p in (run_dir / "ckpt").iterdir()]  # rank 0's checkpoint at step 2


@pytest.mark.parametrize("flags,message", [
    (["--num_devices", "100000"], "ranks: this host runs at most"),
    (["--seq_devices", "3"], "seq mesh size 3 must divide"),
    (["--num_devices", "3"], "data mesh size 3 must divide batch_size"),
    (["--seq_devices", "2", "--local_sinkhorn"], "--local_sinkhorn is a data-parallel mode"),
    (["--num_devices", "0"], "each needs at least one rank"),
])
def test_cli_validates_the_mesh_flags(flags, message, capsys):
    with pytest.raises(SystemExit) as e:
        main([*CLI_FLAGS, *flags], device="cpu")
    assert e.value.code == 2
    assert message in capsys.readouterr().err
