"""The PyTorch port's training iteration vs the JAX package's
``build_train_step``, at the tiny geometry of ``tests/test_train.py``
(B=2, 16x16x1 frames, T=5 with 3 context, f=2, state 3, z 1x1x4, L=10).

The JAX side is built with ``conv_packing='off'`` and ``time_major=False``
(the port ports neither layout), its state created and its step compiled
once per module fixture, without LLVM's optimizations
(``_torch_port.compile_o0``).  The state reaches the port through
``train_state_from_jax``; each phase's z is the JAX step's own draw from
its key, handed to the port.  Two iterations, because at the first the
warmup gives the offset-0 groups (encoder, h) a zero learning rate.

Tolerances, f32:
* losses and pM at rtol 1e-4 (measured 1.2e-5): the Sinkhorn divergence
  is a difference of three costs, so a few ulp in each of them, from
  other summation orders in convs, Gram products and L = 10 dual updates,
  show up magnified;
* BatchNorm statistics at 1e-5 abs;
* gradients, read as Adam's moments, at 1e-4 of each group's largest
  entry (measured 2.6e-5): gradients through two recurrent stacks, summed
  in another order;
* parameters at 3e-6 abs (measured 6.6e-7, against moves of up to 2e-4),
  on every element whose gradient stood above the rounding-noise floor
  (1e-4 of its group's largest) at both iterations.  Below it, Adam's
  ``m / (sqrt(v) + eps)`` turns rounding noise into a step of full size
  and random sign: the conv biases in front of each BatchNorm, whose
  gradient is zero but for rounding, are the clearest case.
bf16: losses and pM at rtol 3e-2 (measured 1.1e-2): both sides round
convs and matmuls to bf16 at the same points, but another f32 summation
order puts some roundings one bf16 ulp (2**-8 relative) apart, and the
norms and the Sinkhorn divergence amplify them.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu.train import GanModules
from kccotgan_tpu.train import build_train_step as jax_build_train_step
from kccotgan_tpu.train import create_train_state as jax_create_train_state
from kccotgan_tpu.train.keras_adam import keras_adam as jax_keras_adam
from kccotgan_tpu.train import warmup_staircase_exponential_decay as jax_schedule
from kccotgan_tpu_torch.models import layers
from kccotgan_tpu_torch.ot import cuda_sinkhorn
from kccotgan_tpu_torch.smoothing import annealing_sigma
from kccotgan_tpu_torch.train import (
    KerasAdam,
    build_train_step,
    create_train_state,
    make_optimizers,
    warmup_staircase_exponential_decay,
)
from kccotgan_tpu_torch.weights import train_state_from_jax
from tests._torch_port import GROUPS, assert_iterations_match, compile_o0, port_cfg, tiny_train_cfg

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX state, two iterations of its step in f32 and in bf16 from
    it, the z each phase drew, and the video."""
    cfg = tiny_train_cfg()
    key = jax.random.PRNGKey(0)
    state = compile_o0(lambda k: jax_create_train_state(cfg, k), key)(key)
    video = np.random.default_rng(3).uniform(size=(2, 16, 5, 16, 1)).astype(np.float32)
    m = cfg.model
    z_shape = (2, cfg.pred_time_steps, m.z_height, m.z_width, m.z_channels)
    out = {"state": _np(state), "video": video}
    for cdt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=cdt)
        step = compile_o0(jax_build_train_step(c, GanModules(c), jit=True, donate=False), state,
                          jnp.asarray(video))
        s, runs = state, []
        for _ in range(2):
            _, k_disc, k_gen = jax.random.split(s.rng, 3)
            z = tuple(np.asarray(jax.random.normal(k, z_shape, jnp.float32)) for k in (k_disc, k_gen))
            s, metrics = step(s, jnp.asarray(video))
            runs.append((z, _np(metrics), _np(s)))
        out[cdt] = runs
    return out


def _port_run(jax_run, cdt, **overrides):
    cfg = dataclasses.replace(port_cfg(tiny_train_cfg(cdt)), **overrides)
    tstep = build_train_step(cfg, device="cpu")
    state, runs = train_state_from_jax(jax_run["state"]), []
    for z, _, _ in jax_run[cdt]:
        state, metrics = tstep(state, torch.tensor(jax_run["video"]), z=tuple(map(torch.tensor, z)))
        runs.append((metrics, state))
    return runs


def test_train_step_matches_jax_f32(jax_run):
    runs = _port_run(jax_run, "float32")
    want = [(z, m, train_state_from_jax(s)) for z, m, s in jax_run["float32"]]
    assert_iterations_match(runs, want, train_state_from_jax(jax_run["state"]))


def test_train_step_losses_match_jax_bf16(jax_run):
    runs = _port_run(jax_run, "bfloat16")
    for (metrics, _), (_, want_m, _) in zip(runs, jax_run["bfloat16"]):
        for key in ("sinkhorn_loss", "pm"):
            np.testing.assert_allclose(float(metrics[key]), float(want_m[key]), rtol=3e-2, err_msg=key)


def test_plain_sinkhorn_path_and_fused_path_agree(jax_run, monkeypatch):
    """``sinkhorn_solver='scan'`` never reaches the fused wrappers and gives
    the same iteration as the fused path's plain version (CPU)."""
    fused = _port_run(jax_run, "float32")

    def no_fused(*args, **kw):
        raise AssertionError("fused Sinkhorn called")

    monkeypatch.setattr(cuda_sinkhorn, "sinkhorn_fwd", no_fused)
    plain = _port_run(jax_run, "float32", sinkhorn_solver="scan")
    for (mf, sf), (mp, sp) in zip(fused, plain):
        np.testing.assert_allclose(float(mp["sinkhorn_loss"]), float(mf["sinkhorn_loss"]), rtol=1e-5)
        for k, v in sp.h_stats.items():
            np.testing.assert_allclose(v.numpy(), sf.h_stats[k].numpy(), rtol=0, atol=1e-6)


def test_per_phase_encoding_gives_the_same_iteration(jax_run):
    """``share_context_encoding=False`` encodes the context in each phase,
    as the reference does; both phases' encoder forwards are the same
    computation, so the iteration is the same."""
    shared = _port_run(jax_run, "float32")
    per_phase = _port_run(jax_run, "float32", share_context_encoding=False)
    for (ms, ss), (mp, sp) in zip(shared, per_phase):
        np.testing.assert_allclose(float(mp["sinkhorn_loss"]), float(ms["sinkhorn_loss"]), rtol=1e-6)
        for k, v in sp.enc_params.items():
            np.testing.assert_allclose(v.numpy(), ss.enc_params[k].numpy(), rtol=0, atol=1e-7)


def test_train_step_draws_noise_and_leaves_its_input():
    cfg = port_cfg(tiny_train_cfg())
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {k: v.clone() for k, v in state.dec_params.items()}
    video = torch.rand(2, 16, 5, 16, 1, generator=torch.Generator().manual_seed(1))
    tstep = build_train_step(cfg, device="cpu")
    s1, m1 = tstep(state, video, torch.Generator().manual_seed(2))
    s2, m2 = tstep(state, video, torch.Generator().manual_seed(2))
    assert s1.step == 1 and s1.dec_opt.count == 1
    assert float(m1["sinkhorn_loss"]) == float(m2["sinkhorn_loss"])
    assert all(torch.isfinite(v).all() for v in (m1["sinkhorn_loss"], m1["pm"]))
    for k, v in before.items():
        assert torch.equal(state.dec_params[k], v)
    assert any(not torch.equal(s1.dec_params[k], v) for k, v in before.items())


def test_create_train_state_matches_jax_structure(jax_run):
    want = train_state_from_jax(jax_run["state"])
    got = create_train_state(port_cfg(tiny_train_cfg()), device="cpu")
    assert got.step == want.step == 0
    for name in ("enc_params", "dec_params", "h_params", "m_params", "h_stats", "m_stats"):
        w, g = getattr(want, name), getattr(got, name)
        assert {k: tuple(v.shape) for k, v in g.items()} == {k: tuple(v.shape) for k, v in w.items()}, name
    for k, v in want.h_stats.items():
        assert torch.equal(got.h_stats[k], v), k  # means 0, variances 1
    for group in GROUPS:
        opt = getattr(got, f"{group}_opt")
        assert opt.count == 0 and all(not v.any() for v in opt.mu.values())
    again = create_train_state(port_cfg(tiny_train_cfg()), device="cpu")  # seeded by cfg.seed
    assert all(torch.equal(again.enc_params[k], v) for k, v in got.enc_params.items())


@pytest.mark.parametrize("lr0,warmup,decay_steps,rate", [
    (1e-3, 100, 50, 0.9), (5e-4, 4, 3, 0.975), (5e-4, 10000, 5000, 0.975),  # the last: TrainConfig's defaults
])
def test_schedule_matches_jax(lr0, warmup, decay_steps, rate):
    ours = warmup_staircase_exponential_decay(lr0, warmup, decay_steps, rate)
    ref = jax_schedule(lr0, warmup, decay_steps, rate)
    steps = {0, 1, warmup - 1, warmup, warmup + 1, warmup + decay_steps - 1, warmup + decay_steps,
             warmup + 5 * decay_steps + 1, 10 * warmup + 7}
    for step in sorted(steps):
        np.testing.assert_allclose(float(ours(step)), float(ref(step)), rtol=1e-7, err_msg=str(step))
    # warmup: Keras step 0 gets lr 0
    assert float(ours(0)) == 0.0


@pytest.mark.parametrize("double_step,offset", [(False, 0), (True, 0), (True, 1)])
def test_keras_adam_matches_jax(double_step, offset):
    rng = np.random.default_rng(offset + 2 * double_step)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    sched_j = jax_schedule(5e-4, 4, 3, 0.975)
    sched_t = warmup_staircase_exponential_decay(5e-4, 4, 3, 0.975)
    opt_j = jax_keras_adam(sched_j, b1=0.5, b2=0.9, eps=1e-7, double_step=double_step, offset=offset)
    opt_t = KerasAdam(sched_t, b1=0.5, b2=0.9, eps=1e-7, double_step=double_step, offset=offset)
    pj, sj = dict(params), opt_j.init(params)
    pt = {k: torch.tensor(v) for k, v in params.items()}
    st = opt_t.init(pt)
    for _ in range(4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        upd, sj = opt_j.update(grads, sj, pj)
        pj = {k: pj[k] + upd[k] for k in pj}
        pt, st = opt_t.update({k: torch.tensor(v) for k, v in grads.items()}, st, pt)
    assert st.count == int(sj.count) == 4
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(st.mu[k].numpy(), np.asarray(sj.mu[k]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(st.nu[k].numpy(), np.asarray(sj.nu[k]), rtol=1e-6, atol=0)


def test_make_optimizers_offsets():
    opts = make_optimizers(port_cfg(tiny_train_cfg()))
    assert {k: (o.offset, o.double_step) for k, o in opts.items()} == {
        "enc": (0, True), "dec": (1, True), "h": (0, True), "m": (1, True)
    }
    # warmup: the offset-0 groups see lr 0 at their first update
    assert float(opts["enc"].learning_rate(opts["enc"].keras_iter(0))) == 0.0
    assert float(opts["dec"].learning_rate(opts["dec"].keras_iter(0))) > 0.0


@pytest.mark.parametrize("kernel", ["1d", "2d", "3d"])
def test_smoothing_options_train(kernel):
    """Each smoothing mode with ``decaying_sigma`` trains: finite losses,
    ``metrics["sigma"]`` the annealed sigma of the 1-based step, and
    another loss than the unsmoothed step's from the same state and z."""
    base = port_cfg(tiny_train_cfg())
    cfg = dataclasses.replace(base, kernel=kernel, decaying_sigma=True, init_sigma=2.0)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    video = torch.rand(2, 16, 5, 16, 1, generator=torch.Generator().manual_seed(1))
    z = tuple(torch.randn(2, cfg.pred_time_steps, 1, 1, 4, generator=torch.Generator().manual_seed(i))
              for i in range(2))
    step = build_train_step(cfg, device="cpu")
    s, losses = state, []
    for i in range(2):
        s, metrics = step(s, video, z=z)
        assert float(metrics["sigma"]) == annealing_sigma(2.0, i + 1) < 2.0
        losses.append(float(metrics["sinkhorn_loss"]))
    assert np.isfinite(losses).all()
    _, plain = build_train_step(base, device="cpu")(state, video, z=z)
    assert float(plain["sigma"]) == base.init_sigma
    assert float(plain["sinkhorn_loss"]) != losses[0]


@pytest.mark.parametrize("kernel_impl", ["scan", "pallas"])
def test_dropout_trains(kernel_impl, monkeypatch):
    """Dropout and recurrent dropout train under either engine, without a
    warning, and the parameters move; under 'pallas' every ConvLSTM call
    of the step goes through ``convlstm_scan`` with its recurrent masks,
    and the loss is the 'scan' engine's on the same masks (drawn from the
    state's key)."""
    cfg = port_cfg(tiny_train_cfg())
    cfg = dataclasses.replace(cfg, kernel_impl=kernel_impl,
                              model=dataclasses.replace(cfg.model, dropout=0.1, rnn_dropout=0.1))
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    video = torch.rand(2, 16, 5, 16, 1, generator=torch.Generator().manual_seed(1))
    step = build_train_step(cfg, device="cpu")
    masked = []
    real_scan = layers.convlstm_scan
    monkeypatch.setattr(layers, "convlstm_scan", lambda *a: masked.append(a[5] is not None) or real_scan(*a))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s1, metrics = step(state, video)
    # per phase: the encoder's 4 and the decoder's 4 ConvLSTMs
    assert masked == ([] if kernel_impl == "scan" else [True] * 16)
    assert s1.step == 1 and np.isfinite(float(metrics["sinkhorn_loss"]))
    if kernel_impl == "pallas":
        _, plain = build_train_step(dataclasses.replace(cfg, kernel_impl="scan"), device="cpu")(state, video)
        np.testing.assert_allclose(float(metrics["sinkhorn_loss"]), float(plain["sinkhorn_loss"]), rtol=1e-4)
    assert any(not torch.equal(s1.dec_params[k], v) for k, v in state.dec_params.items())
