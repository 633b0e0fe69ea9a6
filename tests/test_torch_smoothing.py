"""The PyTorch port's Gaussian smoothing vs the JAX package's, on the CPU.

Every piece of ``kccotgan_tpu_torch/smoothing/gaussian.py`` is held
against ``kccotgan_tpu/smoothing/gaussian.py`` on seeded numpy inputs:

* the REFLECT band matrix bit for bit, from the same taps, at T = 3, 5
  and 20 (and at T = 1 and 2, where the reflected index leaves [0, T)
  and the JAX scatter wraps it once or drops it);
* the taps at rtol 1e-6 (the two libraries' ``exp`` may differ by an ulp);
* each mode's output at atol 1e-6 and its VJP for one seeded cotangent
  at 1e-5 of the VJP's largest entry (measured 1.7e-6; elementwise, the
  few entries where the VJP passes near zero carry ~6e-8 of absolute
  difference), at ``[2, 16, 5, 16, 1]`` and with C = 3, and on a batch
  whose samples tie at the global maximum (the normalization's gradient
  splits among ties);
* ``annealing_sigma`` at steps 1, 500 and 10**5, to the bit;
* ``gan_forward`` with ``kernel='2d'`` under ``jax.value_and_grad``,
  once, at the tiny geometry of ``tests/test_train.py`` (16x16 frames
  shrink to 10x10), with dropout and recurrent dropout in the encoder
  and the decoder (the masks as ``tests/test_torch_dropout.py`` hands
  them to both sides): the loss at rtol 1e-4, pM too, and every
  gradient at 1e-4 of its group's largest entry
  (``tests/test_torch_train.py`` argues these tolerances).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu.smoothing import gaussian as ref
from kccotgan_tpu.train import GanModules as JaxGanModules
from kccotgan_tpu.train.steps import gan_forward as jax_gan_forward
from kccotgan_tpu_torch.config import get_preset
from kccotgan_tpu_torch.models.video import discriminator_modules
from kccotgan_tpu_torch.smoothing import gaussian as port
from kccotgan_tpu_torch.train import create_train_state
from kccotgan_tpu_torch.train.steps import GanModules, gan_forward
from kccotgan_tpu_torch.weights import flatten_flax_tree
from tests._torch_port import GROUPS, bernoulli_streams, flax_tree, port_cfg, tiny_train_cfg

torch.set_num_threads(1)
SIGMA = 5.0


@pytest.mark.parametrize("t", [1, 2, 3, 5, 20])
def test_band_matrix_bit_for_bit(t):
    taps = np.array(ref.gaussian_kernel1d(3, jnp.float32(SIGMA)))
    want = np.asarray(jax.jit(ref._reflect_band_matrix, static_argnums=(0, 1))(t, 3, jnp.asarray(taps)))
    got = port._reflect_band_matrix(t, 3, torch.from_numpy(taps)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", [SIGMA, 0.7, 4.999746799468994])
def test_kernel1d_matches_jax(sigma):
    want = np.asarray(jax.jit(lambda s: ref.gaussian_kernel1d(3, s))(jnp.float32(sigma)))
    np.testing.assert_allclose(port.gaussian_kernel1d(3, sigma).numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("step", [1, 500, 10**5])
def test_annealing_sigma_matches_jax(step):
    want = float(ref.annealing_sigma(SIGMA, jnp.asarray(step, jnp.int32)))
    assert port.annealing_sigma(SIGMA, step) == want


def _video(shape, ties):
    v = np.random.default_rng(sum(shape)).uniform(size=shape).astype(np.float32)
    if ties:
        v[1] = v[0]  # both samples reach the global maximum
    return v


@pytest.mark.parametrize("mode", ["1d", "2d", "3d"])
@pytest.mark.parametrize("shape,ties", [
    ((2, 16, 5, 16, 1), False), ((2, 16, 5, 16, 3), False), ((2, 16, 5, 16, 1), True),
])
def test_smoothing_and_vjp_match_jax(mode, shape, ties):
    v = _video(shape, ties)
    fn = jax.jit(lambda x: ref.apply_smoothing(x, jnp.float32(SIGMA), mode))
    want, vjp = jax.vjp(fn, jnp.asarray(v))
    ct = np.random.default_rng(7).normal(size=want.shape).astype(np.float32)
    (want_grad,) = vjp(jnp.asarray(ct))

    x = torch.from_numpy(v).requires_grad_()
    got = port.apply_smoothing(x, SIGMA, mode)
    (got_grad,) = torch.autograd.grad(got, x, torch.from_numpy(ct))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    want_grad = np.asarray(want_grad)
    scale = float(np.abs(want_grad).max())
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=0, atol=1e-5 * scale)


def test_spatial_output_size_and_none():
    assert port.spatial_output_size(64) == ref.spatial_output_size(64) == 58
    v = torch.rand(1, 4, 3, 4, 1)
    assert port.apply_smoothing(v, SIGMA, "none") is v
    with pytest.raises(ValueError, match="unknown smoothing mode"):
        port.apply_smoothing(v, SIGMA, "4d")


def test_2d_smoothed_frames_give_the_discriminator_its_features():
    """'2d' hands the discriminators 58x58 frames at mmnist_full; three
    SAME stride-2 convs take 58 -> 29 -> 15 -> 8, the 8x8x128 = 8,192
    features lstm1 is sized for from the 64x64 frames."""
    cfg = dataclasses.replace(get_preset("mmnist_full"), compute_dtype="float32")
    disc = discriminator_modules(cfg)[0]
    size = port.spatial_output_size(cfg.model.x_height, cfg.spatial_kernel_size)
    x = torch.zeros(1, size, size, 1)
    with torch.no_grad():
        for conv in (disc.conv1, disc.conv2, disc.conv3):
            x = conv(x)
    assert tuple(x.shape[1:3]) == (8, 8)
    assert x[0].numel() == disc.lstm1.kernel.shape[0] == 8192


def test_gan_forward_2d_matches_jax(monkeypatch):
    """``gan_forward`` with '2d' smoothing, and dropout (0.2) and recurrent
    dropout (0.3) in the encoder and the decoder, their masks from one
    numpy stream handed to both sides; both sides from the port's seeded
    initial state, JAX's through ``flax_tree``."""
    cfg = tiny_train_cfg()
    cfg = dataclasses.replace(cfg, kernel="2d", model=dataclasses.replace(cfg.model, dropout=0.2, rnn_dropout=0.3))
    pcfg = port_cfg(cfg)
    st = create_train_state(pcfg, torch.Generator().manual_seed(0), device="cpu")
    mods = JaxGanModules(cfg)
    rng = np.random.default_rng(5)
    video = rng.uniform(size=(2, 16, 5, 16, 1)).astype(np.float32)
    m = cfg.model
    z = rng.normal(size=(2, cfg.pred_time_steps, m.z_height, m.z_width, m.z_channels)).astype(np.float32)
    h_stats, m_stats = flax_tree(st.h_stats), flax_tree(st.m_stats)
    jax_bernoulli, port_draw = bernoulli_streams(8)
    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)

    def loss_fn(e, d, h, mm):
        loss, pm, _, _ = jax_gan_forward(
            mods, cfg, e, d, h, mm, h_stats, m_stats, jnp.asarray(video), jnp.asarray(z), jnp.float32(SIGMA),
            dropout_rng=jax.random.PRNGKey(3),
        )
        return loss, pm

    params = [getattr(st, f"{g}_params") for g in GROUPS]
    jax_params = [flax_tree(p) for p in params]
    # Compiled without LLVM's optimizations: half this test's compile
    # time; the arithmetic differs from the optimized build by ulps.
    (want_loss, want_pm), want_grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2, 3), has_aux=True,
    )).lower(*jax_params).compile({"xla_backend_optimization_level": 0})(*jax_params)
    want_grads = [flatten_flax_tree(jax.tree_util.tree_map(np.asarray, g)) for g in want_grads]

    groups = [{k: v.clone().requires_grad_() for k, v in p.items()} for p in params]
    loss, pm, _, _ = gan_forward(
        GanModules(pcfg), pcfg, *groups, st.h_stats, st.m_stats, torch.from_numpy(video), torch.from_numpy(z),
        SIGMA, masks=(port_draw, port_draw),
    )
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    np.testing.assert_allclose(pm.item(), float(want_pm), rtol=1e-4)
    grads = iter(torch.autograd.grad(loss, [v for g in groups for v in g.values()]))
    for g, group, want in zip(GROUPS, groups, want_grads):
        scale = max(float(v.abs().max()) for v in want.values())
        assert scale > 0, g
        for k in group:
            np.testing.assert_allclose(next(grads).numpy(), want[k].numpy(), rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{g} {k}")
