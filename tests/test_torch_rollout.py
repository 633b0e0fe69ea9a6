"""PyTorch port's generator and rollout vs the JAX package.

The JAX side is built with ``conv_packing='off'`` and batch-major
layout (packing and time-major change the reduction order, and the port
ports neither), at a tiny geometry: 16x16 frames, g_filter_size=2,
z 1x1x4, 3 context + 2 predicted frames, B=2.  Weights come from the
JAX init and reach the port through ``generator_params_from_jax``; the
rollout's z is the JAX draw, handed to the port.

Tolerances: float32 per module at 1e-5 abs (conv summation order) and
the whole rollout at 1e-4 abs, since each generated frame is fed back
through the encoder.  bfloat16 rollout at 5e-2 abs (1.8e-2 measured):
both sides round the convs to bf16 once, but a different f32 summation
order can put one rounding an ulp (2**-8 relative) apart; each LayerNorm
over the tiny config's 8 to 64 channels divides such a difference by the
features' spread, and every generated frame is encoded again.
"""

import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu.config import ModelConfig, TrainConfig
from kccotgan_tpu.train.rollout import build_rollout as jax_build_rollout
from kccotgan_tpu.train.state import GanModules
from kccotgan_tpu_torch.models import generator_modules
from kccotgan_tpu_torch.train import build_rollout
from kccotgan_tpu_torch.weights import generator_params_from_jax, init_generator_params
from tests._torch_port import port_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def tiny_cfg(compute_dtype="float32"):
    return TrainConfig(
        dname="synthetic",
        batch_size=2,
        compute_dtype=compute_dtype,
        total_time_steps=5,
        int_time_steps=3,
        conv_packing="off",
        time_major=False,
        kernel_impl="scan",
        model=ModelConfig(
            x_height=16, x_width=16, n_channels=1, g_filter_size=2,
            z_channels=4, z_height=1, z_width=1, use_norm=True,
        ),
    )


@pytest.fixture(scope="module")
def setup():
    """JAX modules, their params (numpy) and the context's pyramid and
    carry.  Everything runs under jit, which compiles once instead of
    dispatching every op."""
    cfg = tiny_cfg()
    mods = GanModules(cfg)
    enc, dec = mods.generator_modules(time_major=False)
    m = cfg.model
    context = np.random.default_rng(7).uniform(
        size=(cfg.batch_size, m.x_height, cfg.int_time_steps, m.x_width, m.n_channels)
    ).astype(np.float32)
    enc_p = jax.jit(lambda k: enc.init(k, context, training=False))(jax.random.PRNGKey(0))["params"]
    pyramid, carry = jax.jit(
        lambda p: enc.apply({"params": p}, context, training=False, return_carry=True)
    )(enc_p)
    z = jnp.zeros(mods.z_shape(cfg.batch_size, 1))
    dec_p = jax.jit(lambda k: dec.init(k, pyramid, z, training=False))(jax.random.PRNGKey(1))["params"]
    enc_p, dec_p = jax.tree_util.tree_map(np.asarray, (enc_p, dec_p))
    return types.SimpleNamespace(
        cfg=cfg, mods=mods, dec=dec, enc_p=enc_p, dec_p=dec_p,
        context=context, pyramid=pyramid, carry=carry,
    )


def _port_modules(cfg, enc_p, dec_p):
    encoder, decoder = generator_modules(port_cfg(cfg))
    params = generator_params_from_jax(enc_p, dec_p)
    encoder.load_state_dict(params["encoder"])
    decoder.load_state_dict(params["decoder"])
    return encoder, decoder


def _jax_z(cfg, rng_key, batch):
    m = cfg.model
    keys = jax.random.split(rng_key, cfg.pred_time_steps)
    z_shape = (batch, 1, m.z_height, m.z_width, m.z_channels)
    return np.stack([np.asarray(jax.random.normal(k, z_shape, jnp.float32)) for k in keys])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=0, atol=tol)


def test_encoder_pyramid_and_carry_match_jax(setup):
    encoder, _ = _port_modules(setup.cfg, setup.enc_p, setup.dec_p)
    with torch.no_grad():
        pyr_t, carry_t = encoder(torch.tensor(setup.context), return_carry=True)
    assert len(pyr_t) == 5 and len(carry_t) == 4
    for got, want in zip(pyr_t, setup.pyramid):
        assert tuple(got.shape) == want.shape
        _close(got, want, 1e-5)
    for (h_t, c_t), (h_j, c_j) in zip(carry_t, setup.carry):
        _close(h_t, h_j, 1e-5)
        _close(c_t, c_j, 1e-5)


def test_decoder_matches_jax(setup):
    z = np.random.default_rng(3).normal(size=setup.mods.z_shape(2, 1)).astype(np.float32)
    want = jax.jit(
        lambda p, pyr, zz: setup.dec.apply({"params": p}, pyr, zz, training=False)
    )(setup.dec_p, setup.pyramid, z)
    _, decoder = _port_modules(setup.cfg, setup.enc_p, setup.dec_p)
    with torch.no_grad():
        got = decoder([torch.tensor(np.asarray(p)) for p in setup.pyramid], torch.tensor(z))
    assert tuple(got.shape) == want.shape == (2, 16, 1, 16, 1)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_rollout_matches_jax(setup, compute_dtype, tol):
    enc_p, dec_p, context = setup.enc_p, setup.dec_p, setup.context
    cfg = tiny_cfg(compute_dtype)
    rng_key = jax.random.PRNGKey(11)
    state = types.SimpleNamespace(enc_params=enc_p, dec_params=dec_p)
    want = jax_build_rollout(cfg, GanModules(cfg), jit=False)(state, jnp.asarray(context), rng_key)

    rollout = build_rollout(port_cfg(cfg), device="cpu")
    z = torch.tensor(_jax_z(cfg, rng_key, batch=2))
    got = rollout(generator_params_from_jax(enc_p, dec_p), torch.tensor(context), z=z)
    assert tuple(got.shape) == want.shape == (2, 16, 5, 16, 1)
    assert torch.equal(got[:, :, :3], torch.tensor(context))
    _close(got, want, tol)


def test_plain_rollout_bypasses_the_kernel_wrapper(setup, monkeypatch):
    """``plain=True`` sends every ConvLSTM to the plain version and never
    through ``convlstm_scan``; the default path goes through it."""
    from kccotgan_tpu_torch.models import layers

    def no_wrapper(*args):
        raise AssertionError("convlstm_scan called")

    monkeypatch.setattr(layers, "convlstm_scan", no_wrapper)
    cfg = port_cfg(setup.cfg)
    params = generator_params_from_jax(setup.enc_p, setup.dec_p)
    context = torch.tensor(setup.context)
    z = torch.zeros(cfg.pred_time_steps, 2, 1, 1, 1, 4)
    out = build_rollout(cfg, device="cpu", plain=True)(params, context, z=z)
    assert out.shape == (2, 16, 5, 16, 1) and torch.isfinite(out).all()
    with pytest.raises(AssertionError, match="convlstm_scan called"):
        build_rollout(cfg, device="cpu")(params, context, z=z)


def test_params_from_jax_round_trip(setup):
    """flax tree -> port keys -> flax tree is the identity, and the keys
    and shapes are exactly the port modules' state_dict."""
    cfg, enc_p, dec_p = setup.cfg, setup.enc_p, setup.dec_p
    params = generator_params_from_jax(enc_p, dec_p)
    encoder, decoder = generator_modules(port_cfg(cfg))
    for module, tree, got in ((encoder, enc_p, params["encoder"]), (decoder, dec_p, params["decoder"])):
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == {
            k: tuple(v.shape) for k, v in got.items()
        }
        back = {}
        for key, value in got.items():
            layer, name = key.split(".")
            back.setdefault(layer, {})[name] = value.numpy()
        assert back.keys() == tree.keys()
        for layer in tree:
            assert back[layer].keys() == tree[layer].keys()
            for name in tree[layer]:
                np.testing.assert_array_equal(back[layer][name], tree[layer][name])


def test_init_generator_params(setup):
    cfg, context = port_cfg(setup.cfg), setup.context
    p1 = init_generator_params(cfg, torch.Generator().manual_seed(5))
    p2 = init_generator_params(cfg, torch.Generator().manual_seed(5))
    ref = generator_params_from_jax(setup.enc_p, setup.dec_p)
    for part in ("encoder", "decoder"):
        assert {k: v.shape for k, v in p1[part].items()} == {k: v.shape for k, v in ref[part].items()}
        for k in p1[part]:
            assert torch.equal(p1[part][k], p2[part][k])
    dec = p1["decoder"]
    f = dec["decoder5.recurrent_kernel"].shape[2]
    np.testing.assert_array_equal(dec["decoder5.bias"].numpy(), np.repeat([0.0, 1.0, 0.0, 0.0], f))
    assert torch.equal(dec["decoder5_norm.scale"], torch.ones(f))
    assert torch.equal(dec["decoder5_norm.bias"], torch.zeros(f))
    rk = p1["encoder"]["encoder4.recurrent_kernel"]
    mat = rk.reshape(-1, rk.shape[-1])  # [kh*kw*f, 4f], more rows than columns
    torch.testing.assert_close(mat.T @ mat, torch.eye(mat.shape[1]), rtol=0, atol=1e-5)
    k = p1["encoder"]["encoder1.kernel"]
    kh, kw, c, f4 = k.shape
    limit = (6.0 / (kh * kw * (c + f4))) ** 0.5
    assert k.abs().max() <= limit and k.abs().max() > 0.9 * limit
    out = build_rollout(cfg, device="cpu")(p1, torch.tensor(context), torch.Generator().manual_seed(0))
    assert out.shape == (2, 16, 5, 16, 1) and torch.isfinite(out).all()


def test_port_never_imports_jax():
    """Neither the port nor ``chip_smoke.py`` imports JAX, flax or the JAX
    package, which the GPU machine lacks: every module of the port is
    imported, and a tiny rollout, a tiny training iteration under each
    recurrence engine and two steps of the trainer's command line run,
    before ``sys.modules`` is read."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import chip_smoke, kccotgan_tpu_torch\n"
        "for mod in pkgutil.walk_packages(kccotgan_tpu_torch.__path__, 'kccotgan_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "from kccotgan_tpu_torch.config import ModelConfig, TrainConfig\n"
        "from kccotgan_tpu_torch.train import build_rollout, build_train_step, create_train_state\n"
        "from kccotgan_tpu_torch.weights import init_generator_params\n"
        "torch.set_num_threads(1)\n"
        "cfg = TrainConfig(batch_size=2, total_time_steps=3, int_time_steps=2, sinkhorn_l=3, model=ModelConfig(\n"
        "    x_height=16, x_width=16, g_filter_size=1, d_filter_size=1, d_state_size=2,\n"
        "    z_channels=2, z_height=1, z_width=1))\n"
        "g = torch.Generator().manual_seed(0)\n"
        "out = build_rollout(cfg, device='cpu')(init_generator_params(cfg, g), torch.rand(2, 16, 2, 16, 1), g)\n"
        "assert out.shape == (2, 16, 3, 16, 1)\n"
        "state = create_train_state(cfg, device='cpu')\n"
        "state, metrics = build_train_step(cfg, device='cpu')(state, torch.rand(2, 16, 3, 16, 1), g)\n"
        "assert state.step == 1 and torch.isfinite(metrics['sinkhorn_loss'])\n"
        "import dataclasses\n"
        "pallas = build_train_step(dataclasses.replace(cfg, kernel_impl='pallas'), device='cpu')\n"
        "state, metrics = pallas(state, torch.rand(2, 16, 3, 16, 1), g)\n"
        "assert state.step == 2 and torch.isfinite(metrics['sinkhorn_loss'])\n"
        "import tempfile\n"
        "from kccotgan_tpu_torch.cli.main import main\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    assert main(['--dname', 'synthetic', '-bs', '2', '-tts', '3', '-its', '2', '-sinkl', '3',\n"
        "                 '-xh', '16', '-xw', '16', '-gfs', '1', '-dfs', '1', '-dss', '2', '-nz', '2',\n"
        "                 '-ne', '1', '--max_steps', '2', '--ckpt_freq', '2', '--kernel_impl', 'pallas',\n"
        "                 '--out_dir', d], device='cpu') == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'kccotgan_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
