"""The frozen reference against the port's plain path at a tiny size on
the CPU: the same parameter keys and shapes, the same rollout, and the
same training steps (the port under ``kernel_impl='scan'`` and
``sinkhorn_solver='scan'``, the loops the reference copies).  Only this
test imports both."""

import dataclasses

import numpy as np
import pytest
import torch

from kccotgan_tpu_torch.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch.train.rollout import build_rollout
from kccotgan_tpu_torch.train.state import TrainState, key_from_seed, make_optimizers
from kccotgan_tpu_torch.train.steps import build_train_step
from kccotgan_tpu_torch.weights import init_discriminator_params, init_generator_params
from port_bench.blobs import bouncing_blobs
from port_bench.drivers.common import make_weights
from port_bench.reference import kccot as ref
from port_bench.tests.tiny import TINY_FIELDS, TINY_MODEL

PORT = TrainConfig(**TINY_FIELDS, kernel_impl="scan", sinkhorn_solver="scan", model=ModelConfig(**TINY_MODEL))
GROUPS = ("enc", "dec", "h", "m")


def as_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("n_channels", [1, 3])
def test_parameter_keys_and_shapes_match_the_port(n_channels):
    port = dataclasses.replace(PORT, model=dataclasses.replace(PORT.model, n_channels=n_channels))
    g = torch.Generator().manual_seed(0)
    gen, disc = init_generator_params(port, g), init_discriminator_params(port, g)
    spec = ref.gen_spec(as_dict(port))
    d_spec, bns = ref.disc_spec(as_dict(port))
    for part in ("encoder", "decoder"):
        assert [(k, s) for k, s, *_ in spec[part]] == [(k, tuple(v.shape)) for k, v in gen[part].items()]
    assert [(k, s) for k, s, *_ in d_spec] == [(k, tuple(v.shape)) for k, v in disc["h"].items()]
    assert ref.init_stats(bns, "cpu").keys() == disc["h_stats"].keys()


def test_rollout_equals_the_ports():
    cfg = as_dict(PORT)
    params, _ = make_weights(ref, cfg, 3, "cpu", ("enc", "dec"))
    gen = {"encoder": params["enc"], "decoder": params["dec"]}
    ctx = torch.from_numpy(bouncing_blobs(2, 2, 16, 16, seed=1))
    z = torch.randn(2, 2, 1, 1, 1, 2, generator=torch.Generator().manual_seed(2))
    port = build_rollout(PORT, device="cpu", plain=True)(gen, ctx, z=z)
    assert torch.equal(ref.rollout(cfg, gen, ctx, z, ref.Precision("bfloat16")), port)


def test_training_steps_equal_the_ports():
    cfg = as_dict(PORT)
    params, stats = make_weights(ref, cfg, 4, "cpu", GROUPS)
    opts = make_optimizers(PORT)
    state = TrainState(step=0, rng=key_from_seed(0), **{f"{g}_params": dict(params[g]) for g in GROUPS},
                       h_stats=dict(stats["h"]), m_stats=dict(stats["m"]),
                       **{f"{g}_opt": opts[g].init(params[g]) for g in GROUPS})
    mine = ref.train_state(params, stats)
    step = build_train_step(PORT, device="cpu")
    videos = torch.from_numpy(bouncing_blobs(8, 4, 16, 16, seed=5))
    gen = torch.Generator().manual_seed(6)
    for i in range(2):
        real = videos[4 * i : 4 * i + 4]
        z = (torch.randn(4, 2, 1, 1, 2, generator=gen), torch.randn(4, 2, 1, 1, 2, generator=gen))
        state, met = step(state, real, z=z)
        mine, want = ref.train_step(cfg, mine, real, *z, ref.Precision("bfloat16"))
        np.testing.assert_allclose(float(met["sinkhorn_loss"]), float(want["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["pm"]), float(want["pm"]), rtol=1e-6)
    for g in GROUPS:
        for k, v in getattr(state, f"{g}_params").items():
            torch.testing.assert_close(v, mine["params"][g][k], rtol=1e-6, atol=1e-9, msg=f"{g} {k}")
