"""Configs and checks shared by the PyTorch port's parity tests."""

import dataclasses

import jax
import numpy as np
import torch

from kccotgan_tpu.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch import config as port_config

GROUPS = ("enc", "dec", "h", "m")


def compile_o0(fn, *args):
    """``jax.jit(fn)`` (``fn`` itself if already jitted) compiled for
    ``args`` without LLVM's optimizations (``xla_backend_optimization_level``
    0): a half to two thirds of the optimized build's compile time on the
    tiny geometry, the arithmetic ulps from it, far inside every tolerance
    of the port's tests."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*args).compile({"xla_backend_optimization_level": 0})


def port_cfg(cfg):
    """The port's config holding the JAX config's values."""
    model = port_config.ModelConfig(
        **{f.name: getattr(cfg.model, f.name) for f in dataclasses.fields(port_config.ModelConfig)}
    )
    return port_config.TrainConfig(model=model, **{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(port_config.TrainConfig) if f.name != "model"
    })


def bernoulli_streams(seed):
    """The same 0/1 dropout masks for both packages: ``(jax_bernoulli,
    port_draw)``, each consuming its own copy of one seeded numpy stream
    in call order.  ``jax_bernoulli`` takes the place of
    ``jax.random.bernoulli`` (monkeypatched by the test); ``port_draw``
    is a mask source for the port's ConvLSTMs."""
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)

    def jax_bernoulli(key, p, shape):
        del key
        return jr.uniform(size=shape) < p

    def port_draw(keep, shape):
        return torch.from_numpy((tr.uniform(size=shape) < keep).astype(np.float32))

    return jax_bernoulli, port_draw


def flax_tree(flat):
    """The nested flax tree (numpy arrays) of a dict of dotted ``state_dict``
    keys to tensors: the inverse of ``weights.flatten_flax_tree``, which
    lets the JAX side run on parameters the port initialised."""
    tree = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value.detach().numpy()
    return tree


def tiny_train_cfg(compute_dtype="float32"):
    """The tiny training geometry of ``tests/test_train.py`` (B=2, 16x16x1,
    T=5 with 3 context, f=2, state 3, z 1x1x4, L=10), built with the
    layouts the port ports: no conv packing, batch-major."""
    return TrainConfig(
        dname="synthetic", batch_size=2, compute_dtype=compute_dtype,
        total_time_steps=5, int_time_steps=3, sinkhorn_l=10,
        warmup_steps=10, decay_steps=5,
        conv_packing="off", time_major=False, kernel_impl="scan",
        model=ModelConfig(
            x_height=16, x_width=16, n_channels=1, g_filter_size=2, d_filter_size=2,
            g_state_size=3, d_state_size=3, z_channels=4, z_height=1, z_width=1, use_norm=True,
        ),
    )


def assert_iterations_match(runs, jax_runs, start):
    """The port's training iterations ``runs`` (``(metrics, TrainState)``
    each) against the JAX step's ``jax_runs`` (``(z, metrics, state)``,
    states already converted by ``train_state_from_jax``), both from the
    state ``start``, in f32.  Tolerances are argued in
    ``tests/test_torch_train.py``: losses and pM at rtol 1e-4, BatchNorm
    statistics at 1e-5 abs, Adam moments at 1e-4 of each group's largest
    entry, parameters at 3e-6 abs on every element whose gradient stood
    above rounding noise at every iteration."""
    wants = [want for _, _, want in jax_runs]
    for (metrics, got), (_, want_m, want) in zip(runs, jax_runs):
        for key in ("sinkhorn_loss", "pm"):
            np.testing.assert_allclose(float(metrics[key]), float(want_m[key]), rtol=1e-4, err_msg=key)
        assert float(metrics["sigma"]) == float(want_m["sigma"])
        assert got.step == want.step
        for name in ("h_stats", "m_stats"):
            w, g = getattr(want, name), getattr(got, name)
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
        for group in GROUPS:
            w, g = getattr(want, f"{group}_opt"), getattr(got, f"{group}_opt")
            assert g.count == w.count
            for moments in ("mu", "nu"):
                wm, gm = getattr(w, moments), getattr(g, moments)
                scale = max(float(v.abs().max()) for v in wm.values())
                for k in wm:
                    np.testing.assert_allclose(
                        gm[k].numpy(), wm[k].numpy(), rtol=0, atol=1e-4 * scale, err_msg=f"{group} {k}"
                    )
    got = runs[-1][1]
    for group in GROUPS:
        w, g = getattr(wants[-1], f"{group}_params"), getattr(got, f"{group}_params")
        assert g.keys() == w.keys()
        moved = False
        for k in w:
            signal = torch.ones_like(w[k], dtype=torch.bool)
            for want in wants:
                mu = getattr(want, f"{group}_opt").mu
                signal &= mu[k].abs() >= 1e-4 * max(float(v.abs().max()) for v in mu.values())
            np.testing.assert_allclose(
                g[k][signal].numpy(), w[k][signal].numpy(), rtol=0, atol=3e-6, err_msg=f"{group} {k}"
            )
            moved |= bool((w[k] - getattr(start, f"{group}_params")[k]).abs().max() > 1e-5)
        assert moved, f"{group} did not move"
