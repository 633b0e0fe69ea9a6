"""Configs shared by the PyTorch port's parity tests."""

import dataclasses

from kccotgan_tpu.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch import config as port_config


def port_cfg(cfg):
    """The port's config holding the JAX config's values."""
    model = port_config.ModelConfig(
        **{f.name: getattr(cfg.model, f.name) for f in dataclasses.fields(port_config.ModelConfig)}
    )
    return port_config.TrainConfig(model=model, **{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(port_config.TrainConfig) if f.name != "model"
    })


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
