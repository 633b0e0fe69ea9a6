"""Configuration of the PyTorch port: the fields of the JAX package's
``ModelConfig`` / ``TrainConfig`` that the ported path reads, with the
same names and defaults, and the per-dataset presets restricted to them.

Counterpart of ``kccotgan_tpu/config``; ``tests/test_torch_config.py``
holds every preset here field by field against the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["PRESETS", "ModelConfig", "TrainConfig", "get_preset"]


@dataclass(frozen=True)
class ModelConfig:
    x_height: int = 64
    x_width: int = 64
    n_channels: int = 1
    g_filter_size: int = 8
    z_channels: int = 128
    z_height: int = 4
    z_width: int = 4
    use_norm: bool = True  # LayerNorm in the generator
    dropout: float = 0.0
    rnn_dropout: float = 0.0
    output_activation: str = "sigmoid"


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    total_time_steps: int = 15
    int_time_steps: int = 5
    model: ModelConfig = field(default_factory=ModelConfig)
    # input precision of the convolutions; state and gate math stay f32
    compute_dtype: str = "bfloat16"

    @property
    def pred_time_steps(self) -> int:
        return self.total_time_steps - self.int_time_steps


PRESETS = {
    "mmnist_small": TrainConfig(batch_size=8, total_time_steps=20, int_time_steps=10),
    "mmnist_full": TrainConfig(batch_size=32, total_time_steps=20, int_time_steps=10),
    "mazes": TrainConfig(batch_size=8, model=ModelConfig(n_channels=3)),
    "robot_push": TrainConfig(batch_size=8, model=ModelConfig(n_channels=3)),
    "mmnist_long": TrainConfig(batch_size=32, total_time_steps=30, int_time_steps=5),
    "reference_defaults": TrainConfig(batch_size=2, model=ModelConfig(n_channels=3)),
    "synthetic_demo": TrainConfig(batch_size=32, total_time_steps=20, int_time_steps=10),
}


def get_preset(name: str) -> TrainConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
