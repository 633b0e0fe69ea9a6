"""Configuration of the PyTorch port: the fields of the JAX package's
``ModelConfig`` / ``TrainConfig`` that the ported path reads (the model,
the objective, the optimizer, the data and the trainer's bookkeeping),
with the same names and defaults, and the per-dataset presets restricted
to them.

Counterpart of ``kccotgan_tpu/config``; ``tests/test_torch_config.py``
holds every preset here field by field against the JAX package's.
``check_trainable`` names the training option the port does not carry
yet, and the ROADMAP item that will.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

__all__ = ["PRESETS", "ModelConfig", "TrainConfig", "check_trainable", "get_preset"]


@dataclass(frozen=True)
class ModelConfig:
    x_height: int = 64
    x_width: int = 64
    n_channels: int = 1
    d_state_size: int = 8
    g_filter_size: int = 8
    d_filter_size: int = 8
    z_channels: int = 128
    z_height: int = 4
    z_width: int = 4
    use_norm: bool = True  # LayerNorm in the generator, BatchNorm in the discriminators
    dropout: float = 0.0
    rnn_dropout: float = 0.0
    output_activation: str = "sigmoid"


@dataclass(frozen=True)
class TrainConfig:
    # data
    dname: str = "mmnist"
    data_path: str = "../data"
    batch_size: int = 8
    total_time_steps: int = 15
    int_time_steps: int = 5
    n_epochs: int = 100
    model: ModelConfig = field(default_factory=ModelConfig)

    # objective
    sinkhorn_eps: float = 1.0
    sinkhorn_l: int = 100
    scaling_coef: float = 15.0  # effective multiplier is 1/this
    reg_penalty: float = 1.0
    cost_method: str = "gram"  # 'gram' or 'exact'
    # 'auto' / 'pallas': the fused Sinkhorn kernels for CUDA tensors (their
    # plain version on the CPU); 'scan': the plain loop under autograd
    sinkhorn_solver: str = "auto"

    # kernel smoothing
    kernel: str = "none"  # {'1d', '2d', '3d', 'none'}
    init_sigma: float = 5.0
    decaying_sigma: bool = False
    temporal_kernel_size: int = 6
    spatial_kernel_size: int = 6

    # optimization (Keras-3 Adam on a warmup + staircase-decay schedule)
    lr: float = 5e-4
    warmup_steps: int = 10000
    decay_steps: int = 5000
    decay_rate: float = 0.975
    beta1: float = 0.5
    beta2: float = 0.9
    adam_eps: float = 1e-7
    keras_double_step_quirk: bool = True

    # input precision of the convolutions and matmuls; state, gates,
    # parameters and the Sinkhorn stay f32
    compute_dtype: str = "bfloat16"
    # recurrence engine of the training step: 'scan' (and 'auto', which
    # resolves to it) runs every recurrence's plain loop under autograd;
    # 'pallas' the fused ConvLSTM and LSTM recurrences (the Hopper kernels
    # on the card, forward and backward).  The port's 'pallas' is JAX's
    # 'pallas' in its batch-major, unpacked layout (time_major=False,
    # conv_packing='off'): JAX's defaults (time_major=True,
    # conv_packing='auto') send the generator's layers back to the scan.
    kernel_impl: str = "scan"
    share_context_encoding: bool = True
    fused_discriminators: bool = False

    # on a non-finite loss the trainer restores the last verified
    # checkpoint, folds the retry count into the noise key and goes on,
    # up to this many times a run; 0 stops (train/loop.py)
    nan_recovery_retries: int = 0

    # meshes (parallel/): ranks over the batch (num_devices) and over the
    # generator's time axis (seq_devices; total_time_steps and
    # pred_time_steps must divide by it), together a 2-D data x seq mesh;
    # global_batch_sinkhorn: the exact mixed Sinkhorn on the gathered
    # global batch, else each rank's own on its shard, averaged
    num_devices: int = 1
    seq_devices: int = 1
    global_batch_sinkhorn: bool = True

    # bookkeeping
    seed: int = 1
    save_freq: int = 10  # sample and score a rollout every this many steps
    ckpt_freq: int = 10000
    out_dir: str = "trained"
    run_name: str = ""
    checkpoint: bool = False  # resume from ckpt_path
    ckpt_path: str = ""

    @property
    def pred_time_steps(self) -> int:
        return self.total_time_steps - self.int_time_steps

    @property
    def effective_scaling(self) -> float:
        return 1.0 / self.scaling_coef

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def check_trainable(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for an unknown Sinkhorn solver or recurrence
    engine.  Every training option of the JAX package is ported,
    ``fused_discriminators`` included (``train/steps.py``)."""
    if cfg.sinkhorn_solver not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown sinkhorn_solver: {cfg.sinkhorn_solver!r}")
    if cfg.kernel_impl not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown kernel_impl: {cfg.kernel_impl!r}")


PRESETS = {
    "mmnist_small": TrainConfig(dname="mmnist", batch_size=8, total_time_steps=20, int_time_steps=10),
    "mmnist_full": TrainConfig(dname="mmnist", batch_size=32, total_time_steps=20, int_time_steps=10),
    "mazes": TrainConfig(dname="mazes", batch_size=8, model=ModelConfig(n_channels=3)),
    "robot_push": TrainConfig(dname="robot_push", batch_size=8, model=ModelConfig(n_channels=3)),
    "mmnist_long": TrainConfig(dname="mmnist", batch_size=32, total_time_steps=30, int_time_steps=5),
    "reference_defaults": TrainConfig(dname="robot_push", batch_size=2, model=ModelConfig(n_channels=3)),
    "synthetic_demo": TrainConfig(dname="synthetic", batch_size=32, total_time_steps=20, int_time_steps=10),
}


def get_preset(name: str) -> TrainConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
