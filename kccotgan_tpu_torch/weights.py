"""Parameters of the PyTorch port: seeded inits, and the conversion from
the JAX package's flax trees and train state.

Parameters are dicts of the modules' ``state_dict`` keys, which are the
flax paths joined by dots (``encoder1.kernel``, ``norm1.scale``,
``conv_transpose1.kernel``, ``decoder2_norm.bias``, ``conv1.kernel``,
``lstm1.recurrent_kernel``, ``rnn_bn1.scale``), to tensors in the flax
layouts, so conversion is a rename.  BatchNorm statistics are dicts of
the flax ``batch_stats`` paths (``bn1.mean``, ``rnn_bn2.var``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models.video import discriminator_modules, generator_modules

__all__ = [
    "flatten_flax_tree",
    "generator_params_from_jax",
    "init_discriminator_params",
    "init_generator_params",
    "train_state_from_jax",
]


def init_generator_params(cfg, generator: torch.Generator) -> dict:
    """Fresh generator parameters on ``generator.device``, drawn from
    ``generator``: glorot-uniform kernels, orthogonal recurrent kernels,
    unit forget bias, LayerNorm ones / zeros (flax's distributions)."""
    with torch.device(generator.device):
        encoder, decoder = generator_modules(cfg)
    for module in (*encoder.modules(), *decoder.modules()):
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return {"encoder": encoder.state_dict(), "decoder": decoder.state_dict()}


def init_discriminator_params(cfg, generator: torch.Generator) -> dict:
    """Fresh parameters and BatchNorm statistics of the two discriminators
    on ``generator.device``: ``{"h", "m", "h_stats", "m_stats"}``."""
    with torch.device(generator.device):
        disc_h, disc_m = discriminator_modules(cfg)
    out = {}
    for name, disc in (("h", disc_h), ("m", disc_m)):
        for module in disc.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        out[name] = disc.state_dict()
        out[f"{name}_stats"] = disc.init_stats()
    return out


def flatten_flax_tree(tree: Mapping, prefix: str = "") -> dict:
    """A flax tree (nested mappings of arrays) as CPU float32 tensors keyed
    by the paths joined with dots."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            out.update(flatten_flax_tree(value, f"{prefix}{name}."))
        else:
            out[prefix + name] = torch.tensor(np.asarray(value, dtype=np.float32))
    return out


def generator_params_from_jax(enc_params: Mapping, dec_params: Mapping) -> dict:
    """The port's parameters (CPU float32) from the JAX package's
    ``enc_params`` / ``dec_params`` trees, given as nested dicts of numpy
    arrays."""
    return {"encoder": flatten_flax_tree(enc_params), "decoder": flatten_flax_tree(dec_params)}


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def train_state_from_jax(state):
    """The port's ``TrainState`` (CPU float32) from a JAX ``TrainState``
    whose leaves are numpy arrays (or a mapping of the same fields): the
    four parameter trees, both ``batch_stats`` trees, the four Adam states
    (``count``, ``mu``, ``nu``) and ``step``.  The noise key is seed 0's:
    JAX's threefry key would not give the port's draws anyway."""
    from .train.keras_adam import KerasAdamState
    from .train.state import TrainState, key_from_seed

    def opt(o):
        return KerasAdamState(
            count=int(np.asarray(_get(o, "count"))),
            mu=flatten_flax_tree(_get(o, "mu")),
            nu=flatten_flax_tree(_get(o, "nu")),
        )

    fields = {name: flatten_flax_tree(_get(state, name)) for name in (
        "enc_params", "dec_params", "h_params", "m_params", "h_stats", "m_stats"
    )}
    opts = {name: opt(_get(state, name)) for name in ("enc_opt", "dec_opt", "h_opt", "m_opt")}
    return TrainState(
        step=int(np.asarray(_get(state, "step"))), rng=key_from_seed(0), **fields, **opts
    )
