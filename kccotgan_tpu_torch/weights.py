"""Generator parameters of the PyTorch port: a seeded init, and the
conversion from the JAX package's flax trees.

Parameters are ``{"encoder": {key: tensor}, "decoder": {key: tensor}}``
with the modules' ``state_dict`` keys, which are the flax paths joined by
dots (``encoder1.kernel``, ``norm1.scale``, ``conv_transpose1.kernel``,
``decoder2_norm.bias``) and the flax layouts, so conversion is a rename.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models.video import generator_modules

__all__ = ["generator_params_from_jax", "init_generator_params"]


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


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, f"{prefix}{name}."))
        else:
            out[prefix + name] = torch.tensor(np.asarray(value, dtype=np.float32))
    return out


def generator_params_from_jax(enc_params: Mapping, dec_params: Mapping) -> dict:
    """The port's parameters (CPU float32) from the JAX package's
    ``enc_params`` / ``dec_params`` trees, given as nested dicts of numpy
    arrays."""
    return {"encoder": _flatten(enc_params), "decoder": _flatten(dec_params)}
