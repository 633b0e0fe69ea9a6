"""The PyTorch port's configuration vs the JAX package's.

The port keeps its own copy of the config fields it reads, so that it
runs where the JAX package is absent; these tests keep the copy from
drifting: same preset names, and every ported field equal, field by
field, to the JAX preset's.
"""

import dataclasses

import pytest

from kccotgan_tpu import config as jax_config
from kccotgan_tpu_torch import config


def test_same_presets():
    assert set(config.PRESETS) == set(jax_config.PRESETS)


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_preset_matches_jax(name):
    port, ref = config.get_preset(name), jax_config.get_preset(name)
    for f in dataclasses.fields(config.TrainConfig):
        if f.name != "model":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    for f in dataclasses.fields(config.ModelConfig):
        assert getattr(port.model, f.name) == getattr(ref.model, f.name), f.name
    assert port.pred_time_steps == ref.pred_time_steps


def test_defaults_match_jax():
    assert config.TrainConfig().model == config.ModelConfig()
    for port_cls, ref_cls in ((config.TrainConfig, jax_config.TrainConfig),
                              (config.ModelConfig, jax_config.ModelConfig)):
        ref_defaults = {f.name: f for f in dataclasses.fields(ref_cls)}
        for f in dataclasses.fields(port_cls):
            assert f.name in ref_defaults, f.name
            if f.name != "model":
                assert f.default == ref_defaults[f.name].default, f.name


def test_unknown_preset_raises():
    with pytest.raises(KeyError, match="unknown preset"):
        config.get_preset("no_such_preset")
