"""The PyTorch port's configuration vs the JAX package's.

The port keeps its own copy of the config fields it reads, so that it
runs where the JAX package is absent; these tests keep the copy from
drifting: same preset names, and every ported field equal, field by
field, to the JAX preset's; the trainer's command line gives the config
JAX's command line gives.
"""

import dataclasses
import json

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


@pytest.mark.parametrize("argv", [
    [],
    ["--preset", "mmnist_full"],
    ["--preset", "mmnist_full", "--dname", "synthetic", "--kernel_impl", "pallas", "-bs", "4",
     "--lr", "1e-4", "--height", "32", "--no_batch_norm", "--checkpoint", "--ckpt_path", "runs/x/ckpt"],
    ["--warmu", "500"],
    ["--preset", "synthetic_demo", "--warmu=500"],
    ["--lr=2e-4", "--batch_size=4", "-gss", "6", "--solver", "scan", "--ckpt_freq=7"],
])
def test_cli_config_matches_jax(argv):
    """The trainer's flags give the port the config JAX's CLI gives, on
    every field the port carries: plain defaults, a preset with and
    without typed flags over it, an abbreviated flag, ``--flag=value``."""
    from kccotgan_tpu.cli import main as jax_cli
    from kccotgan_tpu_torch.cli import main as port_cli

    parser, jax_parser = port_cli.build_parser(), jax_cli.build_parser()
    port = port_cli.config_from_args(parser.parse_args(argv), port_cli.provided_dests(parser, argv))
    ref = jax_cli.config_from_args(jax_parser.parse_args(argv), jax_cli.provided_dests(jax_parser, argv))
    for f in dataclasses.fields(config.TrainConfig):
        if f.name != "model":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    for f in dataclasses.fields(config.ModelConfig):
        assert getattr(port.model, f.name) == getattr(ref.model, f.name), f.name


def test_config_to_json_round_trips():
    cfg = config.get_preset("mmnist_full")
    d = json.loads(cfg.to_json())
    assert d["dname"] == "mmnist" and d["model"]["n_channels"] == 1
    assert config.TrainConfig(**{**d, "model": config.ModelConfig(**d["model"])}) == cfg
