"""The train state's tensor layout (``train/state.py``): the order of
``state_tensors`` written out by hand, ``state_with_tensors`` putting a
list back, and the checkpoint file's keys and nesting, with the
discriminators' norms on and off (no statistics).  CPU only, no JAX."""

import dataclasses

import pytest
import torch

from kccotgan_tpu_torch.ckpt import restore_checkpoint, save_checkpoint
from kccotgan_tpu_torch.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch.train import create_train_state
from kccotgan_tpu_torch.train.state import GROUPS, STATS, state_tensors, state_with_tensors

CFG = TrainConfig(
    dname="synthetic", batch_size=2, total_time_steps=3, int_time_steps=2, sinkhorn_l=3, warmup_steps=1,
    model=ModelConfig(x_height=16, x_width=16, g_filter_size=2, d_filter_size=1, d_state_size=2,
                      z_channels=2, z_height=1, z_width=1),
)
NORMS = {"norms": True, "no_norms": False}


def _cfg(norms):
    return dataclasses.replace(CFG, model=dataclasses.replace(CFG.model, use_norm=NORMS[norms]))


def _state(norms):
    state = create_train_state(_cfg(norms), torch.Generator().manual_seed(0), device="cpu")
    for g, count in zip(GROUPS, (3, 5, 7, 11)):
        opt = getattr(state, f"{g}_opt")
        opt.count = count
        for i, tree in enumerate((opt.mu, opt.nu)):  # distinct moments, so that a swap shows
            for k in tree:
                tree[k] = torch.full_like(tree[k], count + 0.5 * i)
    state.step, state.rng = 13, 17
    return state


def _by_hand(state):
    """The layout's trees in order, each named and read field by field."""
    return [
        ("enc_params", state.enc_params), ("dec_params", state.dec_params),
        ("h_params", state.h_params), ("m_params", state.m_params),
        ("h_stats", state.h_stats), ("m_stats", state.m_stats),
        ("enc_opt.mu", state.enc_opt.mu), ("enc_opt.nu", state.enc_opt.nu),
        ("dec_opt.mu", state.dec_opt.mu), ("dec_opt.nu", state.dec_opt.nu),
        ("h_opt.mu", state.h_opt.mu), ("h_opt.nu", state.h_opt.nu),
        ("m_opt.mu", state.m_opt.mu), ("m_opt.nu", state.m_opt.nu),
    ]


@pytest.mark.parametrize("norms", NORMS)
def test_state_tensors_follow_the_layout(norms):
    state = _state(norms)
    want = [(f"{name}/{k}", v) for name, tree in _by_hand(state) for k, v in tree.items()]
    got = list(state_tensors(state).items())
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(a is b for (_, a), (_, b) in zip(got, want))
    assert bool(state.h_stats) == bool(state.m_stats) == NORMS[norms]


@pytest.mark.parametrize("norms", NORMS)
def test_state_with_tensors_round_trips(norms):
    state = _state(norms)
    tensors = list(state_tensors(state).values())
    same = state_with_tensors(state, tensors)
    assert (same.step, same.rng) == (state.step, state.rng)
    assert [getattr(same, f"{g}_opt").count for g in GROUPS] == [3, 5, 7, 11]
    assert all(a is b for a, b in zip(state_tensors(same).values(), tensors))
    # each tensor replaced by its index in the layout: every one must land where it was read
    marked = [torch.full_like(t, float(i)) for i, t in enumerate(tensors)]
    new = state_with_tensors(state, marked, step=1, rng=2, counts=[4, 3, 2, 1])
    assert (new.step, new.rng) == (1, 2)
    assert [getattr(new, f"{g}_opt").count for g in GROUPS] == [4, 3, 2, 1]
    flat = [(k, v) for (name, tree) in _by_hand(new) for k, v in tree.items()]
    assert [k for k, _ in flat] == [k for _, tree in _by_hand(state) for k in tree]
    assert all(v.shape == t.shape and bool((v == i).all()) for i, ((_, v), t) in enumerate(zip(flat, tensors)))


@pytest.mark.parametrize("norms", NORMS)
def test_checkpoint_keeps_its_keys_and_nesting(tmp_path, norms):
    state = _state(norms)
    save_checkpoint(str(tmp_path), state)
    (path,) = tmp_path.glob("step_*.pt")
    d = torch.load(path, map_location="cpu", weights_only=True)
    assert list(d) == ["step", "rng", "enc_params", "enc_opt", "dec_params", "dec_opt", "h_params", "h_opt",
                       "m_params", "m_opt", "h_stats", "m_stats"]
    assert (d["step"], d["rng"]) == (13, 17)
    for g, count in zip(GROUPS, (3, 5, 7, 11)):
        params, opt = getattr(state, f"{g}_params"), getattr(state, f"{g}_opt")
        assert list(d[f"{g}_opt"]) == ["count", "mu", "nu"] and d[f"{g}_opt"]["count"] == count
        for got, want in ((d[f"{g}_params"], params), (d[f"{g}_opt"]["mu"], opt.mu), (d[f"{g}_opt"]["nu"], opt.nu)):
            assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    for name in STATS:
        assert list(d[name]) == list(getattr(state, name))
    back = restore_checkpoint(str(tmp_path), _cfg(norms), device="cpu")
    assert (back.step, back.rng) == (state.step, state.rng)
    got, want = state_tensors(back), state_tensors(state)
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
