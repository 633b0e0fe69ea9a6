"""The PyTorch port's training loop, checkpoints and CLI, on the CPU.

These are pinned against the port's own training step, which
``tests/test_torch_train.py`` already holds against JAX's: checkpoints
round-trip every leaf to the bit, a run stopped and resumed from a
checkpoint equals the straight run to the bit (the noise key is part of
the state), and the ``Trainer`` mirrors JAX's trainer tests
(``tests/test_train.py``: the synthetic run, the NaN sentinel, the
recovery).  The geometry is ``test_port_never_imports_jax``'s (B=2,
16x16, 2 + 1 frames, discriminator f=1, L=3) but for g_filter_size=2,
the narrowest generator in which the noise reaches the loss (at 1 a
LayerNorm over one channel erases it).  A one-step warmup makes each
step from the second on move the parameters by far more than rounding
(Keras's schedule gives the first update of the encoder and of h a rate
of 0).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from kccotgan_tpu_torch.ckpt import CheckpointWriter, latest_step, restore_checkpoint, save_checkpoint
from kccotgan_tpu_torch.cli.main import main
from kccotgan_tpu_torch.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch.data import ArrayDataset, bouncing_blobs, device_prefetch
from kccotgan_tpu_torch.train import Trainer, build_train_step, create_train_state
from kccotgan_tpu_torch.train.state import fold_in

torch.set_num_threads(1)

CFG = TrainConfig(
    dname="synthetic", batch_size=2, total_time_steps=3, int_time_steps=2, sinkhorn_l=3,
    warmup_steps=1, save_freq=10_000, ckpt_freq=10_000,
    model=ModelConfig(x_height=16, x_width=16, g_filter_size=2, d_filter_size=1, d_state_size=2,
                      z_channels=2, z_height=1, z_width=1),
)
TENSOR_FIELDS = ("enc_params", "dec_params", "h_params", "m_params", "h_stats", "m_stats")
GROUPS = ("enc", "dec", "h", "m")


def assert_states_equal(a, b):
    assert (a.step, a.rng) == (b.step, b.rng)
    for name in TENSOR_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.keys() == y.keys(), name
        for k in x:
            assert torch.equal(x[k], y[k]), f"{name} {k}"
    for g in GROUPS:
        x, y = getattr(a, f"{g}_opt"), getattr(b, f"{g}_opt")
        assert x.count == y.count
        for k in x.mu:
            assert torch.equal(x.mu[k], y.mu[k]) and torch.equal(x.nu[k], y.nu[k]), f"{g} {k}"


@pytest.fixture(scope="module")
def run():
    """Four straight steps from the seeded state over four batches, each
    step's noise drawn from the state's key."""
    data = bouncing_blobs(8, CFG.total_time_steps, 16, 16, seed=3)
    batches = [torch.from_numpy(data[2 * i: 2 * i + 2]) for i in range(4)]
    step = build_train_step(CFG, device="cpu")
    states, losses = [create_train_state(CFG, device="cpu")], []
    for batch in batches:
        state, metrics = step(states[-1], batch)
        states.append(state)
        losses.append(float(metrics["sinkhorn_loss"]))
    return step, batches, states, losses


def test_state_key_advances_and_moves_parameters(run):
    _, _, states, losses = run
    assert len({s.rng for s in states}) == len(states)
    assert all(np.isfinite(losses))
    for g in GROUPS:
        p0, p1 = getattr(states[0], f"{g}_params"), getattr(states[2], f"{g}_params")
        assert max(float((p1[k] - p0[k]).abs().max()) for k in p0) > 1e-5, g


@pytest.mark.parametrize("template", ["state", "cfg"])
def test_checkpoint_round_trips_every_leaf(run, tmp_path, template):
    state = run[2][2]
    save_checkpoint(str(tmp_path), state)
    assert latest_step(str(tmp_path)) == 2
    restored = restore_checkpoint(str(tmp_path), state if template == "state" else CFG, device="cpu")
    assert_states_equal(restored, state)


def test_checkpoint_refuses_other_shapes(run, tmp_path):
    save_checkpoint(str(tmp_path), run[2][1])
    other = dataclasses.replace(CFG, model=dataclasses.replace(CFG.model, g_filter_size=1))
    with pytest.raises(ValueError, match="does not match"):
        restore_checkpoint(str(tmp_path), other, device="cpu")


def test_checkpoint_writer_keeps_three(run, tmp_path):
    writer = CheckpointWriter(str(tmp_path))
    for step in range(1, 6):
        writer.save(run[2][1], step)
    writer.close()
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:09d}.pt" for s in (3, 4, 5)]
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "absent")) is None
    assert [r["step"] for r in writer.records] == [1, 2, 3, 4, 5]
    assert all(r["bytes"] > 0 and r["write_ms"] >= 0 for r in writer.records)
    assert restore_checkpoint(str(tmp_path), CFG, 4, device="cpu").step == 1  # saved under 4


def test_resume_replays_the_noise(run, tmp_path):
    """2 steps, checkpoint, restore, 2 more: the straight 4 steps to the
    bit, losses and every leaf of the state, key included."""
    step, batches, states, losses = run
    state = states[0]
    for batch in batches[:2]:
        state, _ = step(state, batch)
    save_checkpoint(str(tmp_path), state)
    state = restore_checkpoint(str(tmp_path), CFG, device="cpu")
    resumed = []
    for batch in batches[2:]:
        state, metrics = step(state, batch)
        resumed.append(float(metrics["sinkhorn_loss"]))
    assert resumed == losses[2:]
    assert_states_equal(state, states[4])


def test_recovery_draws_other_noise(run):
    """Folding the retry count into the key changes the step's noise."""
    step, batches, states, losses = run
    again, metrics = step(states[0], batches[0])
    assert float(metrics["sinkhorn_loss"]) == losses[0]
    refolded = dataclasses.replace(states[0], rng=fold_in(states[0].rng, 1))
    _, metrics = step(refolded, batches[0])
    assert float(metrics["sinkhorn_loss"]) != losses[0]


def test_trainer_fit_synthetic(tmp_path):
    cfg = dataclasses.replace(CFG, out_dir=str(tmp_path), run_name="e2e", n_epochs=1, save_freq=10)
    data = bouncing_blobs(6, cfg.total_time_steps, 16, 16, seed=0)
    trainer = Trainer(cfg, device="cpu")
    state, summary = trainer.fit(
        ArrayDataset(data, cfg.batch_size, seed=0).repeat(2), max_steps=3, test_batch=data[: cfg.batch_size]
    )
    assert summary["status"] == "completed"
    assert summary["steps"] == state.step == 3
    assert os.path.exists(os.path.join(trainer.run_dir, "train_notes.txt"))
    with open(os.path.join(trainer.run_dir, "log", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines if r["tag"] == "Sinkhorn Loss"] == [1, 2, 3]
    assert {"eval/psnr", "eval/ssim"} <= {r["tag"] for r in lines}
    assert len(trainer.timings["sample_ms"]) == 1  # step 1


def test_trainer_skips_the_ragged_tail(tmp_path):
    cfg = dataclasses.replace(CFG, out_dir=str(tmp_path), run_name="ragged")
    data = bouncing_blobs(5, cfg.total_time_steps, 16, 16, seed=0)
    _, summary = Trainer(cfg, device="cpu").fit(iter([data[:2], data[2:3], data[3:5]]))
    assert summary["status"] == "completed" and summary["steps"] == 2


def _poison(batch):
    bad = np.array(batch)
    bad[0, 0, 0, 0, 0] = np.nan
    return bad


def test_nan_sentinel_stops_without_recovery(tmp_path):
    cfg = dataclasses.replace(CFG, out_dir=str(tmp_path), run_name="nanstop")
    good = bouncing_blobs(4, cfg.total_time_steps, 16, 16, seed=5)[: cfg.batch_size]
    trainer = Trainer(cfg, device="cpu")
    _, summary = trainer.fit(iter([good, _poison(good), good, good]), max_steps=4)
    assert summary["status"] == "failed"
    assert summary["recoveries"] == 0
    notes = open(os.path.join(trainer.run_dir, "train_notes.txt")).read()
    assert "Training failed!" in notes


def test_nan_recovery_restores_and_continues(tmp_path):
    cfg = dataclasses.replace(
        CFG, out_dir=str(tmp_path), run_name="nanrec", ckpt_freq=1, nan_recovery_retries=2,
    )
    good = bouncing_blobs(4, cfg.total_time_steps, 16, 16, seed=5)[: cfg.batch_size]
    trainer = Trainer(cfg, device="cpu")
    state, summary = trainer.fit(iter([good, good, _poison(good), good, good, good]), max_steps=4)
    assert summary["status"] == "completed"
    assert summary["steps"] == 4
    assert summary["recoveries"] == 1
    for name in TENSOR_FIELDS[:4]:
        assert all(bool(torch.isfinite(v).all()) for v in getattr(state, name).values())
    notes = open(os.path.join(trainer.run_dir, "train_notes.txt")).read()
    assert "re-seeded (retry 1/2)" in notes
    assert "Training failed!" not in notes


TINY_FLAGS = ["--dname", "synthetic", "-bs", "2", "-tts", "3", "-its", "2", "-sinkl", "3",
              "-xh", "16", "-xw", "16", "-gfs", "2", "-dfs", "1", "-dss", "2", "-nz", "2",
              "-ne", "1", "--max_steps", "2", "--ckpt_freq", "2"]


def test_cli_trains_synthetic(tmp_path, capsys):
    rc = main([*TINY_FLAGS, "--out_dir", str(tmp_path), "--run_name", "cli"], device="cpu")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert summary["status"] == "completed" and summary["steps"] == 2
    assert latest_step(str(tmp_path / "cli" / "ckpt")) == 2


@pytest.mark.parametrize("flags", [
    ["--num_devices", "2"], ["--seq_devices", "4"], ["--conv_packing", "off"], ["--time_major"],
    ["--no_time_major"], ["--remat_policy", "carry_only"], ["--compile_cache", "x"],
    ["--local_sinkhorn"], ["--profile_steps", "5,8"],
])
def test_cli_refuses_what_the_port_does_not_carry(flags, capsys):
    with pytest.raises(SystemExit) as e:
        main([*TINY_FLAGS, *flags], device="cpu")
    assert e.value.code == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_cli_keeps_check_trainable_rejections():
    with pytest.raises(NotImplementedError, match="smoothing"):
        main([*TINY_FLAGS, "--kernel", "1d"], device="cpu")


def test_no_card_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter([np.zeros((2, 1), np.float32)]), device="cuda"))
