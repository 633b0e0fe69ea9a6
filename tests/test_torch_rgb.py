"""The PyTorch port at three channels (the RGB presets ``robot_push`` and
``mazes``) vs the JAX package, on the CPU.

Every other port test runs one channel.  Here the encoder's first input
conv takes three channels, the decoder's output conv gives three, and
the discriminators' first conv takes three, at a tiny geometry (16x16x3,
g_filter_size 2, B=2, 2 context + 2 predicted frames): the rollout and
both discriminators' forward on the same weights as JAX's, which the
port reads from JAX's trees through ``weights.py``, within the f32
tolerances of ``tests/test_torch_rollout.py`` (1e-4 for the rollout,
each generated frame encoded again) and ``tests/test_torch_disc.py``
(1e-5).  Then ``cli.main`` trains two steps
of the ``robot_push`` preset on a BAIR fixture (64x64x3 frames, the
format's own size), both recurrence engines: rc 0, finite losses, and a
PSNR / SSIM of the sample on the test batch.
"""

import collections
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu.config import ModelConfig, TrainConfig
from kccotgan_tpu.data.tfrecord import encode_sequence_example, write_tfrecord
from kccotgan_tpu.train.rollout import build_rollout as jax_build_rollout
from kccotgan_tpu.train.state import GanModules
from kccotgan_tpu_torch.cli.main import main
from kccotgan_tpu_torch.models import discriminator_modules
from kccotgan_tpu_torch.train import build_rollout
from kccotgan_tpu_torch.weights import (
    flatten_flax_tree,
    generator_params_from_jax,
    init_discriminator_params,
    init_generator_params,
)
from tests._torch_port import flax_tree, port_cfg

torch.set_num_threads(1)

CFG = TrainConfig(
    dname="robot_push", batch_size=2, compute_dtype="float32", total_time_steps=4, int_time_steps=2,
    conv_packing="off", time_major=False, kernel_impl="scan",
    model=ModelConfig(x_height=16, x_width=16, n_channels=3, g_filter_size=2, d_filter_size=2,
                      d_state_size=3, z_channels=4, z_height=1, z_width=1, use_norm=True),
)


@pytest.fixture(scope="module")
def jax_side():
    """Seeded weights at three channels as JAX's flax trees (numpy), a
    video, and JAX's rollout of its context and both discriminators'
    training-mode forward on it.  The weights are drawn by the port's
    initialiser and handed to JAX as trees (``flax_tree``), which the port
    reads back through ``weights.py``; JAX's own initialisers would only
    add their compilation."""
    mods = GanModules(CFG)
    cfg, m = port_cfg(CFG), CFG.model
    gen = init_generator_params(cfg, torch.Generator().manual_seed(0))
    disc = init_discriminator_params(cfg, torch.Generator().manual_seed(1))
    enc_p, dec_p = flax_tree(gen["encoder"]), flax_tree(gen["decoder"])
    video = np.random.default_rng(7).uniform(
        size=(CFG.batch_size, m.x_height, CFG.total_time_steps, m.x_width, 3)).astype(np.float32)
    context = video[:, :, : CFG.int_time_steps]
    key = jax.random.PRNGKey(11)
    state = collections.namedtuple("State", "enc_params dec_params")(enc_p, dec_p)
    rollout = np.asarray(jax.jit(jax_build_rollout(CFG, mods, jit=False))(state, jnp.asarray(context), key))
    z_shape = (CFG.batch_size, 1, m.z_height, m.z_width, m.z_channels)
    z = np.stack([np.asarray(jax.random.normal(k, z_shape, jnp.float32))
                  for k in jax.random.split(key, CFG.pred_time_steps)])
    # disc_h and disc_m are one architecture: one compiled forward for both
    forward = jax.jit(lambda v: mods.disc_h.apply(v, video, training=True, mutable=["batch_stats"])[0])
    discs = []
    for name in ("h", "m"):
        variables = {"params": flax_tree(disc[name]), "batch_stats": flax_tree(disc[f"{name}_stats"])}
        discs.append((variables, np.asarray(forward(variables))))
    return types.SimpleNamespace(enc_p=enc_p, dec_p=dec_p, video=video, context=context, rollout=rollout,
                                 z=z, discs=discs)


def test_rgb_rollout_matches_jax(jax_side):
    rollout = build_rollout(port_cfg(CFG), device="cpu")
    got = rollout(generator_params_from_jax(jax_side.enc_p, jax_side.dec_p), torch.tensor(jax_side.context),
                  z=torch.tensor(jax_side.z))
    assert tuple(got.shape) == jax_side.rollout.shape == (2, 16, 4, 16, 3)
    assert torch.equal(got[:, :, :2], torch.tensor(jax_side.context))
    np.testing.assert_allclose(got.numpy(), jax_side.rollout, rtol=0, atol=1e-4)


@pytest.mark.parametrize("which", [0, 1], ids=["h", "m"])
def test_rgb_discriminators_match_jax(jax_side, which):
    variables, want = jax_side.discs[which]
    d = discriminator_modules(port_cfg(CFG))[which]
    d.load_state_dict(flatten_flax_tree(variables["params"]))
    assert tuple(d.state_dict()["conv1.kernel"].shape)[2] == 3
    with torch.no_grad():
        got, _ = d(torch.tensor(jax_side.video), flatten_flax_tree(variables["batch_stats"]))
    assert tuple(got.shape) == want.shape == (2, 4, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def write_bair(root, seed=0):
    """Four train and two test videos of 30 raw 64x64x3 frames."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", 4), ("test", 2)):
        recs = []
        for _ in range(n):
            frames = rng.integers(0, 256, (30, 64, 64, 3), dtype=np.uint8)
            recs.append(encode_sequence_example({f"{i}/image_aux1/encoded": [frames[i].tobytes()]
                                                 for i in range(30)}))
        write_tfrecord(str(root / "softmotion30_44k" / split / "shard0.tfrecord"), recs)


@pytest.mark.parametrize("kernel_impl", ["scan", "pallas"])
def test_cli_trains_robot_push(tmp_path, capsys, kernel_impl):
    write_bair(tmp_path / "data")
    rc = main(["--preset", "robot_push", "--dname", "robot_push", "--data_path", str(tmp_path / "data"),
               "-bs", "2", "-tts", "3", "-its", "2", "-sinkl", "3", "-gfs", "1", "-dfs", "1", "-dss", "2",
               "-nz", "2", "-ne", "1", "--kernel_impl", kernel_impl, "--max_steps", "2", "--ckpt_freq", "2",
               "--out_dir", str(tmp_path / "runs"), "--run_name", "bair"], device="cpu")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["status"] == "completed" and summary["steps"] == 2
    logged = {}
    with open(tmp_path / "runs" / "bair" / "log" / "metrics.jsonl") as f:
        for line in f:
            r = json.loads(line)
            logged.setdefault(r["tag"], {})[r["step"]] = r["value"]
    assert sorted(logged["Sinkhorn Loss"]) == [1, 2]
    assert all(np.isfinite(list(logged["Sinkhorn Loss"].values())))
    for tag in ("eval/psnr", "eval/ssim"):  # the sample at step 1, on the test batch
        assert 1 in logged[tag] and np.isfinite(logged[tag][1])


def test_rgb_rollout_hands_the_kernels_contiguous_stacks(jax_side, monkeypatch):
    """The ConvLSTM kernels take C-contiguous stacks.  A generated RGB
    frame reaches the encoder in the decoder's NCHW strides (at one
    channel those are NHWC's too), and the hoisted conv of such a frame
    comes back NCHW-strided: every ConvLSTM must hand its kernel wrapper
    contiguous tensors all the same.  On the CPU the wrapper runs the
    plain version, which does not care, so the wrapper is watched here."""
    from kccotgan_tpu_torch.models import layers

    wrapper = layers.convlstm_scan
    seen = []

    def watched(*args):
        seen.append([a.is_contiguous() for a in args if isinstance(a, torch.Tensor)])
        return wrapper(*args)

    monkeypatch.setattr(layers, "convlstm_scan", watched)
    rollout = build_rollout(port_cfg(CFG), device="cpu")
    rollout(generator_params_from_jax(jax_side.enc_p, jax_side.dec_p), torch.tensor(jax_side.context),
            z=torch.tensor(jax_side.z))
    assert len(seen) == 4 + 8 * CFG.pred_time_steps
    assert all(all(s) for s in seen), seen
