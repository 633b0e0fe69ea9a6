"""The port's serving path on the CPU: best-of-K, the graph rollout's CPU
split, ``cli.sample`` and the trainer's ``--profile_steps`` window.

``best_of_k`` is held against ``kccotgan_tpu.eval.best_of_k`` at rtol
1e-5: on the same K videos (a stub rollout that pops precomputed
videos), with a rollout shorter than the truth and a tie of per-sample
means, where both compute the same float32 metrics of the same inputs,
the port's SSIM blur in another summation order (``test_torch_metrics.py``
holds the metrics alone at 1e-5); and through both packages' real f32
rollouts on the port's seeded weights with JAX's noise handed to the
port (as ``tests/test_torch_rollout.py`` does), whose videos differ by
the rollouts' few-ulp differences (1.8e-7 relative on the metrics
measured).  The CLI is pinned to the port's own ``best_of_k``.  The
geometry is ``test_torch_loop.py``'s (B=2, 16x16, g_filter_size 2) with 3 + 2 frames.
"""

import collections
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu.config import ModelConfig as JaxModelConfig
from kccotgan_tpu.config import TrainConfig as JaxTrainConfig
from kccotgan_tpu.eval import best_of_k as jax_best_of_k
from kccotgan_tpu.train.rollout import build_rollout as jax_build_rollout
from kccotgan_tpu.train.state import GanModules
from kccotgan_tpu_torch import config as port_config
from kccotgan_tpu_torch.ckpt import restore_checkpoint, save_checkpoint
from kccotgan_tpu_torch.cli import sample
from kccotgan_tpu_torch.cli.main import main as train_main
from kccotgan_tpu_torch.data import make_dataset
from kccotgan_tpu_torch.eval import best_of_k
from kccotgan_tpu_torch.train import build_rollout, create_train_state
from kccotgan_tpu_torch.train.rollout import draw_noise, graph_rollout
from tests._torch_port import flax_tree, port_cfg

torch.set_num_threads(1)

JAX_CFG = JaxTrainConfig(
    dname="synthetic", batch_size=2, compute_dtype="float32", total_time_steps=5, int_time_steps=3,
    sinkhorn_l=3, conv_packing="off", time_major=False, kernel_impl="scan",
    model=JaxModelConfig(x_height=16, x_width=16, g_filter_size=2, d_filter_size=1, d_state_size=2,
                         z_channels=2, z_height=1, z_width=1),
)
CFG = port_cfg(JAX_CFG)
TC = CFG.int_time_steps


@pytest.fixture(scope="module")
def model():
    """The seeded state's generator and a test batch of 5 uniform frames
    (``test_torch_metrics.py``'s videos: on mostly blank frames such as
    the bouncing blobs, SSIM's cancellation magnifies the two packages'
    summation orders past 1e-5)."""
    state = create_train_state(CFG, device="cpu")
    params = {"encoder": state.enc_params, "decoder": state.dec_params}
    batch = np.random.default_rng(4).uniform(size=(2, 16, 5, 16, 1)).astype(np.float32)
    return state, params, batch


def _videos(batch, k, t_out, seed):
    """K noisy copies of the batch's first ``t_out`` frames, each sample
    with its own noise level, so that the best rollout differs by sample
    and SSIM stays far from 0 (where its relative error has no floor)."""
    rng = np.random.default_rng(seed)
    truth = batch[:, :, :t_out]
    return [
        np.clip(truth + rng.uniform(0.02, 0.3, size=(2, 1, 1, 1, 1)) * rng.standard_normal(truth.shape), 0, 1)
        .astype(np.float32)
        for _ in range(k)
    ]


def _both(jax_videos, port_videos, batch, k):
    jax_list, port_list = list(jax_videos), list(port_videos)
    want = jax_best_of_k(lambda s, c, key: jax_list.pop(0), None, jnp.asarray(batch), TC,
                         jax.random.PRNGKey(0), k=k)
    got = best_of_k(lambda p, c, g: port_list.pop(0), None, torch.from_numpy(batch), TC, None, k=k)
    assert not jax_list and not port_list
    return got, want


def _assert_metrics(got, want, rtol):
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=rtol, atol=0, err_msg=key)


@pytest.mark.parametrize("k,t_out", [(1, 5), (3, 5), (3, 4)], ids=["k1", "k3", "k3_short_rollout"])
def test_best_of_k_matches_jax_on_the_same_videos(model, k, t_out):
    """The same K videos scored by both; ``t_out = 4`` rolls out one frame
    fewer than the 5-frame truth, so both score the common 1-frame
    horizon."""
    batch = model[2]
    videos = _videos(batch, k, t_out, seed=k + t_out)
    got, want = _both(videos, [torch.from_numpy(v) for v in videos], batch, k)
    assert got["psnr_per_step"].shape == (t_out - TC,)
    _assert_metrics(got, want, 1e-5)


def test_best_of_k_keeps_the_first_of_a_tie():
    """Two rollouts whose sample 0 ties on mean PSNR with other per-step
    curves: the second carries the first's two frame errors swapped, on
    8-bit values, so each frame's squared errors and their sums are the
    same floats.  Sample 1 is the same in both.  A strict ``>`` keeps the
    first rollout's curve, as JAX does; ``>=`` would take the second's."""
    rng = np.random.default_rng(12)
    batch = (np.round(rng.uniform(size=(2, 16, 5, 16, 1)) * 255) / 256).astype(np.float32)
    err = (rng.integers(-16, 17, size=(2, 16, 2, 16, 1)) / 256).astype(np.float32)
    first = batch.copy()
    first[:, :, TC:] += err
    second = first.copy()
    second[0, :, TC:] = batch[0, :, TC:] + err[0, :, ::-1]
    port = [torch.from_numpy(v) for v in (first, second)]
    got, want = _both([first, second], port, batch, 2)
    _assert_metrics(got, want, 1e-5)
    alone_first, _ = _both([first], port[:1], batch, 1)
    alone_second, _ = _both([second], port[1:], batch, 1)
    assert float(alone_first["psnr"]) == float(alone_second["psnr"])
    assert not torch.equal(alone_first["psnr_per_step"], alone_second["psnr_per_step"])
    assert torch.equal(got["psnr_per_step"], alone_first["psnr_per_step"])


def test_best_of_k_through_the_real_rollouts_matches_jax(model):
    """K = 3 rollouts of both packages on the port's seeded weights; the
    truth's future is JAX's first rollout plus noise, so the metrics sit
    where a trained model's would (PSNR ~25 dB, SSIM near 1)."""
    state, params, batch = model
    jax_state = collections.namedtuple("State", "enc_params dec_params")(
        flax_tree(state.enc_params), flax_tree(state.dec_params))
    rng, k = jax.random.PRNGKey(5), 3
    jax_rollout = jax_build_rollout(JAX_CFG, GanModules(JAX_CFG))
    first = np.asarray(jax_rollout(jax_state, jnp.asarray(batch[:, :, :TC]), jax.random.split(rng, k)[0]))
    noise = 0.05 * np.random.default_rng(6).standard_normal(first[:, :, TC:].shape)
    batch = np.concatenate([batch[:, :, :TC], np.clip(first[:, :, TC:] + noise, 0, 1)], axis=2).astype(np.float32)
    want = jax_best_of_k(jax_rollout, jax_state, jnp.asarray(batch), TC, rng, k=k)
    m = JAX_CFG.model
    zs = []
    for key in jax.random.split(rng, k):  # each rollout's noise as JAX draws it
        z_shape = (2, 1, m.z_height, m.z_width, m.z_channels)
        zs.append(torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(kk, z_shape, jnp.float32))
            for kk in jax.random.split(key, JAX_CFG.pred_time_steps)
        ])))
    port_rollout = build_rollout(CFG, device="cpu")
    got = best_of_k(lambda p, c, g: port_rollout(p, c, z=zs.pop(0)), params, torch.from_numpy(batch), TC,
                    None, k=k)
    _assert_metrics(got, want, 1e-5)


def test_best_of_k_draws_each_rollout_from_one_generator(model):
    """K rollouts from one generator in sequence: the K videos of K
    rollouts drawn one after another from the same seed."""
    _, params, batch = model
    rollout = build_rollout(CFG, device="cpu")
    g = torch.Generator().manual_seed(3)
    videos = [rollout(params, torch.from_numpy(batch[:, :, :TC]), g) for _ in range(2)]
    got = best_of_k(rollout, params, torch.from_numpy(batch), TC, torch.Generator().manual_seed(3), k=2)
    want = best_of_k(lambda p, c, gen: videos.pop(0), params, torch.from_numpy(batch), TC, None, k=2)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_rollout_noise_is_draw_noise(model):
    """The rollout given a generator equals the rollout given
    ``draw_noise`` from a generator of the same seed, which is the noise
    the graph rollout and the artifact draw outside their programs."""
    _, params, batch = model
    rollout = build_rollout(CFG, device="cpu")
    ctx = torch.from_numpy(batch[:, :, :TC])
    z = draw_noise(torch.Generator().manual_seed(9), CFG.pred_time_steps, (2, 1, 1, 1, 2), "cpu")
    assert torch.equal(rollout(params, ctx, torch.Generator().manual_seed(9)), rollout(params, ctx, z=z))


def test_graph_rollout_on_the_cpu_is_the_eager_rollout(model):
    _, params, batch = model
    graphed = graph_rollout(CFG, params, device="cpu")
    ctx = torch.from_numpy(batch[:, :, :TC])
    want = build_rollout(CFG, device="cpu")(params, ctx, torch.Generator().manual_seed(1))
    assert torch.equal(graphed(params, ctx, torch.Generator().manual_seed(1)), want)
    with pytest.raises(ValueError, match="other parameters"):
        graphed(dict(params), ctx, torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def sampled(model, tmp_path_factory):
    """``cli.sample`` on a checkpoint of the seeded state, the synthetic
    data of a throwaway preset holding the tiny config."""
    root = tmp_path_factory.mktemp("sample")
    save_checkpoint(str(root / "ckpt"), model[0])
    port_config.PRESETS["_serving_tiny"] = CFG
    try:
        argv = ["--preset", "_serving_tiny", "--ckpt", str(root / "ckpt"), "--out", str(root / "samples"),
                "--num", "2", "--metrics_k", "2", "--seed", "3"]
        out = io.StringIO()
        with redirect_stdout(out):
            rc = sample.main(argv, device="cpu")
        args = sample.build_parser().parse_args(argv)
        loaded = sample.load(args, "cpu")
    finally:
        port_config.PRESETS.pop("_serving_tiny")
    return root, rc, out.getvalue().splitlines(), loaded


def test_cli_sample_writes_both_images(sampled):
    root, rc, lines, _ = sampled
    assert rc == 0
    for name in ("rollout.gif", "rollout_strips.png"):
        assert (root / "samples" / name).stat().st_size > 0
    assert lines[-1].startswith("wrote ") and lines[-1].endswith("(step 0)")


def test_cli_sample_best_of_k_line_is_best_of_k(sampled):
    """The printed line is ``best_of_k`` on the test batch's first 2
    videos, the noise seeded by --seed + 1, rounded as JAX's CLI."""
    _, _, lines, (cfg, _, _, test_batch) = sampled
    _, want_batch = make_dataset(cfg)
    assert torch.equal(test_batch, torch.from_numpy(want_batch[:2]))
    restored = restore_checkpoint(str(sampled[0] / "ckpt"), CFG, device="cpu")
    params = {"encoder": restored.enc_params, "decoder": restored.dec_params}
    m = best_of_k(build_rollout(CFG, device="cpu"), params, test_batch, TC, torch.Generator().manual_seed(4), k=2)
    line = json.loads(lines[0])
    assert lines[0] == sample.metrics_line(m, 2)
    assert line["best_of_k"] == 2 and len(line["psnr_per_step"]) == CFG.pred_time_steps
    assert np.isfinite(line["psnr"]) and 0 < abs(line["ssim"]) <= 1


def test_cli_main_profile_steps_writes_a_trace(tmp_path, capsys):
    flags = ["--dname", "synthetic", "-bs", "2", "-tts", "3", "-its", "2", "-sinkl", "3", "-xh", "16", "-xw", "16",
             "-gfs", "2", "-dfs", "1", "-dss", "2", "-nz", "2", "-ne", "1", "--max_steps", "3",
             "--profile_steps", "1,2", "--out_dir", str(tmp_path), "--run_name", "prof"]
    assert train_main(flags, device="cpu") == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["status"] == "completed" and summary["steps"] == 3
    traces = list((tmp_path / "prof" / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
