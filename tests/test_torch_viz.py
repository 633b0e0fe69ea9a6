"""The port's ``utils/viz.py`` against ``kccotgan_tpu.utils.viz``: the
sample grid equal, the GIF frames decoded by PIL equal, the PNGs of
``display_frames`` and ``save_low_d`` equal pixel for pixel, and
``samples_to_video`` an HTML animation.  Both run the same numpy and
matplotlib code, so nothing may differ."""

import numpy as np
import pytest
from PIL import Image, ImageSequence

from kccotgan_tpu.utils import viz as jax_viz
from kccotgan_tpu_torch.utils import viz

NX, NY, T, H, W = 2, 3, 4, 8, 8


def _samples(seed, channels=1):
    return np.random.default_rng(seed).uniform(size=(NX * NY, H, T * W, channels)).astype(np.float32)


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_video_grid_equals_jax(channels):
    s = _samples(channels, channels)
    got = viz.video_grid(s, NX, NY, time_steps=T, x_height=H, x_width=W)
    want = jax_viz.video_grid(s, NX, NY, time_steps=T, x_height=H, x_width=W)
    assert got.shape == (T, NX * H, NY * W, min(channels, 3))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3])
def test_gif_frames_equal_jax(tmp_path, channels):
    s = _samples(10 + channels, channels)
    frames = {}
    for name, mod in (("port", viz), ("jax", jax_viz)):
        path = mod.save_video_gif(s, str(tmp_path / name / "v.gif"), NX, NY, time_steps=T, x_height=H,
                                  x_width=W, fps=5)
        with Image.open(path) as im:
            frames[name] = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
            assert im.info["duration"] == 200
    assert len(frames["port"]) == T
    for got, want in zip(frames["port"], frames["jax"], strict=True):
        np.testing.assert_array_equal(got, want)


def test_display_frames_png_equals_jax(tmp_path):
    x = np.random.default_rng(3).uniform(size=(6, H, T, W, 1)).astype(np.float32)
    got = viz.display_frames(x, str(tmp_path / "port.png"), rows=3, seed=0)
    want = jax_viz.display_frames(x, str(tmp_path / "jax.png"), rows=3, seed=0)
    np.testing.assert_array_equal(_pixels(got), _pixels(want))


def test_save_low_d_png_equals_jax(tmp_path):
    data = np.random.default_rng(4).normal(size=(16, 30, 1)).astype(np.float32)
    got = viz.save_low_d(data, str(tmp_path / "port.png"), input_len=10)
    want = jax_viz.save_low_d(data, str(tmp_path / "jax.png"), input_len=10)
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
    with pytest.raises(ValueError, match="need 16 series"):
        viz.save_low_d(data[:4], str(tmp_path / "few.png"))


def test_samples_to_video_returns_html():
    html = viz.samples_to_video(_samples(5), NX, NY, time_steps=T, x_height=H, x_width=W)
    assert isinstance(html, str) and "<script" in html and "animation" in html.lower()
