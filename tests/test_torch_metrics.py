"""The PyTorch port's PSNR, SSIM and ``video_metrics`` vs the JAX
package's ``kccotgan_tpu.eval``, on the CPU, on seeded film-strips
``[2, 16, 4, 16, C]``.

Tolerance: 1e-5 relative.  Both compute in float32 and only the order of
the blur's sums differs (XLA's convolution against PyTorch's), a few
ulps of each blurred moment; SSIM's E[x^2] - E[x]^2 cancels part of the
signal, which magnifies those ulps about tenfold on these videos, still
far inside 1e-5.  The inverted pair (target = 1 - pred) gives SSIM near
-1, the other end of the clip's range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu import eval as jax_eval
from kccotgan_tpu_torch import eval as port_eval

torch.set_num_threads(1)

RTOL = 1e-5


def videos(kind, channels):
    rng = np.random.default_rng(0 if kind == "noisy" else 1)
    shape = (2, 16, 4, 16, channels)
    target = rng.uniform(size=shape)
    if kind == "noisy":
        pred = np.clip(target + 0.1 * rng.standard_normal(shape), 0.0, 1.0)
    else:
        pred = 1.0 - target
    return pred.astype(np.float32), target.astype(np.float32)


@pytest.mark.parametrize("kind", ["noisy", "inverted"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name", ["psnr", "ssim"])
def test_metric_matches_jax(name, kind, channels):
    pred, target = videos(kind, channels)
    got = getattr(port_eval, name)(torch.from_numpy(pred), torch.from_numpy(target))
    want = np.asarray(getattr(jax_eval, name)(jnp.asarray(pred), jnp.asarray(target)))
    assert tuple(got.shape) == want.shape == (2, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    if name == "ssim":
        assert float(got.abs().max()) <= 1.0
        assert (float(got.max()) < -0.5) == (kind == "inverted")


def test_video_metrics_matches_jax():
    pred, target = videos("noisy", 1)
    got = port_eval.video_metrics(torch.from_numpy(pred), torch.from_numpy(target))
    want = jax_eval.video_metrics(jnp.asarray(pred), jnp.asarray(target))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=0, err_msg=k)


def test_psnr_of_a_known_error():
    target = torch.zeros(1, 4, 2, 4, 1)
    pred = torch.full_like(target, 0.1)  # MSE 0.01: 20 dB
    np.testing.assert_allclose(port_eval.psnr(pred, target).numpy(), np.full((1, 2), 20.0), rtol=1e-6)
