"""The port's training iteration under ``kernel_impl='pallas'`` vs the JAX
package's ``build_train_step`` under ``'pallas'``, at the tiny geometry of
``tests/test_train.py``, f32.

JAX is built in the layout whose ``'pallas'`` the port mirrors:
``time_major=False, conv_packing='off'`` (under its defaults the
generator's ConvLSTMs would fall back to the scan).  Its step is compiled
once, with ``convlstm_scan_pallas`` and ``lstm_scan_pallas`` wrapped to
count the layers that trace them and the fallback notices recorded, so
the tests can show that JAX took its Pallas kernels (interpret mode on
the CPU) at every recurrence.  The port runs ``ConvLstmScan`` and
``LstmScan``, whose forward and backward on CPU tensors are the kernels'
plain versions.  Tolerances as ``tests/test_torch_train.py`` argues them
(``_torch_port.assert_iterations_match``).
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu.models import layers as jax_layers
from kccotgan_tpu.models import pallas_convlstm, pallas_lstm
from kccotgan_tpu.train import GanModules
from kccotgan_tpu.train import build_train_step as jax_build_train_step
from kccotgan_tpu.train import create_train_state as jax_create_train_state
from kccotgan_tpu_torch.models import cuda_convlstm, cuda_lstm
from kccotgan_tpu_torch.train import build_train_step
from kccotgan_tpu_torch.weights import train_state_from_jax
from tests._torch_port import assert_iterations_match, port_cfg, tiny_train_cfg

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture(scope="module")
def jax_pallas():
    """Two iterations of JAX's 'pallas' step, f32, from its own state; the
    z each phase drew; the Pallas recurrences traced; the fallback
    notices logged while tracing."""
    cfg = dataclasses.replace(tiny_train_cfg(), kernel_impl="pallas")
    traced = {"convlstm": 0, "lstm": 0}
    records = _Records()
    logger = logging.getLogger(jax_layers.__name__)

    def counting(name, fn):
        def wrapped(*args, **kw):
            traced[name] += 1
            return fn(*args, **kw)
        return wrapped

    # the parameter trees do not depend on the engine: init under 'scan'
    state = jax.jit(lambda k: jax_create_train_state(tiny_train_cfg(), k))(jax.random.PRNGKey(0))
    video = np.random.default_rng(3).uniform(size=(2, 16, 5, 16, 1)).astype(np.float32)
    m = cfg.model
    z_shape = (2, cfg.pred_time_steps, m.z_height, m.z_width, m.z_channels)
    out = {"state": _np(state), "video": video, "runs": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "_PALLAS_FALLBACK_WARNED", set())
        mp.setattr(pallas_convlstm, "convlstm_scan_pallas",
                   counting("convlstm", pallas_convlstm.convlstm_scan_pallas))
        mp.setattr(pallas_lstm, "lstm_scan_pallas", counting("lstm", pallas_lstm.lstm_scan_pallas))
        logger.addHandler(records)
        try:
            step = jax_build_train_step(cfg, GanModules(cfg), jit=True, donate=False)
            s = state
            for _ in range(2):
                _, k_disc, k_gen = jax.random.split(s.rng, 3)
                z = tuple(np.asarray(jax.random.normal(k, z_shape, jnp.float32)) for k in (k_disc, k_gen))
                s, metrics = step(s, jnp.asarray(video))
                out["runs"].append((z, _np(metrics), _np(s)))
        finally:
            logger.removeHandler(records)
    out["traced"], out["fallbacks"] = traced, records.messages
    return out


def _port_run(jax_pallas, **overrides):
    cfg = dataclasses.replace(port_cfg(tiny_train_cfg()), kernel_impl="pallas", **overrides)
    tstep = build_train_step(cfg, device="cpu")
    state, runs = train_state_from_jax(jax_pallas["state"]), []
    for z, _, _ in jax_pallas["runs"]:
        state, metrics = tstep(state, torch.tensor(jax_pallas["video"]), z=tuple(map(torch.tensor, z)))
        runs.append((metrics, state))
    return runs


def test_jax_took_its_pallas_kernels(jax_pallas):
    """The step traced both Pallas recurrences, and no layer fell back to
    the scan (each layer that does logs a notice once)."""
    assert not [m for m in jax_pallas["fallbacks"] if "falls back" in m], jax_pallas["fallbacks"]
    assert jax_pallas["traced"]["convlstm"] > 0 and jax_pallas["traced"]["lstm"] > 0


def test_pallas_train_step_matches_jax_f32(jax_pallas):
    runs = _port_run(jax_pallas)
    want = [(z, m, train_state_from_jax(s)) for z, m, s in jax_pallas["runs"]]
    assert_iterations_match(runs, want, train_state_from_jax(jax_pallas["state"]))


def test_pallas_step_runs_the_plain_versions_on_cpu(jax_pallas, monkeypatch):
    """On the CPU the 'pallas' step builds and runs every recurrence's
    plain forward and backward (8 ConvLSTM and 18 LSTM backward calls an
    iteration), and launches nothing."""
    calls = {"convlstm": 0, "lstm": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(cuda_convlstm, "convlstm_bwd_reference",
                        counting("convlstm", cuda_convlstm.convlstm_bwd_reference))
    monkeypatch.setattr(cuda_lstm, "lstm_bwd_reference", counting("lstm", cuda_lstm.lstm_bwd_reference))
    counters = [fn.launches for fn in (cuda_convlstm.convlstm_fwd, cuda_convlstm.convlstm_bwd,
                                       cuda_lstm.lstm_fwd, cuda_lstm.lstm_bwd)]
    (metrics, state), = _port_run({**jax_pallas, "runs": jax_pallas["runs"][:1]})
    assert calls == {"convlstm": 8, "lstm": 18}
    assert counters == [fn.launches for fn in (cuda_convlstm.convlstm_fwd, cuda_convlstm.convlstm_bwd,
                                               cuda_lstm.lstm_fwd, cuda_lstm.lstm_bwd)]
    assert state.step == 1 and torch.isfinite(metrics["sinkhorn_loss"])
