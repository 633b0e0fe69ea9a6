"""``fused_discriminators=True`` in the PyTorch port, on the CPU.

The port runs the four discriminator passes as ``torch.func.vmap`` of one
discriminator over parameters stacked ``[h, h, m, m]`` and videos
``[fake, real, real, fake]`` (``train/steps.py::fused_discriminators``),
the LSTM recurrences through ``LstmScan``'s ``vmap`` rule with a leading
instance axis.  Held here, at the tiny geometry of ``tests/test_train.py``
(B=2, 16x16x1, T=5 with 3 context, d_filter_size 2, state 3, L=10), from
the port's seeded state carried to JAX by ``flax_tree``:

* the fused ``gan_forward`` against JAX's fused ``gan_forward``
  (``jax.vmap`` over the discriminator; under ``'pallas'`` through the
  batching rule of the Pallas LSTM kernels, interpret mode) under
  ``jax.value_and_grad`` in ``m_params``, as JAX's own
  ``test_fused_discriminators_exact`` holds JAX's fused pass against its
  sequential one: loss and pM at rtol 1e-5; ``h_stats``, ``m_stats`` and
  the ``m_params`` gradient at rtol 1e-4 / atol 1e-5.  JAX's generator
  runs its ``lax.scan`` under both engines (the discriminators are what
  this file pins; the generator's engines are pinned in
  ``tests/test_torch_train_pallas.py``), and JAX is compiled without
  LLVM's optimizations (``_torch_port.compile_o0``);
* the port's fused pass against its own sequential pass under both
  engines, with and without BatchNorm, to the same tolerances;
* the instanced LSTM (``LstmScan`` under ``torch.func.vmap``, and the
  plain versions with the instance axis) against per-instance calls, to
  the bit;
* two ``build_train_step`` iterations with ``fused_discriminators=True``
  under each engine: finite, the statistics chains advanced, and under
  ``'pallas'`` every LSTM recurrence one call with four instances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from kccotgan_tpu.models import pallas_lstm
from kccotgan_tpu.train import GanModules as JaxGanModules
from kccotgan_tpu.train.steps import gan_forward as jax_gan_forward
from kccotgan_tpu_torch.models import cuda_lstm
from kccotgan_tpu_torch.models.cuda_lstm import (
    LstmScan,
    lstm_bwd_reference,
    lstm_scan,
    lstm_scan_reference,
)
from kccotgan_tpu_torch.train import build_train_step, create_train_state
from kccotgan_tpu_torch.train.steps import GanModules, gan_forward
from kccotgan_tpu_torch.weights import flatten_flax_tree
from tests._torch_port import compile_o0, flax_tree, port_cfg, tiny_train_cfg

torch.set_num_threads(1)
ENGINES = ("scan", "pallas")


def _cfg(engine, fused=True, use_norm=True):
    cfg = tiny_train_cfg()
    return dataclasses.replace(cfg, kernel_impl=engine, fused_discriminators=fused,
                               model=dataclasses.replace(cfg.model, use_norm=use_norm))


@pytest.fixture(scope="module")
def start():
    """The port's seeded states with and without norms (keyed by
    ``use_norm``), a video and z (numpy)."""
    states = {norm: create_train_state(port_cfg(_cfg("scan", use_norm=norm)), torch.Generator().manual_seed(0),
                                       device="cpu") for norm in (True, False)}
    rng = np.random.default_rng(5)
    video = rng.uniform(size=(2, 16, 5, 16, 1)).astype(np.float32)
    z = rng.normal(size=(2, 2, 1, 1, 4)).astype(np.float32)
    return states, video, z


def _port_forward(cfg, start):
    """The port's ``gan_forward``: ``(loss, pm, h_stats, m_stats, m_params
    gradient of loss + pm)``, as numpy."""
    states, video, z = start
    st, pcfg = states[cfg.model.use_norm], port_cfg(cfg)
    m_p = {k: v.clone().requires_grad_() for k, v in st.m_params.items()}
    loss, pm, hs, ms = gan_forward(GanModules(pcfg), pcfg, st.enc_params, st.dec_params, st.h_params, m_p,
                                   st.h_stats, st.m_stats, torch.from_numpy(video), torch.from_numpy(z),
                                   pcfg.init_sigma)
    grads = torch.autograd.grad(loss + pm, list(m_p.values()))
    numpy = lambda d: {k: v.detach().numpy() for k, v in d.items()}  # noqa: E731
    return loss.item(), pm.item(), numpy(hs), numpy(ms), {k: g.numpy() for k, g in zip(m_p, grads)}


def _jax_forward(cfg, start):
    """JAX's fused ``gan_forward`` on the same state, as ``_port_forward``,
    and the count of layers that traced the Pallas LSTM."""
    states, video, z = start
    st, mods = states[True], JaxGanModules(cfg)
    lstm, traced = pallas_lstm.lstm_scan_pallas, [0]

    def counted(*args, **kw):
        traced[0] += 1
        return lstm(*args, **kw)

    mods.encoder, mods.decoder = JaxGanModules(tiny_train_cfg()).encoder, JaxGanModules(tiny_train_cfg()).decoder
    enc, dec, h_p, m_p, h_s, m_s = (flax_tree(getattr(st, n)) for n in (
        "enc_params", "dec_params", "h_params", "m_params", "h_stats", "m_stats"))

    def fwd(m_params):
        loss, pm, hs, ms = jax_gan_forward(mods, cfg, enc, dec, h_p, m_params, h_s, m_s, jnp.asarray(video),
                                           jnp.asarray(z), jnp.float32(cfg.init_sigma))
        return loss + pm, (loss, pm, hs, ms)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_lstm, "lstm_scan_pallas", counted)
        (_, (loss, pm, hs, ms)), g = compile_o0(jax.value_and_grad(fwd, has_aux=True), m_p)(m_p)
    flat = lambda t: flatten_flax_tree(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    return (float(loss), float(pm), flat(hs), flat(ms), flat(g)), traced[0]


def _assert_match(got, want):
    for i, name in enumerate(("loss", "pm")):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, err_msg=name)
    for i, name in zip((2, 3, 4), ("h_stats", "m_stats", "m_grad")):
        g, w = got[i], want[i]
        assert g.keys() == w.keys(), name
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("engine", ENGINES)
def test_fused_gan_forward_matches_jax(start, engine):
    """Under 'pallas' JAX's vmap reaches its Pallas LSTM (lstm1 and lstm2;
    lstm3's sigmoid output takes the scan there)."""
    want, traced = _jax_forward(_cfg(engine), start)
    _assert_match(_port_forward(_cfg(engine), start), want)
    assert (traced > 0) == (engine == "pallas")


@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("engine", ENGINES)
def test_fused_matches_sequential(start, engine, use_norm):
    """With BatchNorm the chain rebuilt from the four instances; without,
    no statistics at all on either path."""
    fused = _port_forward(_cfg(engine, True, use_norm), start)
    _assert_match(fused, _port_forward(_cfg(engine, False, use_norm), start))
    assert bool(fused[2]) == use_norm


def _lstm_inputs(dtype, n=4, b=3, t=5, u=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    xproj = torch.randn(n, b, t, 4 * u, generator=g).to(dtype)
    rest = [torch.randn(*s, generator=g) * 0.5 for s in ((n, b, u), (n, b, u), (n, u, 4 * u), (n, 4 * u))]
    return [xproj, *rest]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["tanh", "sigmoid"])
def test_instanced_lstm_matches_per_instance_calls(act, dtype):
    """The plain versions with the instance axis, and ``LstmScan`` under
    ``vmap`` (forward and every gradient), equal per-instance calls to the
    bit."""
    args = _lstm_inputs(dtype, seed=len(act))
    n = args[0].shape[0]
    per = [lstm_scan_reference(*(a[i] for a in args), act) for i in range(n)]
    for got, want in zip(lstm_scan_reference(*args, act), zip(*per)):
        torch.testing.assert_close(got, torch.stack(want), rtol=0, atol=0)
    y, cs = torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per])
    g = torch.Generator().manual_seed(9)
    cot = [torch.randn(y.shape, generator=g).to(dtype), torch.randn(args[1].shape, generator=g),
           torch.randn(args[1].shape, generator=g)]
    per_bwd = [lstm_bwd_reference(*(a[i] for a in (*args, y, cs, *cot)), act) for i in range(n)]
    for got, want in zip(lstm_bwd_reference(*args, y, cs, *cot, act), zip(*per_bwd)):
        torch.testing.assert_close(got, torch.stack(want), rtol=0, atol=0)

    def grads(outs, leaves):
        return torch.autograd.grad(outs, leaves, cot)

    leaves = [a.clone().requires_grad_() for a in args]
    outs = vmap(lambda *a: lstm_scan(*a, act))(*leaves)
    got = (outs[0], *outs[1], *grads((outs[0], *outs[1]), leaves))
    leaves = [a.clone().requires_grad_() for a in args]
    outs = [LstmScan.apply(*(a[i] for a in leaves), act) for i in range(n)]
    outs = [torch.stack(o) for o in zip(*outs)]
    want = (*outs, *grads(outs, leaves))
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, rtol=0, atol=0)


@pytest.mark.parametrize("engine", ENGINES)
def test_fused_step_trains(engine, monkeypatch):
    """Two iterations: finite losses, parameters and statistics, the
    chains advanced at each; under 'pallas' each LSTM layer's forward and
    backward is one plain call with four instances a phase (6 + 6 an
    iteration, the 24 + 18 of the sequential passes)."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, fn):
        def wrapped(xproj, *args, **kw):
            calls[name] += xproj.dim() == 4 and xproj.shape[0] == 4
            return fn(xproj, *args, **kw)
        return wrapped

    monkeypatch.setattr(cuda_lstm, "lstm_scan_reference", counted("fwd", lstm_scan_reference))
    monkeypatch.setattr(cuda_lstm, "lstm_bwd_reference", counted("bwd", lstm_bwd_reference))
    cfg = port_cfg(_cfg(engine))
    state = create_train_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    video = torch.rand(2, 16, 5, 16, 1, generator=torch.Generator().manual_seed(2))
    step = build_train_step(cfg, device="cpu")
    s = state
    for i in range(2):
        prev = s
        s, metrics = step(s, video)
        assert all(bool(torch.isfinite(metrics[k])) for k in ("sinkhorn_loss", "pm"))
        for tree in ("h_params", "m_params", "h_stats", "m_stats"):
            assert all(bool(torch.isfinite(v).all()) for v in getattr(s, tree).values()), tree
        for tree in ("h_stats", "m_stats"):
            old, new = getattr(prev, tree), getattr(s, tree)
            assert new.keys() == old.keys() and len(new) == 10
            assert all(float((new[k] - old[k]).abs().max()) > 0 for k in new), (i, tree)
        assert s.step == i + 1
    assert calls == ({"fwd": 12, "bwd": 12} if engine == "pallas" else {"fwd": 0, "bwd": 0})
