"""Keras dropout in the PyTorch port's ConvLSTMs vs the JAX package's,
and the training step's dropout keys, on the CPU.

JAX draws each mask with ``jax.random.bernoulli``; the port draws from a
mask source.  The tests monkeypatch ``jax.random.bernoulli`` to return a
seeded numpy stream in call order and hand the same stream to the port
(``bernoulli_streams``), so both sides apply the same masks: per
ConvLSTM four input masks, then four recurrent masks, layers in forward
order.  Nothing in the JAX package changes for this.  The encoder and
the decoder with both dropouts are held against JAX inside
``gan_forward`` (``tests/test_torch_smoothing.py``), which shares one
JAX compilation with the smoothing's check.

Both of the port's engines are held against JAX: the plain loop
(``plain=True``) and the kernel engine, whose recurrence takes the
recurrent masks (``ConvLstmScan``: on the CPU the kernels' plain
forward and backward in their masked form).

Tolerances, f32: outputs at 1e-5 abs (``tests/test_torch_convlstm.py``:
the frameworks' conv summation orders); gradients, for one seeded
cotangent, at 1e-5 of each tensor's largest entry.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from kccotgan_tpu.models import layers as jl
from kccotgan_tpu_torch.models import layers
from kccotgan_tpu_torch.models.layers import ConvLSTM2D, bernoulli_source
from kccotgan_tpu_torch.train import build_rollout, build_train_step, create_train_state
from kccotgan_tpu_torch.train.state import dropout_keys, fold_in, split_key
from kccotgan_tpu_torch.weights import flatten_flax_tree, init_generator_params
from tests._torch_port import bernoulli_streams, port_cfg, tiny_train_cfg

torch.set_num_threads(1)


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("p_in,p_rec,stride,bias", [
    (0.3, 0.0, 1, True), (0.0, 0.3, 2, False), (0.3, 0.4, 2, True),
])
def test_convlstm_dropout_matches_jax(p_in, p_rec, stride, bias, monkeypatch):
    rng = np.random.default_rng(int(10 * p_in + 100 * p_rec) + stride)
    b, t, h, w, c, f, k = 2, 3, 8, 8, 3, 4, 3
    x = rng.normal(size=(b, t, h, w, c)).astype(np.float32)
    mod = jl.ConvLSTM2D(filters=f, kernel_size=(k, k), strides=(stride, stride), use_bias=bias,
                        dropout=p_in, recurrent_dropout=p_rec)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x), training=False)["params"]
    jax_bernoulli, port_draw = bernoulli_streams(3)
    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)

    ho = -(-h // stride)
    ct = rng.normal(size=(b, t, ho, ho, f)).astype(np.float32)

    def fwd_bwd(p, xx, cot):
        out, vjp = jax.vjp(
            lambda pp, xxx: mod.apply({"params": pp}, xxx, training=True, rngs={"dropout": jax.random.PRNGKey(2)}),
            p, xx,
        )
        return out, vjp(cot)

    # Compiled without LLVM's optimizations, as test_torch_smoothing.py's
    # gan_forward check: the arithmetic differs from the optimized build by ulps.
    inputs = (params, jnp.asarray(x), jnp.asarray(ct))
    want, (want_dp, want_dx) = jax.jit(fwd_bwd).lower(*inputs).compile(
        {"xla_backend_optimization_level": 0})(*inputs)
    want_dp = flatten_flax_tree(jax.tree_util.tree_map(np.asarray, want_dp))

    masks = []  # the stream, recorded by the first engine and replayed to the second

    def record(keep, shape):
        masks.append(port_draw(keep, shape))
        return masks[-1]

    replay = iter(masks)
    for plain, draw in ((True, record), (False, lambda keep, shape: next(replay))):
        port = ConvLSTM2D(c, f, (k, k), strides=(stride, stride), use_bias=bias, dropout=p_in,
                          recurrent_dropout=p_rec, plain=plain)
        pp = {n: v.clone().requires_grad_() for n, v in flatten_flax_tree(
            jax.tree_util.tree_map(np.asarray, params)).items()}
        xt = torch.from_numpy(x).requires_grad_()
        got, _ = functional_call(port, pp, (xt,), {"training": True, "masks": draw})
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
        grads = torch.autograd.grad(got, [xt, *pp.values()], torch.from_numpy(ct))
        assert _rel(grads[0].numpy(), np.asarray(want_dx)) < 1e-5, plain
        for name, g in zip(pp, grads[1:]):
            assert _rel(g.numpy(), want_dp[name].numpy()) < 1e-5, (plain, name)


@pytest.mark.parametrize("p_in,p_rec", [(0.2, 0.0), (0.2, 0.2), (0.0, 0.2)])
def test_kernel_engine_keeps_dropout_on_the_kernel_path(p_in, p_rec, monkeypatch):
    """Under the kernel engine a ConvLSTM with dropout stays on the kernel
    wrapper in training: the masked input convs are its ``xconv``, the
    recurrent masks (``[4, B, H', W', f]``, or None without recurrent
    dropout) its last argument; no warning.  Its output equals the plain
    loop's on the same masks; without training there are no masks."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8, 8, 3)).astype(np.float32))
    kw = dict(dropout=p_in, recurrent_dropout=p_rec, name="dec9")
    plain, fused = ConvLSTM2D(3, 4, (3, 3), plain=True, **kw), ConvLSTM2D(3, 4, (3, 3), **kw)
    plain.reset_parameters(torch.Generator().manual_seed(0))
    fused.load_state_dict(plain.state_dict())
    calls = []
    real_scan = layers.convlstm_scan
    monkeypatch.setattr(layers, "convlstm_scan", lambda *a: calls.append(a[5]) or real_scan(*a))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got, _ = fused(x, training=True, masks=bernoulli_streams(4)[1])
    want, _ = plain(x, training=True, masks=bernoulli_streams(4)[1])
    assert len(calls) == 1
    assert (calls[0] is None) == (p_rec == 0.0)
    if p_rec:
        assert tuple(calls[0].shape) == (4, 2, 8, 8, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    fused(x)
    assert len(calls) == 2 and calls[1] is None
    with pytest.raises(ValueError, match="mask source"):
        plain(x, training=True)


TINY = dataclasses.replace(port_cfg(tiny_train_cfg()), sinkhorn_l=3)


def _with_dropout(cfg, p=0.2, q=0.3):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=p, rnn_dropout=q))


def test_rollout_ignores_dropout():
    """Sampling runs the generator with ``training=False``: a config with
    dropout gives the dropout-free rollout to the bit."""
    params = init_generator_params(TINY, torch.Generator().manual_seed(0))
    context = torch.rand(2, 16, 3, 16, 1, generator=torch.Generator().manual_seed(1))
    z = torch.randn(2, 2, 1, 1, 1, 4, generator=torch.Generator().manual_seed(2))
    want = build_rollout(TINY, device="cpu")(params, context, z=z)
    got = build_rollout(_with_dropout(TINY), device="cpu")(params, context, z=z)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def tiny_state():
    state = create_train_state(TINY, torch.Generator().manual_seed(0), device="cpu")
    video = torch.rand(2, 16, 5, 16, 1, generator=torch.Generator().manual_seed(1))
    return state, video


def test_dropout_free_key_sequence_is_unchanged(tiny_state):
    """Without dropout a step takes one split of the state's key, as
    before dropout was ported: the next key and the noise seed."""
    state, video = tiny_state
    step = build_train_step(TINY, device="cpu")
    s1, m1 = step(state, video)
    nxt, seed = split_key(state.rng)
    assert s1.rng == nxt
    g = torch.Generator().manual_seed(seed)
    shape = (2, TINY.pred_time_steps, 1, 1, 4)
    z = (torch.randn(shape, generator=g), torch.randn(shape, generator=g))
    _, m2 = step(state, video, z=z)
    assert float(m2["sinkhorn_loss"]) == float(m1["sinkhorn_loss"])


def test_dropout_masks_come_from_the_state_key(tiny_state):
    """With dropout the step splits its key once more (``dropout_keys``);
    the masks follow the key, so the same state gives the same step and a
    key folded by a NaN recovery other masks, under one fixed z."""
    state, video = tiny_state
    cfg = _with_dropout(TINY)
    step = build_train_step(cfg, device="cpu")
    s1, m1 = step(state, video)
    assert s1.rng == dropout_keys(split_key(state.rng)[0])[0]
    z = tuple(torch.randn(2, TINY.pred_time_steps, 1, 1, 4, generator=torch.Generator().manual_seed(i))
              for i in range(2))
    a = float(step(state, video, z=z)[1]["sinkhorn_loss"])
    assert float(step(state, video, z=z)[1]["sinkhorn_loss"]) == a
    folded = dataclasses.replace(state, rng=fold_in(state.rng, 1))
    assert float(step(folded, video, z=z)[1]["sinkhorn_loss"]) != a
    injected = float(step(state, video, z=z, masks=bernoulli_source(torch.Generator().manual_seed(5)))[1][
        "sinkhorn_loss"])
    assert np.isfinite(injected) and injected != a
