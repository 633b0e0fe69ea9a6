"""The PyTorch port's discriminator, its layers and the decoder's training
path vs the JAX package, at the tiny geometry of ``tests/test_train.py``
(B=2, 16x16x1 frames, T=5 with 3 context, d_filter_size=2, state 3).

The JAX side runs under jit, compiled once per module fixture without
LLVM's optimizations (``_torch_port.compile_o0``); weights come from its
init and reach the port through ``train_state_from_jax``.
Tolerances: f32 at 1e-5 abs for the discriminator's output and running
statistics (conv and matmul summation order; the output is a sigmoid in
[0, 1]) and for the decoder's frames; bf16 at 2e-2 abs: both sides round
the conv and matmul inputs to bf16 at the same points, but a different
f32 summation order can put a rounded activation one bf16 ulp (2**-8
relative) apart, and each BatchNorm divides such a difference by its
channel's spread over only B*T = 10 rows.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu.models import layers as jlayers
from kccotgan_tpu.train.state import GanModules
from kccotgan_tpu_torch.models import (
    LSTM,
    BatchNorm,
    Conv2D,
    discriminator_modules,
    generator_modules,
    leaky_relu,
)
from kccotgan_tpu_torch.weights import (
    flatten_flax_tree,
    generator_params_from_jax,
    init_discriminator_params,
)
from tests._torch_port import compile_o0, port_cfg, tiny_train_cfg

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def disc():
    """JAX discriminator variables and two chained training-mode calls
    (fake then real, as the h-discriminator runs them) in f32 and bf16."""
    rng = np.random.default_rng(0)
    fake, real = (rng.uniform(size=(2, 16, 5, 16, 1)).astype(np.float32) for _ in range(2))
    out = {"fake": fake, "real": real}
    for cdt in ("float32", "bfloat16"):
        mod = GanModules(tiny_train_cfg(cdt)).disc_h
        key = jax.random.PRNGKey(3)
        variables = compile_o0(lambda k: mod.init(k, fake, training=False), key)(key)

        def chain(v):
            o1, u1 = mod.apply(v, fake, training=True, mutable=["batch_stats"])
            o2, u2 = mod.apply(
                {"params": v["params"], **u1}, real, training=True, mutable=["batch_stats"]
            )
            return o1, u1["batch_stats"], o2, u2["batch_stats"]

        out[cdt] = (_np(variables), *_np(compile_o0(chain, variables)(variables)))
    return out


def _port_disc(cdt, variables):
    d, _ = discriminator_modules(port_cfg(tiny_train_cfg(cdt)))
    d.load_state_dict(flatten_flax_tree(variables["params"]))
    return d


@pytest.mark.parametrize("cdt,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_discriminator_and_stats_match_jax(disc, cdt, tol):
    variables, o1, s1, o2, s2 = disc[cdt]
    d = _port_disc(cdt, variables)
    stats = flatten_flax_tree(variables["batch_stats"])
    assert stats.keys() == d.init_stats().keys()
    with torch.no_grad():
        got1, st1 = d(torch.tensor(disc["fake"]), stats)
        got2, st2 = d(torch.tensor(disc["real"]), st1)
    assert tuple(got1.shape) == o1.shape == (2, 5, 3)
    for got, want in ((got1, o1), (got2, o2)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    for got, want in ((st1, flatten_flax_tree(s1)), (st2, flatten_flax_tree(s2))):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol, err_msg=k)


def test_discriminator_gradient_matches_jax(disc):
    """d(sum(w * out)) over every parameter and the input, f32, 1e-5
    relative to the gradient's largest entry."""
    variables = disc["float32"][0]
    mod = GanModules(tiny_train_cfg()).disc_h
    w = np.random.default_rng(1).normal(size=(2, 5, 3)).astype(np.float32)

    def loss(p, x):
        out, _ = mod.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, x, training=True, mutable=["batch_stats"]
        )
        return jnp.sum(out * w)

    gp, gx = _np(jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], disc["fake"]))
    d = _port_disc("float32", variables)
    x = torch.tensor(disc["fake"], requires_grad=True)
    out, _ = d(x, flatten_flax_tree(variables["batch_stats"]))
    (out * torch.tensor(w)).sum().backward()
    want = flatten_flax_tree(gp)
    scale = max(float(v.abs().max()) for v in want.values())
    for name, p in d.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)
    np.testing.assert_allclose(x.grad.numpy(), gx, rtol=0, atol=1e-5 * float(np.abs(gx).max()))


def test_layers_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    conv = jlayers.Conv2D(filters=5, kernel_size=(5, 5), strides=(2, 2))
    cv = conv.init(jax.random.PRNGKey(0), x)
    c = Conv2D(4, 5, (5, 5), (2, 2))
    c.load_state_dict(flatten_flax_tree(cv["params"]))
    with torch.no_grad():
        np.testing.assert_allclose(c(torch.tensor(x)).numpy(), conv.apply(cv, x), rtol=0, atol=1e-5)

    seq = rng.normal(size=(2, 4, 6)).astype(np.float32)
    for act in ("tanh", "sigmoid"):
        lstm = jlayers.LSTM(units=3, activation=act)
        lv = lstm.init(jax.random.PRNGKey(1), seq)
        m = LSTM(6, 3, activation=act)
        m.load_state_dict(flatten_flax_tree(lv["params"]))
        with torch.no_grad():
            np.testing.assert_allclose(m(torch.tensor(seq)).numpy(), lstm.apply(lv, seq), rtol=0, atol=1e-6)

    from flax import linen as nn

    for shape in ((3, 4, 4, 5), (2, 4, 5)):
        y = rng.normal(size=shape).astype(np.float32) * 2.0 + 1.0
        bn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
        bv = bn.init(jax.random.PRNGKey(2), y)
        want, upd = bn.apply(bv, y, mutable=["batch_stats"])
        b = BatchNorm(shape[-1])
        b.load_state_dict(flatten_flax_tree(bv["params"]))
        stats = flatten_flax_tree(bv["batch_stats"])
        with torch.no_grad():
            got, (mean, var) = b(torch.tensor(y), stats["mean"], stats["var"])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(mean.numpy(), upd["batch_stats"]["mean"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(var.numpy(), upd["batch_stats"]["var"], rtol=0, atol=1e-6)


def test_leaky_relu_matches_jax_at_zero():
    x = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    y = leaky_relu(x)
    y.sum().backward()
    xj = jnp.array([-2.0, 0.0, 3.0])
    np.testing.assert_allclose(y.detach().numpy(), jlayers.leaky_relu(xj))
    # where(x >= 0, ...) sends the gradient at 0 through the identity
    np.testing.assert_allclose(x.grad.numpy(), jax.grad(lambda a: jnp.sum(jlayers.leaky_relu(a)))(xj))
    assert x.grad[1] == 1.0


def test_decoder_training_path_matches_jax():
    """Teacher forcing: every skip level's ``[:, :-1]`` frames, T_z = 2."""
    cfg = tiny_train_cfg()
    mods = GanModules(cfg)
    enc, dec = mods.generator_modules(time_major=False)
    rng = np.random.default_rng(4)
    video = rng.uniform(size=(2, 16, 5, 16, 1)).astype(np.float32)
    z = rng.normal(size=mods.z_shape(2, cfg.pred_time_steps)).astype(np.float32)

    def run(k1, k2):
        ev = enc.init(k1, video, training=False)
        pyr = enc.apply(ev, video, training=True)
        dv = dec.init(k2, pyr, z, training=True)
        return ev["params"], dv["params"], pyr, dec.apply(dv, pyr, z, training=True)

    keys = (jax.random.PRNGKey(5), jax.random.PRNGKey(6))
    enc_p, dec_p, pyr, want = _np(compile_o0(run, *keys)(*keys))
    encoder, decoder = generator_modules(port_cfg(cfg))
    params = generator_params_from_jax(enc_p, dec_p)
    encoder.load_state_dict(params["encoder"])
    decoder.load_state_dict(params["decoder"])
    with torch.no_grad():
        pyr_t = encoder(torch.tensor(video))
        got = decoder(pyr_t, torch.tensor(z), training=True)
    for a, b in zip(pyr_t, pyr):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    assert tuple(got.shape) == want.shape == (2, 16, 2, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_init_discriminator_params(disc):
    """Same keys and shapes as the JAX init; flax's distributions."""
    variables = disc["float32"][0]
    p = init_discriminator_params(port_cfg(tiny_train_cfg()), torch.Generator().manual_seed(0))
    want = flatten_flax_tree(variables["params"])
    for name in ("h", "m"):
        assert {k: tuple(v.shape) for k, v in p[name].items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert {k: tuple(v.shape) for k, v in p["h_stats"].items()} == {
        k: tuple(v.shape) for k, v in flatten_flax_tree(variables["batch_stats"]).items()
    }
    h = p["h"]
    assert not torch.equal(h["conv1.kernel"], p["m"]["conv1.kernel"])
    assert torch.equal(h["conv1.bias"], torch.zeros_like(h["conv1.bias"]))
    assert torch.equal(p["h_stats"]["bn1.var"], torch.ones_like(p["h_stats"]["bn1.var"]))
    u = h["lstm3.recurrent_kernel"].shape[0]
    np.testing.assert_array_equal(h["lstm3.bias"].numpy(), np.repeat([0.0, 1.0, 0.0, 0.0], u))
    rk = h["lstm1.recurrent_kernel"]  # [U, 4U]: orthonormal rows
    torch.testing.assert_close(rk @ rk.T, torch.eye(rk.shape[0]), rtol=0, atol=1e-5)
    k = h["lstm1.kernel"]
    limit = (6.0 / (k.shape[0] + k.shape[1])) ** 0.5
    assert k.abs().max() <= limit and k.abs().max() > 0.9 * limit
