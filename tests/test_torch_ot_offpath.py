"""The OT pieces off the training path, and the discriminators' inference
mode, in the PyTorch port vs the JAX package, on the CPU.

Seeded numpy inputs go to both sides (the cases of ``tests/test_ot.py``
for the early stop and its gradient, at this file's sizes):

* ``sinkhorn_from_cost``'s early stop (``lmin``, ``threshold``): the
  value at rtol 1e-5 (the same dual updates in another summation order);
  at a threshold of 1e30 it is one dual update, at rtol 1e-6 of the port's
  own single update;
* its gradient, the implicit-function-theorem VJP (``ImplicitCost``: a
  ``[2B, 2B]`` solve with a 1e-6 ridge), and ``grad='implicit'``'s, at
  rtol 1e-4 / atol 1e-6 of JAX's: two solvers (LAPACK through XLA and
  through torch) on the same f32 system, whose ridge-damped gauge
  direction lets the multipliers differ by more than an ulp, though the
  gradient, which the gauge does not reach, agrees; and, as JAX's own
  test holds it, within rtol 1e-2 / atol 1e-5 of the unrolled gradient at
  500 dual updates.  ``benchmark_sinkhorn`` runs at its defaults (eps 1,
  10 updates): at eps 0.5 its ten updates leave the duals far from their
  fixed point, the system inconsistent, and the multipliers' large gauge
  component cancels in the gradient only to f32 rounding of its size:
  JAX and the port then each sit ~7e-4 of the largest entry from the f64
  gradient (measured), 1.1e-4 from each other;
* ``benchmark_sinkhorn`` and ``compute_sinkhorn(bi_causal=True, hx, my)``:
  values at rtol 1e-5, gradients at rtol 1e-4 / atol 1e-6 (``tests/test_torch_ot.py``
  argues these for the plain loop);
* ``VideoDiscriminator(..., training=False)``: every BatchNorm normalizes
  by the running statistics, which come back unchanged; the output at
  1e-5 abs against flax's ``use_running_average=True`` in f32, from
  statistics two training calls left (``tests/test_torch_disc.py``'s
  tolerance).

JAX is compiled without LLVM's optimizations (``_torch_port.compile_o0``):
the arithmetic differs from the optimized build by ulps, well inside
these tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu import ot as jot
from kccotgan_tpu.train.state import GanModules
from kccotgan_tpu_torch import ot
from kccotgan_tpu_torch.models import discriminator_modules
from kccotgan_tpu_torch.weights import flatten_flax_tree
from tests._torch_port import compile_o0, port_cfg, tiny_train_cfg

torch.set_num_threads(1)

B, T, F, J = 4, 6, 10, 3
SCALING = 1.0 / 15.0


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, F)).astype(np.float32) for _ in range(2)] + [
        rng.normal(size=(B, T, J)).astype(np.float32) for _ in range(4)
    ]


def _jit(fn, *args):
    """``fn(*args)`` compiled at LLVM -O0, as numpy."""
    return jax.tree_util.tree_map(np.asarray, compile_o0(fn, *args)(*args))


def _value_and_grad(fn, args, argnums):
    """The port's ``fn(*args)`` and its gradients in ``argnums``."""
    leaves = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(args)]
    val = fn(*leaves)
    grads = torch.autograd.grad(val, [leaves[i] for i in argnums])
    return val.item(), [g.numpy() for g in grads]


def _assert_close(got, want, argnums):
    (val, grads), (want_val, want_grads) = got, want
    np.testing.assert_allclose(val, float(want_val), rtol=1e-5)
    for i, g, w in zip(argnums, grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=f"argument {i}")


@pytest.mark.parametrize("lmin,threshold", [(1, 1e30), (10, 1e-2), (3, 1e-4), (2, 0.0)])
def test_early_stop_matches_jax(lmin, threshold):
    """Value and gradient of the early stop at each (lmin, threshold):
    one update, the benchmark's default, a tight stop and none (all 60
    updates)."""
    x, y, *_ = _inputs(lmin)
    cost = jot.cost_xy(jnp.asarray(x), jnp.asarray(y), SCALING)

    def fn(mod, cost_xy):
        return lambda xx, yy: mod.sinkhorn_from_cost(cost_xy(xx, yy, SCALING), num_iters=60, lmin=lmin,
                                                     threshold=threshold)

    want = _jit(jax.value_and_grad(fn(jot, jot.cost_xy), argnums=(0, 1)), x, y)
    _assert_close(_value_and_grad(fn(ot, ot.cost_xy), (x, y), (0, 1)), want, (0, 1))
    if threshold == 1e30:  # stops after lmin = 1 update
        c = ot.cost_xy(*map(torch.tensor, (x, y)), SCALING)
        np.testing.assert_allclose(float(ot.sinkhorn_from_cost(c, num_iters=60, lmin=1, threshold=threshold)),
                                   float(ot.sinkhorn_from_cost(c, num_iters=1)), rtol=1e-6)
        assert np.isfinite(float(jot.sinkhorn_from_cost(cost, num_iters=1)))


def test_early_stop_gradient_is_the_unrolled_one_at_convergence():
    """``benchmark_sinkhorn`` (lmin 10, up to 500 updates) against the
    unrolled solver at 500 updates: the port's against itself, as JAX's
    own test holds JAX's, and against JAX's early stop."""
    x, y, *_ = _inputs(7)

    def early(mod):
        return lambda xx, yy: mod.benchmark_sinkhorn(xx, yy, SCALING, num_iters=500, lmin=10)

    got = _value_and_grad(early(ot), (x, y), (0,))
    _assert_close(got, _jit(jax.value_and_grad(early(jot), (0,)), x, y), (0,))
    unrolled = _value_and_grad(
        lambda xx, yy: ot.sinkhorn_from_cost(ot.cost_xy(xx, yy, SCALING), num_iters=500), (x, y), (0,))
    assert np.isfinite(got[1][0]).all()
    np.testing.assert_allclose(got[1][0], unrolled[1][0], rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(got[0], unrolled[0], rtol=1e-4)


@pytest.mark.parametrize("method", ["gram", "exact"])
def test_benchmark_sinkhorn_matches_jax(method):
    """The benchmark solver at its defaults (10 updates, lmin 10)."""
    x, y, *_ = _inputs(11)

    def fn(mod):
        return lambda xx, yy: mod.benchmark_sinkhorn(xx, yy, SCALING, cost_method=method)

    _assert_close(_value_and_grad(fn(ot), (x, y), (0, 1)), _jit(jax.value_and_grad(fn(jot), (0, 1)), x, y),
                  (0, 1))


def test_implicit_gradient_matches_jax():
    """``grad='implicit'`` at 30 fixed updates: the unrolled solver's
    value, the implicit VJP's gradient."""
    x, y, hy, mx, *_ = _inputs(13)

    def fn(mod, grad):
        return lambda *a: mod.compute_sinkhorn(*a, SCALING, num_iters=30, grad=grad)

    args = (x, y, hy, mx)
    got = _value_and_grad(fn(ot, "implicit"), args, (0, 1, 2, 3))
    _assert_close(got, _jit(jax.value_and_grad(fn(jot, "implicit"), (0, 1, 2, 3)), *args), (0, 1, 2, 3))
    np.testing.assert_allclose(got[0], _value_and_grad(fn(ot, "unrolled"), args, (0,))[0], rtol=1e-6)
    with pytest.raises(ValueError, match="unknown grad mode"):
        fn(ot, "forward")(*map(torch.tensor, args))


def test_bi_causal_matches_jax():
    """Both causal Lagrangians in the cost, through every argument."""
    args = tuple(_inputs(17))  # x, y, hy, mx, hx, my

    def fn(mod):
        return lambda x, y, hy, mx, hx, my: mod.compute_sinkhorn(
            x, y, hy, mx, SCALING, hx, my, num_iters=20, bi_causal=True)

    nums = tuple(range(6))
    _assert_close(_value_and_grad(fn(ot), args, nums), _jit(jax.value_and_grad(fn(jot), nums), *args), nums)


def test_discriminator_inference_mode_matches_jax():
    """``training=False`` against flax's ``use_running_average=True``, from
    the running statistics two training calls left; the statistics come
    back unchanged, and the output differs from the training mode's."""
    rng = np.random.default_rng(23)
    fake, real = (rng.uniform(size=(2, 16, 5, 16, 1)).astype(np.float32) for _ in range(2))
    mod = GanModules(tiny_train_cfg()).disc_h

    def run(key):
        v = mod.init(key, fake, training=False)
        _, u1 = mod.apply(v, fake, training=True, mutable=["batch_stats"])
        _, u2 = mod.apply({"params": v["params"], **u1}, real, training=True, mutable=["batch_stats"])
        stats = u2["batch_stats"]
        return v["params"], stats, mod.apply({"params": v["params"], "batch_stats": stats}, real, training=False)

    params, stats, want = _jit(run, jax.random.PRNGKey(3))
    d, _ = discriminator_modules(port_cfg(tiny_train_cfg()))
    d.load_state_dict(flatten_flax_tree(params))
    stats = {k: torch.from_numpy(np.asarray(v)) for k, v in flatten_flax_tree(stats).items()}
    with torch.no_grad():
        out, new = d(torch.tensor(real), stats, training=False)
        trained, _ = d(torch.tensor(real), stats)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)
    assert new.keys() == stats.keys() and all(new[k] is stats[k] for k in stats)
    assert float((trained - out).abs().max()) > 1e-3
