"""Runs a function on W ranks of one gloo job on the CPU, and the checks
shared by the port's mesh tests (``tests/test_torch_parallel.py``,
``tests/test_torch_seqpar.py``).

Each rank is a spawned process (``kccotgan_tpu_torch.parallel.launch``)
with one intra-op thread, joined over a file store under the test's
temporary directory; collectives time out after 60 s
(``parallel.mesh.TIMEOUT``), and the whole job after ``TIMEOUT``, which
kills every rank and fails the test.  A rank's exception is raised in
the test with its traceback.  ``start`` returns at once, so the test
process computes its references while the ranks run.  States cross
between processes as numpy (``state_np``): pickling a tensor for a
spawned process moves its storage into shared memory, which would leave
any numpy view of it dangling.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kccotgan_tpu_torch.models.layers import BatchNorm
from kccotgan_tpu_torch.parallel.launch import run_ranks
from kccotgan_tpu_torch.train import KerasAdamState, TrainState
from kccotgan_tpu_torch.train import graph as graph_module

TIMEOUT = 300.0
GROUPS = ("enc", "dec", "h", "m")
TREES = ("enc_params", "dec_params", "h_params", "m_params", "h_stats", "m_stats")


class Job:
    def __init__(self, fn, world, args, store_dir):
        self._pool = ThreadPoolExecutor(1)
        self._future = self._pool.submit(
            run_ranks, fn, world, args, device="cpu", threads=1, timeout=TIMEOUT, store_dir=str(store_dir))

    def result(self):
        try:
            return self._future.result(timeout=TIMEOUT + 60)
        finally:
            self._pool.shutdown(wait=False)


def start(fn, world, *args, store_dir):
    """Start ``fn(rank, device, *args)`` on ``world`` ranks; ``.result()``
    is the ranks' return values in rank order (tensors as numpy)."""
    return Job(fn, world, args, store_dir)


def tensors(tree):
    """A dict of numpy arrays as a dict of tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def state_np(state):
    """A ``TrainState`` as a dict of plain values and numpy arrays."""
    out = {"step": state.step, "rng": state.rng}
    for name in TREES:
        out[name] = {k: v.detach().numpy() for k, v in getattr(state, name).items()}
    for g in GROUPS:
        opt = getattr(state, f"{g}_opt")
        out[f"{g}_count"] = opt.count
        out[f"{g}_mu"] = {k: v.numpy() for k, v in opt.mu.items()}
        out[f"{g}_nu"] = {k: v.numpy() for k, v in opt.nu.items()}
    return out


def state_from_np(d):
    """The ``TrainState`` of ``state_np``'s dict."""
    return TrainState(
        step=d["step"], rng=d["rng"], **{n: tensors(d[n]) for n in TREES},
        **{f"{g}_opt": KerasAdamState(count=d[f"{g}_count"], mu=tensors(d[f"{g}_mu"]), nu=tensors(d[f"{g}_nu"]))
           for g in GROUPS},
    )


def assert_states_match(gots, wants, metrics, want_metrics, lr):
    """Rank 0's metrics and states (``state_np``) after each iteration
    against the one-device step's.  The first iteration's loss and pM at
    rtol 1e-5; its state's parameters and moments, though, start moving by
    noise: the conv biases in front of each BatchNorm have a zero gradient
    but for rounding, so Adam moves them by steps of up to the rate ``lr``
    and of either sign (m's from the first step, whose offset-1 rate is
    not 0).  So the later iterations' loss and pM at 1e-4
    (``test_torch_train``'s tolerance), the statistics at 1e-6 plus what
    such moves can carry into a running mean (1 - momentum times two
    runs' opposite moves of up to twice the rate a step), the moments at
    1e-4 of each group's largest and the parameters at rtol 1e-4 / atol
    1e-6 where the gradient stood above noise (1e-4 of its group's
    largest) at every iteration (``tests/test_torch_train.py``'s rule)."""
    for i, ((lg, pg), (lw, pw)) in enumerate(zip(metrics, want_metrics)):
        np.testing.assert_allclose([lg, pg], [lw, pw], rtol=1e-5 if i == 0 else 1e-4, err_msg=f"iteration {i + 1}")
    stats_atol = 1e-6 + (1 - BatchNorm.momentum) * 4 * lr * len(wants)
    for i, (got, want) in enumerate(zip(gots, wants)):
        assert (got["step"], got["rng"]) == (want["step"], want["rng"])
        for name in ("h_stats", "m_stats"):
            for k, v in want[name].items():
                np.testing.assert_allclose(got[name][k], v, rtol=0, atol=stats_atol,
                                           err_msg=f"iteration {i + 1}: {name} {k}")
    got, want = gots[-1], wants[-1]
    for g in GROUPS:
        for k in want[f"{g}_params"]:
            signal = np.ones(want[f"{g}_params"][k].shape, bool)
            for w in wants:
                mu = w[f"{g}_mu"]
                signal &= np.abs(mu[k]) >= 1e-4 * max(np.abs(v).max() for v in mu.values())
            np.testing.assert_allclose(got[f"{g}_params"][k][signal], want[f"{g}_params"][k][signal],
                                       rtol=1e-4, atol=1e-6, err_msg=f"{g} {k}")
            for moment in ("mu", "nu"):
                scale = max(np.abs(v).max() for v in want[f"{g}_{moment}"].values())
                np.testing.assert_allclose(got[f"{g}_{moment}"][k], want[f"{g}_{moment}"][k], rtol=0,
                                           atol=1e-4 * scale, err_msg=f"{g} {moment} {k}")


class EagerStepGraph(graph_module.StepGraph):
    """``StepGraph`` on the CPU: its buffers, copies, clones and counters,
    with the step's function run on the buffers at each replay in place of
    a captured graph.  A replay puts the counters back as the function
    left them, since a graph's replay counts nothing on the host, so that
    they advance by what ``StepGraph`` adds, as on the card."""

    def _capture(self, run):
        out, shapes = run()

        def replay():
            kept = [graph_module._get(obj, name) for obj, name, _ in self._advance]
            out.copy_(run()[0])
            for (obj, name, _), n in zip(self._advance, kept):
                graph_module._set(obj, name, n)

        return replay, out, shapes


def assert_ranks_equal(results, pick):
    """``pick(result)`` (a ``state_np`` dict) the same on every rank, to
    the bit."""
    first = pick(results[0])
    for res in results[1:]:
        other = pick(res)
        assert (other["step"], other["rng"]) == (first["step"], first["rng"])
        for name, tree in first.items():
            if isinstance(tree, dict):
                for k, v in tree.items():
                    np.testing.assert_array_equal(other[name][k], v, err_msg=f"{name} {k}")
