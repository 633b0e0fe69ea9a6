"""``correct`` has to come out false for the control and for every fault a
cell can have, and true for the program as it is.

Each test drives the whole of a run (``run.run_cell``) on the CPU at the
tiny sizes of ``tiny.py`` with the cells' own limits, skipping only the
look for a card: the program as it is; the control (the plain reference
with float8 operands, put in the program's place); and the timed path
broken underneath: a training step that returns its state unchanged, a
training step on half the batch (the mean over the rest), and a rollout
whose last predicted frame repeats the one before it (an answer altered
where it is produced), and a best-of-K PSNR or SSIM shifted by 0.01 (a
score altered where it is produced)."""

import dataclasses
import importlib

import pytest
import torch

from port_bench import check
from port_bench.run import run_cell
from port_bench.spec import load_benchmark, load_cell
from port_bench.tests.tiny import tiny_root

CELLS = ["mmnist_full.train", "mmnist_full.sample", "robot_push.eval_bo100", "mmnist_dp4.train"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


def run(root, workload, seed=2**31 + 11):
    return run_cell(workload, seed, 0.3, False, device="cpu", bench=load_benchmark(root / "BENCHMARK.json"),
                    root=root)


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_is_correct(root, workload):
    result = run(root, workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not(root, workload):
    cell = load_cell(workload, load_benchmark(root / "BENCHMARK.json"), root)
    driver = importlib.import_module(f"port_bench.drivers.{cell.traffic['driver']}")
    ev = driver.run(cell, 2**31 + 12, 0.3, False, "cpu")["evidence"]
    assert ev["kind"] == "train" or ev["requests"], "no request was kept for the check"
    numbers = check.control_numbers(cell.reference, cell.cfg, ev, "cpu")
    correct, checks = check.judge(numbers, cell.limits)
    assert not correct, checks


def _broken_step(monkeypatch, fault):
    import kccotgan_tpu_torch.train.loop as loop

    build = loop.build_train_step

    def broken(cfg, **kw):
        step = build(cfg, **kw)

        def run_step(state, real, generator=None, z=None, masks=None):
            if fault == "half_batch":
                n = real.shape[0] // 2
                return step(state, real[:n], generator, (z[0][:n], z[1][:n]), masks)
            new, metrics = step(state, real, generator, z, masks)
            return dataclasses.replace(state, step=new.step), metrics

        return run_step

    monkeypatch.setattr(loop, "build_train_step", broken)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_training_step_is_not(root, monkeypatch, fault):
    _broken_step(monkeypatch, fault)
    result = run(root, "mmnist_full.train")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ["mmnist_full.sample", "robot_push.eval_bo100"])
def test_an_altered_answer_is_not(root, monkeypatch, workload):
    import kccotgan_tpu_torch.train.rollout as rollout

    graph_rollout = rollout.graph_rollout

    def broken(cfg, params, **kw):
        fn = graph_rollout(cfg, params, **kw)

        def altered(*args, **kwargs):
            video = fn(*args, **kwargs).clone()
            video[:, :, -1] = video[:, :, -2]
            return video

        return altered

    monkeypatch.setattr(rollout, "graph_rollout", broken)
    result = run(root, workload)
    assert not result["correct"], result["checks"]


def _rank_without_exchange(rank, device, *args):
    """A mesh rank whose gradients skip the all-reduce between the ranks
    (each rank steps with its own rows' gradient alone)."""
    from kccotgan_tpu_torch.parallel.sharding import MeshPlacement

    from port_bench.drivers import train

    MeshPlacement.sum_grads = lambda self, phase, grads: grads
    return train._rank(rank, device, *args)


def test_the_mesh_is_correct_and_not_without_its_exchange(root, monkeypatch):
    from port_bench.drivers import train

    assert run(root, "mmnist_dp4.train")["correct"]
    monkeypatch.setattr(train, "_rank", _rank_without_exchange)
    result = run(root, "mmnist_dp4.train")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("score", ["psnr", "ssim"])
def test_an_altered_score_is_not(root, monkeypatch, score):
    import kccotgan_tpu_torch.eval.metrics as metrics

    exact = getattr(metrics, score)
    monkeypatch.setattr(metrics, score, lambda *a, **kw: exact(*a, **kw) + 0.01)
    result = run(root, "robot_push.eval_bo100")
    assert not result["correct"], result["checks"]
    assert result["checks"][score]["value"] > result["checks"][score]["limit"]
