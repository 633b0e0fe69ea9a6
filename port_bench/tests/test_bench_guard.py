"""The import guard: no file of the benchmark imports JAX, jaxlib, flax or
the JAX package, and the plain reference imports nothing of the program.
Module names are compared by their top-level name whole, since the
port's name begins with the JAX package's.  At run time the harness reads
its own process and every rank it spawns: a rank that loads a module
named ``jax`` leaves the run without a result."""

import ast
import sys
import types

import pytest
import torch

import port_bench.drivers.train as train_driver
from port_bench.guard import FORBIDDEN, Forbidden, forbidden_loaded, top_level
from port_bench.run import run_cell
from port_bench.spec import BENCH_DIR, load_benchmark
from port_bench.tests.tiny import tiny_root

FILES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of every module ``path`` imports, relative imports
    of this package included as ``port_bench``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {top_level(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("port_bench" if node.level else top_level(node.module))
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_only_torch(path):
    assert imported(path) <= {"__future__", "math", "torch"}


def test_runtime_guard_compares_whole_top_level_names():
    assert forbidden_loaded({"kccotgan_tpu_torch", "kccotgan_tpu_torch.train", "jaxtyping", "torch"}) == []
    assert forbidden_loaded({"kccotgan_tpu.config", "jax.numpy", "flax"}) == ["flax", "jax.numpy", "kccotgan_tpu.config"]


_RANK = train_driver._rank


def _rank_loading_jax(rank, device, *args):
    """A rank of the mesh whose process holds a stub module named ``jax``."""
    if rank == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    return _RANK(rank, device, *args)


def test_a_rank_that_loads_jax_leaves_no_result(tmp_path, monkeypatch):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    monkeypatch.setattr(train_driver, "_rank", _rank_loading_jax)
    with pytest.raises(Forbidden, match="rank 1: jax"):
        run_cell("mmnist_dp4.train", 2**31 + 21, 0.3, False, device="cpu",
                 bench=load_benchmark(root / "BENCHMARK.json"), root=root)
    assert "jax" not in sys.modules
