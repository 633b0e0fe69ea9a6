"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

``load_cell(workload)`` reads the cell's entry, its configuration
(``configs/<config>.json``, by the ``file`` the entry names), its traffic
mix (``traffic/<traffic>.json``), its limits (``limits/<workload>.json``),
the end-to-end and per-layer metrics that apply to it, and the plain
reference module the configuration names (``reference/<name>.py``).
Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BENCH_DIR", "Cell", "REPO", "applies", "load_benchmark", "load_cell", "load_metric_reader",
           "port_config", "sub_seed"]

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    """A metric without a ``workloads`` key applies to every cell."""
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # number name -> limit
    end_to_end: list  # the entries of BENCHMARK.json that apply
    per_layer: list
    reference: object  # the plain reference module
    root: Path  # where the cell's files were read from

    @property
    def cfg(self) -> dict:
        """The configuration's fields, as the program's config takes them."""
        return self.config["config"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, bench: dict | None = None, root: Path | None = None) -> Cell:
    """The cell ``workload`` of ``bench`` (``BENCHMARK.json`` by default),
    its files read from under ``root`` (the repository by default)."""
    bench = bench if bench is not None else load_benchmark()
    root = root or REPO
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(root / conf_entry["file"])
    traffic = _json(root / "port_bench" / "traffic" / f"{entry['traffic']}.json")
    limits = _json(root / "port_bench" / "limits" / f"{workload}.json")
    reference = importlib.import_module(f"port_bench.reference.{config['reference']}")
    return Cell(
        name=workload, chips=entry["chips"], config=config, traffic=traffic, limits=limits["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)],
        reference=reference, root=root,
    )


def load_metric_reader(name: str, root: Path | None = None):
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = (root or REPO) / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def sub_seed(seed: int, tag: str) -> int:
    """A 62-bit seed for one stream (weights, data, noise, ...) of a run."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 2


def port_config(cfg: dict, **overrides):
    """The program's ``TrainConfig`` of a configuration's fields."""
    from kccotgan_tpu_torch.config import ModelConfig, TrainConfig

    fields = {k: v for k, v in cfg.items() if k != "model"}
    fields.update(overrides)
    return TrainConfig(**fields, model=ModelConfig(**cfg["model"]))
