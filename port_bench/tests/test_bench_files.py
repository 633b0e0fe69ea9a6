"""The benchmark's files: ``BENCHMARK.json`` against its contract, every
cell resolving to its files, and a configuration, a traffic mix and a
per-layer metric added as new files being found with no edit elsewhere."""

import json
import re
import shutil

import pytest

from port_bench.spec import BENCH_DIR, REPO, load_benchmark, load_cell, load_metric_reader
from port_bench.tests.tiny import with_held
from port_bench.trace import load_families

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()


def test_top_level_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "-m", "port_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    keys = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
    }[section]
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            assert text is None or (1 <= len(text) <= 200 and "\n" not in text and "\t" not in text)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
        if section == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
        if section == "workloads":
            assert e["chips"] in (1, 4) and NAME.match(e["traffic"])


@pytest.mark.parametrize("held", [False, True], ids=["benchmark", "with_held"])
def test_every_cell_resolves_and_reports_what_it_must(held):
    """Every cell of ``BENCHMARK.json``, and with ``held`` every cell held
    back in ``held/*.json`` too, as its entries would stand merged in."""
    bench = with_held(json.loads(json.dumps(BENCH))) if held else BENCH
    e2e_names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e_names
    for w in bench["workloads"]:
        cell = load_cell(w["name"], bench)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
            assert callable(load_metric_reader(m["name"]))
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert (BENCH_DIR / "drivers" / f"{cell.traffic['driver']}.py").exists()


def test_configs_state_their_source_and_changes():
    for entry in BENCH["configs"]:
        conf = json.loads((REPO / entry["file"]).read_text())
        assert entry["file"].startswith("port_bench/configs/")
        assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
        assert sorted(conf["changed"]) == sorted(conf["reduced"]) == sorted(entry["reduced"])
        for key, value in conf["changed"].items():
            assert conf["config"][key] == value
        assert conf["assumed"] == []


def test_kernel_families_cover_every_kernel_of_the_port():
    names = {n for fam in load_families(REPO).values() for n in fam}
    declared = set()
    for src in (REPO / "kccotgan_tpu_torch" / "csrc").glob("*.cu*"):
        text = re.sub(r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)", " ", src.read_text())
        declared |= set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    assert declared and declared <= names, declared - names


def test_new_files_are_found_by_name(tmp_path):
    """A later change adds a configuration, a traffic mix, a metric and a
    cell as files and entries alone."""
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((BENCH_DIR / "configs" / "mmnist_full.json").read_text())
    conf.update(name="mmnist_long", changed={**conf["changed"], "total_time_steps": 30, "int_time_steps": 5})
    conf["config"].update(total_time_steps=30, int_time_steps=5)
    (tmp_path / "port_bench" / "configs" / "mmnist_long.json").write_text(json.dumps(conf))
    mix = json.loads((BENCH_DIR / "traffic" / "train.json").read_text())
    (tmp_path / "port_bench" / "traffic" / "train_small.json").write_text(json.dumps({**mix, "videos": 64}))
    (tmp_path / "port_bench" / "limits" / "mmnist_long.train_small.json").write_text(
        json.dumps({"limits": {"loss": 0.1}}))
    (tmp_path / "port_bench" / "metrics" / "extra.count.py").write_text("def read(rec):\n    return 7.0\n")
    bench["configs"].append({**bench["configs"][0], "name": "mmnist_long", "file": "port_bench/configs/mmnist_long.json"})
    bench["workloads"].append({"name": "mmnist_long.train_small", "config": "mmnist_long", "traffic": "train_small",
                               "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "extra.count", "unit": "1", "better": "lower", "source": "program_counter",
                               "layer": "loop", "moves": "train_frames_per_s",
                               "workloads": ["mmnist_long.train_small"]})
    bench["end_to_end"][0] = {**bench["end_to_end"][0],
                              "workloads": bench["end_to_end"][0]["workloads"] + ["mmnist_long.train_small"]}
    cell = load_cell("mmnist_long.train_small", bench, tmp_path)
    assert cell.cfg["total_time_steps"] == 30 and cell.traffic["videos"] == 64
    assert [m["name"] for m in cell.per_layer] == ["extra.count"]
    assert load_metric_reader("extra.count", tmp_path)({}) == 7.0
    assert load_cell("mmnist_full.train", bench, tmp_path).cfg["total_time_steps"] == 20
