"""BENCHMARK.json against the benchmark's contract, and the harness
finding every file of a cell by name (CPU)."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return spec.load(ROOT)


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert KEYS[group] <= set(entry) <= KEYS[group] | extra, entry
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer") + (("source",) if group == "configs" else ()):
                if key in entry:
                    assert LINE.match(entry[key]), entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_command_paths_and_bounds(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert len(bench["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    # a full check of 24 cells fits in 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_it_needs(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"], ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e and m["moves"] in reported, (w["name"], m["name"])
    for c in bench["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(LINE.match(layer) for layer in layers)


def test_every_cell_resolves_to_its_files(bench):
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"], ROOT)
        assert cell.config["model"]["name"] == w["config"]
        driver = spec.driver(cell.traffic["kind"])
        assert callable(driver.run)
        assert set(cell.limits) == ({"loss_gap", "grad_gap", "change_gap", "stats_gap"}
                                    if cell.traffic["kind"] == "train" else {"recon_err"})
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"], ROOT))


def test_a_new_cell_is_new_files_only(tmp_path, bench):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and entries are found with no file of the harness edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(bench))
    cfg = json.loads((ROOT / "benchmark/configs/ico2ico.json").read_text())
    cfg["model"]["name"] = "ico2ico"
    (tmp_path / "benchmark/configs/ico2ico_b.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "ico2ico_b", "source": "https://example.org",
                             "file": "benchmark/configs/ico2ico_b.json", "reduced": [],
                             "why": "a second file"})
    traffic = json.loads((ROOT / "benchmark/traffic/train_s6_b36.json").read_text())
    traffic["batch_size"] = 12
    (tmp_path / "benchmark/traffic/train_s6_b12.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/limits/new_cell.json").write_text(
        json.dumps({"loss_gap": 1, "grad_gap": 1, "change_gap": 1, "stats_gap": 1}))
    (tmp_path / "benchmark/metrics/steps_seen.train.py").write_text(
        "def read(r):\n    return float(r.launch_steps)\n")
    bench["workloads"].append({"name": "new_cell", "config": "ico2ico_b",
                               "traffic": "train_s6_b12", "chips": 1, "why": "new"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "train loop",
                               "moves": "train_meshes_per_s", "workloads": ["new_cell"]})
    bench["end_to_end"][0]["workloads"].append("new_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell(spec.load(tmp_path), "new_cell", tmp_path)
    assert cell.traffic["batch_size"] == 12
    assert [m["name"] for m in cell.per_layer][-1] == "steps_seen.train"
    read = spec.reader("steps_seen.train", tmp_path)

    class R:
        launch_steps = 7

    assert read(R()) == 7.0
