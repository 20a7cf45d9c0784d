"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix. Its configuration is the
file that ``configs`` gives; its traffic mix is ``benchmark/traffic/
<traffic>.json``, whose ``kind`` picks the driver ``benchmark/drivers/
<kind>.py``; the limits of its comparison are ``benchmark/limits/<cell>.json``;
each per-layer metric is read by ``benchmark/metrics/<metric>.py``. A new
cell, configuration, traffic mix or metric is new files and new entries
in ``BENCHMARK.json``: nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and limits loaded."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(work)}")
    w = work[name]
    config = {c["name"]: c for c in spec["configs"]}[w["config"]]
    here = root / HERE.name
    with open(root / config["file"]) as f:
        cfg = json.load(f)
    with open(here / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(here / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(name, w["chips"], cfg, traffic, limits,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def driver(kind: str):
    """The module ``benchmark/drivers/<kind>.py``."""
    return importlib.import_module(f"{__package__}.drivers.{kind}")


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py`` (a metric
    name may hold dots, so the file is loaded by its path)."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
