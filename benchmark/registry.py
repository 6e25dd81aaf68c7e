"""Finds each piece of the benchmark by its name.

``BENCHMARK.json`` at the checkout's root lists the cells and the metrics.
Everything that belongs to one configuration, traffic mix, driver, metric,
kernel family or cell lives in files of its own under this folder, found
by name, so that a new cell, configuration or metric is new files:

  configs/<config>.json          the configuration as it is run
  traffic/<traffic>.json         the traffic's parameters, and its driver
  drivers/<driver>.py            a general closed-loop driver (``run``)
  metrics/<metric>.py            a per-layer metric's reader (``read``)
  kernels/<family>.json, .py     a kernel family's names and its work
  limits/<cell>.json             the limits of a cell's comparison
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark._by_name.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    for c in (bench or manifest())["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def driver(name: str):
    return _module(HERE / "drivers" / f"{name}.py")


def metric_reader(name: str):
    return _module(HERE / "metrics" / f"{name}.py")


def limits(cell_name: str) -> dict:
    return _json(HERE / "limits" / f"{cell_name}.json")


def kernel_families() -> dict:
    """{family: (its JSON, its module)} of every family under kernels/."""
    out = {}
    for path in sorted((HERE / "kernels").glob("*.json")):
        out[path.stem] = (_json(path), _module(path.with_suffix(".py")))
    return out


def applies(metric: dict, cell_name: str) -> bool:
    """Whether a metric of BENCHMARK.json is reported in a cell."""
    return "workloads" not in metric or cell_name in metric["workloads"]
