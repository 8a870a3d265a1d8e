"""What a run reads: the cell in ``BENCHMARK.json``, its configuration and
traffic files, and the driver and metric readers they name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by name:

- ``configs/<config>.json``: the model's published sizes and its family;
- ``traffic/<traffic>.json``: the mix's parameters and its ``driver``;
- ``drivers/<driver>.py``: the code that runs a kind of traffic;
- ``metrics/<metric>.py``: one per-layer metric's reader;
- ``limits/<cell>.json``: the limits that decide ``correct`` in a cell.

So a later change adds a configuration, a mix or a metric by adding files,
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    listed = metric.get("workloads")
    return listed is None or cell in listed


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` under ``root``; raises
    ``KeyError`` for a name the file does not hold."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config_entry = next(c for c in bench["configs"]
                        if c["name"] == entry["config"])
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=load_json(root / config_entry["file"]),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=end_to_end,
        per_layer=per_layer,
    )


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    """``drivers/<name>.py`` as a module (its ``run(ctx)`` runs a cell)."""
    return _load_file(HERE / "drivers" / f"{name}.py",
                      f"portbench.drivers.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(record) -> float | None``."""
    module = _load_file(HERE / "metrics" / f"{name}.py",
                        "portbench.metrics." + name.replace(".", "_"))
    return module.read
