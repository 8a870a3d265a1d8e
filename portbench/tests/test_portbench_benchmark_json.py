"""``BENCHMARK.json`` keeps to the contract's keys, names and units, and
every file it implies exists."""

from __future__ import annotations

import json
import re

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return spec.benchmark()


def test_top_level_keys_and_sizes():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert len(bench["command"]) <= 32


def test_every_name_and_unit_keeps_to_its_characters():
    bench = _bench()
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for group in (bench["configs"], bench["workloads"],
                  bench["end_to_end"] + bench["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_every_cell_has_its_files_and_reports_enough():
    bench = _bench()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = spec.cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
            assert callable(spec.metric_reader(m["name"]))
        assert callable(spec.driver(cell.traffic["driver"]).run)
        assert set(cell.limits) == {"max_gap"}
        entry = cell.limits["max_gap"]
        assert entry["lower"] < entry["limit"] < entry["upper"]
        assert entry["upper"] >= 3 * entry["lower"]
    for c in bench["configs"]:
        data = spec.load_json(spec.ROOT / c["file"])
        assert data["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in bench["workloads"])
