"""BENCHMARK.json and the harness's files: every cell, configuration,
traffic mix, limit and metric is found by name, and the file keeps to
the contract's shape."""

import json
import os
import re
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from yardstick import spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        cfg = spec.config(ROOT, bench, w["config"])
        assert cfg["name"] == w["config"]
        traffic = spec.traffic(BENCH, w["traffic"])
        assert traffic["kind"] in ("stream", "stills")
        assert spec.limits(BENCH, w["name"])
        for m in spec.end_to_end(bench, w["name"]) + spec.per_layer(bench, w["name"]):
            assert callable(spec.reader(BENCH, m["name"]))
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


def test_every_config_is_used_and_files_resolve(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert spec.config(ROOT, bench, c["name"])["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and c["source"].startswith("https://")


def test_names_units_and_sources(bench):
    names = []
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["source"] in SOURCES
        assert m["moves"] in names
        names.append(m["name"])
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        mine = [m["name"] for m in spec.end_to_end(bench, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        layers = spec.per_layer(bench, w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in mine, (w["name"], m["name"])


def test_layers_name_the_same_layer_alike(bench):
    by_prefix = {}
    for m in bench["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_limit_files_state_readings():
    for f in os.listdir(os.path.join(BENCH, "limits")):
        with open(os.path.join(BENCH, "limits", f)) as fh:
            d = json.load(fh)
        assert set(d["limits"]) == {"px_diff_pct"}
