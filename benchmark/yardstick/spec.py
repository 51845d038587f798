"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root names the cell, its configuration (whose ``file`` it gives) and
its traffic mix; the harness's own directory holds

    traffic/<traffic>.json     the mix's parameters
    limits/<cell>.json         the limit of each number the check compares
    metrics/<metric>.py        one reader a metric: ``read(run)``

so a cell, a mix or a metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List


class SpecError(Exception):
    pass


def load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"missing file: {path}") from e


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload named {name!r} in BENCHMARK.json")


def config(root: str, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise SpecError(f"no configuration named {name!r} in BENCHMARK.json")


def config_dir(root: str, bench: dict, name: str) -> str:
    for c in bench["configs"]:
        if c["name"] == name:
            return os.path.dirname(os.path.join(root, c["file"]))
    raise SpecError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(here: str, name: str) -> dict:
    return load_json(os.path.join(here, "traffic", name + ".json"))


def limits(here: str, cell_name: str) -> Dict[str, float]:
    lim = load_json(os.path.join(here, "limits", cell_name + ".json"))
    return {k: float(v) for k, v in lim["limits"].items()}


def _applies(metric: dict, cell_name: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    reported = [m["name"] for m in end_to_end(bench, cell_name)]
    return [m for m in bench["per_layer"] if _applies(m, cell_name, reported)]


def reader(here: str, metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    path = os.path.join(here, "metrics", metric + ".py")
    if not os.path.exists(path):
        raise SpecError(f"no reader for metric {metric!r}: {path}")
    mod_spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
