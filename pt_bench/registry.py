"""The benchmark's manifest and the files it names: a configuration is its
``file`` (``pt_bench/configs/<config>.json``), a traffic mix
``pt_bench/workloads/<traffic>.json``, a cell's check
``pt_bench/workloads/cells/<cell>.json`` and a per-layer metric's reader
``pt_bench/metrics/<metric>.py``.  Adding any of them is adding a file and
an entry of ``BENCHMARK.json``; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    check: dict
    end_to_end: list          # manifest entries this cell reports with --trace 0
    per_layer: list           # ... and with --trace 1


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_manifest(root: str) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: no manifest")
    return _json(path)


def cell(manifest: dict, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(work)})")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = _json(os.path.join(os.path.dirname(bench_dir), conf["file"]))
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"],
                traffic=_json(os.path.join(bench_dir, "workloads", f"{w['traffic']}.json")),
                check=_json(os.path.join(bench_dir, "workloads", "cells", f"{name}.json")),
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The ``read(ctx)`` function of a per-layer metric's reader file."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"pt_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
