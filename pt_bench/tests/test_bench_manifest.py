"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import os
import re

import pytest

from pt_bench import registry
from pt_bench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# The fused check's numbers (pt_bench/check.py): K2, K1, the new samples,
# the records, the film.
FUSED_NUMBERS = {"k2_rng_off", "k2_off_share", "k1_hit_off_share",
                 "k1_t_gap_median", "k1_occl_off_share", "regen_off", "regen_ray_gap_max",
                 "rec_count_off", "rec_gap_max", "film_samples_off", "film_gap_max"}


@pytest.fixture(scope="module")
def manifest():
    return registry.load_manifest(ROOT)


def test_top_level_keys(manifest):
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["pt_bench"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(manifest["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fit_24_cells(manifest):
    """A full check of 24 cells fits its 43,200 seconds."""
    cells = 24
    need = (2 + 14 * cells) * (manifest["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_names_units_and_text(manifest):
    named = manifest["configs"] + manifest["workloads"] + manifest["end_to_end"] \
        + manifest["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    names = [e["name"] for e in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for c in manifest["configs"]:
        assert 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("pt_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])


def test_end_to_end_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_each_cell_reports_what_it_must(manifest):
    for w in manifest["workloads"]:
        cell = registry.cell(manifest, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            # The metric a per-layer metric moves is reported in its cell.
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert os.path.exists(os.path.join(registry.BENCH_DIR, "metrics", f"{m['name']}.py"))
        want = FUSED_NUMBERS if cell.traffic["integrator"] == "fused" else {"px_err_median",
                                                                            "px_bad_share"}
        assert set(cell.check["limits"]) >= want


def test_per_layer_workloads_name_cells(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    # Metrics of one layer name it alike.
    assert all(len(v) == 1 for v in layers.values())


def test_configuration_files_hold_what_runs(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert {"generator", "render", "materials", "assumed"} <= set(cfg)
