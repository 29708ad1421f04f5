"""The harness finds a cell, its traffic, its check and its metric readers
by name: a later PR adds them as files and entries, editing nothing."""

import json
import os
import shutil

from pt_bench import registry
from pt_bench.tests import tiny
from pt_bench.tests.tiny import ROOT


def test_dropped_in_cell_and_metric(tmp_path):
    bench = tmp_path / "pt_bench"
    shutil.copytree(registry.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    manifest = registry.load_manifest(ROOT)
    manifest["workloads"].append({"name": "grid1m.dummy", "config": "grid1m",
                                  "traffic": "dummy", "chips": 1, "why": "a test cell"})
    manifest["per_layer"].append({"name": "dummy.count", "unit": "n", "better": "lower",
                                  "source": "host_clock", "layer": "dummy",
                                  "moves": "msamples_per_s", "workloads": ["grid1m.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = json.loads((bench / "workloads" / "mega_1spp.json").read_text())
    traffic["width"] = 64
    (bench / "workloads" / "dummy.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "cells" / "grid1m.dummy.json").write_text(
        json.dumps({"limits": {"px_err_median": 1.0, "px_bad_share": 1.0}}))
    (bench / "metrics" / "dummy.count.py").write_text("def read(ctx):\n    return 7.0\n")

    found = registry.cell(registry.load_manifest(str(tmp_path)), "grid1m.dummy", str(bench))
    assert found.traffic["width"] == 64 and found.config["generator"] == "sphere_grid"
    assert [m["name"] for m in found.per_layer] == ["dummy.count"]
    assert {m["name"] for m in found.end_to_end} >= {"msamples_per_s", "setup_s"}
    assert registry.reader("dummy.count", str(bench))(None) == 7.0
    assert os.path.exists(bench / "metrics" / "k1.roofline_pct.py")


def test_every_reader_of_the_manifest_loads():
    for m in tiny.manifest()["per_layer"]:
        assert callable(registry.reader(m["name"]))
