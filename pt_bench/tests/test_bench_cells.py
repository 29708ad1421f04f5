"""Each cell's path at a tiny size on the CPU: set-up, window, traced
passes and the check, ending in a result of the contract's shape."""

import json
import subprocess
import sys

import pytest

from pt_bench.tests.tiny import ROOT, cell, cells, run_tiny


@pytest.mark.parametrize("name", cells())
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_tiny(name, trace):
    result, lines = run_tiny(name, trace)
    json.dumps(result)
    assert list(result)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "cpu"
    want = cell(name).per_layer if trace else cell(name).end_to_end
    got = set(result["metrics"])
    if trace:
        # Device readings are absent on the CPU; the host's are there.
        assert got <= {m["name"] for m in want}
        assert {"setup.scene_s", "setup.kernels_s"} <= got
        assert "busy_s" in result["device"] and "breakdown" in result
    else:
        assert got == {m["name"] for m in want}
        assert all(v["value"] > 0 for k, v in result["metrics"].items() if k != "peak_mem_gib")
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    # The compared numbers are the last lines on standard error.
    assert [x.split()[1] for x in lines[-len(result["check"]):]] == list(result["check"])


def test_cli_refuses_without_a_card():
    """Without the CUDA devices a cell asks for, the command exits non-zero
    and prints no result."""
    out = subprocess.run([sys.executable, "-m", "pt_bench.run", "--workload", cells()[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_cli_refuses_in_a_checkout_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and pt_bench, the command
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{ROOT}/pt_bench", tmp_path / "pt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "pt_bench.run", "--workload", cells()[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", cells())
def test_cli_on_the_card(name):
    """Each cell through the command on the card: a result line, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < cell(name).chips:
        pytest.skip(f"{name} needs {cell(name).chips} CUDA devices")
    out = subprocess.run([sys.executable, "-m", "pt_bench.run", "--workload", name,
                          "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
