"""The import guard compares whole top-level names; the harness, the port
and the reference load no module of JAX or of the JAX package, the
reference loads nothing of the port, and a run that finds either, up to
the moment its result is made, makes none."""

import os
import subprocess
import sys
import types

import pytest

from pt_bench import guard, run
from pt_bench.tests.tiny import ROOT, cells, run_tiny


def test_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "unity_webgpu_pathtracer_tpu", "unity_webgpu_pathtracer_tpu.ops",
            "unity_webgpu_pathtracer_torch", "unity_webgpu_pathtracer_torch.api",
            "jaxtyping", "unity_webgpu_pathtracer_tpux", "bench", "benchmark",
            "unity_webgpu_pathtracer_torch.experiments._common", "numpy"]
    assert guard.forbidden(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "unity_webgpu_pathtracer_tpu",
         "unity_webgpu_pathtracer_tpu.ops", "bench",
         "unity_webgpu_pathtracer_torch.experiments._common"])
    assert guard.forbidden(mods, extra=("unity_webgpu_pathtracer_torch",)) == sorted(
        guard.forbidden(mods) + ["unity_webgpu_pathtracer_torch",
                                 "unity_webgpu_pathtracer_torch.api"])


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print('\\n'.join(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_harness_and_port_load_no_jax():
    mods = _loaded_after("import pt_bench.run, pt_bench.port, pt_bench.trace, pt_bench.check\n"
                         "import unity_webgpu_pathtracer_torch.api")
    assert "unity_webgpu_pathtracer_torch.api" in mods
    assert guard.forbidden(mods) == []


def test_reference_loads_nothing_of_the_port():
    names = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "pt_bench", "reference"))
                   if f.endswith(".py") and f != "__init__.py")
    mods = _loaded_after("\n".join(f"import pt_bench.reference.{n}" for n in names)
                         + "\nimport pt_bench.check, pt_bench.yardstick.roofline")
    assert "pt_bench.reference.integrator" in mods
    assert guard.forbidden(mods, extra=("unity_webgpu_pathtracer_torch",)) == []


def test_reference_binding_the_port_is_found(monkeypatch):
    from pt_bench.reference import render as rrender

    import unity_webgpu_pathtracer_torch.api as api
    import unity_webgpu_pathtracer_torch.scene.scene as pscene

    assert guard.reference_imports() == []
    monkeypatch.setattr(rrender, "api", api, raising=False)
    monkeypatch.setattr(rrender, "Scene", pscene.Scene, raising=False)
    assert guard.reference_imports() == ["unity_webgpu_pathtracer_torch.api",
                                         "unity_webgpu_pathtracer_torch.scene.scene"]


def _plant_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))


def test_module_loaded_by_a_metric_reader_gives_no_result(monkeypatch):
    """A reader runs after the window and the check; what it loads still
    fails the run before a result exists."""
    from pt_bench import registry

    real = registry.reader

    def reader(name, *a):
        read = real(name, *a)

        def planting(ctx):
            _plant_jax(monkeypatch)
            return read(ctx)
        return planting

    monkeypatch.setattr(registry, "reader", reader)
    with pytest.raises(run.Forbidden):
        run_tiny(cells()[0], trace=True)


def test_reference_that_loads_jax_or_the_port_gives_no_result(monkeypatch):
    from pt_bench.reference import render as rrender

    import unity_webgpu_pathtracer_torch.scene.scene as pscene

    real = rrender.film_at

    def planting(*a, **k):
        _plant_jax(monkeypatch)
        return real(*a, **k)

    monkeypatch.setattr(rrender, "film_at", planting)
    with pytest.raises(run.Forbidden):
        run_tiny(cells()[0])
    monkeypatch.setattr(rrender, "film_at", real)
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setattr(rrender, "Scene", pscene.Scene, raising=False)
    with pytest.raises(run.Forbidden):
        run_tiny(cells()[0])


def test_cli_prints_no_result_on_a_forbidden_module(monkeypatch, capsys):
    import torch

    def forbidden(*a, **k):
        raise run.Forbidden("jax")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", forbidden)
    assert run.main(["--workload", cells()[0], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""
