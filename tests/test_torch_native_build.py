"""The port's own native BVH library and the tests' hold on the reference's.

* ``accel/native.py::_load`` compiles ``native/bvh_builder.cpp`` into the
  port's build directory once, however many processes ask at the same
  time, and every one of them loads the same whole file.
* The port never reads ``native/libtpubvh.so``, the reference's in-place
  build, so a partial file there does not touch it.
* ``tests/torch_native.py`` gives a reference binding that kept a failed
  load, or has not loaded yet, the port's whole library, and leaves one
  that loaded its own alone.
* Every port test that imports the JAX package imports that helper, and
  the port runs no ``make`` and names no library under ``native/``.
"""

import glob
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests import torch_native
from unity_webgpu_pathtracer_torch.accel import native as tnative
from unity_webgpu_pathtracer_tpu.accel import native as jnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "unity_webgpu_pathtracer_torch")
F2H_INPUTS = np.array([0.0, -0.0, 1.0, -1.0, 65504.0, 65520.0, 1e30, np.inf, np.nan,
                       6.103515625e-05, 5.960464477539063e-08, 2.0**-25], np.float32)

# One process: the port's binding loaded from its file (no package import,
# so no torch), built into the directory given, reporting what it did.
_LOADER = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("uwpt_native", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native.BUILD_DIR = sys.argv[2]
ok = native._load() is not None
print(json.dumps(dict(native.BUILD_INFO, ok=ok)))
"""


def _whole_library() -> bytes:
    """The port's library, whose leading bytes stand for a file a linker is
    still writing."""
    assert tnative.available(), tnative.BUILD_INFO["error"]
    with open(tnative.BUILD_INFO["path"], "rb") as f:
        return f.read()


def _canon(x: np.ndarray) -> np.ndarray:
    """The port's numpy f32 -> f16 bits, which the builder's f2h equals."""
    from unity_webgpu_pathtracer_torch.accel import wide16 as tw16

    with np.errstate(over="ignore", invalid="ignore"):
        return tw16._canon_f16(x.astype(np.float16))


def test_concurrent_loads_compile_once(tmp_path):
    """Four processes load at once into an empty build directory: one
    compiles, all four load the same path, and no temporary file stays."""
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _LOADER, tnative.__file__, str(build)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    infos = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err
        infos.append(json.loads(out.strip().splitlines()[-1]))
    assert all(i["ok"] for i in infos), infos
    assert sum(i["compiled"] for i in infos) == 1, infos
    paths = {i["path"] for i in infos}
    assert len(paths) == 1, infos
    path = paths.pop()
    assert os.path.dirname(path) == str(build)
    assert os.path.basename(path) == os.path.basename(tnative.lib_path())
    assert sorted(os.listdir(build)) == sorted([os.path.basename(path), "libtpubvh.lock"])


def test_port_loads_beside_a_partial_reference_library(tmp_path, monkeypatch):
    """A third of a library at ``native/libtpubvh.so`` (the reference's
    build, cut short) beside the shared source: the port compiles its own
    copy and loads it, and the partial file is never opened."""
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    shutil.copy(tnative.SRC_PATH, native_dir / "bvh_builder.cpp")
    whole = _whole_library()
    (native_dir / "libtpubvh.so").write_bytes(whole[: len(whole) // 3])
    monkeypatch.setattr(tnative, "NATIVE_DIR", str(native_dir))
    monkeypatch.setattr(tnative, "SRC_PATH", str(native_dir / "bvh_builder.cpp"))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "BUILD_INFO", dict(path=None, compiled=False, seconds=0.0,
                                                    error=""))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    opened = []
    real_cdll = tnative.ctypes.CDLL
    monkeypatch.setattr(tnative.ctypes, "CDLL", lambda p, *a, **k: (opened.append(p),
                                                                  real_cdll(p, *a, **k))[1])
    assert tnative.available(), tnative.BUILD_INFO["error"]
    assert tnative.BUILD_INFO["compiled"]
    assert opened == [tnative.BUILD_INFO["path"]]
    assert os.path.dirname(opened[0]) == str(tmp_path / "build")
    np.testing.assert_array_equal(tnative.native_f2h_or_none(F2H_INPUTS),
                                  _canon(F2H_INPUTS))


@pytest.mark.parametrize("fault", ["no_compiler", "compile_error"])
def test_unbuildable_library_falls_back_with_the_reason(tmp_path, monkeypatch, fault):
    """Without ``g++``, or when the compile fails, the library counts as
    missing, no file is left in the build directory, and the numpy
    build's warning names the directory and the compiler's reason."""
    from tests.test_wide8 import random_tris, recs_of
    from unity_webgpu_pathtracer_torch.accel import wide16 as tw16

    build = tmp_path / "build"
    monkeypatch.setattr(tnative, "BUILD_DIR", str(build))
    monkeypatch.setattr(tnative, "BUILD_INFO", dict(path=None, compiled=False, seconds=0.0,
                                                    error=""))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    if fault == "no_compiler":
        monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
        reason = "g++ not found"
    else:
        monkeypatch.setattr(tnative, "CXX_FLAGS", [*tnative.CXX_FLAGS, "-fno-such-option"])
        reason = "-fno-such-option"
    assert not tnative.available()
    assert reason in tnative.BUILD_INFO["error"] and tnative.BUILD_INFO["path"] is None
    assert not build.exists() or sorted(os.listdir(build)) == ["libtpubvh.lock"]
    monkeypatch.setenv("UWPT_BVH_CACHE", "0")
    tris = random_tris(50, seed=1)
    with pytest.warns(UserWarning, match="native BVH builder is unavailable") as caught:
        tw16.build_scene_wide16(tris, recs_of(tris))
    msg = str(caught[0].message)
    assert str(build) in msg and reason in msg


@pytest.mark.parametrize("state", ["failed", "untried", "loaded"])
def test_helper_gives_the_reference_a_whole_library(tmp_path, monkeypatch, state):
    """``failed``: the reference's load of a 40-byte partial library failed
    and it keeps the failure; ``untried``: it has not loaded yet and its
    library is missing, so it would run ``make``.  Both get the port's
    library, and no ``make`` runs.  ``loaded``: a library the reference
    loaded itself stays."""
    assert jnative.native_available()
    own = jnative._LIB
    monkeypatch.setattr(jnative, "_LIB", own if state == "loaded" else None)
    monkeypatch.setattr(jnative, "_TRIED", state == "loaded")
    path = str(tmp_path / "libtpubvh.so")
    monkeypatch.setattr(jnative, "_LIB_PATH", path)
    monkeypatch.setattr(jnative.subprocess, "run", lambda *a, **k: pytest.fail("make ran"))
    if state == "failed":
        (tmp_path / "libtpubvh.so").write_bytes(_whole_library()[:40])
        assert jnative.native_f2h_or_none(F2H_INPUTS) is None
        assert jnative._TRIED and jnative._LIB is None
    torch_native.steady_reference()
    if state == "loaded":
        assert jnative._LIB is own and jnative._LIB_PATH == path
    else:
        assert jnative._LIB_PATH == tnative.BUILD_INFO["path"]
    got = jnative.native_f2h_or_none(F2H_INPUTS)
    assert got is not None
    np.testing.assert_array_equal(got, tnative.native_f2h_or_none(F2H_INPUTS))
    torch_native.assert_native_pair()


_HELPER = re.compile(r"^(from tests import torch_native\b|from tests\.torch_native import|"
                     r"import tests\.torch_native\b)", re.M)


def test_every_comparing_test_file_loads_the_helper():
    files = [f for f in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py"))
             if re.search(r"^\s*(from|import) unity_webgpu_pathtracer_tpu\b",
                          open(f).read(), re.M)]
    assert len(files) >= 30
    missing = [os.path.basename(f) for f in files if not _HELPER.search(open(f).read())]
    assert missing == []


def test_port_runs_no_make_and_names_no_reference_library():
    found = []
    for path in glob.glob(os.path.join(PORT, "**", "*.*"), recursive=True):
        if "_build" in path.split(os.sep) or not path.endswith((".py", ".cu", ".h")):
            continue
        text = open(path).read()
        for pat in (r"make\s+-C", r"[\"']make[\"']", r"libtpubvh\.so"):
            if re.search(pat, text):
                found.append((os.path.relpath(path, REPO), pat))
    assert found == []
    src = open(os.path.join(PORT, "accel", "native.py")).read()
    assert "sleep" not in src
