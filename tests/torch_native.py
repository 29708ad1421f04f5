"""Both packages' native BVH builders, loaded whole, in every test process.

Every ``tests/test_torch_*.py`` that imports the JAX package imports this
module first, so under xdist each worker runs it while it collects, before
any test runs.  It loads the port's library (``accel/native.py``: compiled
once under a lock and renamed into place whole).  The reference's binding
builds ``native/libtpubvh.so`` in place with ``make``, so a process can
find the file half written, and it keeps a failed load for the life of the
process and then builds every table in numpy.  Where the reference has not
loaded a library, or kept a failure, it is pointed at the port's copy: the
same source compiled with the same flags, so the tables under comparison
still come from each package's own binding, emitters and ordering.  A
library the reference already loaded stays.  No file another process may
still be writing is opened here, not even to test it.

``assert_native_pair`` and the ``native_pair`` fixture make a comparison
of native builds fail with its cause when either binding has no library,
where it would otherwise fail with a byte difference.
"""

from __future__ import annotations

import pytest

from unity_webgpu_pathtracer_torch.accel import native as tnative
from unity_webgpu_pathtracer_tpu.accel import native as jnative


def steady_reference() -> None:
    """Point the reference's binding at the port's library unless it has
    loaded one of its own."""
    if tnative._load() is None:
        return      # assert_native_pair then fails with the compiler's reason
    if jnative._TRIED and jnative._LIB is not None:
        return
    jnative._LIB_PATH = tnative.BUILD_INFO["path"]
    jnative._TRIED, jnative._LIB = False, None


def assert_native_pair() -> None:
    """Both packages build with the native builder in this process."""
    assert tnative.available(), \
        f"the port's native library did not build or load: {tnative.BUILD_INFO['error']}"
    assert jnative.native_available(), \
        f"the reference's native binding did not load {jnative._LIB_PATH}"


@pytest.fixture
def native_pair(monkeypatch, tmp_path):
    """Both native builders loaded, and the BVH cache in this test's own
    directory, so no table another process cached stands in for a build."""
    assert_native_pair()
    monkeypatch.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path))


steady_reference()
