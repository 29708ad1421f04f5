import pytest


@pytest.fixture(autouse=True)
def _bvh_cache(tmp_path_factory, monkeypatch):
    """The port's table cache of a test run in a directory of its own."""
    monkeypatch.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.getbasetemp() / "bvh"))
