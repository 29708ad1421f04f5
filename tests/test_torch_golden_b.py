"""The port's passes at the golden configuration held to the committed
goldens of ``aperture`` (thin lens), ``brdf`` and ``sponza_like`` (the
HDRI scenes, through kernel K2's route: its plain version on the CPU); see
``tests/test_torch_golden_a.py`` for the configuration and why ``tlas`` is
left out."""

import pytest

from tests.test_torch_golden_a import _bvh_cache_elsewhere, check_golden  # noqa: F401


@pytest.mark.parametrize("name", ["aperture", "brdf", "sponza_like"])
def test_golden(name):
    check_golden(name)
