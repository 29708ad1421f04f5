"""The reference's glass and gray furnace tests (``tests/test_furnace.py``)
on the port, with the helpers and sizes of ``test_torch_furnace.py`` (a
file of its own, so that the test runner can spread the renders)."""

import numpy as np
import pytest

from tests.test_torch_furnace import (
    GLASS,
    MATERIALS,
    _albedo_curve,
    _bvh_cache_elsewhere,  # noqa: F401  (autouse: tables into a temporary cache)
    _erode,
    _predicted_image,
    _render_sphere,
)


def test_furnace_glass_energy():
    """Glass: no energy creation at any angle by quadrature, and the
    multi-interface render stays in an energy-conserving band; the
    background (the eroded pixels that miss the sphere) is exact."""
    _mus, rhos = _albedo_curve(GLASS)
    assert rhos.max() < 1.05, f"glass albedo {rhos.max():.3f}"
    img = _render_sphere(GLASS, spp=64, bounces=12)
    assert np.isfinite(img).all()
    assert 0.90 < img.mean() < 1.08, img.mean()
    _pred, inside = _predicted_image(np.array([0.0, 1.0]), np.ones(2))
    assert img.mean(axis=-1)[_erode(~inside, 3)].mean() == pytest.approx(1.0, abs=1e-3)


def test_gray_furnace_absorbs():
    """The albedo-0.5 sphere sits at the quadrature prediction, well below
    the environment."""
    mus, rhos = _albedo_curve(MATERIALS["gray_diffuse"])
    img = _render_sphere(MATERIALS["gray_diffuse"])
    mean_img = img.mean(axis=-1)
    pred, inside = _predicted_image(mus, rhos)
    core = _erode(inside, 3)
    err = abs(mean_img[core].mean() - pred[core].mean()) / pred[core].mean()
    assert err < 0.05, (mean_img[core].mean(), pred[core].mean())
    assert img.max() < 1.35
