"""The output end of the port's main path against the reference: the
tonemap operators and the presentation chain (``post/tonemap.py``, rtol
1e-6, atol 1e-7 for values near 0), the PNG encoder (byte-identical), PNG
and HDR round trips (``tests/test_image.py``'s checks), ``Renderer.image``
against the reference's ``present`` on the same film, and ``cli render``
on the CPU (``tests/test_cli.py``'s check).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch import cli as tcli
from unity_webgpu_pathtracer_torch.config import PostParams as TPost
from unity_webgpu_pathtracer_torch.post import tonemap as ttm
from unity_webgpu_pathtracer_torch.utils import image as tim
from unity_webgpu_pathtracer_tpu.config import PostParams as JPost
from unity_webgpu_pathtracer_tpu.post import tonemap as jtm
from unity_webgpu_pathtracer_tpu.utils import image as jim

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-7)


def _film(h=40, w=56, seed=0):
    """Seeded linear radiance with exact zeros, a dark band and highlights."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 6, (h, w, 3)).astype(np.float32)
    x[0, :8] = 0.0
    x[1] = rng.uniform(0, 0.01, (w, 3))
    x[2, :4] = 50.0
    return x


@pytest.mark.parametrize("op", ["linear_to_srgb", "srgb_to_linear", "aces", "filmic",
                                "lottes", "reinhard"])
def test_operator_matches_reference(op):
    x = _film()
    want = np.asarray(getattr(jtm, op)(jnp.asarray(x)))
    got = getattr(ttm, op)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("srgb", [True, False])
def test_present_matches_reference(mode, srgb):
    """Every tonemap mode, sRGB on and off, with exposure, contrast,
    brightness, saturation and vignette away from their defaults, and at
    the defaults."""
    x = _film(seed=mode)
    for kw in (dict(exposure=1.3, brightness=1.2, contrast=1.1, saturation=0.8, vignette=0.3),
               {}):
        want = np.asarray(jtm.present(jnp.asarray(x), JPost(mode=mode, srgb=srgb, **kw)))
        got = ttm.present(torch.from_numpy(x), TPost(mode=mode, srgb=srgb, **kw)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert got.min() >= 0 and got.max() <= 1


def test_encode_png_byte_identical():
    rng = np.random.default_rng(3)
    for img in (rng.integers(0, 256, (17, 23, 3), np.uint8),
                rng.integers(0, 256, (9, 4, 4), np.uint8),
                rng.integers(0, 256, (5, 6), np.uint8),
                rng.uniform(-0.2, 1.2, (8, 8, 3)).astype(np.float32)):
        assert tim.encode_png(img) == jim.encode_png(img)


def test_png_roundtrip_rgb(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, size=(33, 47, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    tim.write_png(p, img)
    np.testing.assert_array_equal(tim.read_png(p), img)


def test_png_roundtrip_float(tmp_path):
    img = np.linspace(0, 1, 16 * 16 * 3, dtype=np.float32).reshape(16, 16, 3)
    p = str(tmp_path / "t.png")
    tim.write_png(p, img)
    np.testing.assert_allclose(tim.read_png(p).astype(np.float32) / 255.0, img,
                               atol=1 / 255.0 + 1e-6)


def test_hdr_roundtrip(tmp_path):
    img = (np.random.default_rng(1).uniform(size=(17, 23, 3)) * 100.0).astype(np.float32)
    img[0, 0] = 0.0
    p = str(tmp_path / "t.hdr")
    tim.write_hdr(p, img)
    back = tim.read_hdr(p)
    assert (np.abs(back - img) <= img.max(axis=-1, keepdims=True) / 256.0 + 1e-4).all()
    jp = str(tmp_path / "j.hdr")
    jim.write_hdr(jp, img)
    assert open(p, "rb").read() == open(jp, "rb").read()
    np.testing.assert_array_equal(back, jim.read_hdr(p))


def test_renderer_image_matches_reference(tmp_path):
    """``Renderer.image`` (row 0 = top) on a rendered film equals the
    reference's presentation of the same film, flipped and rounded as its
    ``Renderer.image`` does; ``save_png`` writes what ``image`` returns."""
    from unity_webgpu_pathtracer_torch.api import Renderer
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.examples import quad_scene
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    size = 24
    scene, cam, over = quad_scene()
    r = Renderer(scene, RenderConfig(width=size, height=size, samples_per_pass=2, max_bounces=2,
                                     pool_size=1024, **over),
                 make_camera_params(width=size, height=size, **cam, device="cpu"), device="cpu")
    r.render(1)
    film = r.radiance()
    for post in (dict(), dict(mode=3, exposure=2.0, vignette=0.4), dict(mode=0, srgb=False)):
        out = jtm.present(jnp.asarray(film), JPost(**post))
        want = np.asarray((jnp.clip(out, 0, 1) * 255 + 0.5).astype(jnp.uint8))[::-1]
        got = r.image(TPost(**post))
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)
    p = str(tmp_path / "r.png")
    r.save_png(p)
    np.testing.assert_array_equal(tim.read_png(p), r.image())
    # Row 0 is the top: the quad lies below the horizon, the sky above it.
    img = r.image().astype(np.float32)
    assert img[:4].mean() != img[-4:].mean()


def test_cli_render_quad(tmp_path, capsys):
    out = str(tmp_path / "quad.png")
    r = tcli.main(["render", "builtin:quad", "--size", "32", "--spp", "4", "--device", "cpu",
                   "--out", out])
    assert os.path.exists(out) and capsys.readouterr().out.strip() == out
    img = tim.read_png(out)
    assert img.shape == (32, 32, 3) and img.max() > 0
    assert r.sample_count == 4 and r.config.width == 32
    np.testing.assert_array_equal(img, r.image())


def test_cli_examples_and_refusals(capsys):
    from unity_webgpu_pathtracer_torch.models.examples import EXAMPLES

    tcli.main(["examples"])
    assert capsys.readouterr().out.split() == [f"builtin:{n}" for n in EXAMPLES]
    assert set(EXAMPLES) == {"cornell", "quad", "texture", "lights", "rect_lights", "aperture",
                             "brdf", "tlas", "sponza_like"}
    with pytest.raises(SystemExit, match="unrecognized scene spec"):
        tcli.main(["render", "model.ply", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unsupported settings"):
        tcli.main(["render", "builtin:quad", "--traversal", "skip", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unsupported settings"):
        tcli.main(["render", "builtin:quad", "--traversal", "bruteforce", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown builtin"):
        tcli.main(["render", "builtin:nope", "--device", "cpu"])
