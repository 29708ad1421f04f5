"""The port's temporal reprojection (``render/reproject.py``), per-pixel
films (``render/film.py``) and preview renderer (``render/preview.py``)
against the reference's, on the CPU, at 24x24 (32x32 for the preview) on
the Cornell box with the wide16 tables: the reference traces with its XLA
traversal, the port with kernel K1's plain twin.

Contract:
- ``_center_rays`` within 1e-6 (XLA's 3x3 product contracts into FMAs and
  moves an ulp in a few lanes); ``primary_depth``: misses equal, ``t``
  within rtol 1e-5.
- ``_warp`` on the same depths and rays: equal, counts and accum bit for
  bit, to the reference evaluated eagerly (``jax.disable_jit``); against
  its jitted ``_warp`` (XLA's FMA contraction moves the bilinear weights
  by ulps) accum within rtol/atol 1e-5 (at most 3.7e-6 apart) and counts equal on >= 97% of pixels, the others one lower or
  higher: a count quotient a hair under an integer truncates one lower
  (11, 5 and 3 of 576 pixels on the identity, the move and the move
  clamped to 12; ROADMAP.md queue 3).
- ``reproject_film`` whole: counts equal on >= 97% of pixels and within
  one sample everywhere, accum within rtol/atol 1e-5 where they agree.
- ``accumulate`` on per-pixel counts: within rtol 1e-6 (XLA contracts the
  multiply-add).
- The reference's behavioural checks (``tests/test_reproject.py``) on
  the port, and per-pixel checkpoints crossing between the packages.
- ``preview``: >= 99% of pixels within rtol/atol 1e-5, the rest counted
  (a silhouette lane where an ulp of ``t`` picks another triangle; none
  at these sizes: at most 3.2e-6 apart), means within 1e-4 relative; the reference's colour check
  (``tests/test_features.py:129-145``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.api import Renderer
from unity_webgpu_pathtracer_torch.models import examples as texamples
from unity_webgpu_pathtracer_torch.models.cornell import cornell_box
from unity_webgpu_pathtracer_torch.render import camera as tcamera
from unity_webgpu_pathtracer_torch.render import film as tfilm
from unity_webgpu_pathtracer_torch.render import reproject as trep
from unity_webgpu_pathtracer_torch.render.preview import preview
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE
from unity_webgpu_pathtracer_tpu.api import Renderer as JRenderer
from unity_webgpu_pathtracer_tpu.models import examples as jexamples
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box as jcornell_box
from unity_webgpu_pathtracer_tpu.render import camera as jcamera
from unity_webgpu_pathtracer_tpu.render import film as jfilm
from unity_webgpu_pathtracer_tpu.render import preview as jpreview
from unity_webgpu_pathtracer_tpu.render import reproject as jrep

torch.set_num_threads(2)

SIZE = 24
CFG = dict(width=SIZE, height=SIZE, samples_per_pass=8, max_bounces=3, sky_mode=2,
           traversal="wide16", integrator="fused", pool_size=512)


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _cams(cam):
    """The camera, a small move and the reversed camera
    (``tests/test_reproject.py``)."""
    eye = np.asarray(cam["eye"], np.float64)
    target = np.asarray(cam["target"], np.float64)
    moved = dict(cam, eye=tuple(eye + np.array([0.02, 0.01, 0.0])))
    flipped = dict(cam, eye=tuple(target + (target - eye)),
                   target=tuple(2 * target - eye + (target - eye)))
    return {"identity": cam, "move": moved, "reverse": flipped}


@pytest.fixture(scope="module")
def both():
    """Both packages' Cornell tables, configs and cameras."""
    jscene, cam = jcornell_box()
    tscene, _ = cornell_box()
    jsd = jscene.build("wide16")
    tsd = tscene.build("wide16", device="cpu")
    jcfg = jconfig.RenderConfig(**CFG)
    tcfg = tconfig.RenderConfig(**CFG)
    cams = _cams(cam)
    jp = {k: jcamera.make_camera_params(width=SIZE, height=SIZE, **c) for k, c in cams.items()}
    tp = {k: tcamera.make_camera_params(width=SIZE, height=SIZE, **c, device="cpu")
          for k, c in cams.items()}
    return jsd, tsd, jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def depths(both):
    """Each view's centre rays and depths from both packages:
    ``{view: (jax (o, d, t), port (o, d, t))}``."""
    jsd, tsd, jcfg, tcfg, jp, tp = both
    out = {}
    for view in jp:
        jo, jd = (np.asarray(x) for x in jrep._center_rays(jcfg, jp[view]))
        to, td = trep._center_rays(tcfg, tp[view])
        out[view] = ((jo, jd, np.asarray(jrep.primary_depth(jsd, jcfg, jp[view]))),
                     (to.numpy(), td.numpy(), trep.primary_depth(tsd, tcfg, tp[view]).numpy()))
    return out


def _seeded_film(seed=4, uniform=None):
    """A film of seeded radiance, with per-pixel counts in [0, 16) or one
    count ``uniform``."""
    rng = np.random.default_rng(seed)
    accum = rng.uniform(0, 2, (SIZE, SIZE, 3)).astype(np.float32)
    if uniform is not None:
        return accum, np.asarray(uniform, np.int32)
    return accum, rng.integers(0, 16, (SIZE, SIZE, 1)).astype(np.int32)


def _films(accum, counts):
    j = jfilm.Film(jnp.asarray(accum), jnp.asarray(counts))
    if counts.ndim == 0:
        return j, tfilm.Film(torch.from_numpy(accum.copy()), int(counts))
    return j, tfilm.Film(torch.from_numpy(accum.copy()), int(counts.max()),
                         torch.from_numpy(counts.copy()))


@pytest.mark.parametrize("view", ["identity", "move", "reverse"])
def test_primary_depth_matches_reference(depths, view):
    (jo, jd, want), (to, td, got) = depths[view]
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6)
    miss = want >= FAR_PLANE
    np.testing.assert_array_equal(got >= FAR_PLANE, miss)
    assert miss.all() == (view == "reverse")   # the closed box, or its back
    np.testing.assert_allclose(got[~miss], want[~miss], rtol=1e-5)


@pytest.mark.parametrize("view,max_history", [("identity", None), ("move", None),
                                              ("move", 12), ("reverse", None)])
def test_warp_on_shared_depths_matches_reference(both, depths, view, max_history):
    """The 4-tap warp fed the reference's depths and rays on both sides."""
    *_, jp, tp = both
    accum, counts = _seeded_film()
    o_new, d_new, t_new = depths[view][0]
    t_old = depths["identity"][0][2]
    count = counts.astype(np.float32).reshape(-1)
    mh = np.float32(max_history if max_history is not None else 2 ** 30)
    wh = np.asarray([SIZE, SIZE], np.float32)
    old = jp["identity"]
    args = (jnp.asarray(accum), jnp.asarray(count), jnp.asarray(t_new), jnp.asarray(t_old),
            jnp.asarray(o_new), jnp.asarray(d_new), old.cam_to_world, old.cam_inv_proj,
            jnp.asarray(wh), jnp.float32(0.03), mh)
    want_a, want_c = (np.asarray(x) for x in jrep._warp(*args))
    with jax.disable_jit():
        eager_a, eager_c = (np.asarray(x) for x in jrep._warp(*args))
    got_a, got_c = trep._warp(
        *(torch.from_numpy(np.array(x)) for x in (accum, count, t_new, t_old, o_new, d_new)),
        tp["identity"].cam_to_world, tp["identity"].cam_inv_proj, torch.from_numpy(wh),
        torch.tensor(0.03), torch.tensor(mh))
    assert got_c.dtype == torch.int32 and tuple(got_c.shape) == (SIZE, SIZE, 1)
    np.testing.assert_array_equal(got_c.numpy(), eager_c)
    np.testing.assert_array_equal(got_a.numpy(), eager_a)
    same = got_c.numpy() == want_c
    print(f"{view}, max_history {max_history}: counts differ from the jitted reference in "
          f"{int((~same).sum())} of {same.size} pixels")
    assert same.mean() >= 0.97 and np.abs(got_c.numpy() - want_c).max() <= 1
    np.testing.assert_allclose(got_a.numpy(), want_a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("view,uniform", [("identity", None), ("move", None),
                                          ("reverse", None), ("identity", 8)])
def test_reproject_film_matches_reference(both, view, uniform):
    jsd, tsd, jcfg, tcfg, jp, tp = both
    jf, tf = _films(*_seeded_film(uniform=uniform))
    want = jrep.reproject_film(jsd, jcfg, jf, jp["identity"], jp[view], max_history=None)
    got = trep.reproject_film(tsd, tcfg, tf, tp["identity"], tp[view])
    wc, gc = np.asarray(want.sample_count), got.pixel_counts.numpy()
    assert gc.shape == wc.shape == (SIZE, SIZE, 1)
    assert got.sample_count == int(gc.max()) and abs(got.sample_count - int(wc.max())) <= 1
    same = gc == wc
    print(f"{view}: counts differ in {int((~same).sum())} of {same.size} pixels")
    assert same.mean() >= 0.97 and np.abs(gc - wc).max() <= 1
    np.testing.assert_allclose(got.accum.numpy()[same[..., 0]],
                               np.asarray(want.accum)[same[..., 0]], rtol=1e-5, atol=1e-5)


def test_accumulate_per_pixel_matches_reference():
    accum, counts = _seeded_film(seed=9)
    pass_sum = np.random.default_rng(10).uniform(0, 8, accum.shape).astype(np.float32)
    jf, tf = _films(accum, counts)
    want = jfilm.accumulate(jf, jnp.asarray(pass_sum), 4)
    got = tfilm.accumulate(tf, torch.from_numpy(pass_sum), 4)
    np.testing.assert_array_equal(got.pixel_counts.numpy(), np.asarray(want.sample_count))
    assert got.sample_count == int(counts.max()) + 4
    np.testing.assert_allclose(got.accum.numpy(), np.asarray(want.accum), rtol=1e-6)


# ---- the reference's behavioural checks (tests/test_reproject.py) ----

def _renderer(tp, passes, film=None):
    scene, _cam = cornell_box()
    r = Renderer(scene, tconfig.RenderConfig(**CFG), tp, device="cpu")
    if film is not None:
        r.film = film
    r.render(passes)
    return r


@pytest.fixture(scope="module")
def two_passes(both):
    """A Cornell film of two passes (16 spp); films are not updated in
    place, so the tests share it."""
    return _renderer(both[-1]["identity"], 2).film


def test_identity_reprojection_exact(both, two_passes):
    *_, tp = both
    r = _renderer(tp["identity"], 0, two_passes)
    warped = trep.reproject_film(r.scene, r.config, r.film, tp["identity"], tp["identity"])
    # Neighbour taps get ~2e-7 of weight, so black pixels beside bright
    # ones pick up ~1e-6.
    np.testing.assert_allclose(warped.accum.numpy(), r.film.accum.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert int(warped.pixel_counts.min()) == r.sample_count == warped.sample_count
    assert tuple(warped.pixel_counts.shape) == (SIZE, SIZE, 1)


def test_small_move_carries_history(both):
    *_, tp = both
    r = _renderer(tp["identity"], 4)
    warped = trep.reproject_film(r.scene, r.config, r.film, tp["identity"], tp["move"])
    counts = warped.pixel_counts.numpy()[..., 0]
    assert (counts > 0).mean() > 0.7, "most pixels should survive a tiny move"
    fresh = _renderer(tp["move"], 4)
    valid = counts > 0
    ma, mb = warped.accum.numpy()[valid].mean(), fresh.radiance()[valid].mean()
    assert abs(ma - mb) / max(mb, 1e-6) < 0.15, (ma, mb)


def test_reverse_move_disoccludes_everything(both, two_passes):
    *_, tp = both
    r = _renderer(tp["identity"], 0, two_passes)
    warped = trep.reproject_film(r.scene, r.config, r.film, tp["identity"], tp["reverse"])
    assert (warped.pixel_counts.numpy() == 0).mean() > 0.9


def test_update_camera_reproject_then_step(both, two_passes):
    """Every integrator seeds its next pass from the largest count; the
    fused pass's film equals a pass seeded from that count by hand."""
    *_, tp = both
    r = _renderer(tp["identity"], 0, two_passes)
    moved = tp["move"]
    r.update_camera(moved, reproject=True, max_history=12)
    assert tuple(r.film.pixel_counts.shape) == (SIZE, SIZE, 1)
    before = r.sample_count
    assert before == int(r.film.pixel_counts.max()) <= 12
    film = r.film
    r.step()
    assert r.sample_count == before + CFG["samples_per_pass"]
    assert torch.equal(r.film.pixel_counts, film.pixel_counts + CFG["samples_per_pass"])
    assert np.isfinite(r.radiance()).all()
    from unity_webgpu_pathtracer_torch.render.fused import fused_pass_with_stats

    total = fused_pass_with_stats(r.scene, r.config, r.params, before)[0]
    want = tfilm.accumulate(film, total.reshape(SIZE, SIZE, 3), CFG["samples_per_pass"])
    assert torch.equal(r.film.accum, want.accum)
    r.reset()
    assert r.film.pixel_counts is None and r.sample_count == 0
    r.update_camera(moved)   # no reprojection: accumulation restarts
    assert r.sample_count == 0 and r.film.pixel_counts is None


@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
def test_other_integrators_seed_from_the_largest_count(both, integrator):
    *_, tp = both
    scene, _ = cornell_box()
    cfg = tconfig.RenderConfig(width=8, height=8, samples_per_pass=1, max_bounces=2,
                               sky_mode=2, integrator=integrator, traversal="bruteforce")
    p = tcamera.make_camera_params(width=8, height=8, device="cpu", **cornell_box()[1])
    r = Renderer(scene, cfg, p, device="cpu")
    counts = np.arange(64, dtype=np.int32).reshape(8, 8, 1) % 5
    film = tfilm.Film(torch.rand(8, 8, 3, generator=torch.Generator().manual_seed(1)), 4,
                      torch.from_numpy(counts))
    r.film = film
    r.step()
    step = r.film
    r.film = tfilm.Film(film.accum, 4)   # the same pass base, uniform counts
    r.step()
    n = torch.from_numpy(counts).float()
    total = r.film.accum * 5.0 - film.accum * 4.0   # the pass's sum, by the scalar update
    want = (total + film.accum * n) / (n + 1.0)
    torch.testing.assert_close(step.accum, want, rtol=1e-5, atol=1e-5)
    assert step.sample_count == 5 and torch.equal(step.pixel_counts,
                                                  torch.from_numpy(counts) + 1)


def test_checkpoint_roundtrip_per_pixel_counts(both, two_passes, tmp_path):
    *_, tp = both
    r = _renderer(tp["identity"], 0, two_passes)
    r.update_camera(tp["identity"], reproject=True)
    path = str(tmp_path / "film.npz")
    r.save_checkpoint(path)
    with np.load(path) as data:
        assert data["sample_count"].dtype == np.int32
        assert data["sample_count"].shape == (SIZE, SIZE, 1)
    r2 = Renderer(cornell_box()[0], tconfig.RenderConfig(**CFG), tp["identity"], device="cpu")
    r2.load_checkpoint(path)
    assert torch.equal(r2.film.accum, r.film.accum)
    assert torch.equal(r2.film.pixel_counts, r.film.pixel_counts)
    assert r2.sample_count == r.sample_count
    r2.step()
    assert np.isfinite(r2.radiance()).all() and r2.sample_count == r.sample_count + 8


def test_per_pixel_checkpoints_cross_packages(tmp_path):
    """A reprojected film written by the reference loads and resumes in
    the port, and the port's loads and resumes in the reference: both
    resume to the same film (the megakernel on the brute-force oracle)."""
    accum, counts = _seeded_film(seed=12)
    accum, counts = accum[:6, :10], counts[:6, :10]
    jfilm.save(str(tmp_path / "j.npz"), jfilm.Film(jnp.asarray(accum), jnp.asarray(counts)))
    scene, cam = cornell_box()
    over = dict(width=10, height=6, samples_per_pass=1, max_bounces=2, sky_mode=2,
                traversal="bruteforce", integrator="megakernel")
    r = Renderer(scene, tconfig.RenderConfig(**over),
                 tcamera.make_camera_params(width=10, height=6, **cam, device="cpu"),
                 device="cpu")
    r.load_checkpoint(str(tmp_path / "j.npz"))
    assert r.sample_count == int(counts.max())
    assert np.array_equal(r.radiance(), accum)
    assert np.array_equal(r.film.pixel_counts.numpy(), counts)
    r.save_checkpoint(str(tmp_path / "t.npz"))
    jr = JRenderer(jcornell_box()[0], jconfig.RenderConfig(**over),
                   jcamera.make_camera_params(width=10, height=6, **cam), compile_cache=False)
    jr.load_checkpoint(str(tmp_path / "t.npz"))
    assert np.asarray(jr.film.sample_count).dtype == np.int32
    assert np.array_equal(np.asarray(jr.film.sample_count), counts)
    assert jr.sample_count == r.sample_count and np.array_equal(jr.radiance(), accum)
    r.step()
    jr.step()
    np.testing.assert_array_equal(r.film.pixel_counts.numpy(), np.asarray(jr.film.sample_count))
    np.testing.assert_allclose(r.radiance(), jr.radiance(), rtol=0, atol=1e-5)


# ---- the preview (render/preview.py) ----

_jax_preview = jax.jit(jpreview.preview, static_argnums=(1,))


@pytest.mark.parametrize("name", ["cornell", "texture"])
def test_preview_matches_reference(name):
    size = 32
    if name == "cornell":
        (jsc, cam), (tsc, _) = jcornell_box(), cornell_box()
        over = dict(sky_mode=2)
    else:
        jsc, cam, over = jexamples.texture_scene()
        tsc = texamples.texture_scene()[0]
    cfg = dict(width=size, height=size, traversal="wide16", **over)
    want = np.asarray(_jax_preview(jsc.build("wide16"), jconfig.RenderConfig(**cfg),
                                   jcamera.make_camera_params(width=size, height=size, **cam)))
    got = preview(tsc.build("wide16", device="cpu"), tconfig.RenderConfig(**cfg),
                  tcamera.make_camera_params(width=size, height=size, **cam, device="cpu"))
    got = got.numpy()
    assert got.shape == (size, size, 3) and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-5, atol=1e-5).all(-1)
    print(f"{name}: {int((~close).sum())} of {close.size} pixels beyond rtol/atol 1e-5, "
          f"max abs {np.abs(got - want).max():g}")
    assert close.mean() >= 0.99
    assert abs(got.mean() - want.mean()) <= 1e-4 * abs(want.mean())


def test_preview_colours():
    """The reference's check: the red wall on the left, the green on the
    right."""
    scene, cam = cornell_box()
    size = 32
    cfg = tconfig.RenderConfig(width=size, height=size, sky_mode=2)
    img = preview(scene.build("wide16", device="cpu"), cfg,
                  tcamera.make_camera_params(width=size, height=size, **cam,
                                             device="cpu")).numpy()
    assert img.shape == (size, size, 3) and np.isfinite(img).all()
    assert img[16, 2, 0] > img[16, 2, 1]
    assert img[16, -3, 1] > img[16, -3, 0]
