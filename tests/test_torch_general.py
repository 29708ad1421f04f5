"""The port's general transition (``render/fused.py::_transition``, the
path of every configuration but the HDRI on a flat scene) against the
reference's ``_transition``, and the Cornell box (no sky, mesh emission)
against the reference's fused pass and the ``cornell`` golden.

Transition states are captured from real port passes (the state just
before one transition), handed to both packages, and every field of the
state after it is compared.  Contract: integer fields (modes, traversal
and instance registers, RNG states, depths, lane budgets, pixels, queue
and record cursors, record keys, ray count) equal; float fields within
rtol 1e-5 / atol 1e-6 on >= 99.5% of elements and every element within
rtol 1e-3 / atol 1e-5 (XLA's sin/cos/pow/rsqrt and PyTorch's differ by an
ulp, and ``1 - x*x - y*y`` cancels at grazing angles; see
``tests/test_torch_transition.py``).  Whole pass: the
``tests/test_torch_fused.py`` contract.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from tests import golden_common
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.models.cornell import cornell_box as tcornell
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params as tcamera
from unity_webgpu_pathtracer_torch.scene.scene import scene_from_numpy
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.models import examples as jexamples
from unity_webgpu_pathtracer_tpu.models.benchmark import million_triangle_scene, procedural_hdri
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box as jcornell
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as jtw
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params as jcamera

torch.set_num_threads(2)

_jax_transition = jax.jit(jfused._transition, static_argnums=(1, 4))

TABLE_FIELDS = ("wide16_nodes", "wide16_top", "stack_levels", "attr_shade_c", "materials",
                "inst_l2w", "inst_w2l", "inst_offsets")
W, H = 24, 16
CAPTURE_AT = 5     # the transition whose input state is captured


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _arrays(sd) -> dict:
    out = {f: np.asarray(getattr(sd, f)) for f in TABLE_FIELDS}
    out["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    return out


def _scene(name):
    """(JAX SceneData, camera kwargs, config kwargs, uniforms)."""
    uniforms = {}
    if name == "cornell":
        scene, cam = jcornell()
        return scene.build("wide16"), cam, dict(sky_mode=2), uniforms
    if name == "instanced":
        scene, cam, _ = jexamples.tlas_scene(n=4)
        scene.set_environment(procedural_hdri(32))
        return (scene._build_instanced_wide16(), cam,
                dict(sky_mode=0, has_environment_texture=True), uniforms)
    scene, cam = million_triangle_scene(2000)
    sd = scene.build("wide16")
    if name == "hdri":
        return sd, cam, dict(sky_mode=0, has_environment_texture=True), uniforms
    if name == "constant":
        uniforms = dict(environment_color=np.float32([0.6, 0.7, 0.8]),
                        environment_intensity=np.float32(1.3),
                        max_firefly_luminance=np.float32(0.5))
        return sd, cam, dict(sky_mode=0, has_environment_texture=False,
                             use_firefly_filter=True, debug_nan_canary=True), uniforms
    return sd, cam, dict(sky_mode=1, has_environment_texture=False), uniforms


class _Stop(Exception):
    pass


def _capture(tsd, tcfg, tparams):
    """The port's state just before transition CAPTURE_AT of a pass."""
    got = {}
    calls = [0]

    def recorder(fn):
        def rec(scene, config, params, s, budget, current_sample):
            calls[0] += 1
            if calls[0] == CAPTURE_AT:
                # The transitions read trav_done from the arrivals' ptr.
                got.update(s=copy.deepcopy(s), trav_done=s.trav.ptr < 0, budget=budget)
                raise _Stop
            return fn(scene, config, params, s, budget, current_sample)
        return rec

    mp = pytest.MonkeyPatch()
    mp.setattr(tfused, "_transition", recorder(tfused._transition))
    mp.setattr(tfused, "_transition_kernel_path", recorder(tfused._transition_kernel_path))
    try:
        tfused.fused_pass_with_stats(tsd, tcfg, tparams, 0)
    except _Stop:
        pass
    finally:
        mp.undo()
    assert got, "the pass ended before the capture"
    return got


def _to_jax(s: tfused.FusedState):
    """The port's FusedState as the reference's (vectors (B, 3))."""
    def a(x):
        return jnp.asarray(x.numpy())

    tr = s.trav
    jtrav = jtw.Wide16State(**{f: a(getattr(tr, f)) for f in tr._fields
                               if not f.startswith("local_")},
                            **{f: a(getattr(tr, f).T) for f in tr._fields
                               if f.startswith("local_")})
    b = s.mode.shape[0]
    return jfused.FusedState(
        mode=a(s.mode), trav=jtrav, trav_o=a(s.trav_o.T), trav_d=a(s.trav_d.T),
        path_o=a(s.path_o.T), path_d=a(s.path_d.T), hit_t=a(s.hit_t),
        hit_uv_bary=a(s.hit_uv_bary.T), hit_tri=a(s.hit_tri), hit_inst=a(s.hit_inst),
        pending=a(s.pending.T), throughput=a(s.throughput.T), radiance=a(s.radiance.T),
        rng=jnp.asarray(s.rng.numpy().astype(np.uint32)), pixel=a(s.pixel),
        depth=a(s.depth), max_roughness=a(s.max_roughness), prev_pdf=a(s.prev_pdf),
        lane_cap=a(s.lane_cap), film=jnp.zeros((1, 3), jnp.float32),
        queue_head=jnp.int32(int(s.queue_head)), arrivals=jnp.uint32(int(s.arrivals)),
        rays=jnp.int32(int(s.rays)), busy=jnp.int32(int(s.busy)),
        ticks=jnp.int32(int(s.ticks)), rec_pending=jnp.zeros((b,), bool),
        rec_keys=a(s.rec_keys), rec_v0=a(s.rec_rgb[0]), rec_v1=a(s.rec_rgb[1]),
        rec_v2=a(s.rec_rgb[2]), rec_cursor=jnp.int32(int(s.rec_cursor)))


def _pairs(got: tfused.FusedState, want):
    """(name, port array, reference array in the port's layout)."""
    out = []
    for f in got.trav._fields:
        w = np.asarray(getattr(want.trav, f))
        out.append((f"trav.{f}", getattr(got.trav, f).numpy(),
                    w.T if f.startswith("local_") else w))
    for f in ("mode", "hit_t", "hit_tri", "hit_inst", "pixel", "depth", "max_roughness",
              "prev_pdf", "lane_cap", "queue_head", "rays", "rec_keys", "rec_cursor"):
        out.append((f, getattr(got, f).numpy(), np.asarray(getattr(want, f))))
    for f in ("trav_o", "trav_d", "path_o", "path_d", "hit_uv_bary", "pending",
              "throughput", "radiance"):
        out.append((f, getattr(got, f).numpy(), np.asarray(getattr(want, f)).T))
    out.append(("rng", got.rng.numpy().astype(np.uint32), np.asarray(want.rng)))
    out.append(("rec_rgb", got.rec_rgb.numpy(),
                np.stack([np.asarray(want.rec_v0), np.asarray(want.rec_v1),
                          np.asarray(want.rec_v2)])))
    return out


@pytest.mark.parametrize("name", ["hdri", "constant", "basic", "cornell", "instanced"])
def test_general_transition_matches_reference(name):
    jsd, cam, cfg_kw, uniforms = _scene(name)
    common = dict(width=W, height=H, samples_per_pass=4, max_bounces=5, pool_size=1024,
                  transition_every=4, **cfg_kw)
    jcfg = jconfig.RenderConfig(traversal="wide16", integrator="fused", attr_compact=2,
                                **common)
    tcfg = tconfig.RenderConfig(**common)
    tsd = scene_from_numpy(_arrays(jsd), device="cpu")
    tparams = tcamera(width=W, height=H, **cam, **uniforms, device="cpu")
    jparams = jcamera(width=W, height=H, **cam, **uniforms)
    cap = _capture(tsd, tcfg, tparams)
    s = copy.deepcopy(cap["s"])
    tfused._transition(tsd, tcfg, tparams, s, cap["budget"], 0)
    want = _jax_transition(jsd, jcfg, jparams, _to_jax(cap["s"]), cap["budget"], 0,
                           jnp.asarray(cap["trav_done"].numpy()))
    modes = np.bincount(cap["s"].mode.numpy(), minlength=4)
    print(name, "lane modes before", modes, "after", np.bincount(s.mode.numpy(), minlength=4))
    assert (modes[[0, 3]] > 0).all()
    for field, g, w in _pairs(s, want):
        assert g.shape == w.shape, field
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=field)
            close = np.isclose(g, w, rtol=1e-5, atol=1e-6).mean()
            assert close >= 0.995, (field, close)
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                          err_msg=field)


def test_cornell_pass_matches_reference():
    w = h = 32
    scene, cam = jcornell()
    sd = scene.build("wide16")
    common = dict(width=w, height=h, samples_per_pass=4, max_bounces=4, pool_size=1024,
                  transition_every=4, sky_mode=2)
    jcfg = jconfig.RenderConfig(traversal="wide16", integrator="fused", attr_compact=2,
                                use_pallas_arrival=True, use_pallas_transition=True, **common)
    step = jax.jit(jfused.fused_pass_with_stats, static_argnums=(1,))
    jfilm, jocc, jrays, jarr = step(sd, jcfg, jcamera(width=w, height=h, **cam), 0)
    tfilm, tocc, trays, tarr, iters = tfused.fused_pass_with_stats(
        scene_from_numpy(_arrays(sd), device="cpu"), tconfig.RenderConfig(**common),
        tcamera(width=w, height=h, **cam, device="cpu"), 0)
    print(f"rays port {int(trays)} reference {int(jrays)}; arrivals port {int(tarr)} "
          f"reference {int(jarr)}; super-iterations {iters}")
    assert abs(int(trays) - int(jrays)) <= 0.005 * int(jrays)
    assert abs(int(tarr) - int(jarr)) <= 0.005 * int(jarr)
    assert abs(float(tocc) - float(jocc)) <= 0.005
    got, want = tfilm.numpy(), np.asarray(jfilm)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    print(f"pixels diverged beyond rtol 1e-4: {int((~close).sum())} of {close.size}")
    assert close.mean() >= 0.99 and want.mean() > 0
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


def test_cornell_golden():
    """The port's passes at the golden configuration (64x64, 32 spp, 4
    bounces, pool 4096, firefly clamp at luminance 2, the test seeds)."""
    scene, cam = tcornell()
    size, spp = golden_common.SIZE, golden_common.SPP
    cfg = tconfig.RenderConfig(width=size, height=size, samples_per_pass=spp, max_bounces=4,
                               pool_size=4096, use_firefly_filter=True, sky_mode=2)
    sd = scene.build(device="cpu")
    passes = []
    for seed in golden_common.seed_roots(golden_common.TEST_SEED_BASE,
                                         golden_common.N_TEST_PASSES):
        params = tcamera(width=size, height=size, **cam, seed_root=np.uint32(seed),
                         max_firefly_luminance=np.float32(2.0), device="cpu")
        film, *_ = tfused.fused_pass_with_stats(sd, cfg, params, 0)
        passes.append(film.numpy().reshape(size, size, 3) / spp)
    ok, stats = golden_common.compare_to_golden(np.stack(passes), "cornell")
    print(stats)
    assert ok, stats


def test_update_material_changes_image_and_resets():
    """``Renderer.update_material`` (the ``tests/test_dynamic.py`` check):
    a red sphere under the constant environment turns green and the film
    restarts."""
    from unity_webgpu_pathtracer_torch.api import Renderer
    from unity_webgpu_pathtracer_torch.models import primitives
    from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
    from unity_webgpu_pathtracer_torch.scene.scene import Scene

    size = 32
    scene = Scene()
    m = scene.add_material(MaterialDesc(base_color=(0.8, 0.2, 0.2, 1), roughness=0.6))
    scene.add_mesh(primitives.uv_sphere(radius=1.0, stacks=12, slices=24, material_index=m))
    cfg = tconfig.RenderConfig(width=size, height=size, samples_per_pass=8, max_bounces=2,
                               pool_size=1024, sky_mode=0, has_environment_texture=False)
    r = Renderer(scene, cfg, tcamera(eye=(0, 0, 3), target=(0, 0, 0), fov_y_deg=45,
                                     width=size, height=size, device="cpu",
                                     environment_color=np.float32([1.0, 1.0, 1.0])),
                 device="cpu")
    r.render(2)
    before = r.radiance().copy()
    assert r.sample_count == 16
    r.update_material(0, MaterialDesc(base_color=(0.1, 0.9, 0.1, 1), roughness=0.6))
    assert r.sample_count == 0 and r.stats() == {}
    r.render(2)
    after = r.radiance()
    center = (slice(12, 20), slice(12, 20))
    assert after[center][..., 1].mean() > before[center][..., 1].mean()
    assert after[center][..., 0].mean() < before[center][..., 0].mean()


def test_hdri_config_refuses_scene_without_hdri():
    """Sky mode 0 with ``has_environment_texture`` on a scene that has no
    HDRI raises instead of sampling the scene's 1x1 placeholder table."""
    from unity_webgpu_pathtracer_torch.api import Renderer
    from unity_webgpu_pathtracer_torch.models import primitives
    from unity_webgpu_pathtracer_torch.scene.scene import Scene

    scene = Scene()
    scene.add_mesh(primitives.uv_sphere(radius=1.0, stacks=6, slices=12))
    cfg = tconfig.RenderConfig(width=8, height=8, pool_size=1024)
    assert cfg.sky_mode == 0 and cfg.has_environment_texture
    r = Renderer(scene, cfg, tcamera(eye=(0, 0, 3), target=(0, 0, 0), fov_y_deg=45,
                                     width=8, height=8, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="has none"):
        r.render(1)
