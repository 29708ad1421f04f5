"""The megakernel's shading kernel (``ops/cuda_shade.py`` ->
``csrc/shade16.cu``) and its route.

On the CPU: the route's one predicate over the configurations it admits
and refuses, CPU tensors always on the plain shading, ``Renderer.stats()``
carrying ``shade_launches``, the state layout the kernel accepts, the
callers under the kernel route's in-place contract (emulated with the
plain bounce), and the build key's cover of the shared header.

On the card (``gpu``-marked; ``python -m pytest --noconftest -m gpu
tests/test_torch_shade.py`` on a machine with a GPU): the kernel against
its twin, the plain ``trace_bounce`` run on the same CUDA tensors, bit for
bit (every plane compared as integers, so NaN lanes compare by their bits)
on the 64K-triangle benchmark scene, flat and instanced: after every
bounce of a whole path, including lanes that die, pass through an alpha
material or take the NaN / zero-pdf kill; ``render_pass`` at two samples
a pass; a wavefront pass; and no shading kernel where the predicate
refuses the configuration.
"""

import contextlib
import dataclasses
import os
import shutil
import types

import numpy as np
import pytest
import torch

from unity_webgpu_pathtracer_torch.api import Renderer
from unity_webgpu_pathtracer_torch.config import (
    SKY_MODE_BASIC,
    SKY_MODE_ENVIRONMENT,
    SKY_MODE_NONE,
    RenderConfig,
)
from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
from unity_webgpu_pathtracer_torch.ops import cuda_build, cuda_shade, get_intersectors
from unity_webgpu_pathtracer_torch.render import camera as ucamera
from unity_webgpu_pathtracer_torch.render import integrator, wavefront
from unity_webgpu_pathtracer_torch.scene.lights import LightDesc
from unity_webgpu_pathtracer_torch.scene.scene import Scene
from unity_webgpu_pathtracer_torch.utils import rng as urng

torch.set_num_threads(2)

gpu = pytest.mark.gpu


def _launches() -> int:
    return sum(cuda_shade.shade16_cuda.launches.values())


# ---------------------------------------------------------------- the CPU

def _scene_on(device_type: str, lights: int = 0, instances: int = 0):
    """A stand-in for a ``SceneData``: what the predicate reads."""
    tables = types.SimpleNamespace(device=torch.device(device_type))
    return types.SimpleNamespace(attr_normals=tables, lights=torch.zeros((lights, 16)),
                                 inst_w2l=torch.zeros((instances, 12)))


ROUTES = [
    ("hdri", {}, 0, True),
    ("hdri_no_rr", dict(use_russian_roulette=False, max_bounces=3), 0, True),
    ("hdri_firefly", dict(use_firefly_filter=True), 0, True),
    ("hdri_lights_flag_no_lights", dict(has_lights=True), 0, True),
    ("wide8", dict(traversal="wide8"), 0, True),
    ("bruteforce", dict(traversal="bruteforce"), 0, True),
    ("mbvh", dict(traversal="mbvh"), 0, True),
    ("analytic_lights", dict(has_lights=True), 3, False),
    ("constant_env", dict(has_environment_texture=False), 0, False),
    ("basic_sky", dict(sky_mode=SKY_MODE_BASIC), 0, False),
    ("no_sky", dict(sky_mode=SKY_MODE_NONE), 0, False),
    ("textures", dict(has_textures=True), 0, False),
    ("normal_maps", dict(has_textures=True, has_normal_maps=True), 0, False),
    ("nan_canary", dict(debug_nan_canary=True), 0, False),
]


@pytest.mark.parametrize("name,kw,lights,want", ROUTES, ids=[r[0] for r in ROUTES])
@pytest.mark.parametrize("instances", [0, 4])
def test_route_predicate(name, kw, lights, want, instances):
    """The one predicate: CUDA tables, the HDRI, no analytic lights, no
    textures or normal maps, no canary; any backend, flat or two-level.
    The same configuration on CPU tables is always refused."""
    cfg = RenderConfig(integrator="megakernel", **kw)
    assert cfg.sky_mode == kw.get("sky_mode", SKY_MODE_ENVIRONMENT)
    assert cuda_shade.covers(cfg, _scene_on("cuda", lights, instances)) is want
    assert cuda_shade.covers(cfg, _scene_on("cpu", lights, instances)) is False


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The north-star scene's shapes at 2,000 triangles with its HDRI,
    built on the CPU into a cache of its own."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    scene, cam = million_triangle_scene(2000)
    yield scene.build("wide16", device="cpu"), cam
    mp.undo()


@pytest.mark.parametrize("integrator_", ["megakernel", "wavefront"])
@pytest.mark.parametrize("spp", [1, 2])
def test_cpu_tensors_shade_in_plain_pytorch(grid, integrator_, spp):
    """On CPU tensors every bounce takes the plain shading, under a
    configuration the kernel covers on the card: no launch is counted, and
    after a megakernel pass ``stats()`` carries ``shade_launches`` = 0
    beside its other counters."""
    sd, cam = grid
    cfg = RenderConfig(width=12, height=8, samples_per_pass=spp, max_bounces=3,
                       integrator=integrator_, pool_size=1024)
    assert not cuda_shade.covers(cfg, sd)
    r = Renderer(sd, cfg, ucamera.make_camera_params(width=12, height=8, **cam, device="cpu"),
                 device="cpu")
    before = _launches()
    r.step()
    assert _launches() == before
    st = r.stats()
    if integrator_ == "wavefront":
        assert st == {}
        return
    assert set(st) == {"closest_rays", "shadow_rays", "bounces", "k1_launches",
                       "shade_launches", "host_reads"}
    assert st["shade_launches"] == 0 and st["bounces"] >= 1 and st["shadow_rays"] > 0


def _path_state(b: int, device="cpu"):
    f32 = dict(dtype=torch.float32, device=device)
    o = torch.arange(3 * b, **f32).reshape(3, b)
    return integrator.new_path_state(o, o.flip(0).contiguous() + 1.0,
                                     torch.arange(b, dtype=torch.int64, device=device))


@pytest.mark.parametrize("case", ["owned", "transposed", "shared", "shared_with_work",
                                  "wrong_dtype", "no_work"])
def test_check_state_refuses_a_state_without_the_kernels_layout(case):
    """``check_state`` passes the planes ``new_path_state`` builds and
    refuses, without copying, a transposed plane, a plane sharing its
    storage with another field or a work plane, a wrong dtype, and a
    bounce without work planes."""
    s = _path_state(8)
    work = cuda_shade.new_work(8, "cpu")
    if case == "transposed":
        s.origin = s.origin.T.contiguous().T
    elif case == "shared":
        s.radiance = s.origin
    elif case == "shared_with_work":
        s.radiance = work.nee_radiance
    elif case == "wrong_dtype":
        s.depth = s.depth.to(torch.int64)
    elif case == "no_work":
        work = None
    before = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    if case == "owned":
        cuda_shade.check_state(s, work)
    else:
        with pytest.raises(ValueError):
            cuda_shade.check_state(s, work)
    assert all(getattr(s, f.name) is before[f.name] for f in dataclasses.fields(s))


def _emulated_kernel(works: list):
    """A stand-in for ``_trace_bounce_kernel`` on CPU tensors with the
    kernel route's contract: the state checked by ``check_state``, the
    plain bounce written into ``s`` in place and ``s`` returned, the shade
    mask in ``work.shade``, which the next bounce overwrites."""
    def bounce(scene, config, params, s, closest_fn, occluded_fn, with_stats, work):
        cuda_shade.check_state(s, work)
        works.append(work)
        out, shade = integrator._trace_bounce_plain(scene, config, params, s, closest_fn,
                                                    occluded_fn, True)
        for f in dataclasses.fields(s):
            getattr(s, f.name).copy_(getattr(out, f.name))
        work.shade.copy_(shade)
        return (s, work.shade) if with_stats else s
    return bounce


@pytest.mark.parametrize("case", ["render_pass_1spp", "render_pass_2spp", "wavefront",
                                  "path_trace_inputs"])
def test_callers_keep_only_the_returned_state(grid, monkeypatch, case):
    """The megakernel and wavefront passes under the kernel route's
    aliasing (the state updated in place, the shade mask overwritten by
    the next bounce), emulated on the CPU: the same film and counts bit
    for bit as the plain route, each caller handing every bounce one set
    of work planes (one a ``path_trace``, one a wavefront pass), and
    ``path_trace`` leaving its inputs as they were."""
    sd, cam = grid
    spp = 2 if case == "render_pass_2spp" else 1
    cfg = RenderConfig(width=12, height=8, samples_per_pass=spp, max_bounces=3,
                       integrator="wavefront" if case == "wavefront" else "megakernel",
                       pool_size=32)
    params = ucamera.make_camera_params(width=12, height=8, **cam, device="cpu")

    def run():
        if case == "wavefront":
            return wavefront.wavefront_pass_with_stats(sd, cfg, params, 1)
        if case == "path_trace_inputs":
            pix = torch.arange(96, dtype=torch.int64)
            rng = urng.seed(pix, 1, params.seed_root)
            coords, rng = ucamera.jittered_pixel_coords(pix, cfg, rng)
            o, d, rng = ucamera.get_screen_ray(coords, cfg, params, rng)
            ins = (o.T.contiguous(), d.T.contiguous(), rng)
            kept = [x.clone() for x in ins]
            out = integrator.path_trace(sd, cfg, params, *ins)
            assert all(torch.equal(x, k) for x, k in zip(ins, kept))
            return out
        st = {}
        return integrator.render_pass(sd, cfg, params, 1, stats=st), st["closest"], \
            st["shadow"], st["bounces"]

    want = run()
    works = []
    with monkeypatch.context() as m:
        m.setattr(cuda_shade, "covers", lambda config, scene: True)
        m.setattr(integrator, "_trace_bounce_kernel", _emulated_kernel(works))
        got = run()
    assert len(works) > 1
    assert len({id(w) for w in works}) == (1 if case in ("wavefront", "path_trace_inputs")
                                           else spp)
    for g, w in zip(got, want):
        _assert_bits(torch.as_tensor(g), torch.as_tensor(w), case)


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """The transition and shading libraries include ``shade_common.cuh``:
    an edit of it changes both keys, and not K1's."""
    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.SRC_DIR, src)
    monkeypatch.setattr(cuda_build, "SRC_DIR", str(src))
    flags = ["-O3"]
    before = {n: cuda_build._source_key(n, flags) for n in cuda_build.ENTRIES}
    with open(os.path.join(src, "shade_common.cuh"), "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build._source_key(n, flags) for n in cuda_build.ENTRIES}
    assert {n for n in before if before[n] != after[n]} == {"transition16", "shade16"}


# --------------------------------------------------------------- the card

W, H = 128, 96


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _instanced(flat: Scene) -> Scene:
    """``flat`` (a ``million_triangle_scene``) as a two-level scene, as
    ``models/benchmark.py::instanced_million_triangle_scene`` builds it."""
    scene = Scene(materials=list(flat.materials), env_image=flat.env_image)
    (sphere, _), (ground, ground_xf) = flat.meshes[0], flat.meshes[-1]
    sphere_id, ground_id = scene.add_mesh(sphere), scene.add_mesh(ground)
    for mesh, xf in flat.meshes[:-1]:
        scene.add_instance(sphere_id, xf, mesh.material_index)
    scene.add_instance(ground_id, ground_xf, ground.material_index)
    return scene


@pytest.fixture(scope="module")
def scenes64k(cuda):
    """The 64K-triangle benchmark scene (its wide16 table is committed
    under ``.bvh_cache``) flat and two-level, with its camera."""
    flat, cam = million_triangle_scene(64_000)
    return {"flat": flat.build("wide16", device=cuda),
            "instanced": _instanced(flat).build("wide16", device=cuda)}, cam


def _materials(sd, kind: str):
    """The scene as built, or with materials that exercise the alpha
    passthrough (a blended sphere material, a masked one cut away) and the
    NaN kill (a NaN sheen makes every BSDF value of that material NaN)."""
    if kind == "as_built":
        return sd
    m = sd.materials.clone()
    m[0, 12], m[0, 3] = 1.0, 0.6                  # ALPHA_MODE_BLEND
    m[2, 12], m[2, 3], m[2, 7] = 2.0, 0.3, 0.5    # ALPHA_MODE_MASK, below the cutoff
    m[1, 4:7] = torch.tensor([0.3, 0.1, 0.05])    # emission
    m[3, 16] = float("nan")
    return sd._replace(materials=m.contiguous())


def _setup(scenes64k, cuda, layout, materials="as_built", **kw):
    scenes, cam = scenes64k
    sd = _materials(scenes[layout], materials)
    cfg = RenderConfig(width=W, height=H, max_bounces=5, integrator="megakernel", **kw)
    params = ucamera.make_camera_params(width=W, height=H, device=cuda, **cam)
    assert cuda_shade.covers(cfg, sd)
    return sd, cfg, params


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


def _assert_bits(got, want, name):
    assert torch.equal(_bits(got), _bits(want)), (
        f"{name}: {int((_bits(got) != _bits(want)).sum())} lanes differ")


@contextlib.contextmanager
def _plain(monkeypatch):
    """Inside, the predicate refuses every configuration: the plain
    shading runs on the same CUDA tensors."""
    with monkeypatch.context() as m:
        m.setattr(cuda_shade, "covers", lambda config, scene: False)
        yield


@gpu
@pytest.mark.parametrize("lights", ["unlit", "lights_flag_no_lights"])
@pytest.mark.parametrize("materials", ["as_built", "alpha_and_nan"])
@pytest.mark.parametrize("layout", ["flat", "instanced"])
def test_kernel_bounce_equals_plain(cuda, scenes64k, monkeypatch, layout, materials, lights):
    """Every bounce of a whole path: the kernel's state and shade mask
    against the plain ``trace_bounce``'s from the same state, every plane
    bit for bit, the lanes that die, pass through or are killed included.
    ``has_lights`` on a scene without lights is covered: its plain route
    runs ``intersect_analytic_lights`` on an empty table, which the kernel
    skips."""
    sd, cfg, params = _setup(scenes64k, cuda, layout, materials,
                             has_lights=lights == "lights_flag_no_lights")
    assert sd.lights.shape[0] == 0
    work = cuda_shade.new_work(W * H, cuda)
    pix = torch.arange(W * H, dtype=torch.int64, device=cuda)
    rng = urng.seed(pix, 7, params.seed_root)
    coords, rng = ucamera.jittered_pixel_coords(pix, cfg, rng)
    o, d, rng = ucamera.get_screen_ray(coords, cfg, params, rng)
    s = integrator.new_path_state(o.T.contiguous(), d.T.contiguous(), rng)
    closest_fn, occluded_fn = get_intersectors(cfg)
    seen = dict(died=0, passthrough=0, killed=0, nan=0, bounces=0)
    while bool(s.alive.any()):
        mine = integrator.PathState(**{f.name: getattr(s, f.name).clone()
                                       for f in dataclasses.fields(s)})
        before = _launches()
        got, got_shade = integrator.trace_bounce(sd, cfg, params, mine, closest_fn,
                                                 occluded_fn, with_stats=True, work=work)
        assert got is mine and _launches() == before + 2
        with _plain(monkeypatch):
            want, want_shade = integrator.trace_bounce(sd, cfg, params, s, closest_fn,
                                                       occluded_fn, with_stats=True)
        for f in dataclasses.fields(want):
            _assert_bits(getattr(got, f.name), getattr(want, f.name),
                         f"bounce {seen['bounces']} {f.name}")
        _assert_bits(got_shade, want_shade, f"bounce {seen['bounces']} shade")
        seen["died"] += int((s.alive & ~want.alive).sum())
        seen["passthrough"] += int((s.alive & ~want_shade & want.alive).sum())
        seen["killed"] += int((want_shade & ~want.alive & (want.depth == s.depth)).sum())
        seen["nan"] += int((want_shade & torch.isnan(want.prev_pdf)).sum())
        seen["bounces"] += 1
        s = want
    assert seen["bounces"] >= 3 and seen["died"] == W * H
    if materials == "alpha_and_nan":
        assert seen["passthrough"] > 0 and seen["killed"] > 0, seen


@gpu
@pytest.mark.parametrize("layout", ["flat", "instanced"])
def test_render_pass_two_samples_equals_plain(cuda, scenes64k, monkeypatch, layout):
    """``render_pass`` at two samples a pass (the second sample's camera
    jitter draws from the state the first left): the kernel route's sum
    equals the plain route's bit for bit, two launches a bounce."""
    sd, cfg, params = _setup(scenes64k, cuda, layout, samples_per_pass=2)
    before = _launches()
    st = {}
    got = integrator.render_pass(sd, cfg, params, 3, stats=st)
    assert _launches() - before == 2 * st["bounces"] > 0
    with _plain(monkeypatch):
        want = integrator.render_pass(sd, cfg, params, 3)
    _assert_bits(got, want, "render_pass")


@gpu
@pytest.mark.parametrize("layout", ["flat", "instanced"])
def test_wavefront_pass_equals_plain(cuda, scenes64k, monkeypatch, layout):
    """A wavefront pass (a pool smaller than the film, refilled between
    bounces): the kernel route's film and counts equal the plain route's."""
    sd, cfg, params = _setup(scenes64k, cuda, layout)
    cfg = dataclasses.replace(cfg, integrator="wavefront", pool_size=4096)
    before = _launches()
    got = wavefront.wavefront_pass_with_stats(sd, cfg, params, 2)
    assert _launches() > before
    with _plain(monkeypatch):
        want = wavefront.wavefront_pass_with_stats(sd, cfg, params, 2)
    for name, g, w in zip(("film", "occupancy", "closest", "shadow"), got, want):
        _assert_bits(g, w, name)


@gpu
@pytest.mark.parametrize("case", ["analytic_lights", "textures", "normal_maps", "nan_canary",
                                  "basic_sky"])
def test_out_of_cover_launches_no_shade_kernel(cuda, scenes64k, case):
    """Configurations the predicate refuses shade in plain PyTorch on the
    card: a pass launches no shading kernel, and its stats say so."""
    scenes, cam = scenes64k
    sd = scenes["flat"]
    kw = dict(analytic_lights=dict(has_lights=True), textures=dict(has_textures=True),
              normal_maps=dict(has_textures=True, has_normal_maps=True),
              nan_canary=dict(debug_nan_canary=True), basic_sky=dict(sky_mode=SKY_MODE_BASIC))
    if case == "analytic_lights":
        flat, _ = million_triangle_scene(64_000)
        flat.add_light(LightDesc(position=(0.0, 3.0, 0.0), intensity=5.0, range=30.0))
        sd = flat.build("wide16", device=cuda)
    cfg = RenderConfig(width=W, height=H, max_bounces=3, integrator="megakernel", **kw[case])
    assert not cuda_shade.covers(cfg, sd)
    r = Renderer(sd, cfg, ucamera.make_camera_params(width=W, height=H, device=cuda, **cam),
                 device=cuda)
    before = _launches()
    r.step()
    st = r.stats()
    assert _launches() == before and st["shade_launches"] == 0 and st["bounces"] >= 1
    assert np.isfinite(r.film.accum.cpu().numpy()).all()


@gpu
def test_stats_show_every_bounce_through_the_kernel(cuda, scenes64k):
    """A megakernel pass on a covered configuration through ``Renderer``:
    two shading launches a bounce, K1's launches beside them."""
    sd, cfg, params = _setup(scenes64k, cuda, "flat")
    r = Renderer(sd, cfg, params, device=cuda)
    r.step()
    st = r.stats()
    assert st["shade_launches"] == 2 * st["bounces"] > 0 and st["k1_launches"] > 0
