"""The port's host build against the reference's ``SceneData``, the
numpy bridge between them, the BVH cache key, the config's refusals, and
the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_native import assert_native_pair, native_pair  # noqa: F401  (fixture)
from unity_webgpu_pathtracer_torch.accel import wide16 as tw16
from unity_webgpu_pathtracer_torch.config import RenderConfig
from unity_webgpu_pathtracer_torch.models import benchmark as tbench
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
from unity_webgpu_pathtracer_torch.scene.scene import scene_from_numpy, scene_to_numpy
from unity_webgpu_pathtracer_tpu.models import benchmark as jbench

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_FIELDS = ("image", "cdf", "cdf_sum", "alias_prob", "alias_idx",
              "alias_row", "quad_rows", "merged_rows")


def jax_arrays(sd) -> dict:
    """A JAX ``SceneData`` as the numpy dict ``scene_from_numpy`` reads."""
    out = {f: np.asarray(getattr(sd, f)) for f in
           ("wide16_nodes", "wide16_top", "stack_levels", "attr_shade_c", "materials")}
    out["env"] = {f: np.asarray(getattr(sd.env, f)) for f in ENV_FIELDS}
    return out


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """The reference's native build, into a cache of its own."""
    assert_native_pair()
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    try:
        scene, _cam = jbench.million_triangle_scene(2000)
        return jax_arrays(scene.build("wide16"))
    finally:
        mp.undo()


def _same_bytes(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, name
    assert a.tobytes() == b.tobytes(), name


def test_host_build_byte_identical(native_pair, jax_scene):  # noqa: F811
    """The port's own build (native SBVH into an empty cache) equals the
    reference's tables byte for byte."""
    before = dict(tw16.CACHE_STATS)
    scene, _cam = tbench.million_triangle_scene(2000)
    got = scene.build_arrays()
    assert tw16.CACHE_STATS["miss"] == before["miss"] + 1
    for f in ("wide16_nodes", "wide16_top", "attr_shade_c", "materials"):
        _same_bytes(got[f], jax_scene[f], f)
    assert got["stack_levels"].shape == jax_scene["stack_levels"].shape
    for f in ENV_FIELDS:
        _same_bytes(got["env"][f], jax_scene["env"][f], f"env.{f}")


def test_scene_from_numpy_round_trip(jax_scene):
    sd = scene_from_numpy(jax_scene, device="cpu")
    assert sd.stack_depth == jax_scene["stack_levels"].shape[0]
    back = scene_to_numpy(sd)
    for f in ("wide16_nodes", "wide16_top", "attr_shade_c", "materials"):
        _same_bytes(back[f], jax_scene[f], f)
    for f in ENV_FIELDS:
        _same_bytes(back["env"][f], jax_scene["env"][f], f"env.{f}")


def test_cache_key_names_the_committed_table():
    """The 1M-triangle bench scene's key is the reference's and names the
    committed table, so the card loads it instead of building an SBVH.
    Basenames: tests point UWPT_BVH_CACHE_DIR elsewhere."""
    from unity_webgpu_pathtracer_tpu.accel import native as jnative
    from unity_webgpu_pathtracer_tpu.accel.wide16 import _bvh_cache_path

    assert jnative.native_available()   # the reference keys on the builder's source
    jflat = jbench.million_triangle_scene(1_000_000)[0].flatten()
    want = _bvh_cache_path(jflat.positions, jflat.tri_records(), 4, 1, False)
    tflat = tbench.million_triangle_scene(1_000_000)[0].flatten()
    got = tw16.bvh_cache_path(tflat.positions, tflat.tri_records())
    assert os.path.basename(got) == os.path.basename(want)
    assert os.path.exists(os.path.join(REPO, ".bvh_cache", os.path.basename(got)))


@pytest.mark.parametrize("knob", [
    # attr_compact=3 stores no uv: refused with textures or normal maps, as
    # the reference does.
    # The fused integrator has no route for mbvh/bvh2/skip/bruteforce (the
    # reference's never ends on them); every integrator refuses unknown
    # backends and octant counts other than 1 and 8.
    dict(traversal="skip"), dict(integrator="megakernel", traversal="wide4"),
    dict(attr_compact=3, has_textures=True),
    dict(sky_mode=3), dict(attr_compact=4), dict(attr_compact=3, has_normal_maps=True),
    dict(integrator="fused", traversal="bruteforce"), dict(traversal="mbvh"),
    dict(traversal="bvh2"), dict(integrator="wavefront", bvh_octants=4),
    dict(integrator="pallas"),
    dict(transition_every=0), dict(film_k_shift=-1), dict(use_lane_film=True),
])
def test_config_refuses_unported_knobs(knob):
    with pytest.raises(ValueError):
        RenderConfig(**knob)


@pytest.mark.parametrize("knob", ["has_lights", "has_textures", "has_normal_maps",
                                  "use_depth_of_field"])
def test_config_admits_ported_features(knob):
    assert getattr(RenderConfig(**{knob: True}), knob)


def test_params_from_numpy_refuses_unported_fields():
    cam = dict(eye=(0.0, 1.0, 5.0), target=(0.0, 0.0, 0.0), fov_y_deg=45.0,
               width=8, height=8)
    p = make_camera_params(**cam, seed_root=np.uint32(0xFFFFFFFF), device="cpu")
    assert p.seed_root.dtype == torch.int64 and int(p.seed_root) == 0xFFFFFFFF
    p = make_camera_params(**cam, aperture=0.1, focal_length=3.0, device="cpu")
    assert float(p.aperture) == np.float32(0.1) and float(p.focal_length) == 3.0
    with pytest.raises(ValueError, match="no_such_uniform"):
        make_camera_params(**cam, no_such_uniform=0.1, device="cpu")


def test_port_imports_no_jax():
    """Every module of the port imports in a clean interpreter without
    loading JAX (in-process is impossible: conftest imports JAX)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import unity_webgpu_pathtracer_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "new = ('render.integrator', 'render.wavefront', 'render.hitinfo', 'render.lights',\n"
        "       'scene.obj', 'scene.gltf', 'ops', 'render.reproject', 'render.preview',\n"
        "       'viewer', 'parallel.film_tiling', 'utils.profiling', 'experiments.multigpu',\n"
        "       'accel.wide8', 'accel.cwbvh', 'accel.mbvh', 'ops.traverse_wide8',\n"
        "       'accel.linearize', 'accel.wide', 'accel.wide2', 'accel.tlas',\n"
        "       'ops.traverse_mbvh', 'ops.traverse_skip', 'ops.traverse_wide',\n"
        "       'ops.traverse_wide2')\n"
        "assert all(p.__name__ + '.' + m in mods for m in new), mods\n"
        "assert 'jax' not in sys.modules\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
