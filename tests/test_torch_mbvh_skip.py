"""The reference's ``mbvh``/``bvh2`` and ``skip`` backends in the port
(``accel/__init__.py``, ``accel/native.py``, ``accel/linearize.py``,
``ops/traverse_mbvh.py``, ``ops/traverse_skip.py``, ``Scene.build``)
against the reference's, on the CPU.

Contract: the tables byte for byte, with the native builder and with the
numpy one (both packages' libraries switched off); ``Scene.build``'s
permuted ``tris`` and ``tri_index`` and its attribute tables byte for
byte; hit slots, instances and occlusion bits equal on the reference's
random triangles and rays (``tests/test_bvh.py``) and on a case of
deliberate ties, ``t`` within rtol 1e-5 / atol 1e-5 and barycentrics
within 1e-4 (the wide8 tests' ulps); the megakernel's Cornell film at
32x32 and the wavefront's within 1e-5 of the reference's on the same
backend.  An instanced scene is refused on these backends with the
reference's message, and the fused integrator refuses them (the
reference's fused pass has no route for them: its fall-through walks an
empty fat-row table whose root never advances, so the pass never ends).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_native import native_pair  # noqa: F401  (fixture)
from tests.torch_backends import numpy_builders  # noqa: F401  (fixture)
from tests.torch_backends import built_pair, hits_match, ray_sets, tie_case
from unity_webgpu_pathtracer_torch import accel as taccel
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.accel import native as tnative
from unity_webgpu_pathtracer_torch.api import Renderer as TRenderer
from unity_webgpu_pathtracer_torch.models import examples as texamples
from unity_webgpu_pathtracer_torch.models.cornell import cornell_box as tcornell
from unity_webgpu_pathtracer_torch.render import camera as tcamera
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_tpu import accel as jaccel
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.api import Renderer as JRenderer
from unity_webgpu_pathtracer_tpu.models import examples as jexamples
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
from unity_webgpu_pathtracer_tpu.ops import traverse_wide as jtw
from unity_webgpu_pathtracer_tpu.render import camera as jcamera

torch.set_num_threads(2)


def _same(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _mbvh_skip_tables(pos):
    return [taccel.build_scene_bvh(pos), taccel.build_scene_skip_bvh(pos)], \
           [jaccel.build_scene_bvh(pos), jaccel.build_scene_skip_bvh(pos)]


@pytest.mark.parametrize("n", [1, 33, 2000])
def test_tables_byte_identical_native(native_pair, n):  # noqa: F811
    pos = ray_sets(n, 1)[0]
    got, want = _mbvh_skip_tables(pos)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _same(a, b)


@pytest.mark.parametrize("n", [1, 33, 500])
def test_tables_byte_identical_numpy(numpy_builders, n):  # noqa: F811
    pos = ray_sets(n, 1)[0]
    got, want = _mbvh_skip_tables(pos)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _same(a, b)


def test_native_bindings_count_as_missing_when_disabled():
    pos = ray_sets(20, 1)[0]
    recs = np.zeros((20, 9), np.float32)
    with tnative.disabled():
        assert tnative.native_build_or_none(pos) is None
        assert tnative.native_linearize_or_none(pos) is None
        assert tnative.native_wide_or_none(pos, recs) is None
    assert tnative.native_build_or_none(pos) is not None


@pytest.mark.parametrize("traversal,ntri,nray", [
    ("mbvh", 1, 64), ("mbvh", 50, 256), ("mbvh", 1000, 512), ("bvh2", 50, 256),
    ("skip", 1, 64), ("skip", 50, 256), ("skip", 1000, 512)])
def test_hits_match_reference(native_pair, traversal, ntri, nray):  # noqa: F811
    pos, o, d = ray_sets(ntri, nray)
    jsd, tsd = built_pair(pos, traversal)
    if ntri > 1:
        # slot indexes the permuted tris; tri_index maps it to scene order.
        assert not np.array_equal(tsd.tri_index.numpy(), np.arange(ntri))
    hits = hits_match(jsd, tsd, traversal, o, d, seed=ntri, eager=ntri == 1000)
    assert hits > (0 if ntri == 1 else nray // 4)


@pytest.mark.parametrize("traversal", ["mbvh", "skip"])
def test_ties_match_reference(native_pair, traversal):  # noqa: F811
    pos, o, d = tie_case()
    jsd, tsd = built_pair(pos, traversal)
    assert hits_match(jsd, tsd, traversal, o, d) >= 200


@pytest.fixture(scope="module")
def cornell32():
    size = 32
    scene, cam = cornell_box()
    tsc, _ = tcornell()
    common = dict(width=size, height=size, samples_per_pass=1, max_bounces=3, sky_mode=2)
    jparams = jcamera.make_camera_params(width=size, height=size, **cam)
    tparams = tcamera.make_camera_params(width=size, height=size, device="cpu", **cam)
    return scene, tsc, common, jparams, tparams


@pytest.mark.parametrize("traversal,integrator", [("mbvh", "megakernel"), ("bvh2", "megakernel"),
                                                  ("skip", "megakernel"), ("skip", "wavefront")])
def test_film_matches_reference(cornell32, traversal, integrator):
    scene, tsc, common, jparams, tparams = cornell32
    common = dict(common, traversal=traversal, integrator=integrator)
    jr = JRenderer(scene, jconfig.RenderConfig(**common), jparams, compile_cache=False)
    tr = TRenderer(tsc, tconfig.RenderConfig(has_environment_texture=False, **common), tparams,
                   device="cpu")
    jr.render(1)
    tr.render(1)
    got = tr.radiance()
    assert got.std() > 0
    np.testing.assert_allclose(got, np.asarray(jr.radiance()), rtol=0, atol=1e-5)


@pytest.mark.parametrize("traversal", ["mbvh", "bvh2", "skip", "bruteforce"])
def test_instanced_scene_refused(traversal):
    """The reference's refusal, word for word, in both packages."""
    msg = "instanced scenes require traversal='wide', 'wide2', 'wide8' or 'wide16'"
    jscene, _cam, _o = jexamples.tlas_scene(n=2)
    tscene, _cam, _o = texamples.tlas_scene(n=2)
    with pytest.raises(ValueError, match=msg):
        jscene.build(traversal)
    with pytest.raises(ValueError, match=msg):
        tscene.build(traversal, device="cpu")


@pytest.mark.parametrize("traversal", ["mbvh", "bvh2", "skip", "bruteforce"])
def test_fused_refuses_backends_without_a_route(traversal):
    """The port refuses these backends under the fused integrator (config
    and pass).  The reference accepts them and falls through to its wide
    route over the (1, 1, 48) placeholder table: the zero row is an inner
    row whose children are all empty, so the skip (0) keeps every lane at
    the root, which is below the table's end, and the pass never ends."""
    with pytest.raises(ValueError, match="unsupported settings: \\['traversal'\\]"):
        tconfig.RenderConfig(traversal=traversal)
    for integrator in ("megakernel", "wavefront"):
        assert tconfig.RenderConfig(traversal=traversal, integrator=integrator)
    cfg = tconfig.RenderConfig(traversal="wide", has_environment_texture=False, sky_mode=2)
    object.__setattr__(cfg, "traversal", traversal)
    tsc, cam = tcornell()
    params = tcamera.make_camera_params(width=8, height=8, device="cpu", **cam)
    with pytest.raises(ValueError, match="the fused integrator runs on"):
        tfused.fused_pass_with_stats(tsc.build(traversal, device="cpu"), cfg, params, 0)
    # The reference's fall-through: its placeholder table never lets a lane go.
    scene, _cam = cornell_box()
    nodes = scene.build(traversal).wide_nodes
    assert nodes.shape == (1, 1, 48)
    s = jtw.init_state(4, jnp.float32(1e5))
    o = jnp.zeros((4, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.3, -0.2, 0.9]], jnp.float32), (4, 1))
    for _ in range(3):
        s = jtw.arrival_step(nodes.reshape(1, 48), 1, jnp.zeros((4,), jnp.int32), o, d,
                             1.0 / d, s)
    assert (np.asarray(s.ptr) == 0).all()
