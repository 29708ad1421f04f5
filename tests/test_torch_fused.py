"""The whole ported slice against the reference: the port's fused pass
(kernel twins on the CPU) and the reference's fused pass with both Pallas
kernels (interpret mode), on the same tables via ``scene_from_numpy``.

Contract: rays and arrivals within 0.5% (exact is expected and printed);
film mean within 1%; >= 99% of pixels within rtol 1e-4.  Progressive
accumulation over two passes through ``Renderer`` matches the same way.
"""

import jax
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.api import Renderer as TRenderer
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.scene.scene import scene_from_numpy
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.api import Renderer as JRenderer
from unity_webgpu_pathtracer_tpu.models.benchmark import million_triangle_scene
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params

torch.set_num_threads(2)

W, H, SPP = 40, 24, 4
SLICE = dict(width=W, height=H, samples_per_pass=SPP, max_bounces=5, pool_size=1024,
             transition_every=4)


@pytest.fixture(scope="module")
def both():
    """(JAX SceneData, JAX params, JAX config, port SceneData, port params,
    port config) on the same tables and uniforms."""
    scene, cam = million_triangle_scene(2000)
    sd = scene.build("wide16")
    params = make_camera_params(width=W, height=H, **cam)
    jcfg = jconfig.RenderConfig(
        traversal="wide16", sky_mode=jconfig.SKY_MODE_ENVIRONMENT,
        has_environment_texture=True, integrator="fused", attr_compact=2,
        use_pallas_arrival=True, use_pallas_transition=True, **SLICE)
    arrays = {f: np.asarray(getattr(sd, f)) for f in
              ("wide16_nodes", "wide16_top", "stack_levels", "attr_shade_c", "materials")}
    arrays["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    tparams = tconfig.params_from_numpy(
        {f: np.asarray(getattr(params, f)) for f in
         ("cam_to_world", "cam_inv_proj", "environment_intensity",
          "environment_rotation", "max_firefly_luminance", "seed_root")}, device="cpu")
    return (sd, params, jcfg, scene_from_numpy(arrays, device="cpu"), tparams,
            tconfig.RenderConfig(**SLICE))


def _film_close(got, want):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    print(f"pixels diverged beyond rtol 1e-4: {int((~close).sum())} of {close.size}")
    assert close.mean() >= 0.99
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


@pytest.mark.parametrize("current_sample", [0, 7])
def test_fused_pass_matches_reference(both, current_sample):
    sd, params, jcfg, tsd, tparams, tcfg = both
    step = jax.jit(jfused.fused_pass_with_stats, static_argnums=(1,))
    jfilm, jocc, jrays, jarr = step(sd, jcfg, params, current_sample)
    tfilm, tocc, trays, tarr, iters = tfused.fused_pass_with_stats(
        tsd, tcfg, tparams, current_sample)
    print(f"rays port {int(trays)} reference {int(jrays)}; arrivals port "
          f"{int(tarr)} reference {int(jarr)}; super-iterations {iters}")
    assert abs(int(trays) - int(jrays)) <= 0.005 * int(jrays)
    assert abs(int(tarr) - int(jarr)) <= 0.005 * int(jarr)
    assert abs(float(tocc) - float(jocc)) <= 0.005
    _film_close(tfilm.numpy(), np.asarray(jfilm))


def test_renderer_accumulates_like_reference(both):
    sd, params, jcfg, tsd, tparams, tcfg = both
    jr = JRenderer(sd, jcfg, params, compile_cache=False)
    tr = TRenderer(tsd, tcfg, tparams, device="cpu")
    assert tr.stats() == {}
    for _ in range(2):
        jr.step()
        tr.step()
        assert tr.stats()["rays"] == jr.stats()["rays"]
    assert tr.sample_count == int(jr.film.sample_count) == 2 * SPP
    _film_close(tr.radiance(), jr.radiance())
    tr.reset()
    assert tr.stats() == {} and tr.sample_count == 0 and not tr.radiance().any()
