"""The port's passes at the golden configuration held to the committed
goldens (``tests/golden/*.npz``) through
``tests/golden_common.py::compare_to_golden``: ``quad``, ``texture``,
``lights`` and ``rect_lights`` here, the rest in
``tests/test_torch_golden_b.py`` (two files, so that ``--dist loadfile``
spreads them).  ``cornell``'s is ``tests/test_torch_general.py``'s.

The golden configuration is ``golden_common.build_scene``'s: 64x64, 32
samples a pass, 4 bounces, pool 4096, the firefly clamp at luminance 2,
the scene's own overrides, and the test seed family.  ``tlas`` is left
out: the reference's golden of it was rendered through its 4-wide build
(``Scene.build("wide16")`` does not build instanced scenes two-level) and
shows only the sky, while the port's two-level build sees the spheres.
"""

import numpy as np
import pytest
import torch

from tests import golden_common
from unity_webgpu_pathtracer_torch.config import RenderConfig
from unity_webgpu_pathtracer_torch.models.examples import EXAMPLES
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
from unity_webgpu_pathtracer_torch.render.fused import fused_pass_with_stats

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def golden_passes(name: str, device="cpu") -> np.ndarray:
    """(N_TEST_PASSES, 64, 64, 3) per-pass mean images of builtin ``name``
    rendered by the port at the golden configuration on ``device``."""
    scene, cam, over = EXAMPLES[name]()
    over = dict(over)
    over.setdefault("has_lights", bool(scene.lights))
    over.setdefault("has_textures", bool(scene.textures))
    size, spp = golden_common.SIZE, golden_common.SPP
    cfg = RenderConfig(width=size, height=size, samples_per_pass=spp, max_bounces=4,
                       pool_size=4096, use_firefly_filter=True, **over)
    sd = scene.build(device=device)
    passes = []
    for seed in golden_common.seed_roots(golden_common.TEST_SEED_BASE,
                                         golden_common.N_TEST_PASSES):
        params = make_camera_params(width=size, height=size, **cam, seed_root=np.uint32(seed),
                                    max_firefly_luminance=np.float32(2.0), device=device)
        film, *_ = fused_pass_with_stats(sd, cfg, params, 0)
        passes.append(film.cpu().numpy().reshape(size, size, 3) / spp)
    return np.stack(passes)


def check_golden(name: str) -> None:
    ok, stats = golden_common.compare_to_golden(golden_passes(name), name)
    print(name, stats)
    assert ok, stats


@pytest.mark.parametrize("name", ["quad", "texture", "lights", "rect_lights"])
def test_golden(name):
    check_golden(name)
