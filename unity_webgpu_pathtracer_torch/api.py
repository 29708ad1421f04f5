"""High-level progressive renderer (``api.py`` of the reference).

Example::

    from unity_webgpu_pathtracer_torch.api import Renderer
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    scene, cam = million_triangle_scene(1_000_000)
    cfg = RenderConfig(width=1920, height=1080, samples_per_pass=4,
                       transition_every=8)
    r = Renderer(scene, cfg, make_camera_params(width=1920, height=1080, **cam))
    r.render(passes=2)
    rgb = r.radiance()         # (H, W, 3) linear mean radiance, numpy
    r.save_png("out.png")      # ACES, sRGB; row 0 = top
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.config import PostParams, RenderConfig, RenderParams
from unity_webgpu_pathtracer_torch.device import resolve_device
from unity_webgpu_pathtracer_torch.post.tonemap import present
from unity_webgpu_pathtracer_torch.render import film as ufilm
from unity_webgpu_pathtracer_torch.render.fused import fused_pass_and_accumulate
from unity_webgpu_pathtracer_torch.render.integrator import megakernel_pass_and_accumulate
from unity_webgpu_pathtracer_torch.render.reproject import reproject_film
from unity_webgpu_pathtracer_torch.render.wavefront import wavefront_pass_and_accumulate
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc, pack_materials
from unity_webgpu_pathtracer_torch.scene.scene import (
    Scene,
    SceneData,
    light_table,
    rebuild_tlas_rows,
)
from unity_webgpu_pathtracer_torch.utils.image import write_png


class Renderer:
    """Owns the device scene, the film and the last pass's statistics, and
    presents the film (``image``, ``save_png``).  Built from a host
    ``Scene``, it also takes the dynamic-scene edits
    (``update_instance_transform``, ``update_material``, ``update_lights``;
    ``update_camera`` takes new uniforms), each of which restarts
    accumulation as the reference's dirty tracking does
    (``PathTracer.cs:169-180, 211-222, 463-471``), unless a camera move
    reprojects the film.  It runs on the CUDA device
    unless ``device`` says otherwise (``device="cpu"``)."""

    def __init__(self, scene, config: RenderConfig, params: RenderParams,
                 device=None):
        self.device = resolve_device(device)
        self._host_scene = scene if isinstance(scene, Scene) else None
        if isinstance(scene, Scene):
            scene = scene.build(config.traversal, device=self.device)
        if not isinstance(scene, SceneData):
            raise TypeError("scene must be a Scene or SceneData")
        if scene.materials.device != self.device:
            raise ValueError(f"SceneData lies on {scene.materials.device}, "
                             f"the renderer on {self.device}")
        self.scene = scene
        self.config = config
        self.params = params.to(self.device)
        self.film = ufilm.new_film(config.height, config.width, self.device)
        self._last = None   # (occupancy, rays, arrivals, super_iterations)

    def reset(self) -> None:
        """Restart accumulation; the last pass's statistics go with it."""
        self.film = ufilm.reset(self.film)
        self._last = None

    def _require_host_scene(self) -> Scene:
        if self._host_scene is None:
            raise ValueError("the renderer was built from SceneData; dynamic "
                             "updates need the host Scene")
        return self._host_scene

    def update_instance_transform(self, instance_id: int, transform) -> None:
        """Move an instance: only the TLAS rows of the node table and the
        instance transforms are re-emitted and copied to the device, the
        rows in place (cost independent of the BLAS sizes, as the
        reference's per-frame TLAS upload, ``BVHScene.cs:823-838``);
        accumulation restarts."""
        host = self._require_host_scene()
        host.set_instance_transform(instance_id, transform)
        fmt = "wide8" if self.config.traversal == "wide8" else "wide16"
        rows, l2w, w2l = rebuild_tlas_rows(host, fmt)
        getattr(self.scene, f"{fmt}_nodes")[: rows.shape[0]].copy_(torch.from_numpy(rows))
        self.scene = self.scene._replace(
            inst_l2w=torch.from_numpy(l2w).to(self.device),
            inst_w2l=torch.from_numpy(w2l).to(self.device))
        self.reset()

    def update_material(self, material_id: int, desc: MaterialDesc) -> None:
        """Replace a material (``PathTracer.UpdateMaterialData``, :474);
        accumulation restarts."""
        host = self._require_host_scene()
        host.materials[material_id] = desc
        self.scene = self.scene._replace(
            materials=torch.from_numpy(pack_materials(host.materials)).to(self.device))
        self.reset()

    def update_lights(self, lights) -> None:
        """Replace the light table (``PathTracer.UpdateLights``, :367);
        accumulation restarts."""
        host = self._require_host_scene()
        host.lights = list(lights)
        self.scene = self.scene._replace(
            lights=torch.from_numpy(light_table(host.lights)).to(self.device))
        self.reset()

    def update_camera(self, params: RenderParams, reproject: bool = False,
                      max_history: int | None = None) -> None:
        """New camera and uniforms (``PathTracer.cs:211-222``);
        accumulation restarts.  With ``reproject=True`` the film is warped
        through the camera move instead (``render/reproject.py``): pixels
        that stay visible keep their radiance with a per-pixel sample
        count, clamped to ``max_history``; disoccluded pixels restart."""
        params = params.to(self.device)
        if reproject:
            self.film = reproject_film(self.scene, self.config, self.film, self.params, params,
                                       max_history=max_history)
            self.params = params
            return
        self.params = params
        self.reset()

    def step(self) -> None:
        """Render one progressive pass (``samples_per_pass`` samples/pixel)
        with ``config.integrator``."""
        if self.config.integrator == "fused":
            self.film, *self._last = fused_pass_and_accumulate(
                self.scene, self.config, self.params, self.film)
            return
        step = (wavefront_pass_and_accumulate if self.config.integrator == "wavefront"
                else megakernel_pass_and_accumulate)
        self.film = step(self.scene, self.config, self.params, self.film)
        self._last = None

    def render(self, passes: int = 1) -> ufilm.Film:
        for _ in range(passes):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.film

    def stats(self) -> dict:
        """The last fused pass's lane occupancy, rays traced (closest +
        shadow), arrivals and super-iterations; ``{}`` before the first
        pass, after ``reset`` and after a megakernel or wavefront pass (as
        in the reference).  Reads device scalars, so it waits for the
        pass."""
        if self._last is None:
            return {}
        occ, rays, arrivals, iters = self._last
        return {"occupancy": float(occ), "rays": int(rays),
                "arrivals": int(arrivals), "super_iterations": int(iters)}

    @property
    def sample_count(self) -> int:
        """Samples per pixel; after a reprojection, the largest count."""
        return self.film.sample_count

    def radiance(self) -> np.ndarray:
        """Linear mean radiance (H, W, 3), row 0 = bottom."""
        return self.film.accum.cpu().numpy()

    def image(self, post: PostParams = PostParams()) -> np.ndarray:
        """Display-ready uint8 (H, W, 3), row 0 = top (the image
        convention; the film's row 0 is the bottom).  The presentation chain
        runs on the film's device; one host copy, of the uint8 result."""
        out = torch.clamp(present(self.film.accum, post), 0.0, 1.0) * 255 + 0.5
        return out.to(torch.uint8).flip(0).cpu().numpy()

    def save_png(self, path: str, post: PostParams = PostParams()) -> None:
        write_png(path, self.image(post))

    def save_checkpoint(self, path: str) -> None:
        """Write the film (the reference's npz layout)."""
        ufilm.save(path, self.film)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a film written by ``save_checkpoint`` (of either
        package), with its per-pixel counts if it has them; its size must
        be the config's."""
        film = ufilm.load(path, self.device)
        want = (self.config.height, self.config.width, 3)
        if tuple(film.accum.shape) != want:
            raise ValueError(f"{path}: film of {tuple(film.accum.shape)}, the renderer's is "
                             f"{want}")
        self.film = film
        self._last = None
