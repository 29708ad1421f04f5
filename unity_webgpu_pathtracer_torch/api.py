"""High-level progressive renderer (``api.py`` of the reference).

Example::

    from unity_webgpu_pathtracer_torch.api import Renderer
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    scene, cam = million_triangle_scene(1_000_000)
    cfg = RenderConfig(width=1920, height=1080, samples_per_pass=4,
                       transition_every=8)
    r = Renderer(scene, cfg, make_camera_params(width=1920, height=1080, **cam),
                 device="cuda")
    r.render(passes=2)
    rgb = r.radiance()         # (H, W, 3) linear mean radiance, numpy
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_torch.render import film as ufilm
from unity_webgpu_pathtracer_torch.render.fused import fused_pass_and_accumulate
from unity_webgpu_pathtracer_torch.scene.scene import Scene, SceneData


class Renderer:
    """Owns the device scene, the film and the last pass's statistics."""

    def __init__(self, scene, config: RenderConfig, params: RenderParams,
                 device="cpu"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if isinstance(scene, Scene):
            scene = scene.build(config.traversal, device=self.device)
        if not isinstance(scene, SceneData):
            raise TypeError("scene must be a Scene or SceneData")
        if scene.wide16_nodes.device != self.device:
            raise ValueError(f"SceneData lies on {scene.wide16_nodes.device}, "
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

    def step(self) -> None:
        """Render one progressive pass (``samples_per_pass`` samples/pixel)."""
        self.film, *self._last = fused_pass_and_accumulate(
            self.scene, self.config, self.params, self.film)

    def render(self, passes: int = 1) -> ufilm.Film:
        for _ in range(passes):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.film

    def stats(self) -> dict:
        """The last pass's lane occupancy, rays traced (closest + shadow),
        arrivals and super-iterations; ``{}`` before the first pass and
        after ``reset``.  Reads device scalars, so it waits for the pass."""
        if self._last is None:
            return {}
        occ, rays, arrivals, iters = self._last
        return {"occupancy": float(occ), "rays": int(rays),
                "arrivals": int(arrivals), "super_iterations": int(iters)}

    @property
    def sample_count(self) -> int:
        return self.film.sample_count

    def radiance(self) -> np.ndarray:
        """Linear mean radiance (H, W, 3), row 0 = bottom."""
        return self.film.accum.cpu().numpy()
