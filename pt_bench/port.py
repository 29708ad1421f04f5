"""The system under test: the port (``unity_webgpu_pathtracer_torch``) driven
through its public API, from the benchmark's own scene arrays.

Nothing else in ``pt_bench`` imports the port, and the plain reference
(``pt_bench/reference``) never imports this module.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.api import Renderer
from unity_webgpu_pathtracer_torch.config import RenderConfig
from unity_webgpu_pathtracer_torch.ops.cuda_transition import TransitionState
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
from unity_webgpu_pathtracer_torch.scene.lights import LightDesc
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
from unity_webgpu_pathtracer_torch.scene.mesh import Mesh
from unity_webgpu_pathtracer_torch.scene.scene import Scene


def load_kernels(device: torch.device) -> None:
    """Build or load the CUDA kernel libraries and the native BVH builder
    (each is built once a checkout, in the package's own build directory)."""
    from unity_webgpu_pathtracer_torch.accel import native

    native.available()
    if device.type == "cuda":
        from unity_webgpu_pathtracer_torch.ops import cuda_build

        cuda_build.load()


def _desc(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def port_scene(spec) -> Scene:
    """The spec as the port's host ``Scene``: flat (every placement a mesh
    with its transform and material) or two-level (a mesh once, an instance
    a placement with its material); its textures and analytic lights in
    their order, so a material's texture indices name them."""
    scene = Scene()
    for m in spec.materials:
        scene.add_material(MaterialDesc(**_desc(m)))
    for image in spec.textures:
        scene.add_texture(image)
    for light in spec.lights:
        scene.add_light(LightDesc(**_desc(light)))
    if spec.instanced:
        first_mat = {}
        for p in spec.placements:
            first_mat.setdefault(p.mesh, p.material)
        ids = [scene.add_mesh(Mesh(vertices=m.vertices, indices=m.indices, normals=m.normals,
                                   uvs=m.uvs, material_index=first_mat.get(i, 0)))
               for i, m in enumerate(spec.meshes)]
        for p in spec.placements:
            scene.add_instance(ids[p.mesh], p.transform, p.material)
    else:
        for p in spec.placements:
            m = spec.meshes[p.mesh]
            scene.add_mesh(Mesh(vertices=m.vertices, indices=m.indices, normals=m.normals,
                                uvs=m.uvs, material_index=p.material), p.transform)
    scene.set_environment(spec.env_image)
    return scene


def render_config(cfg: dict, traffic: dict, width: int, height: int) -> RenderConfig:
    """The port's configuration of a cell: the configuration's ``render``
    keys and the traffic's film, samples, integrator, pool (0: the pass's
    default) and, where the traffic names it, the fused loop's arrivals a
    transition."""
    extra = ({"transition_every": traffic["transition_every"]}
             if "transition_every" in traffic else {})
    return RenderConfig(width=width, height=height,
                        samples_per_pass=traffic["samples_per_pass"],
                        integrator=traffic["integrator"],
                        pool_size=traffic.get("pool_size", 0),
                        **extra, **cfg["render"])


class PortRenderer:
    """The cell's renderer on one card, built in set-up and driven by the
    window: ``api.Renderer``.  ``counts`` sums, over the passes since it
    was built, the host integers of the port's own per-pass counters
    (``Renderer.stats()``'s: K1's and the shading kernel's launches, the
    host reads and bounces of a megakernel pass, the super-iterations of a
    fused one), read from the renderer's last-pass record without
    ``stats()``'s conversion, so no device value is read."""

    def __init__(self, spec, cfg: dict, traffic: dict, width: int, height: int,
                 seed_root: int, device: torch.device):
        self.config = render_config(cfg, traffic, width, height)
        params = make_camera_params(width=width, height=height, seed_root=seed_root,
                                    device=device, **spec.camera)
        self.renderer = Renderer(port_scene(spec), self.config, params, device=device)
        self.counts = {}

    def step(self) -> None:
        self.renderer.step()
        for k, v in (self.renderer._last or {}).items():
            if isinstance(v, int):
                self.counts[k] = self.counts.get(k, 0) + v

    def image(self) -> np.ndarray:
        return self.renderer.image()

    def reset(self) -> None:
        self.renderer.reset()

    @property
    def film(self) -> torch.Tensor:
        return self.renderer.film.accum

    @property
    def sample_count(self) -> int:
        return self.renderer.film.sample_count

    @property
    def scene(self):
        return self.renderer.scene

    @property
    def params(self):
        return self.renderer.params


# The lane state of a fused transition, less its ray counter.
STATE_FIELDS = tuple(f for f in TransitionState._fields if f != "rays")
# The lane state that the start of a new sample writes (``render/fused.py``'s
# ``_record_and_regenerate``), under ``FusedState``'s names.
REGEN_FIELDS = ("mode", "path_o", "path_d", "trav_o", "trav_d", "throughput", "radiance",
                "rng", "pixel", "depth", "max_roughness", "prev_pdf")


def _lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Lanes ``idx`` of a (B,) plane or of (k, B) planes, lane-major."""
    return x[idx].clone() if x.dim() == 1 else x[:, idx].T.contiguous()


@dataclasses.dataclass
class FusedCapture:
    """What one fused pass did, copied for the check at lanes and pixels
    the seed drew: kernel K2's inputs and outputs at ``lanes`` (every
    transition; each field lane-major, transitions one after another); at
    the end of every transition, the lanes' state before and after the
    record append and the start of new samples, the whole pool's modes and
    the queue's head (``regen``; the first transition starts the pass's
    first samples); the records of the lanes that died on ``pixels`` (slot
    of the pixel, rgb); the pass's film sum and the film before and after,
    at ``pixels``.  With work counting, the least time of every K1 and K2
    launch of the pass (``k1_ms``, ``k2_ms``)."""

    lane_count: int
    pixels: torch.Tensor                  # (P,) int64 pixel indices
    lanes: torch.Tensor | None = None     # (L,) int64, drawn at the first transition
    inputs: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)
    records: list = dataclasses.field(default_factory=list)
    regen: list = dataclasses.field(default_factory=list)
    queue: dict = dataclasses.field(default_factory=dict)
    k1_ms: list = dataclasses.field(default_factory=list)
    k2_ms: list = dataclasses.field(default_factory=list)
    super_iterations: int = 0
    pass_sum: torch.Tensor | None = None
    film_before: torch.Tensor | None = None
    film_after: torch.Tensor | None = None
    samples_before: int = 0
    samples_after: int = 0

    @staticmethod
    def stacked(which: list) -> dict:
        return {k: torch.cat([t[k] for t in which]) for k in which[0]}


def _draw_lanes(seed: int, b: int, count: int, device) -> torch.Tensor:
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x1A7E])
    idx = np.sort(rng.choice(b, size=min(count, b), replace=False))
    return torch.from_numpy(idx).to(device)


@contextlib.contextmanager
def capture_fused(cap: FusedCapture, seed: int, work=None):
    """Wrap, for the passes inside the block, the fused loop's call of kernel
    K2 (``render/fused.py``'s ``transition16_cuda``), its record append and
    start of new samples (``_record_and_regenerate``), and its pass, filling
    ``cap``; the port is not edited.  ``work``, where given, counts each
    launch's least time: ``work.k2(scene, config, params, before, after,
    died)`` from K2's whole lane state before and after, and ``work.k1``
    from the arguments of every K1 call (``arrival_steps16_cuda``), its
    traversal state copied before the launch."""
    from unity_webgpu_pathtracer_torch.render import fused

    k1, k2, record, fused_pass = (fused.arrival_steps16_cuda, fused.transition16_cuda,
                                  fused._record_and_regenerate, fused.fused_pass_with_stats)
    slot = {}

    def k1_wrapped(nodes, oT, dT, invT, s, *rest):
        before = s._replace(**{f: getattr(s, f).clone() for f in s._fields})
        cap.k1_ms.append(work.k1(nodes, oT, dT, invT, before, *rest))
        return k1(nodes, oT, dT, invT, s, *rest)

    def k2_wrapped(scene, config, params, st):
        if cap.lanes is None:
            cap.lanes = _draw_lanes(seed, st.mode.shape[0], cap.lane_count, st.mode.device)
        idx = cap.lanes
        cap.inputs.append({f: _lanes(getattr(st, f), idx) for f in STATE_FIELDS})
        before = (st._replace(**{f: getattr(st, f).clone() for f in st._fields})
                  if work is not None else None)
        died, rad_out = k2(scene, config, params, st)
        out = {f: _lanes(getattr(st, f), idx) for f in STATE_FIELDS}
        out["died"] = died[idx].clone()
        out["rad_out"] = rad_out[:, idx].T.contiguous()
        cap.outputs.append(out)
        if work is not None:
            cap.k2_ms.append(work.k2(scene, config, params, before, st, died))
        return died, rad_out

    def record_wrapped(config, params, s, budget, current_sample, died, rad_out):
        if config.film_k_shift or not config.use_record_film:
            raise ValueError("the capture reads the record film at film_k_shift 0")
        if "map" not in slot:
            m = torch.full((config.pixel_count(),), -1, dtype=torch.int64, device=died.device)
            m[cap.pixels] = torch.arange(cap.pixels.shape[0], device=died.device)
            slot["map"] = m
        sl = slot["map"][s.pixel.long()]
        idx = torch.nonzero(died & (sl >= 0))[:, 0]
        cap.records.append({"slot": sl[idx], "rgb": rad_out[:, idx].T.contiguous()})
        lanes = cap.lanes
        cap.queue = dict(budget=budget, current_sample=current_sample, shard=tuple(s.shard))
        ev = {"modes": s.mode.to(torch.int8), "queue_head": s.queue_head.clone(),
              "died": died[lanes].clone(),
              "before": {f: _lanes(getattr(s, f), lanes) for f in REGEN_FIELDS}}
        out = record(config, params, s, budget, current_sample, died, rad_out)
        ev["after"] = {f: _lanes(getattr(s, f), lanes) for f in REGEN_FIELDS}
        cap.regen.append(ev)
        return out

    def pass_wrapped(*a, **k):
        out = fused_pass(*a, **k)
        cap.pass_sum = out[0][cap.pixels].clone()
        cap.super_iterations = int(out[4])
        return out

    if work is not None:
        fused.arrival_steps16_cuda = k1_wrapped
    fused.transition16_cuda = k2_wrapped
    fused._record_and_regenerate = record_wrapped
    fused.fused_pass_with_stats = pass_wrapped
    try:
        yield cap
    finally:
        fused.arrival_steps16_cuda = k1
        fused.transition16_cuda = k2
        fused._record_and_regenerate = record
        fused.fused_pass_with_stats = fused_pass


def checked_fused_pass(pr: PortRenderer, seed: int, pixels: torch.Tensor, lane_count: int,
                       work=None) -> FusedCapture:
    """One more pass of ``pr`` (a fused renderer) under ``capture_fused``,
    with the film at ``pixels`` and its sample count read before and
    after; the card is synchronised at the end."""
    cap = FusedCapture(lane_count=lane_count, pixels=pixels)
    cap.film_before = pr.film.reshape(-1, 3)[pixels].clone()
    cap.samples_before = pr.sample_count
    with capture_fused(cap, seed, work):
        pr.step()
    cap.film_after = pr.film.reshape(-1, 3)[pixels].clone()
    cap.samples_after = pr.sample_count
    if pixels.device.type == "cuda":
        torch.cuda.synchronize(pixels.device)
    return cap
