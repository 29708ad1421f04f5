"""Render configuration of the ported integrators.

:class:`RenderConfig` keeps the fields of the reference's ``RenderConfig``
(``unity_webgpu_pathtracer_tpu/config.py``) that the port's integrators
read, under the same names.  Defaults follow the reference except where
the reference default is not the main path's (``traversal``,
``integrator``, ``sky_mode``, ``has_environment_texture``): those default
to the main path's values (the fused wide16 integrator with the HDRI).
Every knob the port does not implement raises ``ValueError`` at
construction.

:class:`RenderParams` is a dataclass of tensors (camera matrices, the
thin lens and environment uniforms); ``params_from_numpy`` builds one from
the reference's fields as numpy arrays.  :class:`PostParams` configures the
presentation chain (``post/tonemap.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.device import resolve_device

# Sky modes (common.hlsl:85-86)
SKY_MODE_ENVIRONMENT = 0
SKY_MODE_BASIC = 1
SKY_MODE_NONE = 2

# Tonemap modes (Presentation.shader:42-56)
TONEMAP_NONE = 0
TONEMAP_ACES = 1
TONEMAP_FILMIC = 2
TONEMAP_REINHARD = 3
TONEMAP_LOTTES = 4

# Alpha modes (common.hlsl:88-90)
ALPHA_MODE_OPAQUE = 0
ALPHA_MODE_BLEND = 1
ALPHA_MODE_MASK = 2

# Light types (common.hlsl:137-145)
LIGHT_TYPE_SPOT = 0
LIGHT_TYPE_DIRECTIONAL = 1
LIGHT_TYPE_POINT = 2
LIGHT_TYPE_RECTANGLE = 3


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration.

    ``integrator`` is ``"fused"`` (``render/fused.py``),
    ``"megakernel"`` (``render/integrator.py``: every lane of a sample
    steps through the bounces together) or ``"wavefront"``
    (``render/wavefront.py``: a pool of ``pool_size`` lanes refilled from
    the pass's work queue; 0 = ``min(pixels, 65536)``).  Each runs on
    ``traversal`` ``"wide16"`` (kernel K1) or ``"wide8"`` (the reference's
    cross-check backend, plain PyTorch); the last two also on the
    brute-force oracle ``"bruteforce"``.

    ``sky_mode`` 0 is the environment (the HDRI when
    ``has_environment_texture``, else the constant ``environment_color``),
    with environment NEE; 1 the basic gradient sky; 2 no sky.  The
    reference's ``has_tlas`` is not a field: it reads it nowhere, and here
    as there the scene's instance table selects the two-level traversal.

    ``has_lights`` turns on the analytic lights (their interception and
    their NEE), ``has_textures`` the texture atlas (base colour, alpha,
    metallic-roughness, emission, occlusion), ``has_normal_maps`` the
    normal maps (they read the atlas, so they need ``has_textures``), and
    ``use_depth_of_field`` the thin lens of ``RenderParams.aperture`` and
    ``focal_length``.

    ``attr_compact`` picks the attribute rows the transitions read: 0, the
    f32 normals, uvs and material of each triangle (the bytes of the
    reference's 48-float ``attr_shade`` rows, read from the megakernel's
    per-triangle tables); 1 and 2, one 32-byte row of f16
    normals and uvs per triangle (the reference pairs two rows a gather in
    mode 2 and not in mode 1; here both read the same row, bit for bit);
    3, one 16-byte row of oct-encoded normals (no uv, so untextured scenes
    only: refused with textures or normal maps, as the reference refuses
    it).  The compact modes 1-3 hold a u16 material index: a scene past
    65,536 materials renders with mode 0 or the other integrators.
    ``attr_in_kernel`` is the reference's choice between decoding the
    mode-2 rows before its transition kernel and inside it.  The port's
    kernel K2 always reads and decodes each lane's row itself, so either
    value selects the same kernel (``transition16``) and gives the same
    film, bit for bit; mode 3 and the general transition ignore it, as in
    the reference.  ``attr_direct`` is the reference's choice between two
    gathers of the same mode-0 bytes (a (3T, 16) view or a 48-float row
    and a select), whose films are bit-identical; the port reads each
    triangle's f32 values once either way, so it is accepted and ignored.

    The fused pass's film (``render/fused.py``): the record film
    (``use_record_film``, the default) appends each dying lane's record
    and resolves the film with one sort at the end of the pass; with it
    off, the sorted-prefix film (``use_sorted_film``) scatter-adds a
    sorted prefix of the records each transition, and the legacy film (both
    off) scatter-adds every lane's.  The record and sorted films accept at
    most K = pool >> ``film_k_shift`` records a transition; the others
    wait in their lanes with their radiance and retry.  Only the scatter
    order differs between the three: the per-sample radiance is the
    same."""

    width: int = 512
    height: int = 512
    samples_per_pass: int = 1
    max_bounces: int = 5
    use_russian_roulette: bool = True
    use_firefly_filter: bool = False
    debug_nan_canary: bool = False
    sky_mode: int = SKY_MODE_ENVIRONMENT
    has_environment_texture: bool = True
    has_lights: bool = False
    has_textures: bool = False
    has_normal_maps: bool = False
    use_depth_of_field: bool = False
    traversal: str = "wide16"
    integrator: str = "fused"
    # Lanes resident in the pass; 0 = the integrator's own choice (fused:
    # min(pixels * spp, 96K), rounded up to a multiple of 1024; wavefront:
    # min(pixels, 65536)).
    pool_size: int = 0
    # Arrivals per transition step.
    transition_every: int = 4
    use_record_film: bool = True
    use_sorted_film: bool = True
    film_k_shift: int = 0
    use_lane_film: bool = False
    attr_compact: int = 2
    attr_direct: bool = True
    attr_in_kernel: bool = False

    def __post_init__(self):
        unsupported = {
            "traversal": self.traversal not in (
                ("wide16", "wide8") if self.integrator == "fused"
                else ("wide16", "wide8", "bruteforce")),
            "integrator": self.integrator not in ("fused", "megakernel", "wavefront"),
            "attr_compact": self.attr_compact not in (0, 1, 2, 3),
            "sky_mode": self.sky_mode not in (SKY_MODE_ENVIRONMENT, SKY_MODE_BASIC,
                                              SKY_MODE_NONE),
            "film_k_shift": self.film_k_shift < 0,
            "use_lane_film": self.use_lane_film,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(
                "the PyTorch port implements integrator 'fused' on traversal 'wide16' or "
                "'wide8' and 'megakernel' or 'wavefront' on 'wide16', 'wide8' or "
                "'bruteforce' (attr_compact 0-3, sky modes 0-2, the record, sorted and "
                f"legacy films, film_k_shift >= 0); unsupported settings: {bad}")
        if self.attr_compact == 3 and (self.has_textures or self.has_normal_maps):
            raise ValueError("attr_compact=3 requires has_textures=False and "
                             "has_normal_maps=False (no uv in the oct-normal rows); "
                             "use attr_compact=2")
        if self.transition_every < 1 or self.max_bounces < 0:
            raise ValueError("transition_every must be >= 1 and "
                             "max_bounces >= 0")

    def pixel_count(self) -> int:
        return self.width * self.height


def _scalar(x, dtype, device):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


@dataclasses.dataclass
class RenderParams:
    """Per-frame uniforms as tensors (the reference's ``RenderParams``).

    ``aperture`` and ``focal_length`` are the thin lens's diameter and
    focus distance (read with ``use_depth_of_field``; either 0 gives the
    pinhole).  ``environment_color`` (3,) is the constant environment's
    radiance.
    ``seed_root`` holds a uint32 value in an int64 tensor (the port's PCG
    arithmetic runs in int64 masked to 32 bits)."""

    cam_to_world: torch.Tensor          # (4, 4) float32
    cam_inv_proj: torch.Tensor          # (4, 4) float32
    aperture: torch.Tensor
    focal_length: torch.Tensor
    environment_intensity: torch.Tensor
    environment_rotation: torch.Tensor
    environment_color: torch.Tensor     # (3,) float32
    max_firefly_luminance: torch.Tensor
    seed_root: torch.Tensor             # () int64, value < 2**32

    def to(self, device) -> "RenderParams":
        return RenderParams(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


_PARAM_DEFAULTS = dict(
    aperture=0.0, focal_length=0.0, environment_intensity=1.0, environment_rotation=0.0,
    environment_color=(0.5, 0.5, 0.5), max_firefly_luminance=100.0, seed_root=0,
)


def params_from_numpy(arrays: dict, device=None) -> RenderParams:
    """``RenderParams`` on ``device`` (None: the CUDA device) from a dict
    of numpy arrays keyed by the reference's field names (``np.asarray``
    of each JAX field); missing keys take the reference's defaults, keys
    the port has no field for are refused."""
    device = resolve_device(device)
    extra = set(arrays) - {f.name for f in dataclasses.fields(RenderParams)}
    if extra:
        raise ValueError(f"RenderParams has no fields {sorted(extra)}")
    kw = {}
    for f in dataclasses.fields(RenderParams):
        val = arrays[f.name] if f.name in arrays else _PARAM_DEFAULTS[f.name]
        if f.name == "seed_root":
            kw[f.name] = _scalar(np.asarray(val).astype(np.uint32),
                                 torch.int64, device)
        else:
            kw[f.name] = _scalar(np.asarray(val, np.float32), torch.float32, device)
    return RenderParams(**kw)


@dataclasses.dataclass(frozen=True)
class PostParams:
    """Presentation parameters (``Presentation.shader:19-27``): the
    tonemap operator, sRGB encoding, exposure, brightness (a gamma),
    contrast, saturation and vignette strength."""

    mode: int = TONEMAP_ACES
    srgb: bool = True
    exposure: float = 1.0
    brightness: float = 1.0
    contrast: float = 1.0
    saturation: float = 1.0
    vignette: float = 0.0
