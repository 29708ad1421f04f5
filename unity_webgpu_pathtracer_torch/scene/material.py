"""Material descriptions, 32-float packing and the per-lane runtime
derivation (``scene/material.py`` of the reference).

The packed layout is the reference's ``MaterialData`` record
(``BVHScene.cs:241-282``); ``derive_material`` turns gathered records into
the runtime :class:`~unity_webgpu_pathtracer_torch.render.bsdf.Material`
(roughness regularisation, anisotropy, eta), untextured.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.render.bsdf import Material

MATERIAL_SIZE = 32


@dataclasses.dataclass
class MaterialDesc:
    """Host-side material description (glTF metallic-roughness style)."""

    base_color: tuple = (0.8, 0.8, 0.8, 1.0)   # linear RGBA
    emission: tuple = (0.0, 0.0, 0.0)
    metallic: float = 0.0
    roughness: float = 0.5
    ior: float = 1.1
    transmission: float = 0.0
    normal_scale: float = 1.0
    alpha_mode: int = 0
    alpha_cutoff: float = 0.5
    anisotropic: float = 0.0
    specular: float = 0.0
    specular_tint: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    subsurface: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.0
    # Texture indices (-1 = unbound); textures are not ported yet, but the
    # packed record keeps their slots.
    base_color_texture: int = -1
    metallic_roughness_texture: int = -1
    normal_texture: int = -1
    emission_texture: int = -1
    occlusion_texture: int = -1
    uv_scale: tuple = (1.0, 1.0)
    uv_offset: tuple = (0.0, 0.0)


def pack_materials(materials: list[MaterialDesc]) -> np.ndarray:
    """Pack to the (N, 32) float32 record table."""
    out = np.zeros((max(len(materials), 1), MATERIAL_SIZE), np.float32)
    for i, m in enumerate(materials):
        bc = np.asarray(m.base_color, np.float32)
        opacity = float(bc[3]) * (1.0 - m.transmission) if bc.shape[0] > 3 else 1.0 - m.transmission
        out[i, 0:3] = bc[:3]
        out[i, 3] = opacity
        out[i, 4:7] = np.asarray(m.emission, np.float32)
        out[i, 7] = m.alpha_cutoff
        out[i, 8] = m.metallic
        out[i, 9] = m.roughness
        out[i, 10] = m.normal_scale
        out[i, 11] = m.ior
        out[i, 12] = float(m.alpha_mode)
        out[i, 13] = m.anisotropic
        out[i, 14] = m.specular
        out[i, 15] = m.specular_tint
        out[i, 16] = m.sheen
        out[i, 17] = m.sheen_tint
        out[i, 18] = m.subsurface
        out[i, 19] = m.clearcoat
        out[i, 20] = m.clearcoat_gloss
        out[i, 21] = 1.0 - opacity
        out[i, 22] = m.base_color_texture
        out[i, 23] = m.metallic_roughness_texture
        out[i, 24] = m.normal_texture
        out[i, 25] = m.emission_texture
        out[i, 26] = m.occlusion_texture
        out[i, 27] = -1.0
        out[i, 28:30] = np.asarray(m.uv_scale, np.float32)
        out[i, 30:32] = np.asarray(m.uv_offset, np.float32)
    return out


def derive_material(md, ray_dir, normal) -> Material:
    """Packed records -> runtime ``Material`` (``material.hlsl:84-137``),
    the reference's untextured branch.  ``md`` is the gathered records as
    planes (``md[k]`` is field k for every lane, e.g. a (32, B) tensor);
    ``ray_dir`` and ``normal`` are planes."""
    opacity = md[3]
    roughness = torch.clamp_min(md[9], 0.001)
    ior = torch.clamp(md[11], 1.001, 2.0)
    anisotropic = torch.clamp(md[13], -0.9, 0.9)
    aspect = torch.sqrt(1.0 - anisotropic * 0.9)
    entering = (ray_dir[0] * normal[0] + ray_dir[1] * normal[1]
                + ray_dir[2] * normal[2]) < 0.0
    return Material(
        base_color=(md[0], md[1], md[2]),
        opacity=opacity,
        emission=(md[4], md[5], md[6]),
        alpha_mode=md[12].to(torch.int32),
        alpha_cutoff=md[7],
        anisotropic=anisotropic,
        metallic=md[8],
        roughness=roughness,
        subsurface=md[18],
        specular_tint=md[15],
        sheen=md[16],
        sheen_tint=md[17],
        clearcoat=md[19],
        clearcoat_roughness=0.1 + (0.001 - 0.1) * md[20],
        spec_trans=1.0 - torch.clamp(opacity, 0.0, 1.0),
        ior=ior,
        ax=torch.clamp_min(roughness / aspect, 0.001),
        ay=torch.clamp_min(roughness * aspect, 0.001),
        eta=torch.where(entering, 1.0 / ior, ior),
    )
