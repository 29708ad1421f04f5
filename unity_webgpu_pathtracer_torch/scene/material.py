"""Material descriptions and 32-float packing (``scene/material.py`` of
the reference).

The packed layout is the reference's ``MaterialData`` record
(``BVHScene.cs:241-282``); the runtime derivation (roughness
regularisation, anisotropy, eta) happens per lane inside the transition
kernel and its plain twin (``ops/cuda_transition.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
