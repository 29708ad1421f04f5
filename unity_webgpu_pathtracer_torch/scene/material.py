"""Material descriptions, 32-float packing and the per-lane runtime
derivation (``scene/material.py`` of the reference).

The packed layout is the reference's ``MaterialData`` record
(``BVHScene.cs:241-282``); ``derive_material`` turns gathered records into
the runtime :class:`~unity_webgpu_pathtracer_torch.render.bsdf.Material`
(texture fetches, roughness regularisation, anisotropy, eta), and
``apply_normal_map`` perturbs the shading normal by the material's normal
map.  Per-lane values are planes (``utils/math.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.render.bsdf import Material
from unity_webgpu_pathtracer_torch.scene import texture as tex
from unity_webgpu_pathtracer_torch.utils.math import sqrt, vcross, vdot, vwhere

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
    # Texture indices into the scene's atlas (-1 = unbound).
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


def _uv_transformed(md, uv):
    """The material's texture transform of ``uv``: ``uv * scale + offset``."""
    return uv[0] * md[28] + md[30], uv[1] * md[29] + md[31]


def derive_material(md, ray_dir, normal, uv=None, texture_data=None,
                    has_textures: bool = False) -> Material:
    """Packed records -> runtime ``Material`` (``material.hlsl:84-137``).
    ``md`` is the gathered records as planes (``md[k]`` is field k for every
    lane, e.g. a (32, B) tensor); ``ray_dir``, ``normal`` and ``uv`` are
    planes.  With ``has_textures`` the bound textures of the int32 atlas
    ``texture_data`` replace the constants, by the reference's rules: the
    base colour texture (at the transformed uv) multiplies the base colour
    and opacity; metallic-roughness reads ``(b, g^2)``; emission ``rgb``;
    occlusion ``r`` (``material.hlsl:38-51, 69-82``); an unbound (negative)
    index keeps the packed constant."""
    base = (md[0], md[1], md[2], md[3])
    occlusion = None
    if has_textures and texture_data is not None:
        t_base = md[22].to(torch.int32)
        px = tex.sample_texture(texture_data, t_base, *_uv_transformed(md, uv))
        base = tuple(torch.where(t_base >= 0, px[c] * base[c], base[c]) for c in range(4))

        t_mr = md[23].to(torch.int32)
        mr_px = tex.sample_texture(texture_data, t_mr, uv[0], uv[1])
        metallic = torch.where(t_mr >= 0, mr_px[2], md[8])
        roughness = torch.where(t_mr >= 0, mr_px[1] * mr_px[1], md[9])

        t_em = md[25].to(torch.int32)
        em_px = tex.sample_texture(texture_data, t_em, uv[0], uv[1])
        emission = tuple(torch.where(t_em >= 0, em_px[c], md[4 + c]) for c in range(3))

        t_oc = md[26].to(torch.int32)
        oc_px = tex.sample_texture(texture_data, t_oc, uv[0], uv[1])
        occlusion = torch.where(t_oc >= 0, oc_px[0], torch.ones_like(oc_px[0]))
    else:
        metallic, roughness = md[8], md[9]
        emission = (md[4], md[5], md[6])
    opacity = base[3]
    roughness = torch.clamp_min(roughness, 0.001)
    ior = torch.clamp(md[11], 1.001, 2.0)
    anisotropic = torch.clamp(md[13], -0.9, 0.9)
    aspect = sqrt(1.0 - anisotropic * 0.9)
    entering = (ray_dir[0] * normal[0] + ray_dir[1] * normal[1]
                + ray_dir[2] * normal[2]) < 0.0
    return Material(
        base_color=base[:3],
        opacity=opacity,
        emission=emission,
        alpha_mode=md[12].to(torch.int32),
        alpha_cutoff=md[7],
        anisotropic=anisotropic,
        metallic=metallic,
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
        occlusion=occlusion,
    )


def apply_normal_map(md, uv, normal, tangent, texture_data, has_textures: bool):
    """The shading normal perturbed by the material's normal map (the
    reference's live version of ``util/material.hlsl:114-133``): the
    tangent-space sample ``2 * px - 1`` at the transformed uv, its xy
    scaled by ``normalScale`` (``md[10]``), in the frame
    ``T' = normalize(T - N (T.N))``, ``B = cross(N, T')``.  An unbound
    texture or a degenerate tangent keeps the interpolated normal; without
    ``has_textures`` the normal is returned as it is."""
    if not has_textures or texture_data is None:
        return normal
    t_nm = md[24].to(torch.int32)
    px = tex.sample_texture(texture_data, t_nm, *_uv_transformed(md, uv))
    scale = md[10]
    tsx = (px[0] * 2.0 - 1.0) * scale
    tsy = (px[1] * 2.0 - 1.0) * scale
    tsz = px[2] * 2.0 - 1.0
    # Gram-Schmidt the interpolated tangent against the normal.
    t_dot_n = vdot(tangent, normal)
    t_orth = tuple(tangent[c] - normal[c] * t_dot_n for c in range(3))
    t_len = sqrt(torch.clamp_min(vdot(t_orth, t_orth), 1e-20))
    t_hat = tuple(t_orth[c] / t_len for c in range(3))
    b_hat = vcross(normal, t_hat)
    n_new = tuple(t_hat[c] * tsx + b_hat[c] * tsy + normal[c] * tsz for c in range(3))
    n_len = sqrt(torch.clamp_min(vdot(n_new, n_new), 1e-20))
    n_new = tuple(n_new[c] / n_len for c in range(3))
    return vwhere((t_nm >= 0) & (t_len > 1e-6), n_new, normal)
