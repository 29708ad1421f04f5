"""Analytic light descriptions and 64-byte record packing
(``scene/lights.py`` of the reference; numpy).

Record layout matches the reference's ``Light`` struct
(``common.hlsl:147-160``; packed host-side in ``PathTracer.cs:407-461``):

====== ==========================================================
floats  contents
====== ==========================================================
0-3     position.xyz, type (int bitcast in reference; plain float here)
4-7     emission.rgb (color·intensity), range
8-11    u.xyz, area
12-15   v.xyz, padding
====== ==========================================================

Rect lights store the *corner* at position with edge vectors u/v
(``PathTracer.cs:346-349``); spot lights store forward in u and
(cos outer, cos inner) in v.xy (``PathTracer.cs:337-341``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from unity_webgpu_pathtracer_torch.config import (
    LIGHT_TYPE_POINT,
    LIGHT_TYPE_RECTANGLE,
    LIGHT_TYPE_SPOT,
)

LIGHT_SIZE = 16


@dataclasses.dataclass
class LightDesc:
    type: int = LIGHT_TYPE_POINT
    position: tuple = (0.0, 0.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    range: float = 100.0
    # Rect lights: center + right/up axes + size (converted to corner/u/v).
    size: tuple = (1.0, 1.0)
    right: tuple = (1.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    # Spot lights: forward direction + angles (degrees).
    forward: tuple = (0.0, 0.0, -1.0)
    spot_angle: float = 60.0
    inner_spot_angle: float = 40.0


def pack_lights(lights: list[LightDesc]) -> np.ndarray:
    """Pack to the (L, 16) float32 table."""
    out = np.zeros((max(len(lights), 1), LIGHT_SIZE), np.float32)
    for i, l in enumerate(lights):
        pos = np.asarray(l.position, np.float32)
        emission = np.asarray(l.color, np.float32) * l.intensity
        area = float(l.size[0] * l.size[1])
        if l.type == LIGHT_TYPE_SPOT:
            u = np.asarray(l.forward, np.float32)
            v = np.array(
                [np.cos(np.radians(l.spot_angle * 0.5)),
                 np.cos(np.radians(l.inner_spot_angle * 0.5)), 0.0],
                np.float32,
            )
        elif l.type == LIGHT_TYPE_RECTANGLE:
            u = np.asarray(l.right, np.float32) * l.size[0]
            v = np.asarray(l.up, np.float32) * l.size[1]
            pos = pos - (u + v) * 0.5
        else:  # point
            u = np.zeros(3, np.float32)
            v = np.zeros(3, np.float32)
        out[i, 0:3] = pos
        out[i, 3] = float(l.type)
        out[i, 4:7] = emission
        out[i, 7] = l.range
        out[i, 8:11] = u
        out[i, 11] = area
        out[i, 12:15] = v
    return out
