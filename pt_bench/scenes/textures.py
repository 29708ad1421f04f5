"""Procedural texture images, named by a configuration's ``textures``
entries: ``{"kind": "checker", "size": n, "cells": k, "colors": [a, b]}``
(a base colour, alpha or metallic-roughness image of k x k squares) and
``{"kind": "bumps", "size": n, "cells": k, "strength": s}`` (a tangent-space
normal map of k x k round bumps).  Each is an (n, n, 3|4) float32 image in
[0, 1], which the port and the reference each pack into their own atlas."""

from __future__ import annotations

import numpy as np


def checker(size: int, cells: int, colors) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size]
    odd = ((x * cells // size) + (y * cells // size)) % 2 == 1
    a, b = (np.asarray(c, np.float32) for c in colors)
    return np.where(odd[..., None], b, a).astype(np.float32)


def bumps(size: int, cells: int, strength: float) -> np.ndarray:
    c = (np.arange(size) + 0.5) / size * cells
    f = c - np.floor(c) - 0.5                          # position inside a cell, [-0.5, 0.5)
    fx, fy = np.meshgrid(f, f)
    r2 = fx * fx + fy * fy
    inside = r2 < 0.16
    nx = np.where(inside, -strength * fx, 0.0)
    ny = np.where(inside, -strength * fy, 0.0)
    n = np.stack([nx, ny, np.ones_like(nx)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)


KINDS = {"checker": checker, "bumps": bumps}


def make(desc: dict) -> np.ndarray:
    kw = {k: v for k, v in desc.items() if k != "kind"}
    return KINDS[desc["kind"]](**kw)
