"""The comparison that decides ``correct``: the program's film after the
window against the plain reference at pixels drawn from the seed, and its
last presented image against the reference's presentation of that film.

Numbers (each held to the cell's limit in ``workloads/cells/<cell>.json``):

* ``px_err_median``: the median over the sampled pixels of the pixel's
  error, ``max_c |film - ref| / max(max_c |ref|, RADIANCE_FLOOR)``;
* ``px_bad_share``: the share of sampled pixels whose error passes
  ``BAD_ERR`` (a path that took another way: a silhouette, a shadow edge);
* ``image_lsb_max``: the largest difference, in 8-bit steps, between the
  last image the program presented and the reference's presentation
  (``Renderer.image``'s chain) of the program's final film, over every pixel.
"""

from __future__ import annotations

import numpy as np
import torch

from pt_bench.reference import tonemap
from pt_bench.reference.config import PostParams

RADIANCE_FLOOR = 1e-2
BAD_ERR = 0.05


def sample_pixels(seed: int, n_pixels: int, count: int) -> np.ndarray:
    """``count`` distinct pixel indices drawn from the seed, sorted."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels), replace=False))


def pixel_errors(film_px: torch.Tensor, ref_px: torch.Tensor) -> torch.Tensor:
    diff = (film_px.double() - ref_px.double()).abs().amax(-1)
    return diff / ref_px.double().abs().amax(-1).clamp_min(RADIANCE_FLOOR)


def film_numbers(film_px: torch.Tensor, ref_px: torch.Tensor) -> dict:
    err = pixel_errors(film_px, ref_px)
    return {"px_err_median": float(err.median()),
            "px_bad_share": float((err > BAD_ERR).double().mean())}


def present(film: torch.Tensor) -> np.ndarray:
    """uint8 (H, W, 3), row 0 = top: ``Renderer.image`` with default post."""
    out = torch.clamp(tonemap.present(film, PostParams()), 0.0, 1.0) * 255 + 0.5
    return out.to(torch.uint8).flip(0).cpu().numpy()


def image_lsb_max(image: np.ndarray, film: torch.Tensor) -> float:
    want = present(film)
    return float(np.abs(image.astype(np.int16) - want.astype(np.int16)).max())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number at or under its limit; the report pairs each with it."""
    report = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return bool(ok), report
