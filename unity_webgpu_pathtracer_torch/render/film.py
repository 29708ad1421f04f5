"""Progressive film and its checkpoints (``render/film.py`` of the
reference).

``accum`` holds the running mean radiance (H, W, 3) on the device.  Every
pixel has the same sample count until a temporal reprojection
(``render/reproject.py``) leaves a count per pixel: ``pixel_counts``,
(H, W, 1) int32 on the film's device (None while the counts are uniform).
``sample_count`` is a host integer, the largest count: it seeds the next
pass's RNG streams (the reference's ``jnp.max(film.sample_count)``), and
keeping it on the host avoids a device read per pass; a reprojection reads
it from the device once, when it makes the counts.  ``save``/``load`` use
the reference's npz layout (``accum`` float32 (H, W, 3), ``sample_count``
int32, a scalar or (H, W, 1)), so a checkpoint written by either package
loads in the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Film(NamedTuple):
    accum: torch.Tensor                       # (H, W, 3) running mean radiance
    sample_count: int                         # samples of the most-sampled pixel
    pixel_counts: torch.Tensor | None = None  # (H, W, 1) int32; None: all sample_count


def new_film(height: int, width: int, device) -> Film:
    return Film(torch.zeros((height, width, 3), dtype=torch.float32, device=device), 0)


def accumulate(film: Film, pass_sum: torch.Tensor, samples_in_pass: int) -> Film:
    """mean' = (pass_sum + mean * n) / (n + s) (``PathTracer.compute:89-98``),
    per pixel when the film has per-pixel counts."""
    s = float(samples_in_pass)
    if film.pixel_counts is None:
        n = float(film.sample_count)
        mean = (pass_sum + film.accum * n) / (n + s)
        return Film(mean, film.sample_count + samples_in_pass)
    n = film.pixel_counts.to(torch.float32)
    mean = (pass_sum + film.accum * n) / (n + s)
    return Film(mean, film.sample_count + samples_in_pass,
                film.pixel_counts + samples_in_pass)


def reset(film: Film) -> Film:
    """Zero the film; the counts go back to one scalar 0."""
    return Film(torch.zeros_like(film.accum), 0)


def save(path: str, film: Film) -> None:
    """The reference's layout: ``sample_count`` an int32 scalar, or
    (H, W, 1) after a reprojection."""
    counts = (np.asarray(film.sample_count, np.int32) if film.pixel_counts is None
              else film.pixel_counts.cpu().numpy())
    np.savez(path, accum=film.accum.detach().cpu().numpy(), sample_count=counts)


def load(path: str, device) -> Film:
    """A film saved by ``save`` (or the reference's) on ``device``, its
    per-pixel counts with it."""
    with np.load(path) as data:
        accum = np.asarray(data["accum"], np.float32)
        count = np.asarray(data["sample_count"])
    accum_t = torch.from_numpy(np.ascontiguousarray(accum)).to(device)
    if count.ndim == 0:
        return Film(accum_t, int(count))
    if count.shape != accum.shape[:2] + (1,):
        raise ValueError(f"{path}: sample counts of {count.shape} for a film of {accum.shape}")
    counts = torch.from_numpy(np.ascontiguousarray(count, np.int32)).to(device)
    return Film(accum_t, int(count.max()), counts)
