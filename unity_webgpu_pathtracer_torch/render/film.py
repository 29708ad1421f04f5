"""Progressive film and its checkpoints (``render/film.py`` of the
reference).

``accum`` holds the running mean radiance (H, W, 3) on the device; the
sample count is a host integer (it seeds the next pass's RNG streams, so
keeping it on the host avoids a device sync per pass).  ``save``/``load``
use the reference's npz layout (``accum`` float32 (H, W, 3),
``sample_count`` int32), so a checkpoint written by either package loads
in the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Film(NamedTuple):
    accum: torch.Tensor    # (H, W, 3) running mean radiance
    sample_count: int      # samples accumulated per pixel


def new_film(height: int, width: int, device) -> Film:
    return Film(torch.zeros((height, width, 3), dtype=torch.float32, device=device), 0)


def accumulate(film: Film, pass_sum: torch.Tensor, samples_in_pass: int) -> Film:
    """mean' = (pass_sum + mean * n) / (n + s) (``PathTracer.compute:89-98``)."""
    n = float(film.sample_count)
    s = float(samples_in_pass)
    mean = (pass_sum + film.accum * n) / (n + s)
    return Film(mean, film.sample_count + samples_in_pass)


def reset(film: Film) -> Film:
    return Film(torch.zeros_like(film.accum), 0)


def save(path: str, film: Film) -> None:
    np.savez(path, accum=film.accum.detach().cpu().numpy(),
             sample_count=np.asarray(film.sample_count, np.int32))


def load(path: str, device) -> Film:
    """A film saved by ``save`` (or the reference's) on ``device``.  A
    per-pixel sample count (the reference's after a reprojection) must be
    uniform: the port's film keeps one count."""
    with np.load(path) as data:
        accum = np.asarray(data["accum"], np.float32)
        count = np.asarray(data["sample_count"])
    if count.size and (count != count.flat[0]).any():
        raise ValueError(f"{path}: per-pixel sample counts differ; the port's film keeps one")
    n = int(count.flat[0]) if count.size else 0
    return Film(torch.from_numpy(np.ascontiguousarray(accum)).to(device), n)
