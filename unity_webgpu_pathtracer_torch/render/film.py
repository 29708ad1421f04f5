"""Progressive film (``render/film.py`` of the reference).

``accum`` holds the running mean radiance (H, W, 3) on the device; the
sample count is a host integer (it seeds the next pass's RNG streams, so
keeping it on the host avoids a device sync per pass).
"""

from __future__ import annotations

from typing import NamedTuple

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
