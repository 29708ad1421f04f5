"""The plain reference of a progressive film at chosen pixels: every sample
that the program's passes took there, traced again from its seed with the
frozen megakernel (``integrator.py``) on the reference's own tables and ray
casts, and accumulated into the running mean as the film accumulates it.

``dtype=torch.bfloat16`` is the control: the geometry, the ray casts and
the path state between bounces held in bfloat16.
"""

from __future__ import annotations

import torch

from pt_bench.reference import camera as ucamera
from pt_bench.reference import rng as urng
from pt_bench.reference.config import RenderConfig, RenderParams
from pt_bench.reference.integrator import ALPHA_SLACK, firefly_clamp, new_path_state, trace_bounce
from pt_bench.reference.intersect import intersectors

# Paths traced together.
LANES = 1 << 16


def _quantize(s, dtype):
    if dtype == torch.float32:
        return s
    for f in ("origin", "direction", "radiance", "throughput"):
        setattr(s, f, getattr(s, f).to(dtype).to(torch.float32))
    return s


def _path_trace(scene, config, params, o, d, state, fns, dtype):
    s = new_path_state(o, d, state)
    for _ in range(config.max_bounces + 1 + ALPHA_SLACK):
        if not bool(s.alive.any()):
            break
        s = _quantize(trace_bounce(scene, config, params, s, *fns), dtype)
    return s.radiance, s.rng


def pass_sums(scene, config: RenderConfig, params: RenderParams, pixels: torch.Tensor,
              passes: int, dtype=torch.float32) -> torch.Tensor:
    """(passes, P, 3): each pass's radiance sum at ``pixels`` (the port's
    ``render_pass`` at each lane: seeds per (pixel, first sample of the
    pass), ``samples_per_pass`` samples)."""
    dev = pixels.device
    spp = config.samples_per_pass
    pix = pixels.repeat(passes)
    first = torch.arange(passes, device=dev).repeat_interleave(pixels.shape[0]) * spp
    fns = intersectors(dtype)
    out = torch.zeros((pix.shape[0], 3), dtype=torch.float32, device=dev)
    for a in range(0, pix.shape[0], LANES):
        p = pix[a:a + LANES]
        state = urng.seed(p, first[a:a + LANES], params.seed_root)
        total = torch.zeros((3, p.shape[0]), dtype=torch.float32, device=dev)
        for _ in range(spp):
            coords, state = ucamera.jittered_pixel_coords(p, config, state)
            o, d, state = ucamera.get_screen_ray(coords, config, params, state)
            radiance, state = _path_trace(scene, config, params, o.T.contiguous(),
                                          d.T.contiguous(), state, fns, dtype)
            if config.use_firefly_filter:
                radiance = firefly_clamp(radiance, params)
            total = total + radiance
        out[a:a + LANES] = total.T
    return out.reshape(passes, pixels.shape[0], 3)


def film_at(scene, config: RenderConfig, params: RenderParams, pixels: torch.Tensor,
            passes: int, dtype=torch.float32) -> torch.Tensor:
    """(P, 3) running mean after ``passes`` passes at ``pixels``
    (``render/film.py::accumulate``: mean' = (sum + mean n) / (n + s))."""
    sums = pass_sums(scene, config, params, pixels, passes, dtype)
    s = float(config.samples_per_pass)
    mean = torch.zeros_like(sums[0])
    for k in range(passes):
        n = float(k * config.samples_per_pass)
        mean = (sums[k] + mean * n) / (n + s)
    return mean
