# Frozen copy of unity_webgpu_pathtracer_torch/utils/rng.py at commit 628fc1bc0151d37c4767d2275c25b153616afc0d,
# imports rewritten to this package; the benchmark's yardstick, not to be edited with the port.
"""Counter-based PCG random numbers (``utils/rng.py`` of the reference).

The state is a uint32 per lane.  PyTorch's uint32 arithmetic is
incomplete, so states live in int64 tensors holding values in
``[0, 2**32)`` and every step masks back to 32 bits; the stream is bit
for bit the reference's (``random.hlsl:5-16``), seeded per (pixel,
sample) as ``pixel * (sample + 1) + seed_root`` (``PathTracer.compute:60``).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# f32(1 / (2**32 - 1)), the reference's uniform scale.
_INV_U32 = torch.tensor(1.0 / 4294967295.0, dtype=torch.float32).item()


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``(a * b) mod 2**32`` for values below 2**32 without int64
    overflow: split ``b`` into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def seed(pixel_index: torch.Tensor, sample_index, seed_root) -> torch.Tensor:
    """Per-ray RNG state: ``pixel * (sample + 1) + seed_root`` mod 2**32."""
    pixel = pixel_index.to(torch.int64) & _M32
    sample = torch.as_tensor(sample_index, dtype=torch.int64,
                             device=pixel.device) & _M32
    root = torch.as_tensor(seed_root, dtype=torch.int64,
                           device=pixel.device) & _M32
    return (_mul32(pixel, (sample + 1) & _M32) + root) & _M32


def next_state(state: torch.Tensor) -> torch.Tensor:
    """One PCG step (``random.hlsl:5-10``), uint32 wrap-around."""
    old = (state + 747796405 + 2891336453) & _M32
    shift = (old >> 28) + 4
    word = (((old >> shift) ^ old) * 277803737) & _M32
    return (word >> 22) ^ word


def random_float(state: torch.Tensor):
    """Advance and return ``(u, new_state)``, u uniform in [0, 1].

    int64 -> float32 conversion rounds to nearest, as XLA's uint32 convert
    does, so ``u`` matches the reference bit for bit."""
    state = next_state(state)
    return state.to(torch.float32) * _INV_U32, state


def random_floats(state: torch.Tensor, n: int):
    """Draw ``n`` sequential uniforms; returns ``(list_of_u, new_state)``."""
    us = []
    for _ in range(n):
        u, state = random_float(state)
        us.append(u)
    return us, state
