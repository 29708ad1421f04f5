"""A 64-op elementwise chain on the H100 (``experiments/round20_tile3d_probe.py``).

32 steps of ``x = x * 1.000001 + 0.000001`` over B = 98,304 lanes, in the
three layouts the TPU compared ((B,), (8, B/8), (B/1024, 8, 128)).  They
are the same bytes on the card, so the same kernel runs on each view; the
question of a relayout copy does not arise.

    python -m unity_webgpu_pathtracer_torch.experiments.round20_tile3d_probe
"""

from __future__ import annotations

import torch

from unity_webgpu_pathtracer_torch.experiments._common import (check, cuda_device, max_err, row,
                                                              time_ms)
from unity_webgpu_pathtracer_torch.ops import cuda_probes as cp

B = 3 << 15
SHAPES = {"1-D (B,)": (B,), "2-D (8, B/8)": (8, B // 8), "3-D (n, 8, 128)": (B // 1024, 8, 128)}


def run(device=None) -> list[dict]:
    dev = cuda_device(device)
    out = []
    for label, shape in SHAPES.items():
        x = torch.arange(B, dtype=torch.float32, device=dev).reshape(shape)
        got, want = cp.step_chain(x), cp.step_chain_plain(x)
        ms = time_ms(lambda: cp.step_chain(x))
        out.append(row(f"chain {label}", "step_chain", ms, time_ms(lambda: cp.step_chain_plain(x)),
                       ms * 1e6 / B, "lane-chain", 2 * x.nbytes, 2 * cp.STEPS * B,
                       max_err(got, want), bool(torch.equal(got, want)), "exact"))
    return check(out)


def main() -> None:
    print(f"device: {torch.cuda.get_device_name(cuda_device())}  B={B} ops={2 * cp.STEPS}")
    for r in run():
        print(f"{r['name']:28s} {r['ns_per']:8.5f} ns/lane-chain ({r['ms']:.4f} ms; plain "
              f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms, {r['bound_by']})")


if __name__ == "__main__":
    main()
