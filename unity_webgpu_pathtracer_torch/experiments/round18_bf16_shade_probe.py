"""The shading chain's rate in f32 and bf16 on the H100
(``experiments/round18_bf16_shade_probe.py``).

64 repeats of a Disney lobe chain (schlick + GTR2 + Smith + Fresnel, ~68
f32 operations) over B = 65,536 lanes, accumulated in f32, computed in f32
and in bf16 (two lanes a thread, packed bf16x2 instructions).  The TPU
compared three layouts of the lanes ((B,), (8, B/8), (16, B/16)); on the
card they are the same bytes and one kernel serves them all.  The TPU
rejected bf16; on the card it runs, and its time against f32 is the
answer.

    python -m unity_webgpu_pathtracer_torch.experiments.round18_bf16_shade_probe
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.experiments._common import (check, cuda_device, max_err, row,
                                                              time_ms)
from unity_webgpu_pathtracer_torch.ops import cuda_probes as cp

B = 1 << 16
# Operations of one repeat on one lane, counted from _chain: in f32, 68 (the
# chain and the sum).  In bf16, 61 of them are packed bf16x2 instructions
# (add, sub, mul, min, max) at the bf16 rate; 13 run at the f32 rate: the
# four divisions and two square roots, each rounded back to bf16 (six
# conversions), and the f32 sum.  Widening bf16 to f32 moves bits and is
# not counted.
CHAIN_OPS = 68
BF16_PACKED_OPS, BF16_F32_OPS = 61, 13
# The bf16 kernel rounds each add once where PyTorch rounds to f32 and then
# to bf16, and those rare one-ulp steps grow along the chain: at least 99%
# of lanes within rtol 2^-6 (two bf16 ulps), all finite.
BF16_RTOL, BF16_SHARE = 2.0 ** -6, 0.99


def inputs(dev, b: int = B) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).uniform(0.05, 0.95, b)
                            .astype(np.float32)).to(dev)


def bf16_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    close = torch.isclose(got, want, rtol=BF16_RTOL, atol=0.0).float().mean()
    return bool(torch.isfinite(got).all()) and float(close) >= BF16_SHARE


def run(device=None) -> list[dict]:
    dev = cuda_device(device)
    x = inputs(dev)
    out = []
    lane_chains = cp.LOBE_REPEATS * B
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        got, want = cp.lobe_chain(x, dtype), cp.lobe_chain_plain(x, dtype)
        if dtype == torch.float32:
            ok, tol = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6)), "rtol 1e-5, atol 1e-6"
        else:
            ok, tol = bf16_close(got, want), "99% of lanes within rtol 2^-6"
        ms = time_ms(lambda: cp.lobe_chain(x, dtype))
        f32_ops, bf16_ops = ((CHAIN_OPS, 0) if dtype == torch.float32
                             else (BF16_F32_OPS, BF16_PACKED_OPS))
        out.append(row(f"{name} lobe chain (B,) = (8, B/8) = (16, B/16)", f"lobe_chain_{name}",
                       ms, time_ms(lambda: cp.lobe_chain_plain(x, dtype)),
                       ms * 1e6 / lane_chains, "lane-chain", 2 * x.nbytes,
                       f32_ops * lane_chains, max_err(got, want), ok, tol,
                       bf16_ops=bf16_ops * lane_chains))
    return check(out)


def main() -> None:
    print("device:", torch.cuda.get_device_name(cuda_device()))
    rows = run()
    for r in rows:
        print(f"{r['name']:42s}: {r['ms']:.4f} ms = {r['ns_per']:.5f} ns/lane-chain; plain "
              f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"bf16 / f32 time: {rows[1]['ms'] / rows[0]['ms']:.3f}")


if __name__ == "__main__":
    main()
