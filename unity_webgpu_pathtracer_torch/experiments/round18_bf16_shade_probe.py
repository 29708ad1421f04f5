"""The shading chain's rate in f32 and bf16 on the H100
(``experiments/round18_bf16_shade_probe.py``).

64 repeats of a Disney lobe chain (schlick + GTR2 + Smith + Fresnel, ~68
f32 operations) over B = 65,536 lanes, accumulated in f32, computed in f32
and in bf16, one lane a thread (bf16: scalar bf16 instructions).  The TPU
compared three layouts of the lanes ((B,), (8, B/8), (16, B/16)); on the
card they are the same bytes and one kernel serves them all.  The TPU
rejected bf16; on the card it runs, and its time against f32 is the
answer for this chain at this B, where both kernels are bound by latency
(a scheduler holds few independent chains), and for scalar bf16: it does
not say whether the packed bf16x2 rate pays where throughput binds.

    python -m unity_webgpu_pathtracer_torch.experiments.round18_bf16_shade_probe
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.experiments._common import (check, cuda_device, max_err, row,
                                                              time_cold_ms, time_ms)
from unity_webgpu_pathtracer_torch.ops import cuda_probes as cp

B = 1 << 16
# Operations of one repeat on one lane, counted from _chain: in f32, 68 (the
# chain and the sum).  In bf16, 61 of them are bf16 adds, subs, muls, mins
# and maxes, counted as lane-operations at the card's packed bf16x2 rate
# (the least time for them; the kernel issues scalar bf16 instructions);
# 13 run at the f32 rate: the four divisions and two square roots, each
# rounded back to bf16 (six conversions), and the f32 sum.  Widening bf16
# to f32 moves bits and is not counted.
CHAIN_OPS = 68
BF16_PACKED_OPS, BF16_F32_OPS = 61, 13


def inputs(dev, b: int = B) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).uniform(0.05, 0.95, b)
                            .astype(np.float32)).to(dev)


def run(device=None) -> list[dict]:
    """Both chains held exact against ``lobe_chain_plain`` (torch.equal),
    timed with a warm and a cold L2 (``cold_ms``)."""
    dev = cuda_device(device)
    x = inputs(dev)
    out = []
    lane_chains = cp.LOBE_REPEATS * B
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        want = cp.lobe_chain_plain(x, dtype)
        got = cp.lobe_chain(x, dtype)
        ok, err = bool(torch.equal(got, want)), max_err(got, want)
        ms = time_ms(lambda: cp.lobe_chain(x, dtype))
        f32_ops, bf16_ops = ((CHAIN_OPS, 0) if dtype == torch.float32
                             else (BF16_F32_OPS, BF16_PACKED_OPS))
        out.append(row(f"{name} lobe chain (B,) = (8, B/8) = (16, B/16)", f"lobe_chain_{name}",
                       ms, time_ms(lambda: cp.lobe_chain_plain(x, dtype)),
                       ms * 1e6 / lane_chains, "lane-chain", 2 * x.nbytes,
                       f32_ops * lane_chains, err, ok, "exact (torch.equal)",
                       bf16_ops=bf16_ops * lane_chains,
                       cold_ms=time_cold_ms(lambda: cp.lobe_chain(x, dtype))))
    return check(out)


def ratio(rows: list[dict]) -> float:
    """bf16 time over f32 time: the probe's answer (scalar bf16, this
    latency-bound size)."""
    ms = {r["kernel"]: r["ms"] for r in rows}
    return ms["lobe_chain_bf16"] / ms["lobe_chain_f32"]


def main() -> None:
    print("device:", torch.cuda.get_device_name(cuda_device()))
    rows = run()
    for r in rows:
        print(f"{r['name']:42s}: {r['ms']:.4f} ms warm, {r['cold_ms']:.4f} cold = "
              f"{r['ns_per']:.5f} ns/lane-chain; plain {r['plain_ms']:.3f} ms; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"bf16 / f32 time: {ratio(rows):.3f}")


if __name__ == "__main__":
    main()
