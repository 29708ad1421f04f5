"""What a bf16 leaf decode would save K1 on the H100
(``experiments/round16_bf16leaf_probe.py``).

The production arrival kernel (``f16leaf``: the split slot order, f16
leaf halfwords through ``__half2float``) against the same kernel with the
halfwords decoded as bf16 (``bf16leaf``: ``__uint_as_float(h << 16)``):
one arrival of ``arrival16_run_kernel`` in place, lane i on row
``rows[i]``, on the original's input (``round14_kernel_diet.synthetic_inputs``:
B = 98,304 lanes, each on a row of its own, DEPTH = 11), each twice, timed
with the L2 flushed after each restore (``ms``) and warm (``warm_ms``),
bounded by the production kernel's in-place bytes
(``_common.arrivals_work`` with the row plane; the out-of-place yardstick
as ``old_bound_ms``).  ``chip_smoke.py`` phase 13 also runs both on
captured 1080p states.

    python -m unity_webgpu_pathtracer_torch.experiments.round16_bf16leaf_probe
"""

from __future__ import annotations

import torch

from unity_webgpu_pathtracer_torch.experiments._common import check, cuda_device
from unity_webgpu_pathtracer_torch.experiments.round14_kernel_diet import (B, DEPTH,
                                                                           modes_on_state,
                                                                           savings,
                                                                           synthetic_inputs)

MODES = ("f16leaf", "bf16leaf")


def run(device=None) -> list[dict]:
    dev = cuda_device(device)
    return check(modes_on_state(synthetic_inputs(dev), "synthetic", MODES + MODES))


def main() -> None:
    print(f"B={B} DEPTH={DEPTH} (production kernel) "
          f"device={torch.cuda.get_device_name(cuda_device())}")
    rows = run()
    for r in rows:
        print(f"{r['mode']:8s}: {r['ms']:7.4f} ms/call cold ({r['ns_per']:5.3f} ns/lane), warm "
              f"{r['warm_ms']:.4f}; plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}; out of place {r['old_bound_ms']:.5f})")
    dt, share = savings(rows, "f16leaf")["bf16leaf"]
    print(f"  -> bf16 leaf decode saves {dt:7.4f} ms/call ({share * 100:4.1f}% of kernel)")


if __name__ == "__main__":
    main()
