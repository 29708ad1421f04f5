"""The upper tree held on chip, on the H100
(``experiments/round18_vmem_tree_probe.py``).

A (4096, 96) bf16 table (level 3 of a wide16 tree, 768 KB) held in the
L2, read with an evict-last policy; each of B = 32,768 lanes fetches its
row as f32 (``cuda_probes.tree_gather``), a row of zeros where its index
lies outside the table, as the TPU probe's one-hot MXU product gives.
Against the gather from device memory, ``table.float()[idx]``, which the
TPU probe timed beside its product.  ``ms`` with the L2 flushed before
each call, ``warm_ms`` without: warm, the table and the last call's
output may stay in the L2.  ns per lane-row.

    python -m unity_webgpu_pathtracer_torch.experiments.round18_vmem_tree_probe
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.experiments._common import (check, cuda_device, max_err, row,
                                                              time_cold_ms, time_ms)
from unity_webgpu_pathtracer_torch.ops import cuda_probes as cp

B = 1 << 15
# Indices outside the table, each of which must give a row of zeros.
OUTSIDE = (-1, cp.TREE_ROWS, 2**31 - 1, -(2**31))


def inputs(dev, b: int = B):
    idx = np.random.default_rng(0).integers(0, cp.TREE_ROWS, b).astype(np.int32)
    table = np.random.default_rng(1).uniform(size=(cp.TREE_ROWS, cp.TREE_COLS))
    return (torch.from_numpy(table.astype(np.float32)).to(torch.bfloat16).to(dev),
            torch.from_numpy(idx).to(dev))


def with_outside(idx: torch.Tensor) -> torch.Tensor:
    """``idx`` with every 7th index replaced by one of ``OUTSIDE`` in turn."""
    out = idx.clone()
    k = torch.arange(0, idx.shape[0], 7, device=idx.device)
    out[k] = torch.tensor(OUTSIDE, dtype=torch.int32, device=idx.device).repeat(
        -(-k.shape[0] // len(OUTSIDE)))[:k.shape[0]]
    return out


def run(device=None) -> list[dict]:
    dev = cuda_device(device)
    table, idx = inputs(dev)
    table32, li = table.float(), idx.long()   # the library call times the gather alone
    got, want = cp.tree_gather(table, idx), cp.tree_gather_plain(table, idx)
    odd = with_outside(idx)
    got_o, want_o = cp.tree_gather(table, odd), cp.tree_gather_plain(table, odd)
    ok = (bool(torch.equal(got, want)) and bool(torch.equal(got_o, want_o))
          and not bool(got_o[::7].any()))
    ms = time_cold_ms(lambda: cp.tree_gather(table, idx))
    warm = time_ms(lambda: cp.tree_gather(table, idx))
    distinct = int(torch.unique(idx).numel())
    nbytes = distinct * cp.TREE_COLS * 2 + idx.nbytes + got.nbytes
    return check([row(f"tree gather B={B} rows={cp.TREE_ROWS}x{cp.TREE_COLS} bf16 (L2)",
                      "tree_gather", ms, time_ms(lambda: cp.tree_gather_plain(table, idx)),
                      ms * 1e6 / B, "lane-row", nbytes, 0.0,
                      max(max_err(got, want), max_err(got_o, want_o)), ok,
                      "exact (every 7th index outside the table in a second call: zeros)",
                      library_ms=time_ms(lambda: table32[li]), warm_ms=warm)])


def main() -> None:
    print("device:", torch.cuda.get_device_name(cuda_device()))
    (r,) = run()
    print(f"tree gather        : {r['ms']:.4f} ms cold, {r['warm_ms']:.4f} warm / {B} lanes = "
          f"{r['ns_per']:.4f} ns/lane-row")
    print(f"table.float()[idx] : {r['library_ms']:.4f} ms / {B} lanes = "
          f"{r['library_ms'] * 1e6 / B:.4f} ns/lane-row")
    print(f"exact rows: {r['ok']}; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


if __name__ == "__main__":
    main()
