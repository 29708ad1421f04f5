"""The upper tree held on chip, on the H100
(``experiments/round18_vmem_tree_probe.py``).

A (4096, 96) bf16 table (level 3 of a wide16 tree, 768 KB) held in the
distributed shared memory of a 4-block cluster, 1,024 rows a block; each
of B = 32,768 lanes fetches its row through the cluster as f32.  Against
the gather from device memory, ``table.float()[idx]``, which the TPU
probe timed beside its one-hot MXU product.  ns per lane-row.

    python -m unity_webgpu_pathtracer_torch.experiments.round18_vmem_tree_probe
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.experiments._common import (check, cuda_device, max_err, row,
                                                              time_ms)
from unity_webgpu_pathtracer_torch.ops import cuda_probes as cp

B = 1 << 15


def inputs(dev, b: int = B):
    idx = np.random.default_rng(0).integers(0, cp.TREE_ROWS, b).astype(np.int32)
    table = np.random.default_rng(1).uniform(size=(cp.TREE_ROWS, cp.TREE_COLS))
    return (torch.from_numpy(table.astype(np.float32)).to(torch.bfloat16).to(dev),
            torch.from_numpy(idx).to(dev))


def run(device=None) -> list[dict]:
    dev = cuda_device(device)
    table, idx = inputs(dev)
    table32, li = table.float(), idx.long()   # the library call times the gather alone
    got, want = cp.cluster_gather(table, idx), cp.cluster_gather_plain(table, idx)
    ms = time_ms(lambda: cp.cluster_gather(table, idx))
    distinct = int(torch.unique(idx).numel())
    nbytes = distinct * cp.TREE_COLS * 2 + idx.nbytes + got.nbytes
    return check([row(f"cluster gather B={B} rows={cp.TREE_ROWS}x{cp.TREE_COLS} bf16",
                      "cluster_gather", ms, time_ms(lambda: cp.cluster_gather_plain(table, idx)),
                      ms * 1e6 / B, "lane-row", nbytes, 0.0, max_err(got, want),
                      bool(torch.equal(got, want)), "exact",
                      library_ms=time_ms(lambda: table32[li]))])


def main() -> None:
    print("device:", torch.cuda.get_device_name(cuda_device()))
    (r,) = run()
    print(f"cluster-dsmem      : {r['ms']:.4f} ms / {B} lanes = {r['ns_per']:.4f} ns/lane-row")
    print(f"table.float()[idx] : {r['library_ms']:.4f} ms / {B} lanes = "
          f"{r['library_ms'] * 1e6 / B:.4f} ns/lane-row")
    print(f"exact rows: {r['ok']}; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


if __name__ == "__main__":
    main()
