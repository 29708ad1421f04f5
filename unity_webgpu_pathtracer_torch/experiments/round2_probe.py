"""Row gathers and a shading-like chain on the H100 (``experiments/round2_probe.py``).

Three kernels of the original, each against its plain version, the
gathers beside the PyTorch calls that compute what they compute:

* ``dma_gather`` (P1): per-row TMA bulk copies through rings of slots
  on blocks over every SM, from tables of 8 / 87 / 232 MB, 1,024 and
  8,192 rows a call; out is the last 16 rows' sum, as the original's
  16-slot ring leaves it, checked after the first call and after the
  timed replays;
* ``vmem_gather`` (P2): 4,096 dynamic row reads from a (N, 48) table held
  in the distributed shared memory of a thread block cluster (24, 48, 96
  and 192 KB on 8 blocks, 2 MB on 16) or read from device memory (the
  original's 2-24 MB, held by the 50 MB L2), each size beside the launch
  floor (``_common.launch_floor_ms``).  Its library call is
  ``table_sum_library``, one ``embedding_bag`` that computes sum_k
  table[idx[k], 0], checked exact against the plain version;
  ``tab[li, 0].sum()``, two calls, is timed beside it;
* ``shade`` (P3): 40 blocks of a Schlick-like chain over (2048, 128),
  bit for bit against its plain version, and its remainder by 0.9f
  against fmodf on every non-negative f32 bit pattern
  (``cuda_probes.remainder_check``).

    python -m unity_webgpu_pathtracer_torch.experiments.round2_probe
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from unity_webgpu_pathtracer_torch.experiments._common import (check, cuda_device,
                                                              launch_floor_ms, max_err, row,
                                                              time_ms, time_ms_out)
from unity_webgpu_pathtracer_torch.ops import cuda_probes as cp

DMA_MB, DMA_CHUNKS = (8, 87, 232), (1024, 8192)
VMEM_MB = (2, 8, 12, 16, 24)
SMEM_KB = (24, 48, 96, 192)   # tables on a cluster of 8 blocks
CLUSTER_MB = (2,)             # tables on a cluster of 16 blocks
VMEM_CHUNK = 4096
SHADE_B = 262144
SCHLICK_OPS = 17      # f32 operations per block and element (sqrt, fmod as one)


def table(n: int, w: int, device) -> torch.Tensor:
    """``jnp.arange(n * w, dtype=float32).reshape(n, w) % 7.0``: the index
    rounded to f32, then its remainder (integers 0-6)."""
    i = torch.arange(n * w, dtype=torch.int64, device=device).to(torch.float32)
    return torch.fmod(i, 7.0).reshape(n, w)


def hashed_idx(chunk: int, n: int) -> np.ndarray:
    """``(jnp.arange(chunk, dtype=int32) * int32(-1640531527)) % n``: the
    product wraps in int32, the remainder is floored."""
    prod = (np.arange(chunk, dtype=np.int64) * -1640531527).astype(np.int32)
    return np.mod(prod.astype(np.int64), n).astype(np.int32)


def table_sum_library(tab: torch.Tensor, li: torch.Tensor, bag: torch.Tensor) -> torch.Tensor:
    """P2's function in one PyTorch call, (1, 1): ``embedding_bag`` sums
    the column view ``tab[:, :1]`` over one bag of every index (``bag``
    holds its offset, 0)."""
    return F.embedding_bag(li, tab[:, :1], bag, mode="sum")


def dma_gather(dev) -> list[dict]:
    rows = []
    for mb in DMA_MB:
        n = int(mb * 1e6 / (cp.RING_W * 4))
        tab = table(n, cp.RING_W, dev)
        for chunk in DMA_CHUNKS:
            idx = torch.from_numpy(hashed_idx(chunk, n)).to(dev)
            li = idx.long()   # the library call times the gather alone
            got, want = cp.ring_gather(tab, idx), cp.ring_gather_plain(tab, idx)
            ms, again = time_ms_out(lambda: cp.ring_gather(tab, idx))
            nbytes = chunk * (cp.RING_W * 4 + 4) + cp.RING_W * 4
            rows.append(row(f"dma_gather table={mb}MB chunk={chunk}", "ring_gather", ms,
                            time_ms(lambda: cp.ring_gather_plain(tab, idx)),
                            ms * 1e6 / chunk, "row", nbytes, 0.0,
                            max(max_err(got, want), max_err(again, want)),
                            torch.equal(got, want) and torch.equal(again, want), "exact",
                            library_ms=time_ms(lambda: tab[li])))
        del tab
    return rows


def vmem_gather(dev) -> list[dict]:
    rows = []
    floor = launch_floor_ms(dev)
    sizes = [(kb * 1024 // (cp.TABLE_W * 4), f"{kb}KB on chip", True) for kb in SMEM_KB]
    sizes += [(int(mb * 1e6 / (cp.TABLE_W * 4)), f"{mb}MB on chip", True) for mb in CLUSTER_MB]
    sizes += [(int(mb * 1e6 / (cp.TABLE_W * 4)), f"{mb}MB in device memory", False)
              for mb in VMEM_MB]
    for n, label, on_chip in sizes:
        tab = table(n, cp.TABLE_W, dev)
        idx = torch.from_numpy(hashed_idx(VMEM_CHUNK, n)).to(dev)
        li, bag = idx.long(), torch.zeros(1, dtype=torch.long, device=dev)
        got, want = cp.table_sum(tab, idx, on_chip), cp.table_sum_plain(tab, idx)
        if not torch.equal(table_sum_library(tab, li, bag), want):
            raise AssertionError(f"table_sum_library disagrees with table_sum_plain at {label}")
        ms, again = time_ms_out(lambda: cp.table_sum(tab, idx, on_chip))
        distinct = int(torch.unique(idx).numel())
        plan = (dict(cluster=cp.table_cluster_plan(n)[0]) if on_chip
                else dict(blocks=cp.table_plan(VMEM_CHUNK)[0]))
        rows.append(row(f"vmem_gather table={label} chunk={VMEM_CHUNK}",
                        "table_sum_smem" if on_chip else "table_sum_global", ms,
                        time_ms(lambda: cp.table_sum_plain(tab, idx)), ms * 1e6 / VMEM_CHUNK,
                        "row", distinct * 4 + VMEM_CHUNK * 4 + 4, VMEM_CHUNK,
                        max(max_err(got, want), max_err(again, want)),
                        torch.equal(got, want) and torch.equal(again, want), "exact",
                        library_ms=time_ms(lambda: table_sum_library(tab, li, bag)),
                        two_calls_ms=time_ms(lambda: tab[li, 0].sum()), floor_ms=floor, **plan))
    return rows


def shade(dev) -> list[dict]:
    x = torch.from_numpy(np.linspace(0.1, 0.9, SHADE_B).astype(np.float32)
                         .reshape(SHADE_B // 128, 128)).to(dev)
    got, want = cp.schlick_chain(x), cp.schlick_chain_plain(x)
    mismatches = cp.remainder_check(device=dev)
    ms = time_ms(lambda: cp.schlick_chain(x))
    return [row(f"shade 40-block chain B={SHADE_B}", "schlick_chain", ms,
                time_ms(lambda: cp.schlick_chain_plain(x)), ms * 1e6 / SHADE_B, "lane",
                2 * x.nbytes, SCHLICK_OPS * cp.SCHLICK_BLOCKS * SHADE_B, max_err(got, want),
                torch.equal(got, want) and mismatches == 0, "exact",
                remainder_mismatches=mismatches)]


def run(device=None) -> list[dict]:
    dev = cuda_device(device)
    return check(dma_gather(dev) + vmem_gather(dev) + shade(dev))


def main() -> None:
    print("device:", torch.cuda.get_device_name(cuda_device()))
    for r in run():
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        if "two_calls_ms" in r:
            lib += f", tab[li, 0].sum() (two calls) {r['two_calls_ms']:.4f} ms"
        if "floor_ms" in r:
            lib += f"; launch floor {r['floor_ms']:.4f} ms"
        if "remainder_mismatches" in r:
            lib += f"; remainder vs fmodf: {r['remainder_mismatches']} mismatches of 2^31"
        print(f"{r['name']}: {r['ms']:.4f} ms ({r['ns_per']:.2f} ns/{r['per']}); plain "
              f"{r['plain_ms']:.4f} ms{lib}; bound {r['bound_ms']:.5f} ms ({r['bound_by']}); "
              f"max abs err {r['max_abs_err']:g} ({r['tol']})")


if __name__ == "__main__":
    main()
