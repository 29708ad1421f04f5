"""Split tables of the fat-row format (``accel/wide2.py`` of the
reference), the tables of the ``wide2`` traversal
(``ops/traverse_wide2.py``): the inner rows apart from the leaves.

* ``inner (O, Ni, 32)``: per octant order, ``[child boxes SoA 24 | child
  codes 4 | skip code 1 | kind 1 | 0 0]``;
* ``leaf_geo (Nl, 48)``: the leaf rows, shared by every order (a leaf's
  content does not depend on it), skip lane cleared, count kept;
* ``leaf_skip (O, Nl)``: each leaf's continuation code per order.

Signed position codes replace row indices: ``c > 0`` is inner row ``c -
1``, ``c < 0`` leaf ``-c - 1``, ``0`` the end.  An instance row
(kind < 0, ``accel/tlas.py``) keeps ``[entry code, inner end, leaf end,
material]`` in its child lanes: its BLAS region, in both index spaces,
as exclusive bounds + 1.

Built from the unified table (``accel/wide.py`` / ``accel/tlas.py``), so
the numpy and native builders share this step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

OFF_PTRS = 24
OFF_SKIP = 44
OFF_KIND = 45


class SplitTables(NamedTuple):
    inner: np.ndarray       # (O, Ni, 32) float32
    leaf_geo: np.ndarray    # (Nl, 48) float32 (skip lane cleared)
    leaf_skip: np.ndarray   # (O, Nl) int32 signed codes
    leaf_count: np.ndarray  # (Nl,) int32 triangles per leaf


def _ints(rows: np.ndarray, col: int) -> np.ndarray:
    return rows[..., col:col + 1].view(np.int32)[..., 0]


def split_wide(table: np.ndarray) -> SplitTables:
    """Split a unified ``(O, N, 48)`` table."""
    n_oct, n, _ = table.shape
    is_leaf0 = _ints(table[0], OFF_KIND) > 0

    # The shared leaves, from order 0.
    leaf_rows0 = np.where(is_leaf0)[0]
    nl = leaf_rows0.shape[0]
    leaf_geo = table[0, leaf_rows0].copy()
    leaf_count = _ints(leaf_geo, OFF_KIND).copy()
    leaf_geo[:, OFF_SKIP] = 0.0
    # A leaf is named by its sorted attribute indices.
    leaf_id_by_key = {}
    for li, row_idx in enumerate(leaf_rows0):
        idx = table[0, row_idx, 36:40].view(np.int32)
        leaf_id_by_key[tuple(sorted(idx[:leaf_count[li]].tolist()))] = li

    ni = n - nl
    inner = np.zeros((n_oct, ni, 32), np.float32)
    leaf_skip = np.zeros((n_oct, nl), np.int32)

    for o in range(n_oct):
        kinds = _ints(table[o], OFF_KIND)
        is_leaf = kinds > 0
        inner_new = np.cumsum(~is_leaf) - 1          # row -> inner id
        leaf_ids = np.zeros(n, np.int64)             # row -> shared leaf id
        for row_idx in np.where(is_leaf)[0]:
            idx = table[o, row_idx, 36:40].view(np.int32)
            leaf_ids[row_idx] = leaf_id_by_key[tuple(sorted(idx[:kinds[row_idx]].tolist()))]

        def code(row_idx):
            r = np.asarray(row_idx)
            rc = np.clip(r, 0, n - 1)
            c = np.where(r >= n, 0, np.where(is_leaf[rc], -(leaf_ids[rc] + 1), inner_new[rc] + 1))
            return c.astype(np.int32)

        rows = table[o]
        skips = _ints(rows, OFF_SKIP)
        inner_rows = np.where(~is_leaf)[0]
        out = inner[o]
        out[:, 0:24] = rows[inner_rows, 0:24]
        # Inner rows' child indices become codes; an instance row's
        # [blas_ptr, blas_len, material, -] becomes [entry code, inner end,
        # leaf end, material].
        ptrs = rows[inner_rows, OFF_PTRS:OFF_PTRS + 4].view(np.int32)
        kk = kinds[inner_rows]
        remapped = np.zeros_like(ptrs)
        im = (kk == 0)[:, None] & (ptrs > 0)
        remapped[im] = code(ptrs[im])
        for ir in np.where(kk < 0)[0]:
            p, ln = int(ptrs[ir, 0]), int(ptrs[ir, 1])
            remapped[ir, 0] = code(p)
            region = np.arange(p, p + ln)
            inner_in = region[~is_leaf[region]]
            leaf_in = region[is_leaf[region]]
            remapped[ir, 1] = (inner_new[inner_in].max() + 2) if inner_in.size else 1
            remapped[ir, 2] = (leaf_ids[leaf_in].max() + 2) if leaf_in.size else 1
            remapped[ir, 3] = ptrs[ir, 2]
        out[:, 24:28] = remapped.view(np.float32)
        out[:, 28] = code(skips[inner_rows]).view(np.float32)
        out[:, 29] = kk.view(np.float32)

        lr = np.where(is_leaf)[0]
        leaf_skip[o, leaf_ids[lr]] = code(skips[lr])

    return SplitTables(inner=inner, leaf_geo=leaf_geo, leaf_skip=leaf_skip,
                       leaf_count=leaf_count)
