"""The reference's ray casts: Möller-Trumbore on the f32 world-space
triangles with the port's determinant cut-off, minimum distance and far
plane (``ops/intersect.py`` of the port, frozen at commit
628fc1bc0151d37c4767d2275c25b153616afc0d), without the port's BVH: each ray
is tested against the boxes of clusters of consecutive triangles, then
against every triangle of each cluster whose box it enters.

``dtype`` is the precision of the geometry and of the test: float32 for the
reference, bfloat16 for the control.  Closest-hit ties go to the lowest
triangle index.  Signatures are the port's ``ops.get_intersectors`` pair,
so the frozen integrator calls them in its place.
"""

from __future__ import annotations

import torch

from pt_bench.reference.vmath import FAR_PLANE

DET_EPS = 1e-7
T_MIN = 1e-4
# Ray x cluster box tests and ray x triangle tests per block (memory bound).
BOX_BLOCK = 1 << 24
TRI_BLOCK = 1 << 23


def _pairs(scene, o, inv, t_max):
    """(ray, cluster) pairs whose slab interval meets (T_MIN, t_max)."""
    k = scene.box_lo.shape[0]
    rows = max(BOX_BLOCK // k, 1)
    rs, cs = [], []
    for a in range(0, o.shape[0], rows):
        oo, ii, tm = o[a:a + rows, None], inv[a:a + rows, None], t_max[a:a + rows, None]
        t0 = (scene.box_lo[None] - oo) * ii
        t1 = (scene.box_hi[None] - oo) * ii
        near = torch.minimum(t0, t1).nan_to_num(nan=-float("inf")).amax(-1)
        far = torch.maximum(t0, t1).nan_to_num(nan=float("inf")).amin(-1)
        r, c = torch.nonzero((near <= far) & (far >= 0.0) & (near < tm), as_tuple=True)
        rs.append(r + a)
        cs.append(c)
    return torch.cat(rs), torch.cat(cs)


def _cast(scene, o, d, t_max, dtype):
    """Per ray: (t, u, v, triangle) of the nearest hit in (T_MIN, t_max),
    triangle -1 and t = t_max where there is none."""
    from pt_bench.reference.scene import CLUSTER

    n, dev = o.shape[0], o.device
    inv = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
    r, c = _pairs(scene, o, inv, t_max)
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    ntri = scene.v0.shape[0]
    v0, e1, e2 = (x.to(dtype) for x in (scene.v0, scene.e1, scene.e2))
    od, dd = o.to(dtype), d.to(dtype)
    step = max(TRI_BLOCK // CLUSTER, 1)
    lane = torch.arange(CLUSTER, device=dev)
    for a in range(0, r.shape[0], step):
        rr, cc = r[a:a + step], c[a:a + step]
        tri = (cc[:, None] * CLUSTER + lane[None]).clamp_max(ntri - 1)    # (P, C)
        ro, rd = od[rr][:, None], dd[rr][:, None]                          # (P, 1, 3)
        te1, te2, tv0 = e1[tri], e2[tri], v0[tri]                           # (P, C, 3)
        pv = torch.linalg.cross(rd.expand_as(te2), te2)
        det = (te1 * pv).sum(-1)
        f = 1.0 / torch.where(torch.abs(det) < DET_EPS, torch.ones_like(det), det)
        s = ro - tv0
        u = f * (s * pv).sum(-1)
        q = torch.linalg.cross(s, te1)
        v = f * (rd * q).sum(-1)
        t = f * (te2 * q).sum(-1)
        t, u, v = t.float(), u.float(), v.float()
        ok = ((torch.abs(det) > DET_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t > T_MIN) & (t < t_max[rr][:, None]))
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        # The nearest of the block per ray, then the lowest triangle of that t.
        tmin = torch.full((n,), float("inf"), device=dev).scatter_reduce(
            0, rr, t.amin(1), "amin")
        take = ok & (t == tmin[rr][:, None]) & (t < best_t[rr][:, None])
        cand = torch.where(take, tri, torch.full_like(tri, 1 << 62))
        tri_min = torch.full((n,), 1 << 62, dtype=torch.int64, device=dev).scatter_reduce(
            0, rr, cand.amin(1), "amin")
        hit = take & (tri == tri_min[rr][:, None])
        pr, pc = torch.nonzero(hit, as_tuple=True)
        ray = rr[pr]
        improve = (t[pr, pc] < best_t[ray]) | ((t[pr, pc] == best_t[ray])
                                                 & (tri[pr, pc] < best_tri[ray]))
        ray, pr, pc = ray[improve], pr[improve], pc[improve]
        best_t[ray] = t[pr, pc]
        best_tri[ray] = tri[pr, pc]
        best_u[ray] = u[pr, pc]
        best_v[ray] = v[pr, pc]
    return best_t, best_u, best_v, best_tri


def intersectors(dtype=torch.float32):
    """``(closest, occluded)`` with the port's ``get_intersectors``
    signatures, on ``scene`` (a ``RefScene``)."""

    def closest(scene, origins, directions, live=None):
        n, dev = origins.shape[0], origins.device
        t = torch.full((n,), FAR_PLANE, dtype=torch.float32, device=dev)
        u = torch.zeros((n,), dtype=torch.float32, device=dev)
        v = torch.zeros_like(u)
        tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
        idx = torch.arange(n, device=dev) if live is None else torch.nonzero(live)[:, 0]
        if idx.numel():
            bt, bu, bv, btri = _cast(scene, origins[idx], directions[idx],
                                     torch.full((idx.shape[0],), FAR_PLANE, device=dev), dtype)
            t[idx], u[idx], v[idx], tri[idx] = bt, bu, bv, btri.to(torch.int32)
        return t, torch.stack([u, v], dim=-1), tri, torch.full_like(tri, -1)

    def occluded(scene, origins, directions, t_max, live=None):
        n, dev = origins.shape[0], origins.device
        out = torch.zeros((n,), dtype=torch.bool, device=dev)
        idx = torch.arange(n, device=dev) if live is None else torch.nonzero(live)[:, 0]
        if idx.numel():
            out[idx] = _cast(scene, origins[idx], directions[idx],
                             t_max[idx].to(torch.float32), dtype)[3] >= 0
        return out

    return closest, occluded
