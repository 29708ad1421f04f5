"""The reference side of the fused cell's check: what kernel K1 and kernel
K2 should have answered on the inputs a fused pass handed them, worked out
again on the reference's own tables, and what the pass's records and the
film should hold.

* Closest hits: every captured lane at the end of a primary segment (or of
  the shadow segment after one) casts its path ray with the brute-force
  Möller-Trumbore of ``intersect.py`` on the reference's f32 triangles;
  every lane at the end of a shadow segment casts its shadow ray for
  occlusion.
* The transition: each captured input replayed through the frozen plain
  transition (``transition.py``), reading the attribute row of the
  triangle the reference's own cast found, from rows the reference packs
  from its own triangles as the configuration stores them (f16 normals and
  uvs, ``attr_compact`` 2), and its own material and environment tables.
* The start of new samples, at the end of every transition: from the
  whole pool's modes after the transition and the queue's head, which
  captured lanes start a work item and which one (the pool's dead lanes in
  lane order take the queue's next items, item ``i`` being pixel ``i %
  pixels`` and sample ``i // pixels`` of the pass), each started lane's
  PCG seed, jittered camera ray (``rng.py``, ``camera.py``) and reset path
  state; a dead lane's radiance cleared, every other lane left as it was.
* The records: the float64 sum, at each checked pixel, of the radiance of
  the captured lanes that died on it; the film: the running mean after one
  more pass of those sums.

``dtype=torch.bfloat16`` is the control: the geometry and the ray casts in
bfloat16, the path state rounded to bfloat16 into and out of the
transition, the new samples' camera rays in bfloat16, the records summed
and the film accumulated in bfloat16.
"""

from __future__ import annotations

import types

import torch

from pt_bench.reference import camera as rcamera
from pt_bench.reference import rng as rrng
from pt_bench.reference import transition as rt
from pt_bench.reference.intersect import _cast
from pt_bench.reference.vmath import FAR_PLANE

# Rays cast together.
CAST_BLOCK = 1 << 15
FIELDS = tuple(f for f in rt.STATE if f != "rays")
# Float fields of the path state (held in bfloat16 by the control).
FLOATS = tuple(f for f in FIELDS if rt.STATE[f][0] == torch.float32)


def tables(rs) -> types.SimpleNamespace:
    """The tables the transition reads, from the reference's scene ``rs``
    (``scene.py``): its f16 attribute rows (``attr_compact`` 1 and 2),
    packed by the frozen packer from its own f32 per-triangle normals, uvs
    and materials, which mode 0 reads as they are; its materials and
    environment."""
    shade_c = rt._pack_attr_shade_c(rs.attr_normals.cpu().numpy(), rs.attr_uvs.cpu().numpy(),
                                    rs.attr_material.cpu().numpy())
    return types.SimpleNamespace(
        env=rs.env, materials=rs.materials,
        attr_shade_c=torch.from_numpy(shade_c.view("int32")).to(rs.materials.device),
        attr_normals=rs.attr_normals, attr_uvs=rs.attr_uvs, attr_material=rs.attr_material)


def segment_ends(inputs: dict) -> tuple:
    """Masks over captured lane-transitions: ``a`` (a primary segment just
    ended) and ``shadow`` (an environment shadow segment just ended)."""
    done = inputs["ptr"] < 0
    a = (inputs["mode"] == rt.MODE_PRIMARY) & done
    return a, (inputs["mode"] == rt.MODE_SHADOW_ENV) & (done | inputs["found"])


def cast_closest(rs, o: torch.Tensor, d: torch.Tensor, dtype=torch.float32) -> tuple:
    """(t, u, v, triangle) of each (N, 3) ray's nearest hit; triangle -1 on
    a miss."""
    outs = []
    for k in range(0, o.shape[0], CAST_BLOCK):
        oo, dd = o[k:k + CAST_BLOCK], d[k:k + CAST_BLOCK]
        far = torch.full((oo.shape[0],), FAR_PLANE, dtype=torch.float32, device=o.device)
        outs.append(_cast(rs, oo, dd, far, dtype))
    if not outs:
        z = torch.zeros((0,), device=o.device)
        return z, z, z, z.long()
    return tuple(torch.cat(x) for x in zip(*outs))


def hits(rs, inputs: dict, dtype=torch.float32) -> dict:
    """The reference's (or, in bfloat16, the control's) answers of K1 at the
    captured segment ends: ``cast`` indexes the lanes whose path ray was
    cast (primary ends and shadow ends), with ``t``, ``u``, ``v`` and
    ``tri`` of its nearest hit and ``size``, the longest edge of that
    triangle; ``shadow`` indexes the shadow ends, with ``occluded``, the
    shadow ray's verdict."""
    a, shadow = segment_ends(inputs)
    cast = torch.nonzero(a | shadow)[:, 0]
    t, u, v, tri = cast_closest(rs, inputs["path_o"][cast], inputs["path_d"][cast], dtype)
    k = tri.clamp_min(0)
    e1, e2 = rs.e1[k], rs.e2[k]
    size = torch.stack([e1.norm(dim=-1), e2.norm(dim=-1), (e2 - e1).norm(dim=-1)]).amax(0)
    sidx = torch.nonzero(shadow)[:, 0]
    _st, _su, _sv, stri = cast_closest(rs, inputs["trav_o"][sidx], inputs["trav_d"][sidx],
                                       dtype)
    return dict(cast=cast, t=t, u=u, v=v, tri=tri, size=torch.where(tri >= 0, size, 0.0),
                shadow=sidx, occluded=stri >= 0)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def transition(tabs, config, params, inputs: dict, attr: torch.Tensor,
               dtype=torch.float32) -> dict:
    """Each captured input through the frozen plain transition, lane by
    lane in one batch, lane ``k`` reading attribute row ``attr[k]``: the
    outputs in the capture's layout (lane-major, with ``died`` and
    ``rad_out``)."""
    dev = inputs["mode"].device
    st = {}
    for f in FIELDS:
        x = inputs[f]
        if f in FLOATS:
            x = _round(x, dtype)
        st[f] = (x.T if x.dim() == 2 else x).clone().contiguous()
    st = rt.TransitionState(**st, rays=torch.zeros((), dtype=torch.int64, device=dev))
    died, rad_out = rt.transition16_plain(tabs, config, params, st, attr=attr)
    out = {}
    for f in FIELDS:
        x = getattr(st, f)
        x = x.T.contiguous() if x.dim() == 2 else x
        out[f] = _round(x, dtype) if f in FLOATS else x
    out["died"] = died
    out["rad_out"] = _round(rad_out.T.contiguous(), dtype)
    return out


def records(cap_records: list, pixels: int, device, dtype=torch.float32) -> tuple:
    """(sum (P, 3) float64, count (P,)) at each checked pixel of the
    captured records, summed in float64 (the reference) or in ``dtype``."""
    acc = torch.zeros((pixels, 3), dtype=torch.float64 if dtype == torch.float32 else dtype)
    count = torch.zeros((pixels,), dtype=torch.int64)
    if cap_records:
        slots = torch.cat([r["slot"] for r in cap_records]).cpu()
        rgb = torch.cat([r["rgb"] for r in cap_records]).cpu().to(acc.dtype)
        for k in range(slots.shape[0]):          # one record at a time, in the pass's order
            acc[slots[k]] += rgb[k]
        count.index_add_(0, slots, torch.ones_like(slots))
    return acc.double().to(device), count.to(device)


def accumulate(before: torch.Tensor, pass_sum: torch.Tensor, n: int, s: int,
               dtype=torch.float32) -> torch.Tensor:
    """The running mean after one more pass (``render/film.py``): float64
    for the reference, ``dtype`` for the control."""
    wd = torch.float64 if dtype == torch.float32 else dtype
    return ((pass_sum.to(wd) + before.to(wd) * n) / (n + s)).double()


def regenerate(config, params, regen: list, queue: dict, lanes: torch.Tensor,
               dtype=torch.float32) -> dict:
    """What the end of each captured transition should leave at ``lanes``
    (``regen``'s events: the lanes' state before, their died plane, the
    pool's modes and the queue's head; ``queue``: the pass's budget of work
    items, its first sample and its shard), stacked as the capture stacks
    its ``after``, with ``take``: the lanes that start a new sample."""
    budget, first = queue["budget"], queue["current_sample"]
    pixel_base, npix, sample_base, _spp = queue["shard"]
    outs = []
    for ev in regen:
        dead = ev["modes"] == rt.MODE_DEAD
        rank = torch.cumsum(dead.to(torch.int64), 0)[lanes] - 1
        head = ev["queue_head"]
        take = dead[lanes] & (rank < budget - head)
        work = head + rank.clamp_min(0)
        pixel = torch.remainder(work, npix) + pixel_base
        sample = torch.div(work, npix, rounding_mode="floor") + first + sample_base
        state = rrng.seed(pixel, sample, params.seed_root)
        coords, state = rcamera.jittered_pixel_coords(pixel, config, state)
        o, d, state = rcamera.get_screen_ray(coords, config, params, state)
        o, d = _round(o, dtype), _round(d, dtype)
        b = ev["before"]
        t = take[:, None]
        out = dict(b)
        out["radiance"] = torch.where((ev["died"] | take)[:, None],
                                      torch.zeros_like(b["radiance"]), b["radiance"])
        out["mode"] = torch.where(take, torch.full_like(b["mode"], rt.MODE_PRIMARY), b["mode"])
        for f, x in (("path_o", o), ("path_d", d), ("trav_o", o), ("trav_d", d)):
            out[f] = torch.where(t, x, b[f])
        out["throughput"] = torch.where(t, torch.ones_like(b["throughput"]), b["throughput"])
        out["rng"] = torch.where(take, state, b["rng"])
        out["pixel"] = torch.where(take, pixel.to(b["pixel"].dtype), b["pixel"])
        for f in ("depth", "max_roughness", "prev_pdf"):
            out[f] = torch.where(take, torch.zeros_like(b[f]), b[f])
        out["take"] = take
        outs.append(out)
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def answers(side, cap, samples_before: int, spp: int, dtype=torch.float32,
            attr_hits: dict | None = None) -> dict:
    """The reference's answers (or, in bfloat16, the control's) on what a
    checked pass captured (``cap``: the harness's ``FusedCapture``), from
    ``side``'s scene ``rs``, ``tables``, ``config`` and camera ``params``:
    K1's (``hits``), K2's (``out``), the start of new samples (``regen``),
    the records' sum and count at each checked pixel, the film after the
    pass and its samples.  The transition reads the attribute rows of the
    triangles that ``attr_hits`` found (the float32 reference's cast), or
    of its own cast's."""
    inputs = cap.stacked(cap.inputs)
    h = hits(side.rs, inputs, dtype)
    found = h if attr_hits is None else attr_hits
    attr = torch.zeros_like(inputs["mode"], dtype=torch.int64)
    attr[found["cast"]] = found["tri"].clamp_min(0)
    pass_sum, count = records(cap.records, cap.pixels.shape[0], inputs["mode"].device, dtype)
    return dict(hits=h, out=transition(side.tables, side.config, side.params, inputs, attr, dtype),
                regen=regenerate(side.config, side.params, cap.regen, cap.queue, cap.lanes,
                                 dtype),
                pass_sum=pass_sum, count=count,
                film=accumulate(cap.film_before, cap.pass_sum, samples_before, spp, dtype),
                samples=samples_before + spp)
