"""Kernel K2's work: what one launch reads, writes and computes, for the
``k2.roofline_pct`` metric.

Frozen from ``unity_webgpu_pathtracer_torch/experiments/_common.py``
(``K2_OPS``, ``transition_work``) at commit
ac8b7b411ffdc6049c86dcf74accf9846b5185f6, with the port's helpers it called
taken from the frozen plain transition (``reference/transition.py``) and
environment (``reference/envmap.py``) instead: it reads the lane state
before and after the launch and the launch's scene tables (to count the
distinct rows the launch loads), and nothing of the port's code.
"""

from __future__ import annotations

import torch

from pt_bench.reference import rng as urng
from pt_bench.reference import transition as rt
from pt_bench.reference.envmap import _bilerp_coords
from pt_bench.reference.vmath import INV_PI, INV_TWO_PI, PI
from pt_bench.yardstick.roofline import bound

# f32 operations of K2 (csrc/transition16.cu) by lane case, counted from
# its source (each add, multiply, divide, square root and transcendental
# one; selects and integer work none): every lane at a finished segment
# (its uniforms and radiance updates); a miss (the sky footprint, its pdf,
# the MIS weight); a shaded hit (the alias sample, its direction and pdf,
# the NEE contribution); the attribute row's normal by attr_compact (f16
# or oct decode, interpolation, normalize); the material and hit frame;
# one BSDF evaluation with its frame and lobe probabilities; the lobe
# sample; the throughput update and RR.  A lane between segments does
# integer work only (its PCG steps).
K2_OPS = dict(lane=40, miss=68, hit=50, normal={2: 36, 3: 93}, material=43, eval=622,
              sample=219, rr=14)


def transition_work(scene, attr_compact: int, rotation, st, after, died):
    """(bytes, f32 operations, counts) of one K2 launch on the lane state
    ``st``, where ``after`` is the state it leaves and ``died`` its died
    plane.  Bytes: mode, ptr, found and rng of every lane read, rng and died
    written; for each lane at a finished segment the state its case reads,
    read once; each field element whose value changes written once,
    rad_out of the lanes that die, the ray counter; each distinct attribute
    row (32 or 16 bytes), material row (22 words) and env row half (the
    32-byte alias half on a hit, the 48-byte footprint on a miss) once.
    Operations: ``K2_OPS`` by lane case.  ``counts``: lanes by case and
    distinct rows."""
    trav_done = st.ptr < 0
    a = (st.mode == rt.MODE_PRIMARY) & trav_done
    hit, miss = a & (st.tri >= 0), a & (st.tri < 0)
    shadow = (st.mode == rt.MODE_SHADOW_ENV) & (trav_done | st.found)
    need = hit | shadow
    b = st.mode.shape[0]

    attr = rt.attr_index(a, need, st.tri, st.hit_tri)[need]
    mats = rt.shade_rows(scene, attr_compact, attr)[1]
    row_bytes = 16 if attr_compact == 3 else 32
    h, w = scene.env.image.shape[0], scene.env.image.shape[1]
    u1 = urng.random_float(st.rng[hit])[0]
    bins = torch.clamp((u1 * (h * w)).to(torch.int32), 0, h * w - 1)
    d = st.path_d[:, miss]
    theta = torch.acos(torch.clamp(d[1], -1.0, 1.0))
    uv = torch.stack([(PI + torch.atan2(d[2], d[0])) * INV_TWO_PI
                      + rotation, 1.0 - theta * INV_PI], dim=-1)
    x0i, y0i, _fx, _fy = _bilerp_coords(h, w, uv)
    counts = dict(idle=int((~(a | shadow)).sum()), miss=int(miss.sum()), hit=int(hit.sum()),
                  shadow=int(shadow.sum()), attr_rows=int(torch.unique(attr).numel()),
                  material_rows=int(torch.unique(mats).numel()),
                  alias_rows=int(torch.unique(bins).numel()),
                  footprint_rows=int(torch.unique(y0i * w + x0i).numel()))
    proc = counts["miss"] + counts["hit"] + counts["shadow"]

    reads = (17 * b + 52 * proc + 4 * (counts["miss"] + counts["hit"]) + 24 * counts["hit"]
             + 40 * counts["shadow"] + row_bytes * counts["attr_rows"]
             + 88 * counts["material_rows"] + 32 * counts["alias_rows"]
             + 48 * counts["footprint_rows"] + 16)
    writes = 9 * b + 12 * int(died.sum()) + 8
    for f in rt.TransitionState._fields:
        if f in ("rng", "rays"):
            continue
        x, y = getattr(st, f), getattr(after, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        writes += int((x != y).sum()) * x.element_size()
    ops = (K2_OPS["lane"] * proc + K2_OPS["miss"] * counts["miss"]
           + (K2_OPS["hit"] + K2_OPS["normal"][attr_compact] + K2_OPS["material"]
              + K2_OPS["eval"]) * counts["hit"]
           + (K2_OPS["normal"][attr_compact] + K2_OPS["material"] + K2_OPS["eval"]
              + K2_OPS["sample"] + K2_OPS["rr"]) * counts["shadow"])
    return reads + writes, ops, counts


def launch_bound(scene, config, params, st, after, died) -> float:
    """The least time (ms) of one K2 launch on an H100 (``bound``)."""
    nbytes, ops, _counts = transition_work(scene, config.attr_compact,
                                           params.environment_rotation, st, after, died)
    return bound(nbytes, ops)[0]
