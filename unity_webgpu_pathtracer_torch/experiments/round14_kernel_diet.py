"""K1's cost by section on the H100 (``experiments/round14_kernel_diet.py``).

The diet's copy of the arrival kernel with sections stubbed out
(``arrival_probe_cuda`` modes, ``arrival16_diet_kernel`` in
``csrc/arrival16.cu``, in place on ``arrival16_run_kernel``'s design,
whose stubs keep every load of the section they remove; plain version
``diet_step16`` here):

* ``full``       the diet's copy of K1 (its older interleaved slot order)
* ``no_leaf``    leaf f16 decode + Moller-Trumbore replaced by FAR_PLANE + row[5]
* ``no_inner``   child-box decode + slab test replaced by row[0]
* ``no_stack``   no stack plane read or written: a pop takes the entry the
                 inner section would push (so every live lane runs the slab test)
* ``leaf_bf16``  the leaf halfwords decoded as bf16
* ``leaf_noint`` the split slot order (today's tables)

``run`` times them on the original's input: B = 98,304 lanes, each on a
row of its own of normal floats, DEPTH = 11.  Word 3 of such a row is a
random float's bits, never 0, so no lane is an inner row there and on the
card a branch no lane takes costs nothing: ``no_inner`` means something
only on a real state (``modes_on_state``, run by ``chip_smoke.py`` phase
13 on states captured early and deep in a 1080p pass).  Each mode is
timed with the L2 flushed before each call (``ms``) and warm
(``warm_ms``, which also charges the mode for the restore's L2 misses:
``_common.time_in_place_ms``), bounded by the bytes it moves
(``_common.diet_work``) and held exact against ``diet_step16``.

    python -m unity_webgpu_pathtracer_torch.experiments.round14_kernel_diet
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.accel.wide16 import OFF_IDX, WIDTH
from unity_webgpu_pathtracer_torch.experiments._common import (arrival_work, arrivals_work,
                                                              bound, check, clone_state,
                                                              cuda_device, diet_work, row,
                                                              time_in_place_ms, time_ms)
from unity_webgpu_pathtracer_torch.ops.cuda_arrival import (_FLAT_FIELDS, DIET_MODES,
                                                            PROBE_KERNELS, arrival_probe_cuda,
                                                            arrival_probe_plain)
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import (DET_EPS, DONE, FULL, T_MIN,
                                                               Wide16State, _bf16_halves, _perm_h,
                                                               _pick, _push, _scales, _slab,
                                                               init_state16)
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE

B, DEPTH = 98_304, 11
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


def synthetic_inputs(dev, b: int = B, depth: int = DEPTH):
    """The original's input: rows (B, 96) of normal floats, lane i on row
    i; one (3, B) normal plane as origin, direction and inverse; ptr 0,
    pend FULL, t 1e5, zero stacks.  Returns (nodes, rows, oT, dT, invT,
    state, active)."""
    rng = np.random.default_rng(0)
    rows_t = rng.normal(size=(96, b)).astype(np.float32)
    vec3 = torch.from_numpy(rng.normal(size=(3, b)).astype(np.float32)).to(dev)
    nodes = torch.from_numpy(np.ascontiguousarray(rows_t.T)).to(dev)
    s = init_state16(b, 1e5, depth=depth, device=dev)._replace(
        tri=torch.zeros((b,), dtype=torch.int32, device=dev))
    return nodes, torch.arange(b, dtype=torch.int32, device=dev), vec3, vec3, vec3, s, None


def diet_step16(nodes: torch.Tensor, rows: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                inv: torch.Tensor, s: Wide16State, active: torch.Tensor | None,
                mode: str, trace: dict | None = None) -> Wide16State:
    """The plain version of ``arrival16_diet_kernel<mode>``: one arrival of
    ``make_kernel(mode)`` on flat (N, 96) rows, the ray (B, 3), live lane i
    on row ``rows[i]``.  The diet's kernel predates the split slot order:
    slot j of a child box is byte j of its 16-byte plane, and slot j of a
    leaf component halfword j of its 8 words (``leaf_noint`` reads the
    leaves in today's split order).  The stubs act on every lane, as the
    diet's selects do: ``no_inner`` makes t_near row[0] for all 16 slots,
    ``no_leaf`` offers t = FAR_PLANE + row[5] in every slot, and
    ``no_stack`` leaves the stack planes as they are and pops the entry
    the inner section would have pushed.  ``trace``, where given, receives
    the lane masks ``live``, ``is_inner``, ``is_leaf``, ``push``, ``pop``
    (a pop that reads the stack), ``improved``, the best slot ``best`` and
    ``meta`` (``_common.diet_work`` counts bytes from them)."""
    nodes_i = nodes.view(torch.int32)
    live = s.ptr >= 0 if active is None else (s.ptr >= 0) & active
    idx = torch.where(live, rows, torch.zeros_like(rows)).long()
    rowf, rowi = nodes[idx], nodes_i[idx]
    meta = rowi[:, 3]
    is_leaf, is_inner = live & (meta > 0), live & (meta == 0)
    anchor = rowf[:, 0:3]
    iota = torch.arange(WIDTH, dtype=torch.int32, device=nodes.device)[None, :]

    # ---- inner: slab test of 16 boxes, bytes in slot order ----
    if mode == "no_inner":
        t_near = torch.zeros((idx.shape[0], WIDTH), device=nodes.device) + anchor[:, 0:1]
        t_far = s.t[:, None].expand_as(t_near)
    else:
        qbytes = rowi[:, 8:32].contiguous().view(torch.uint8).to(torch.float32)  # (B, 96)
        t_near, t_far = _slab(anchor, _scales(rowi[:, 4]), qbytes[:, :48], qbytes[:, 48:],
                              o, inv, s.t)
    ptrs = rowi[:, 32:48]
    hit = (t_near <= t_far) & (ptrs >= 0) & (((s.pend[:, None] >> iota) & 1) > 0)
    _, any_hit, child_ptr, remaining, one_left, direct_ptr = _pick(hit, t_near, ptrs)
    found_child = is_inner & any_hit
    push = found_child & (remaining > 0)
    entry_row = torch.where(one_left, direct_ptr, s.ptr)
    entry_mask = torch.where(one_left, torch.zeros_like(remaining), remaining)
    sp = s.sp + push.to(torch.int32)

    # ---- leaf: Moller-Trumbore on 16 f16 (leaf_bf16: bf16) triangles ----
    words = rowi[:, 4:OFF_IDX]
    halves = (_bf16_halves(words) if mode == "leaf_bf16"
              else words.contiguous().view(torch.float16).to(torch.float32))
    perm_h = _perm_h(WIDTH, nodes.device) if mode == "leaf_noint" else iota[0]
    e2x, e2y, e2z, e1x, e1y, e1z, v0x, v0y, v0z = (
        halves[:, WIDTH * c:WIDTH * c + WIDTH][:, perm_h] for c in range(9))
    v0x, v0y, v0z = v0x + anchor[:, 0:1], v0y + anchor[:, 1:2], v0z + anchor[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    rx = dy * e2z - dz * e2y
    ry = dz * e2x - dx * e2z
    rz = dx * e2y - dy * e2x
    a = e1x * rx + e1y * ry + e1z * rz
    finv = 1.0 / torch.where(torch.abs(a) < DET_EPS, torch.ones_like(a), a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    uu = finv * (sx * rx + sy * ry + sz * rz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = finv * (dx * qx + dy * qy + dz * qz)
    tt = finv * (e2x * qx + e2y * qy + e2z * qz)
    valid = (is_leaf[:, None] & (iota < meta[:, None]) & (torch.abs(a) > DET_EPS)
             & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0) & (uu + vv <= 1.0)
             & (tt > T_MIN) & (tt < s.t[:, None]))
    tt = torch.where(valid, tt, torch.full_like(tt, FAR_PLANE))
    if mode == "no_leaf":
        uu = vv = torch.zeros_like(tt)
        tt = torch.full_like(tt, FAR_PLANE) + rowf[:, 5:6]
    best = torch.argmin(tt, dim=1, keepdim=True)
    t_cand = tt.gather(1, best)[:, 0]
    improved = t_cand < s.t

    # ---- stack push and pop ----
    if mode == "no_stack":
        stack_row, stack_mask = s.stack_row, s.stack_mask
        top_row, top_mask = entry_row, entry_mask
    else:
        stack_row, stack_mask = _push(s.stack_row, s.stack_mask, s.sp, push, entry_row,
                                      entry_mask)
        top = (sp - 1).clamp_min(0).long()[None, :]
        top_row, top_mask = stack_row.gather(0, top)[0], stack_mask.gather(0, top)[0]
    need_pop = (is_inner & ~found_child) | is_leaf
    has = sp > 0
    full = torch.full_like(top_mask, FULL)
    pop_ptr = torch.where(has, top_row, torch.full_like(top_row, DONE))
    pop_pend = torch.where(top_mask == 0, full, top_mask)
    new_ptr = torch.where(found_child, child_ptr, torch.where(need_pop, pop_ptr, s.ptr))
    new_pend = torch.where(found_child, full,
                           torch.where(need_pop, torch.where(has, pop_pend, full), s.pend))
    if trace is not None:
        trace.update(live=live, is_inner=is_inner, is_leaf=is_leaf, push=push,
                     pop=need_pop & has, improved=improved, best=best[:, 0], meta=meta)
    return s._replace(
        ptr=torch.where(live, new_ptr, s.ptr), pend=torch.where(live, new_pend, s.pend),
        sp=torch.where(live, torch.where(need_pop & has, sp - 1, sp), s.sp),
        stack_row=stack_row, stack_mask=stack_mask,
        t=torch.where(improved, t_cand, s.t),
        u=torch.where(improved, uu.gather(1, best)[:, 0], s.u),
        v=torch.where(improved, vv.gather(1, best)[:, 0], s.v),
        tri=torch.where(improved, rowi[:, OFF_IDX:OFF_IDX + WIDTH].gather(1, best)[:, 0], s.tri),
        found=s.found | improved)


def _same(out: Wide16State, ref: Wide16State, exact: bool) -> tuple[bool, float]:
    """Integers equal; floats equal where ``exact`` (NaN where the other is
    NaN), else within FLOAT_TOL; and the largest float difference."""
    ok, worst = True, 0.0
    for f in _FLAT_FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        if a.dtype.is_floating_point:
            if exact:
                ok &= bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
            else:
                ok &= bool(torch.allclose(a, b, equal_nan=True, **FLOAT_TOL))
            fin = torch.isfinite(a) & torch.isfinite(b)
            if bool(fin.any()):
                worst = max(worst, float((a[fin] - b[fin]).abs().max()))
        else:
            ok &= bool(torch.equal(a, b))
    return ok, worst


def restorer(inputs):
    """(work, restore): a copy of the state of ``inputs`` and the function
    that copies the state back into it."""
    s = inputs[5]
    work = clone_state(s)

    def restore():
        for f in _FLAT_FIELDS:
            getattr(work, f).copy_(getattr(s, f))

    return work, restore


def in_place_times(inputs, launch) -> tuple[float, float]:
    """(warm, cold) device ms of ``launch(state)``, one in-place arrival of
    a probe mode, on a copy of the state restored from ``inputs`` before
    each call (``cold``: the L2 flushed after the restore)."""
    work, restore = restorer(inputs)
    return (time_in_place_ms(lambda: launch(work), restore)[0],
            time_in_place_ms(lambda: launch(work), restore, cold=True)[0])


def modes_on_state(inputs, label: str, modes) -> list[dict]:
    """Each probe mode in ``modes`` on one state, in place on a copy:
    kernel against the plain version (the diet's modes exact; the leaf
    decodes integers equal, floats within FLOAT_TOL), kernel and plain
    times, the bound, and the state's distinct rows.  ``ms`` is taken with
    the L2 flushed after each restore, and the row carries the warm
    reading as ``warm_ms``.  Bounds: the diet's by mode (``diet_work``);
    the leaf decodes' the production kernel's in-place one-arrival launch
    on the row plane (``arrivals_work`` with ``rows``), with the
    out-of-place yardstick they were held to before (``arrival_work``) as
    ``old_bound_ms``."""
    nodes, rows, oT, dT, invT, s, active = inputs
    k1_bytes, k1_ops, distinct, _ = arrivals_work(nodes, oT, dT, invT, s, 1, active,
                                                  rows=rows)
    old_bound_ms = bound(*arrival_work(nodes, rows, oT, dT, invT, s, active)[:2])[0]
    b = s.ptr.shape[0]
    out = []
    for mode in modes:
        ref = arrival_probe_plain(nodes, rows, oT, dT, invT, s, active, mode)
        got = arrival_probe_cuda(nodes, rows, oT, dT, invT, clone_state(s), active, mode)
        extra = {}
        extra["warm_ms"], ms = in_place_times(inputs, lambda w: arrival_probe_cuda(
            nodes, rows, oT, dT, invT, w, active, mode))
        if mode in DIET_MODES:
            ok, err = _same(got, ref, True)
            nbytes, ops, extra["counts"] = diet_work(nodes, rows, oT, dT, invT, s, active, mode)
            tol = "exact (max abs err 0)"
        else:
            ok, err = _same(got, ref, False)
            nbytes, ops, extra["old_bound_ms"] = k1_bytes, k1_ops, old_bound_ms
            tol = "integers equal, floats rtol 1e-5 / atol 1e-6"
        plain = time_ms(lambda: arrival_probe_plain(nodes, rows, oT, dT, invT, s, active, mode))
        out.append(row(f"{label} {mode}", PROBE_KERNELS[mode], ms, plain, ms * 1e6 / b, "lane",
                       nbytes, ops, err, ok, tol, mode=mode, distinct_rows=distinct, **extra))
    return out


def savings(rows: list[dict], base: str = "full",
            key: str = "ms") -> dict[str, tuple[float, float]]:
    """ms and share each mode saves against the first ``base`` row, by
    ``key`` (``ms``, cold, or ``warm_ms``)."""
    full = next(r[key] for r in rows if r["mode"] == base)
    return {r["mode"]: (full - r[key], (full - r[key]) / full) for r in rows
            if r["mode"] != base and key in r}


def run(device=None) -> list[dict]:
    dev = cuda_device(device)
    # "full" twice, as the original does, for a feel of the spread.
    return check(modes_on_state(synthetic_inputs(dev), "synthetic", ("full",) + DIET_MODES))


def report(rows: list[dict]) -> list[str]:
    """A line a mode (cold and warm ms, the bound), then the savings
    against ``full``, cold and warm."""
    lines = []
    for r in rows:
        lines.append(f"{r['name']}: {r['ms']:.4f} ms cold / {r['warm_ms']:.4f} warm; plain "
                     f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                     f"{r['bytes'] / 1e6:.3f} MB); {r['counts']}; max_abs_err "
                     f"{r['max_abs_err']:g}")
    for key in ("ms", "warm_ms"):
        for mode, (dt, share) in savings(rows, key=key).items():
            lines.append(f"  {mode} saves {dt:.4f} ms ({share * 100:.1f}%) "
                         f"{'cold' if key == 'ms' else 'warm'}")
    return lines


def main() -> None:
    print(f"B={B} DEPTH={DEPTH} device={torch.cuda.get_device_name(cuda_device())}")
    for line in report(run()):
        print(line)


if __name__ == "__main__":
    main()
