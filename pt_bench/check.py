"""The comparison that decides ``correct``, held to each cell's limits in
``workloads/cells/<cell>.json``.

The megakernel's cells: the program's film after the window against the
plain reference at pixels drawn from the seed, and its last presented image
against the reference's presentation of that film:

* ``px_err_median``: the median over the sampled pixels of the pixel's
  error, ``max_c |film - ref| / max(max_c |ref|, RADIANCE_FLOOR)``;
* ``px_bad_share``: the share of sampled pixels whose error passes
  ``BAD_ERR`` (a path that took another way: a silhouette, a shadow edge);
* ``image_lsb_max``: the largest difference, in 8-bit steps, between the
  last image the program presented and the reference's presentation
  (``Renderer.image``'s chain) of the program's final film, over every pixel.

The fused cell: one checked pass after the window, with kernel K2's inputs
and outputs and the start of new samples captured at lanes drawn from the
seed at every transition and the records of the pixels drawn from the seed
(``port.capture_fused``), against what the reference works out from the
same inputs (``reference/replay.py``):

* (K2) ``k2_rng_off``: captured lane-transitions whose PCG state after K2
  is not the replay's, exactly; ``k2_off_share``: the share of the compared
  lane-transitions (every captured one but the segment ends where K1's hit
  is not the reference's, or lies within ``BARY_TOL`` of a triangle's
  corner, where two triangles that share it read alike and the reference
  cannot tell which row K2 read) with an integer output off, or a float
  output whose relative gap to the replay's passes ``GAP_BAD``;
* (K1) ``k1_hit_off_share``: the share of primary segment ends whose
  closest hit is not the reference's (a hit against a miss, or another
  triangle: barycentrics, or the hit points in units of the reference
  triangle's longest edge, more than ``BARY_TOL`` apart);
  ``k1_t_gap_median``: the median relative gap of the hit distance where
  both hit; ``k1_occl_off_share``: the share of shadow
  segment ends whose verdict is not the reference's;
* (new samples) ``regen_off``: captured lane-ends whose state after the
  transition's start of new samples is not the reference's (mode, PCG
  seed, pixel, depth, radiance, throughput, roughness and pdf exactly; a
  lane that starts no sample keeping its rays exactly);
  ``regen_ray_gap_max``: the widest relative gap of a started lane's
  camera ray to the frozen camera's;
* (records) ``rec_count_off``: checked pixels that did not get
  ``samples_per_pass`` records in the pass, exactly; ``rec_gap_max``: the
  widest pixel error of the pass's film sum against the float64 sum of
  the records of the lanes that died on the pixel;
* (film) ``film_samples_off``: the film's sample count against the samples
  of the passes the harness ran, exactly; ``film_gap_max``: the widest
  pixel error of the film after the pass against the running mean of the
  film before it and the pass's sum, over the harness's sample count.
"""

from __future__ import annotations

import numpy as np
import torch

from pt_bench.reference import replay, tonemap
from pt_bench.reference import transition as rt
from pt_bench.reference.config import PostParams

RADIANCE_FLOOR = 1e-2
BAD_ERR = 0.05
# The fused check: barycentrics of one triangle's hit (and its point, in
# units of the triangle's longest edge), as far apart as the f16 leaves move
# them; a lane's float output off; the floor under a float's magnitude in
# its relative gap.
BARY_TOL = 1e-2
GAP_BAD = 1e-4
FLOAT_FLOOR = 1e-2
# K2's outputs compared exactly: every one not a float, but the PCG state
# (a number of its own) and the ray counter (not captured).
INTS = tuple(f for f, (dtype, _rows) in rt.STATE.items()
             if dtype != torch.float32 and f not in ("rng", "rays")) + ("died",)
# The start of a new sample: the fields it sets exactly, and its rays.
REGEN_EXACT = ("mode", "rng", "pixel", "depth", "radiance", "throughput", "max_roughness",
               "prev_pdf")
REGEN_RAYS = ("path_o", "path_d", "trav_o", "trav_d")


def sample_pixels(seed: int, n_pixels: int, count: int) -> np.ndarray:
    """``count`` distinct pixel indices drawn from the seed, sorted."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels), replace=False))


def pixel_errors(film_px: torch.Tensor, ref_px: torch.Tensor) -> torch.Tensor:
    diff = (film_px.double() - ref_px.double()).abs().amax(-1)
    return diff / ref_px.double().abs().amax(-1).clamp_min(RADIANCE_FLOOR)


def film_numbers(film_px: torch.Tensor, ref_px: torch.Tensor) -> dict:
    err = pixel_errors(film_px, ref_px)
    return {"px_err_median": float(err.median()),
            "px_bad_share": float((err > BAD_ERR).double().mean())}


def present(film: torch.Tensor) -> np.ndarray:
    """uint8 (H, W, 3), row 0 = top: ``Renderer.image`` with default post."""
    out = torch.clamp(tonemap.present(film, PostParams()), 0.0, 1.0) * 255 + 0.5
    return out.to(torch.uint8).flip(0).cpu().numpy()


def image_lsb_max(image: np.ndarray, film: torch.Tensor) -> float:
    want = present(film)
    return float(np.abs(image.astype(np.int16) - want.astype(np.int16)).max())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number at or under its limit; the report pairs each with it."""
    report = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return bool(ok), report


def _gap(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per lane (row), the widest relative gap of ``x`` against ``y``: 0
    where equal (NaN where both are), inf where one side alone is not
    finite."""
    x, y = x.double(), y.double()
    same = (x == y) | (torch.isnan(x) & torch.isnan(y))
    g = (x - y).abs() / y.abs().clamp_min(FLOAT_FLOOR)
    g = torch.where(same, torch.zeros_like(g), torch.nan_to_num(g, nan=float("inf")))
    return g if g.dim() == 1 else g.amax(-1)


def program_hits(inputs: dict, ref_hits: dict) -> dict:
    """K1's answers in the captured inputs, at the lanes the reference cast:
    a primary end's fresh hit, a shadow end's saved hit and its verdict."""
    a = inputs["mode"] == 0
    pick = {"t": torch.where(a, inputs["t"], inputs["hit_t"]),
            "u": torch.where(a, inputs["u"], inputs["hit_bary"][:, 0]),
            "v": torch.where(a, inputs["v"], inputs["hit_bary"][:, 1]),
            "tri": torch.where(a, inputs["tri"], inputs["hit_tri"]).long()}
    out = {k: x[ref_hits["cast"]] for k, x in pick.items()}
    out["occluded"] = inputs["found"][ref_hits["shadow"]]
    return out


def program_answers(cap, ref: dict) -> dict:
    """The program's answers in a checked pass's capture (``cap``), laid out
    as ``reference/replay.py::answers`` lays out the reference's."""
    return dict(hits=program_hits(cap.stacked(cap.inputs), ref["hits"]),
                out=cap.stacked(cap.outputs),
                regen=cap.stacked([ev["after"] for ev in cap.regen]),
                pass_sum=cap.pass_sum, film=cap.film_after, samples=cap.samples_after)


def same_hit(got: dict, ref: dict) -> torch.Tensor:
    """Where the judged side's closest hit is the reference's: both miss,
    or both hit at barycentrics within ``BARY_TOL``, at points along the ray
    within ``BARY_TOL`` of the reference triangle's longest edge."""
    miss, ref_miss = got["tri"] < 0, ref["tri"] < 0
    near = (((got["u"] - ref["u"]).abs() <= BARY_TOL) & ((got["v"] - ref["v"]).abs() <= BARY_TOL)
            & ((got["t"] - ref["t"]).abs() <= BARY_TOL * ref["size"]))
    return (miss == ref_miss) & (miss | near)


def compared(inputs: dict, ref_hits: dict, same: torch.Tensor) -> torch.Tensor:
    """The captured lane-transitions whose K2 outputs are compared: all but
    the segment ends whose hit is not the reference's (``same`` at the cast
    lanes) or lies within ``BARY_TOL`` of a corner of the reference's
    triangle, where two triangles that share the corner read alike."""
    w = torch.stack([1.0 - ref_hits["u"] - ref_hits["v"], ref_hits["u"], ref_hits["v"]])
    corner = (ref_hits["tri"] >= 0) & ((w <= BARY_TOL).sum(0) >= 2)
    agree = torch.ones_like(inputs["mode"], dtype=torch.bool)
    agree[ref_hits["cast"]] = same & ~corner
    return agree


def _regen_numbers(ref: dict, got: dict) -> dict:
    """``regen_off``: captured lane-ends whose state after the start of new
    samples differs from the reference's in a field it sets exactly (mode,
    PCG state, pixel, depth, radiance, throughput, roughness, pdf), or, on a
    lane that starts no sample, in its rays; ``regen_ray_gap_max``: the
    widest relative gap of a started lane's camera ray (path and
    traversal origin and direction)."""
    take = ref["take"]
    off = torch.zeros_like(take)
    for f in REGEN_EXACT:
        x, y = got[f], ref[f]
        ne = (_gap(x, y) > 0) if x.dtype.is_floating_point else (x != y)
        off |= ne if ne.dim() == 1 else ne.any(-1)
    gap = torch.zeros(take.shape, dtype=torch.float64, device=take.device)
    for f in REGEN_RAYS:
        gap = torch.maximum(gap, _gap(got[f], ref[f]))
    off |= ~take & (gap > 0)
    return {"regen_off": float(off.sum()),
            "regen_ray_gap_max": float(gap[take].max()) if bool(take.any()) else 0.0}


def fused_numbers(inputs: dict, ref: dict, got: dict, spp: int) -> dict:
    """The fused check's numbers for the judged side's answers ``got`` (the
    program's, ``program_answers``, or the control's) against the
    reference's ``ref`` (``reference/replay.py::answers``), on the captured
    ``inputs``."""
    ref_hits, hits, ref_out, out = ref["hits"], got["hits"], ref["out"], got["out"]
    primary = inputs["mode"][ref_hits["cast"]] == 0
    same = same_hit(hits, ref_hits)
    both = primary & (hits["tri"] >= 0) & (ref_hits["tri"] >= 0)
    t_gap = ((hits["t"] - ref_hits["t"]).abs() / ref_hits["t"].abs())[both]
    agree = compared(inputs, ref_hits, same)
    off = torch.zeros_like(agree)
    for f in INTS:
        x, y = out[f], ref_out[f]
        off |= (x != y) if x.dim() == 1 else (x != y).any(-1)
    gap = torch.zeros(agree.shape, dtype=torch.float64, device=agree.device)
    for f, x in out.items():
        if f in INTS or f == "rng":
            continue
        g = _gap(x, ref_out[f])
        if f == "rad_out":
            g = torch.where(out["died"] & ref_out["died"], g, torch.zeros_like(g))
        gap = torch.maximum(gap, g)
    off |= gap > GAP_BAD

    def share(m):
        return float(m.double().mean()) if m.numel() else 0.0

    return {
        "k2_rng_off": float((out["rng"] != ref_out["rng"]).sum()),
        "k2_off_share": share(off[agree]),
        "k1_hit_off_share": share(~same[primary]),
        "k1_t_gap_median": float(t_gap.median()) if t_gap.numel() else 0.0,
        "k1_occl_off_share": share(hits["occluded"] != ref_hits["occluded"]),
        **_regen_numbers(ref["regen"], got["regen"]),
        "rec_count_off": float((ref["count"] != spp).sum()),
        "rec_gap_max": float(pixel_errors(got["pass_sum"], ref["pass_sum"]).max()),
        "film_samples_off": float(abs(got["samples"] - ref["samples"])),
        "film_gap_max": float(pixel_errors(got["film"], ref["film"]).max()),
    }


def fused_program_numbers(cap, ref: dict, spp: int) -> dict:
    """The fused check's numbers of the program's answers in ``cap``."""
    return fused_numbers(cap.stacked(cap.inputs), ref, program_answers(cap, ref), spp)


def fused_control_numbers(side, cap, ref: dict, samples_before: int, spp: int) -> dict:
    """The fused check's numbers of its control: the reference's answers
    computed in bfloat16 (``replay.answers``) on the same capture, its
    transition reading the rows of the float32 cast's triangles."""
    low = replay.answers(side, cap, samples_before, spp, torch.bfloat16,
                         attr_hits=ref["hits"])
    return fused_numbers(cap.stacked(cap.inputs), ref, low, spp)
