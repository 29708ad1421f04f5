"""Do the card's ops agree with the plain versions?
(``experiments/round18_mosaic_probe.py``).

Each op the TPU probe asked Mosaic for, as one kernel launch over B =
1,024 lanes held against its plain PyTorch version at the original's
tolerances (PASS or MISMATCH, and the largest error in ulps): a uint32 PCG
step and cumsum over int32 (exact), uint32 -> f32 times 1/4294967295
(atol 1e-6, as the original; exactness is printed), sin, cos, log, exp,
sqrt, arccos, arctan, arctan2, power (rtol 1e-5, atol 1e-6), and the sum
of the (B,) plane to one scalar (exact against its plain version, which
follows the kernel's order; rtol 1e-5 of ``torch.sum``).  Each is also
timed at B = 98,304 (the pool's lanes), since at 1,024 the time is only
the launch, beside the one PyTorch call that computes it where there is
one, and checked there after its first call and after the timed replays.
The one-pass scan and the sum carry their scratch from call to call, so
they are also checked at ragged sizes (1, 1,025, 98,303) and timed once
more at 4,194,304, where bandwidth and not the launch sets the time.
``reductions`` times PyTorch's reductions of a 98,304-lane plane as the
main path's super-iteration calls them (``render/fused.py``); ``chip_smoke.py``
prices a super-iteration's from the calls its profile counts.

    python -m unity_webgpu_pathtracer_torch.experiments.round18_mosaic_probe
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.experiments._common import (check, cuda_device, max_err, row,
                                                              time_ms, time_ms_out)
from unity_webgpu_pathtracer_torch.ops import cuda_probes as cp

B, B_TIMED = 1024, 98_304
RAGGED, LARGE = (1, 1025, 98_303), 4_194_304   # the scan's and the sum's further sizes
EXACT = ("pcg_uint32", "cumsum_i32")
LIBRARY = {"sin": torch.sin, "cos": torch.cos, "log": torch.log, "exp": torch.exp,
           "sqrt": torch.sqrt, "arccos": torch.acos, "arctan": torch.atan,
           "arctan2": torch.atan2, "power": torch.pow,
           "cumsum_i32": lambda a: torch.cumsum(a, 0, dtype=torch.int32)}


def inputs(dev, b: int) -> dict[str, torch.Tensor]:
    """The original's operands: uint32 states (random below 2^31 times
    2654435761, wrapped; as int32 bits), f uniform in [0.01, 0.99), int32
    in [0, 100)."""
    u = np.random.default_rng(0).integers(0, 2**31 - 1, b).astype(np.uint64)
    u32 = ((u * 2654435761) % 2**32).astype(np.uint32).view(np.int32)
    f = np.random.default_rng(1).uniform(0.01, 0.99, b).astype(np.float32)
    i32 = np.random.default_rng(2).integers(0, 100, b).astype(np.int32)
    t = {k: torch.from_numpy(v).to(dev) for k, v in (("u32", u32), ("f", f), ("i32", i32))}
    t["f2"] = t["f"] * 2 - 1
    return t


def operands(op: str, t: dict) -> tuple:
    if op in ("pcg_uint32", "u32_to_f32"):
        return (t["u32"],)
    if op == "cumsum_i32":
        return (t["i32"],)
    if op == "arctan2":
        return (t["f"], t["f2"])
    if op == "power":
        return (t["f"], t["f"])
    return (t["f"],)


def max_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in f32 ulps over lanes finite in both (0 for
    integers that are equal)."""
    if not got.dtype.is_floating_point:
        return 0 if torch.equal(got, want) else -1
    fin = torch.isfinite(got) & torch.isfinite(want)
    a = got[fin].view(torch.int32).to(torch.int64)
    b = want[fin].view(torch.int32).to(torch.int64)
    # Map the sign-magnitude bits onto a line so that ulps subtract.
    a = torch.where(a < 0, -2**31 - a, a)
    b = torch.where(b < 0, -2**31 - b, b)
    return int((a - b).abs().max()) if a.numel() else 0


def _tol_check(op: str, got: torch.Tensor, want: torch.Tensor) -> bool:
    if op in EXACT:
        return bool(torch.equal(got, want))
    rtol = 0.0 if op == "u32_to_f32" else 1e-5
    return bool(torch.allclose(got, want, rtol=rtol, atol=1e-6))


def run(device=None) -> list[dict]:
    dev = cuda_device(device)
    small, big = inputs(dev, B), inputs(dev, B_TIMED)
    # A kernel's last row is the one chip_smoke.py's kernels line reports:
    # the scan's and the sum's are the pool's 98,304, below, not these.
    out = [scan_large(dev), sum_row(dev, LARGE)]
    for op in cp.INTRINSICS:
        args = operands(op, small)
        got, want = cp.intrinsic(op, *args), cp.intrinsic_plain(op, *args)
        tol = "exact" if op in EXACT else \
            f"rtol {0.0 if op == 'u32_to_f32' else 1e-5:g}, atol 1e-6"
        bargs = operands(op, big)
        lib = LIBRARY.get(op)
        first = cp.intrinsic(op, *bargs)
        ms, again = time_ms_out(lambda: cp.intrinsic(op, *bargs))
        res = cp.intrinsic_plain(op, *bargs)
        pairs = [(got, want), (first, res), (again, res)]
        if op == "cumsum_i32":
            for n in RAGGED:
                a = inputs(dev, n)["i32"]
                pairs.append((cp.intrinsic(op, a), cp.intrinsic_plain(op, a)))
        ok = all(_tol_check(op, g, w) for g, w in pairs)
        tol += f"; at {B}, at {B_TIMED} and after its replays" + \
            (f", also at {RAGGED}" if op == "cumsum_i32" else "")
        out.append(row(f"{op} B={B}: {'PASS' if ok else 'MISMATCH'}", f"intrinsic_{op}", ms,
                       time_ms(lambda: cp.intrinsic_plain(op, *bargs)), ms * 1e6 / B_TIMED,
                       "lane", sum(a.nbytes for a in bargs) + res.nbytes, B_TIMED,
                       max(max_err(g, w) for g, w in pairs), ok, tol,
                       library_ms=None if lib is None else time_ms(lambda: lib(*bargs)),
                       ulps=max(max_ulps(g, w) for g, w in pairs),
                       exact=all(bool(torch.equal(g, w)) for g, w in pairs), timed_b=B_TIMED))
    out.append(sum_row(dev, B_TIMED))
    return check(out)


def sum_row(dev, b: int) -> dict:
    """P9 at ``b``: exact against ``sum_scalar_plain`` after the first
    call, after a second (the same bits) and after the timed replays, and
    within rtol 1e-5 of ``torch.sum``; at the pool's size also at ``B``
    and the ragged sizes."""
    f = inputs(dev, b)["f"]
    want = cp.sum_scalar_plain(f)
    got, second = cp.sum_scalar(f), cp.sum_scalar(f)
    ms, again = time_ms_out(lambda: cp.sum_scalar(f))
    pairs = [(got, want), (second, want), (again, want)]
    sizes = (B, *RAGGED) if b == B_TIMED else ()
    for n in sizes:
        x = inputs(dev, n)["f"]
        pairs.append((cp.sum_scalar(x), cp.sum_scalar_plain(x)))
    lib_ms = time_ms(lambda: f.sum())
    ok = all(torch.equal(g, w) for g, w in pairs) and bool(
        torch.allclose(got, f.sum().reshape(1), rtol=1e-5, atol=0.0))
    return row(f"sum_to_scalar B={b}: {'PASS' if ok else 'MISMATCH'}", "sum_scalar", ms,
               time_ms(lambda: cp.sum_scalar_plain(f)), ms * 1e6 / b, "lane", f.nbytes + 4, b,
               max(max_err(g, w) for g, w in pairs), ok,
               "exact against the plain version after the first call, a second and the "
               f"replays{f', also at {sizes}' if sizes else ''}; rtol 1e-5 of torch.sum",
               library_ms=lib_ms, ulps=max(max_ulps(g, w) for g, w in pairs),
               exact=all(bool(torch.equal(g, w)) for g, w in pairs), timed_b=b)


def scan_large(dev) -> dict:
    """cumsum_i32 at LARGE: checked after the first call and after the
    timed replays, beside ``torch.cumsum``."""
    a = inputs(dev, LARGE)["i32"]
    got, want = cp.intrinsic("cumsum_i32", a), cp.intrinsic_plain("cumsum_i32", a)
    ms, again = time_ms_out(lambda: cp.intrinsic("cumsum_i32", a))
    ok = bool(torch.equal(got, want) and torch.equal(again, want))
    return row(f"cumsum_i32 B={LARGE}: {'PASS' if ok else 'MISMATCH'}",
               "intrinsic_cumsum_i32", ms,
               time_ms(lambda: cp.intrinsic_plain("cumsum_i32", a)), ms * 1e6 / LARGE,
               "lane", 2 * a.nbytes, LARGE, max(max_err(got, want), max_err(again, want)),
               ok, "exact, after the first call and after the replays",
               library_ms=time_ms(lambda: LIBRARY["cumsum_i32"](a)), ulps=0 if ok else -1,
               exact=ok, timed_b=LARGE)


def reductions(device=None, per_si: dict | None = None) -> dict:
    """Device ms of PyTorch's reductions of a 98,304-lane plane as the
    super-iteration calls them (``bool.sum()``, ``int32.sum()``,
    ``.any()``), and with ``per_si`` (the ``sum`` and ``any`` calls a
    super-iteration, as ``k2_span.launches_per_si`` counts them on the main
    path) their device ms a super-iteration, each sum priced as a bool
    sum."""
    dev = cuda_device(device)
    t = inputs(dev, B_TIMED)
    mask = t["i32"] < 50
    ms = {"bool_sum": time_ms(lambda: mask.sum()), "int32_sum": time_ms(lambda: t["i32"].sum()),
          "any": time_ms(lambda: mask.any())}
    if per_si is not None:
        ms["per_super_iteration"] = per_si["sum"] * ms["bool_sum"] + per_si["any"] * ms["any"]
    return ms


def main() -> None:
    print("device:", torch.cuda.get_device_name(cuda_device()))
    print("reductions of 98,304 lanes (ms):", reductions())
    for r in run():
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        print(f"{r['name']} exact={r['exact']} max ulps={r['ulps']} ({r['tol']}); at "
              f"B={r['timed_b']} {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}; bound "
              f"{r['bound_ms']:.5f} ms")


if __name__ == "__main__":
    main()
