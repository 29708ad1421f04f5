"""Run one cell of the benchmark once.

    python3 -m pt_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up builds the cell's scene from its
configuration, the port's renderer with its kernels and tables, and renders
one warm-up pass at the cell's shape; the window then renders passes back to
back (a closed loop: the next pass starts when the last one, and its
presentation, has ended) for ``--seconds``; with ``--trace 1`` a few more
passes run under the profiler.  Then the film is judged against the plain
reference (``check.py``), and the last line of standard output is the
result: end-to-end metrics with ``--trace 0``, per-layer metrics with
``--trace 1``.  Exits with 2 and prints no result without the CUDA devices
the cell asks for, with 3 if a forbidden module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The port's table cache, at a fixed place inside the checkout: the first
# run of a checkout builds the BVH, later runs load it.
CACHE_DIR = os.path.join(ROOT, ".pt_bench_cache")


class Forbidden(RuntimeError):
    pass


def seed_root(seed: int) -> int:
    """The uint32 root of the sample streams of ``seed``."""
    return int(np.random.SeedSequence(seed % (1 << 64)).generate_state(1)[0])


def _guard(where: str, log) -> None:
    """Raise :class:`Forbidden` if a forbidden module is loaded, or if the
    reference or the yardstick has bound anything of the port."""
    from pt_bench import guard

    bad = guard.forbidden() + guard.reference_imports()
    if bad:
        log(f"forbidden modules loaded {where}: {', '.join(bad)}")
        raise Forbidden(", ".join(bad))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, log=None,
             overrides: dict | None = None, t_start: float | None = None) -> dict:
    """One run of ``cell`` (a ``registry.Cell``) on ``device``: the result
    object.  ``overrides`` replaces configuration and traffic keys (the CPU
    tests' tiny sizes); ``log`` takes the lines for standard error.  Raises
    :class:`Forbidden`, before any result exists, if a forbidden module was
    loaded by then: after set-up, and once the check and the metric readers
    have run."""
    import torch

    from pt_bench import check, port, scenes
    from pt_bench import trace as ptrace

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    t_start = T_START if t_start is None else t_start
    ov = overrides or {}
    cfg = {**cell.config, **ov.get("config", {})}
    traffic = {**cell.traffic, **ov.get("traffic", {})}
    w, h, spp = traffic["width"], traffic["height"], traffic["samples_per_pass"]
    present = bool(traffic["present"])
    root = seed_root(seed)

    # ---- set-up
    t0 = time.perf_counter()
    port.load_kernels(device)
    kernels_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = scenes.generate(cfg)
    pr = port.PortRenderer(spec, cfg, traffic, w, h, root, device)
    _sync(device)
    scene_s = time.perf_counter() - t0
    pr.step()
    if present:
        pr.image()
    _sync(device)
    pr.reset()
    _guard("after set-up", log)
    setup_s = time.perf_counter() - t_start

    # ---- window: closed loop
    frames, presents = [], []
    c0 = port.counters()
    _sync(device)
    w0 = time.perf_counter()
    image = None
    while True:
        f0 = time.perf_counter()
        pr.step()
        if present:
            p0 = time.perf_counter()
            image = pr.image()
            f1 = time.perf_counter()
            presents.append(f1 - p0)
        else:
            _sync(device)
            f1 = time.perf_counter()
        frames.append(f1 - f0)
        if f1 - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    c1 = port.counters()
    passes = len(frames)

    # ---- traced passes
    tr, k1_bounds = None, None
    n_traced = int(traffic["trace_passes"]) if trace else 0
    if trace:
        with ptrace.traced(device) as holder:
            with ptrace.window_span():
                for k in range(n_traced):
                    with ptrace.pass_span(k):
                        pr.step()
                        if present:
                            image = pr.image()
                        _sync(device)
        tr = holder.trace
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if trace and traffic["integrator"] == "megakernel" and device.type == "cuda":
        k1_bounds = _k1_first_traversal(pr, spec, cfg, traffic, w, h, root, passes, device)

    # ---- the check
    total_passes = passes + n_traced
    film = pr.film
    pix = check.sample_pixels(seed, w * h, int(traffic["check_pixels"]))
    pix_t = torch.from_numpy(pix).to(device)
    film_px = film.reshape(-1, 3)[pix_t].clone()
    numbers = {}
    if present:
        numbers["image_lsb_max"] = check.image_lsb_max(image, film)
    del film, pr
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref_px = _reference(spec, cfg, traffic, w, h, root, pix_t, total_passes, device)
    check_s = time.perf_counter() - t0
    numbers = {**check.film_numbers(film_px, ref_px), **numbers}
    correct, report = check.judge(numbers, cell.check["limits"])

    ctx = types.SimpleNamespace(
        cell=cell.name, traffic=traffic, passes=passes, window_s=window_s, frames=frames,
        presents=presents, n_traced=n_traced,
        counters={k: c1[k] - c0[k] for k in c0}, kernels_s=kernels_s, scene_s=scene_s,
        setup_s=setup_s, trace=tr, k1_bounds=k1_bounds, pixels=w * h, spp=spp)
    if trace:
        from pt_bench import registry

        metrics = {}
        for m in cell.per_layer:
            v = registry.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        log(f"card: {_power_limit() if device.type == 'cuda' else 'cpu'}")
        log(f"K1 launches and host reads of the traversals' loop test a pass: "
            f"{ctx.counters['k1_launches'] / passes}, {ctx.counters['host_reads'] / passes}")
    else:
        e2e = {
            "msamples_per_s": passes * spp * w * h / window_s / 1e6,
            "frame_ms_p90": statistics.quantiles(frames, n=10, method="inclusive")[8] * 1e3
            if len(frames) >= 2 else frames[0] * 1e3,
            "peak_mem_gib": peak / 2**30,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    # The reference and every reader have loaded by now.
    _guard("after the window and the check", log)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": total_passes,
              "failed": 0 if correct else total_passes, "metrics": metrics, "device": dev}
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_us * 1e-6
        dev["window_s"] = tr.window_us * 1e-6
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    q = statistics.quantiles(frames, n=10, method="inclusive") if len(frames) >= 2 else frames
    log(f"frame ms: min {min(frames) * 1e3:.1f}, median {statistics.median(frames) * 1e3:.1f}, "
        f"p90 {q[-1] * 1e3:.1f}, max {max(frames) * 1e3:.1f}")
    log(f"passes {passes} in {window_s:.3f} s (+{n_traced} traced), set-up {setup_s:.3f} s "
        f"(kernels {kernels_s:.3f} s, scene {scene_s:.3f} s), reference {check_s:.3f} s "
        f"over {pix.shape[0]} pixels")
    for k, v in report.items():
        log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")
    result["check"] = report
    return result


def _reference(spec, cfg, traffic, w, h, root, pix_t, passes, device):
    """The reference's film at the sampled pixels after ``passes`` passes."""
    from pt_bench.reference import camera as rcamera
    from pt_bench.reference import config as rconfig
    from pt_bench.reference import render as rrender
    from pt_bench.reference import scene as rscene

    rs = rscene.build(spec, device)
    rc = rconfig.RenderConfig(width=w, height=h, samples_per_pass=traffic["samples_per_pass"],
                              integrator="megakernel", **cfg["render"])
    rp = rcamera.make_camera_params(width=w, height=h, seed_root=root, device=device,
                                    **spec.camera)
    return rrender.film_at(rs, rc, rp, pix_t, passes)


def _k1_first_traversal(pr, spec, cfg, traffic, w, h, root, pass_index, device):
    """Bounds (ms) of the K1 launches of the first traced pass's first
    closest-hit traversal: its primary rays from the frozen camera, from
    the root, on the program's table."""
    import torch

    from pt_bench.reference import camera as rcamera
    from pt_bench.reference import config as rconfig
    from pt_bench.reference import rng as rrng
    from pt_bench.yardstick import roofline

    rc = rconfig.RenderConfig(width=w, height=h, samples_per_pass=traffic["samples_per_pass"],
                              integrator="megakernel", **cfg["render"])
    rp = rcamera.make_camera_params(width=w, height=h, seed_root=root, device=device,
                                    **spec.camera)
    pix = torch.arange(w * h, dtype=torch.int64, device=device)
    state = rrng.seed(pix, pass_index * traffic["samples_per_pass"], rp.seed_root)
    coords, state = rcamera.jittered_pixel_coords(pix, rc, state)
    o, d, _ = rcamera.get_screen_ray(coords, rc, rp, state)
    scene = pr.scene
    return roofline.traversal_work(scene.wide16_nodes, o.contiguous(), d.contiguous(),
                                   scene.stack_depth, scene.inst_w2l.shape[0] > 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["UWPT_BVH_CACHE_DIR"] = os.path.join(CACHE_DIR, "bvh")

    from pt_bench import registry

    cell = registry.cell(registry.load_manifest(ROOT), args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0))
    except Forbidden:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
