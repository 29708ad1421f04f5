"""The transition span of the main path on the H100: everything the HDRI
kernel route runs between K1 and the record append, measured on states of
a 1920x1080 pass over the 1M-triangle benchmark scene.

    python -m unity_webgpu_pathtracer_torch.experiments.k2_span [--passes N]

The span is ``render/fused.py::_transition_kernel_path`` with
``_record_and_regenerate`` replaced by a no-op: kernel K2's one launch,
which samples the environment and reads the attribute and material rows
itself.  The script prints:

- the span's device time at the starts of the transitions of
  super-iterations 4 and 151 (``SPAN_AT``): a CUDA graph of a restore of the
  captured state plus the span, minus a graph of the restore alone;
- its host wall time, eager: ``REPS`` calls of restore + span, minus
  ``REPS`` restores, from a synchronize to a synchronize;
- the kernel launches of one eager span, and of the main path per
  super-iteration over three super-iterations (5, 6, 7), counted by
  ``torch.profiler`` (device kernels, memcpy/memset, and the CPU-side
  launch calls; the ctypes kernels appear as device kernels only), and
  the main path's reductions of a whole tensor to one value
  (``ScalarReductions``);
- with ``--passes N``, only this: the set-up seconds (the scene's
  generation, its table build or cache load and the upload, to a
  synchronize), then N passes of that configuration through ``Renderer``
  after one warm-up pass, the seconds of each (the same work every pass),
  so two checkouts can be timed in turns in one machine session (run this
  file by its path from the other checkout, with ``PYTHONPATH`` there).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from unity_webgpu_pathtracer_torch.experiments._common import (cuda_device, ptxas_registers,
                                                               time_in_place_ms)

SPAN_AT = (4, 151)
REPS = 50
PROFILE_SI = (5, 8)   # profile from K1 of super-iteration 5 up to K1 of 8


class _Stop(Exception):
    pass


def _setup(dev):
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    scene, cam = million_triangle_scene(1_000_000)
    sd = scene.build("wide16", device=dev)
    params = make_camera_params(width=1920, height=1080, device=dev, **cam)
    cfg = RenderConfig(width=1920, height=1080, samples_per_pass=4, max_bounces=5,
                       transition_every=8, pool_size=98_304)
    return sd, cfg, params


def _clone(s):
    """A FusedState whose per-lane tensors and counters are copies (the
    record film is shared: the span does not touch it)."""
    kw = {}
    for f in dataclasses.fields(s):
        x = getattr(s, f.name)
        if f.name == "trav":
            kw[f.name] = x._replace(**{k: v.clone() for k, v in x._asdict().items()})
        elif isinstance(x, torch.Tensor) and not f.name.startswith("rec_"):
            kw[f.name] = x.clone()
        else:
            kw[f.name] = x
    return dataclasses.replace(s, **kw)


def capture_spans(sd, cfg, params, at=SPAN_AT) -> list:
    """(args, kwargs) of the transition of each super-iteration in ``at``
    (``args[3]`` the FusedState, cloned before the call)."""
    from unity_webgpu_pathtracer_torch.render import fused

    orig, got, n = fused._transition_kernel_path, [], [0]

    def hook(*args, **kw):
        n[0] += 1
        if n[0] in at:
            got.append((args[:3] + (_clone(args[3]),) + args[4:], kw))
            if n[0] == max(at):
                raise _Stop
        return orig(*args, **kw)

    fused._transition_kernel_path = hook
    try:
        fused.fused_pass_with_stats(sd, cfg, params, 0)
    except _Stop:
        pass
    finally:
        fused._transition_kernel_path = orig
    if len(got) != len(at):
        raise RuntimeError(f"pass ended after {n[0]} transitions")
    return got


def _span_fns(cap):
    """(span, restore) on a working copy of the captured state: ``span``
    runs the transition, in place, without its record append and
    regeneration; ``restore`` copies the captured state back."""
    from unity_webgpu_pathtracer_torch.render import fused

    args, kw = cap
    s0 = args[3]
    work = _clone(s0)

    def restore():
        for f in dataclasses.fields(work):
            x = getattr(work, f.name)
            if f.name == "trav":
                for k, v in x._asdict().items():
                    v.copy_(getattr(s0.trav, k))
            elif isinstance(x, torch.Tensor) and not f.name.startswith("rec_"):
                x.copy_(getattr(s0, f.name))

    def span():
        orig = fused._record_and_regenerate
        fused._record_and_regenerate = lambda *a, **k: None
        try:
            fused._transition_kernel_path(*args[:3], work, *args[4:], **kw)
        finally:
            fused._record_and_regenerate = orig

    return span, restore


def host_ms(span, restore, reps=REPS) -> float:
    """Wall ms per eager call of ``span`` (restore + span minus restore)."""
    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def both():
        restore()
        span()

    wall(both)   # warm
    return wall(both) - wall(restore)


def _count(prof) -> dict:
    """Device kernels, device memcpy/memset and CPU launch calls in a
    profile."""
    from torch.autograd import DeviceType

    kern, mem, launch, names = 0, 0, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if "memcpy" in e.name.lower() or "memset" in e.name.lower():
                mem += 1
            else:
                kern += 1
                names[e.name] = names.get(e.name, 0) + 1
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                        "cuLaunchKernelEx"):
            launch += 1
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return dict(kernels=kern, memcpy_memset=mem, cpu_launch_calls=launch, top=top)


class ScalarReductions(TorchDispatchMode):
    """Counts the reductions of a whole tensor to one value that the code
    calls (``x.sum()``, ``x.any()``); a reduction over a dim
    (``x.sum(dim=1)``) and an op that an op calls inside are not counted."""

    OPS = {torch.ops.aten.sum.default: "sum", torch.ops.aten.any.default: "any"}

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(self.OPS.values(), 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            self.counts[self.OPS[func]] += 1
        return func(*args, **(kwargs or {}))


def _profile(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _count(prof)


def launches_per_si(sd, cfg, params, window=PROFILE_SI) -> dict:
    """The main path's launches and reductions to one value
    (``ScalarReductions``) per super-iteration, counted from the K1 launch
    of super-iteration ``window[0]`` to that of ``window[1]``."""
    from torch.profiler import ProfilerActivity, profile

    from unity_webgpu_pathtracer_torch.render import fused

    orig, n, box = fused.arrival_steps16_cuda, [0], {}

    def k1(*a, **k):
        n[0] += 1
        if n[0] == window[0]:
            torch.cuda.synchronize()
            box["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            box["prof"].__enter__()
            box["red"] = ScalarReductions()
            box["red"].__enter__()
        elif n[0] == window[1]:
            box["red"].__exit__(None, None, None)
            torch.cuda.synchronize()
            box["prof"].__exit__(None, None, None)
            raise _Stop
        return orig(*a, **k)

    fused.arrival_steps16_cuda = k1
    try:
        fused.fused_pass_with_stats(sd, cfg, params, 0)
    except _Stop:
        pass
    finally:
        fused.arrival_steps16_cuda = orig
    c = _count(box["prof"])
    si = window[1] - window[0]
    return {**c, "super_iterations": si, "kernels_per_si": c["kernels"] / si,
            "memcpy_memset_per_si": c["memcpy_memset"] / si,
            "reductions_per_si": {k: v / si for k, v in box["red"].counts.items()}}


def main() -> None:
    dev = cuda_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    from unity_webgpu_pathtracer_torch.ops import cuda_build

    cuda_build.load()
    regs = ptxas_registers(cuda_build.BUILD_INFO["log"], "transition16")
    print(f"card: {card}; K2 registers (ptxas): {regs}", flush=True)
    t0 = time.perf_counter()
    sd, cfg, params = _setup(dev)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    if "--passes" in sys.argv:
        from unity_webgpu_pathtracer_torch.api import Renderer

        r = Renderer(sd, cfg, params)
        r.render(passes=1)
        secs = []
        for _ in range(int(sys.argv[sys.argv.index("--passes") + 1])):
            r.reset()
            t0 = time.perf_counter()
            r.render(passes=1)   # ends in a synchronize
            secs.append(time.perf_counter() - t0)
        print(f"set-up: {setup_s} s; passes: {secs} s/pass; {r.stats()}; card: {card}",
              flush=True)
        return
    for si, cap in zip(SPAN_AT, capture_spans(sd, cfg, params)):
        span, restore = _span_fns(cap)
        restore()
        prof = _profile(span)
        ms, t_both, t_restore = time_in_place_ms(span, restore)
        h = host_ms(span, restore)
        print(f"span SI {si}: device {ms:.4f} ms (graph of restore + span {t_both:.4f}, restore "
              f"{t_restore:.4f}); host wall eager {h:.4f} ms; one eager span: {prof}",
              flush=True)
    c = launches_per_si(sd, cfg, params)
    print(f"main path, super-iterations {PROFILE_SI[0]}-{PROFILE_SI[1] - 1}: "
          f"{c['kernels_per_si']:.1f} kernels and {c['memcpy_memset_per_si']:.1f} "
          f"memcpy/memset per super-iteration; {c}", flush=True)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
