"""The megakernel's bounce shading: the CUDA kernel ``csrc/shade16.cu``.

``covers(config, scene)`` is the route's one predicate: the scene's tables
on a CUDA device, the HDRI environment (``sky_mode`` 0 with
``has_environment_texture``), no analytic lights (``has_lights`` off, or
an empty light table), no textures and no normal maps, the NaN canary
off; any traversal backend, flat or two-level (the kernel reads only the
closest hit's ``t``, barycentrics, slot and instance).  Where it holds,
``render/integrator.py::trace_bounce`` shades the bounce with this kernel;
everywhere else, and always on CPU tensors, with its plain PyTorch body,
the kernel's twin.  The wavefront integrator and ``multichip_render_pass``
call the same ``trace_bounce``, so they take the same route.

``shade16_cuda(scene, config, params, s, hit, work)`` runs the first
entry on the path state ``s`` (``render/integrator.py::PathState``) in
place: from the closest hit ``hit`` = ``(t, bary, slot, inst)`` to Russian
roulette, writing the shaded lanes' mask and shadow rays into ``work``
(a ``ShadeWork``, allocated once per ``path_trace`` or wavefront pass).
``check_state`` is the contract on ``s`` and ``work``: each state plane
of its dtype, contiguous and with a storage of its own; the callers build
such planes, and a state without that layout is refused, not copied.  After the occlusion
test of those rays, ``nee16_cuda(s, work, occluded)`` runs the second
entry, which adds the NEE term where the shadow ray found nothing.  Both
count their launches in ``shade16_cuda.launches[name]`` (``KERNELS``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from unity_webgpu_pathtracer_torch.config import SKY_MODE_ENVIRONMENT
from unity_webgpu_pathtracer_torch.ops import cuda_build
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE

# Threads per block (UWPT_SHADE_THREADS in csrc/shade16.cu).
SHADE_THREADS = 128
# The two entries' names; each C entry is the name + "_launch".
KERNELS = ("shade16", "shade16_nee")

# The PathState fields the kernel updates in place, in the struct's order:
# (name, dtype, rows), rows 0 = (B,).
_STATE = (("origin", torch.float32, 3), ("direction", torch.float32, 3),
          ("radiance", torch.float32, 3), ("throughput", torch.float32, 3),
          ("rng", torch.int64, 0), ("alive", torch.bool, 0),
          ("prev_pdf", torch.float32, 0), ("max_roughness", torch.float32, 0),
          ("depth", torch.int32, 0))


def covers(config, scene) -> bool:
    """Whether a bounce of ``config`` on ``scene`` is shaded by the kernel."""
    return (scene.attr_normals.device.type == "cuda"
            and config.sky_mode == SKY_MODE_ENVIRONMENT and config.has_environment_texture
            and not (config.has_lights and scene.lights.shape[0] > 0)
            and not config.has_textures and not config.has_normal_maps
            and not config.debug_nan_canary)


class ShadeWork(NamedTuple):
    """What a bounce's shading hands its occlusion test and the second
    entry, allocated once per ``path_trace`` or wavefront pass."""

    shade: torch.Tensor          # (B,) bool: the lanes that fire a shadow ray
    shadow_o: torch.Tensor       # (B, 3) shadow ray origins, where shade
    shadow_d: torch.Tensor       # (B, 3) shadow ray directions (the env sample)
    nee_radiance: torch.Tensor   # (3, B) radiance with an unoccluded NEE term
    far: torch.Tensor            # (B,) the shadow rays' t_max, the far plane


def new_work(b: int, device) -> ShadeWork:
    f32 = dict(dtype=torch.float32, device=device)
    return ShadeWork(shade=torch.zeros((b,), dtype=torch.bool, device=device),
                     shadow_o=torch.zeros((b, 3), **f32), shadow_d=torch.zeros((b, 3), **f32),
                     nee_radiance=torch.zeros((3, b), **f32),
                     far=torch.full((b,), FAR_PLANE, **f32))


class _ShadeArgs(ctypes.Structure):
    """Mirror of ``ShadeArgs`` in ``csrc/shade16.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n, _d, _r in _STATE]
                + [(n, ctypes.c_void_p) for n in (
                    "t", "bary", "slot", "inst", "shade", "shadow_o", "shadow_d",
                    "nee_radiance", "occluded", "tri_index", "attr_normals", "attr_material",
                    "materials", "inst_w2l", "inst_offsets", "env_image", "env_cdf",
                    "cdf_sum", "rotation", "intensity")]
                + [(n, ctypes.c_int) for n in ("b", "n_inst", "env_w", "env_h", "use_rr",
                                               "max_bounces")])


def check_state(s, work: ShadeWork | None) -> None:
    """Raise unless the path state ``s`` and the work planes ``work`` have
    the kernel's layout: each field of ``_STATE`` of its dtype and shape,
    contiguous, with a storage shared with no other field and no work
    plane (the kernel updates them in place), and each plane of ``work``
    of its dtype and shape on the state's device."""
    if work is None:
        raise ValueError("work: the shading kernel writes its shadow rays into planes "
                         "allocated once a pass (cuda_shade.new_work); none were given")
    dev = s.alive.device
    b = s.alive.shape[0]
    check = cuda_build.check_tensor
    for name, dtype, rows in _STATE:
        check(getattr(s, name), name, dtype, (b,) if rows == 0 else (rows, b), dev)
    for name, dtype, shape in (("shade", torch.bool, (b,)), ("shadow_o", torch.float32, (b, 3)),
                               ("shadow_d", torch.float32, (b, 3)),
                               ("nee_radiance", torch.float32, (3, b)),
                               ("far", torch.float32, (b,))):
        check(getattr(work, name), name, dtype, shape, dev)
    cuda_build.check_in_place(s, [n for n, _d, _r in _STATE], work._asdict())


def _check(scene, params, s, hit, work) -> None:
    """The kernel's contract: ``check_state``, the hit of the lanes'
    count, the tables of their dtypes and widths, the material rows
    16-byte aligned (loaded as 16-byte vectors), the scalars one float32
    each, all on the state's device."""
    check_state(s, work)
    dev = s.alive.device
    b = s.alive.shape[0]
    check = cuda_build.check_tensor
    t, bary, slot, inst = hit
    check(t, "t", torch.float32, (b,), dev)
    check(bary, "bary", torch.float32, (b, 2), dev)
    check(slot, "slot", torch.int32, (b,), dev)
    check(inst, "inst", torch.int32, (b,), dev)
    n_tri = scene.tri_index.shape[0]
    env = scene.env
    h, w = env.image.shape[0], env.image.shape[1]
    for name, x, dtype, shape in (
            ("tri_index", scene.tri_index, torch.int32, (n_tri,)),
            ("attr_normals", scene.attr_normals, torch.float32, (n_tri, 9)),
            ("attr_material", scene.attr_material, torch.int32, (n_tri,)),
            ("materials", scene.materials, torch.float32, (scene.materials.shape[0], 32)),
            ("inst_w2l", scene.inst_w2l, torch.float32, (scene.inst_w2l.shape[0], 12)),
            ("inst_offsets", scene.inst_offsets, torch.int32, (scene.inst_w2l.shape[0], 4)),
            ("env.image", env.image, torch.float32, (h, w, 3)),
            ("env.cdf", env.cdf, torch.float32, (h * w,))):
        check(x, name, dtype, shape, dev)
    if scene.materials.data_ptr() % 16:
        raise ValueError("materials: the kernel loads rows as 16-byte vectors; pass a "
                         "16-byte-aligned table")
    for name, x in (("env.cdf_sum", env.cdf_sum), ("environment_rotation",
                                                    params.environment_rotation),
                    ("environment_intensity", params.environment_intensity)):
        if x.device != dev or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"{name}: expected one float32 on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _launch(name: str, args: _ShadeArgs, dev) -> None:
    lib = cuda_build.load()["shade16"]
    err = getattr(lib, name + "_launch")(ctypes.byref(args),
                                         torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, name)
    shade16_cuda.launches[name] += 1


def _args(scene, config, params, s, hit, work, occluded=None) -> _ShadeArgs:
    env = scene.env
    ptrs = [getattr(s, n).data_ptr() for n, _d, _r in _STATE]
    ptrs += [x.data_ptr() for x in hit]
    ptrs += [work.shade.data_ptr(), work.shadow_o.data_ptr(), work.shadow_d.data_ptr(),
             work.nee_radiance.data_ptr(), 0 if occluded is None else occluded.data_ptr()]
    ptrs += [x.data_ptr() for x in (scene.tri_index, scene.attr_normals, scene.attr_material,
                                    scene.materials, scene.inst_w2l, scene.inst_offsets,
                                    env.image, env.cdf, env.cdf_sum,
                                    params.environment_rotation,
                                    params.environment_intensity)]
    return _ShadeArgs(*ptrs, s.alive.shape[0], scene.inst_w2l.shape[0], env.image.shape[1],
                      env.image.shape[0], int(config.use_russian_roulette),
                      int(config.max_bounces))


def shade16_cuda(scene, config, params, s, hit, work: ShadeWork) -> None:
    """The first entry on the path state ``s``, in place (see the module
    doc); ``s`` and ``work`` as ``check_state`` holds them, on the device
    of a scene that ``covers`` admits.  ``hit`` is the closest-hit tuple of the bounce's
    live lanes; its slot and instance are taken as int32 and its planes
    contiguous."""
    t, bary, slot, inst = hit
    hit = (t.contiguous(), bary.contiguous(), slot.to(torch.int32).contiguous(),
           inst.to(torch.int32).contiguous())
    _check(scene, params, s, hit, work)
    _launch("shade16", _args(scene, config, params, s, hit, work), s.alive.device)


def nee16_cuda(s, work: ShadeWork, occluded: torch.Tensor) -> None:
    """The second entry: the lanes of ``work.shade`` whose shadow ray
    ``occluded`` ((B,) bool) did not block take ``work.nee_radiance``."""
    b, dev = s.alive.shape[0], s.alive.device
    cuda_build.check_tensor(occluded, "occluded", torch.bool, (b,), dev)
    cuda_build.check_tensor(s.radiance, "radiance", torch.float32, (3, b), dev)
    args = _ShadeArgs(radiance=s.radiance.data_ptr(), shade=work.shade.data_ptr(),
                      nee_radiance=work.nee_radiance.data_ptr(),
                      occluded=occluded.data_ptr(), b=b)
    _launch("shade16_nee", args, dev)


# Launch count of each entry.
shade16_cuda.launches = dict.fromkeys(KERNELS, 0)
