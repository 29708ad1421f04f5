"""wide16 arrival step: the CUDA kernel ``csrc/arrival16.cu`` and its
plain twin.

``arrival_step16_cuda`` takes the ray as (3, B) planes, as the reference's
``ops/pallas_arrival.py::arrival_step16_pallas`` does.  Tensors on a CUDA
device launch the kernel (the row ``nodes[ptr]`` is loaded inside it);
tensors on the CPU run the plain twin ``traverse_wide16.arrival_step16``
with the same row gather, so the signatures match.
"""

from __future__ import annotations

import ctypes

import torch

from unity_webgpu_pathtracer_torch.ops import cuda_build
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import Wide16State, arrival_step16


class _ArrivalArgs(ctypes.Structure):
    """Mirror of ``ArrivalArgs`` in ``csrc/arrival16.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("nodes", "o", "d", "inv", "active")]
                + [(n, ctypes.c_void_p) for n in Wide16State._fields]
                + [("o_" + n, ctypes.c_void_p) for n in Wide16State._fields]
                + [("b", ctypes.c_int), ("depth", ctypes.c_int)])


def _check(x: torch.Tensor, name: str, dtype, shape, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
                         f"{'' if x.is_contiguous() else ' (non-contiguous)'}")


def arrival_step16_cuda(nodes: torch.Tensor, oT: torch.Tensor, dT: torch.Tensor,
                        invT: torch.Tensor, s: Wide16State,
                        active: torch.Tensor | None = None) -> Wide16State:
    """One arrival for every lane; ``oT``/``dT``/``invT`` are (3, B)."""
    if nodes.device.type == "cpu":
        return arrival_step16(nodes, oT.T, dT.T, invT.T, s, active)
    if nodes.device.type != "cuda":
        raise ValueError(f"unsupported device {nodes.device}")
    dev = nodes.device
    b = s.ptr.shape[0]
    depth = s.stack_row.shape[0]
    if nodes.dim() != 2 or nodes.shape[1] != 96:
        raise ValueError(f"nodes: expected (N, 96), got {tuple(nodes.shape)}")
    _check(nodes, "nodes", torch.float32, nodes.shape, dev)
    for name, x in (("oT", oT), ("dT", dT), ("invT", invT)):
        _check(x, name, torch.float32, (3, b), dev)
    for name in ("ptr", "pend", "sp", "tri"):
        _check(getattr(s, name), name, torch.int32, (b,), dev)
    for name in ("t", "u", "v"):
        _check(getattr(s, name), name, torch.float32, (b,), dev)
    _check(s.found, "found", torch.bool, (b,), dev)
    _check(s.stack_row, "stack_row", torch.int32, (depth, b), dev)
    _check(s.stack_mask, "stack_mask", torch.int32, (depth, b), dev)
    if active is not None:
        _check(active, "active", torch.bool, (b,), dev)

    out = Wide16State(
        ptr=torch.empty_like(s.ptr), pend=torch.empty_like(s.pend),
        sp=torch.empty_like(s.sp),
        stack_row=torch.empty_like(s.stack_row),
        stack_mask=torch.empty_like(s.stack_mask),
        t=torch.empty_like(s.t), u=torch.empty_like(s.u), v=torch.empty_like(s.v),
        tri=torch.empty_like(s.tri), found=torch.empty_like(s.found),
    )
    args = _ArrivalArgs(
        nodes.data_ptr(), oT.data_ptr(), dT.data_ptr(), invT.data_ptr(),
        0 if active is None else active.data_ptr(),
        *(getattr(s, n).data_ptr() for n in Wide16State._fields),
        *(getattr(out, n).data_ptr() for n in Wide16State._fields),
        b, depth)
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.arrival16_launch(ctypes.byref(args), stream)
    cuda_build.check(lib, err, "arrival16")
    arrival_step16_cuda.launches += 1
    return out


arrival_step16_cuda.launches = 0
