"""wide16 arrival step: the CUDA kernels of ``csrc/arrival16.cu`` and
their plain twin.

``arrival_step16_cuda`` takes the ray as (3, B) planes, as the reference's
``ops/pallas_arrival.py::arrival_step16_pallas`` does.  Tensors on a CUDA
device launch a kernel (the row ``nodes[ptr]`` is loaded inside it):
``arrival16`` for flat tables, ``arrival16_inst`` with ``has_instances``
(two-level tables, whose instance rows the flat kernel cannot read).
Tensors on the CPU run the plain twin ``traverse_wide16.arrival_step16``
with the same row gather, so the signatures match.
"""

from __future__ import annotations

import ctypes

import torch

from unity_webgpu_pathtracer_torch.ops import cuda_build
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import Wide16State, arrival_step16


# Wide16State fields of each argument struct, in struct order.
_FLAT_FIELDS = ("ptr", "pend", "sp", "stack_row", "stack_mask", "t", "u", "v", "tri",
                "found")
_INST_FIELDS = ("inst", "hit_inst", "sp_enter", "local_o", "local_d", "local_inv")


class _ArrivalArgs(ctypes.Structure):
    """Mirror of ``ArrivalArgs`` in ``csrc/arrival16.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("nodes", "o", "d", "inv", "active")]
                + [(n, ctypes.c_void_p) for n in _FLAT_FIELDS]
                + [("o_" + n, ctypes.c_void_p) for n in _FLAT_FIELDS]
                + [("b", ctypes.c_int), ("depth", ctypes.c_int)])


class _InstArgs(ctypes.Structure):
    """Mirror of ``InstArgs`` in ``csrc/arrival16.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _INST_FIELDS]
                + [("o_" + n, ctypes.c_void_p) for n in _INST_FIELDS])


def _check(x: torch.Tensor, name: str, dtype, shape, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
                         f"{'' if x.is_contiguous() else ' (non-contiguous)'}")


def arrival_step16_cuda(nodes: torch.Tensor, oT: torch.Tensor, dT: torch.Tensor,
                        invT: torch.Tensor, s: Wide16State,
                        active: torch.Tensor | None = None,
                        has_instances: bool = False) -> Wide16State:
    """One arrival for every lane; ``oT``/``dT``/``invT`` are (3, B).
    ``has_instances`` must be set exactly for two-level tables.  The
    inputs are checked against the kernel's contract on either device."""
    dev = nodes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
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
    fields = _FLAT_FIELDS
    if has_instances:
        for name in ("inst", "hit_inst", "sp_enter"):
            _check(getattr(s, name), name, torch.int32, (b,), dev)
        for name in ("local_o", "local_d", "local_inv"):
            _check(getattr(s, name), name, torch.float32, (3, b), dev)
        fields = _FLAT_FIELDS + _INST_FIELDS
    if dev.type == "cpu":
        return arrival_step16(nodes, oT.T, dT.T, invT.T, s, active, has_instances)

    # The flat kernel passes the instance registers through untouched.
    out = s._replace(**{n: torch.empty_like(getattr(s, n)) for n in fields})
    args = _ArrivalArgs(
        nodes.data_ptr(), oT.data_ptr(), dT.data_ptr(), invT.data_ptr(),
        0 if active is None else active.data_ptr(),
        *(getattr(s, n).data_ptr() for n in _FLAT_FIELDS),
        *(getattr(out, n).data_ptr() for n in _FLAT_FIELDS),
        b, depth)
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if has_instances:
        inst = _InstArgs(*(getattr(s, n).data_ptr() for n in _INST_FIELDS),
                         *(getattr(out, n).data_ptr() for n in _INST_FIELDS))
        err = lib.arrival16_inst_launch(ctypes.byref(args), ctypes.byref(inst), stream)
        cuda_build.check(lib, err, "arrival16_inst")
        arrival_step16_cuda.launches_inst += 1
    else:
        err = lib.arrival16_launch(ctypes.byref(args), stream)
        cuda_build.check(lib, err, "arrival16")
        arrival_step16_cuda.launches += 1
    return out


# Launch counts of the flat and the instanced kernel.
arrival_step16_cuda.launches = 0
arrival_step16_cuda.launches_inst = 0
