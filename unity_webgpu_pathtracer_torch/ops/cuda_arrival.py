"""wide16 arrival step: the CUDA kernels of ``csrc/arrival16.cu`` and
their plain twin.

``arrival_step16_cuda`` takes the ray as (3, B) planes, as the reference's
``ops/pallas_arrival.py::arrival_step16_pallas`` does.  Tensors on a CUDA
device launch a kernel (the row ``nodes[ptr]`` is loaded inside it),
picked by the table's row width and ``has_instances`` (two-level tables,
whose instance rows the flat kernels cannot read): ``arrival16`` and
``arrival16_inst`` on (N, 96) tables, ``arrival16_leaf8`` and
``arrival16_inst_leaf8`` on (N, 48) leaf8 tables.  Each entry counts its
launches in ``arrival_step16_cuda.launches[name]``.  Tensors on the CPU
run the plain twin ``traverse_wide16.arrival_step16`` with the same row
gather, so the signatures match.
"""

from __future__ import annotations

import ctypes

import torch

from unity_webgpu_pathtracer_torch.ops import cuda_build
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import Wide16State, arrival_step16


# Kernel name by (row width, has_instances); its C entry is name + "_launch".
KERNELS = {(96, False): "arrival16", (96, True): "arrival16_inst",
           (48, False): "arrival16_leaf8", (48, True): "arrival16_inst_leaf8"}

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
    if nodes.dim() != 2 or nodes.shape[1] not in (96, 48):
        raise ValueError(f"nodes: expected (N, 96) or leaf8 (N, 48), got {tuple(nodes.shape)}")
    cuda_build.check_tensor(nodes, "nodes", torch.float32, nodes.shape, dev)
    for name, x in (("oT", oT), ("dT", dT), ("invT", invT)):
        cuda_build.check_tensor(x, name, torch.float32, (3, b), dev)
    for name in ("ptr", "pend", "sp", "tri"):
        cuda_build.check_tensor(getattr(s, name), name, torch.int32, (b,), dev)
    for name in ("t", "u", "v"):
        cuda_build.check_tensor(getattr(s, name), name, torch.float32, (b,), dev)
    cuda_build.check_tensor(s.found, "found", torch.bool, (b,), dev)
    cuda_build.check_tensor(s.stack_row, "stack_row", torch.int32, (depth, b), dev)
    cuda_build.check_tensor(s.stack_mask, "stack_mask", torch.int32, (depth, b), dev)
    if active is not None:
        cuda_build.check_tensor(active, "active", torch.bool, (b,), dev)
    fields = _FLAT_FIELDS
    if has_instances:
        for name in ("inst", "hit_inst", "sp_enter"):
            cuda_build.check_tensor(getattr(s, name), name, torch.int32, (b,), dev)
        for name in ("local_o", "local_d", "local_inv"):
            cuda_build.check_tensor(getattr(s, name), name, torch.float32, (3, b), dev)
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
    lib = cuda_build.load()["arrival16"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = KERNELS[(nodes.shape[1], has_instances)]
    launch = getattr(lib, name + "_launch")
    if has_instances:
        inst = _InstArgs(*(getattr(s, n).data_ptr() for n in _INST_FIELDS),
                         *(getattr(out, n).data_ptr() for n in _INST_FIELDS))
        err = launch(ctypes.byref(args), ctypes.byref(inst), stream)
    else:
        err = launch(ctypes.byref(args), stream)
    cuda_build.check(lib, err, name)
    arrival_step16_cuda.launches[name] += 1
    return out


# Launch count of each kernel entry.
arrival_step16_cuda.launches = dict.fromkeys(KERNELS.values(), 0)
