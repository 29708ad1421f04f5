"""wide16 arrival step: the CUDA kernels of ``csrc/arrival16.cu`` and
their plain twins.

``arrival_steps16_cuda`` runs ``steps`` arrivals in one launch and updates
the state's tensors in place (the render paths call it once per
super-iteration).  Tensors on a CUDA device launch
``arrival16_run_kernel`` (the row ``nodes[ptr]`` is loaded inside it),
picked by the table's row width and ``has_instances`` (two-level tables,
whose instance rows the flat kernels cannot read): ``arrival16_run`` and
``arrival16_inst_run`` on (N, 96) tables, ``arrival16_leaf8_run`` and
``arrival16_inst_leaf8_run`` on (N, 48) leaf8 tables (``RUN_KERNELS``),
each counting its launches in ``arrival_steps16_cuda.launches[name]``.
Tensors on the CPU run the plain version ``traverse_wide16.arrival_steps16``.

``arrival_step16_cuda`` runs one arrival out of place; it takes the ray as
(3, B) planes, as the reference's
``ops/pallas_arrival.py::arrival_step16_pallas`` does.  On CUDA tensors it
clones the fields the arrival updates and launches the same kernel on the
copy with ``steps=1``, counting the launch under the one-arrival name
(``KERNELS``: ``arrival16``, ``arrival16_inst``, ``arrival16_leaf8``,
``arrival16_inst_leaf8``) in ``arrival_step16_cuda.launches``.  Tensors on
the CPU run the plain twin ``traverse_wide16.arrival_step16`` with the same
row gather, so the signatures match.

``arrival_probe_cuda`` runs a probe mode (``PROBE_MODES``) on flat
96-float rows, each lane on the row its ``rows`` plane names, in place:
the kernel diet's six (``arrival16_diet_kernel``, entry
``arrival16_diet_launch``; plain version
``experiments/round14_kernel_diet.diet_step16``), and ``f16leaf`` and
``bf16leaf`` (one arrival of ``arrival16_run_kernel`` on the row plane,
with the f16 or a bf16 leaf decode, entry ``arrival16_run_probe_launch``;
plain version the twin).  It counts launches in
``arrival_probe_cuda.launches`` by the names in ``PROBE_KERNELS``.  The
render path never calls it.
"""

from __future__ import annotations

import ctypes

import torch

from unity_webgpu_pathtracer_torch.ops import cuda_build
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import (
    Wide16State,
    arrival_step16,
    arrival_steps16,
)


# One-arrival name by (row width, has_instances): the launch counter of
# ``arrival_step16_cuda``.
KERNELS = {(96, False): "arrival16", (96, True): "arrival16_inst",
           (48, False): "arrival16_leaf8", (48, True): "arrival16_inst_leaf8"}
# The multi-arrival kernel of each, name + "_run"; its C entry is that
# name + "_launch".
RUN_KERNELS = {k: f"{v}_run" for k, v in KERNELS.items()}
# Blocks of 256 threads K1 and the diet must fit on an SM
# (UWPT_K1_MIN_BLOCKS in csrc/arrival16.cu; 3: at most 80 registers a
# thread).  experiments/k1_variants.py builds and times other values.
K1_MIN_BLOCKS = 3

# Probe modes: the six of the reference's
# experiments/round14_kernel_diet.py::make_kernel, and the production step
# with the f16 or a bf16 leaf decode (experiments/round16_bf16leaf_probe.py).
DIET_MODES = ("full", "no_leaf", "no_inner", "no_stack", "leaf_bf16", "leaf_noint")
PROBE_MODES = DIET_MODES + ("f16leaf", "bf16leaf")
# Probe kernel name by mode; the C entries ``arrival16_diet_launch`` (the
# diet's modes) and ``arrival16_run_probe_launch`` (the leaf decodes) take
# the mode's number (``cuda_build`` passes them as UWPT_PROBE_* macros; 0
# is the production code).
PROBE_KERNELS = {m: f"arrival16_{m}" if m.endswith("16leaf") else f"arrival16_diet_{m}"
                 for m in PROBE_MODES}
PROBE_NUMBERS = {m: k + 1 for k, m in enumerate(PROBE_MODES)}

# Wide16State fields of each argument struct, in struct order.
_FLAT_FIELDS = ("ptr", "pend", "sp", "stack_row", "stack_mask", "t", "u", "v", "tri",
                "found")
_INST_FIELDS = ("inst", "hit_inst", "sp_enter", "local_o", "local_d", "local_inv")


class _RunArgs(ctypes.Structure):
    """Mirror of ``RunArgs`` in ``csrc/arrival16.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("nodes", "o", "d", "inv", "live",
                                                 "stop_on_found")]
                + [(n, ctypes.c_void_p) for n in _FLAT_FIELDS]
                + [("b", ctypes.c_int), ("depth", ctypes.c_int), ("steps", ctypes.c_int)])


class _InstArgs(ctypes.Structure):
    """Mirror of ``InstArgs`` in ``csrc/arrival16.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _INST_FIELDS]
                + [("o_" + n, ctypes.c_void_p) for n in _INST_FIELDS])


def _check(nodes, oT, dT, invT, s, active, has_instances) -> None:
    """The kernels' contract, checked on either device."""
    dev = nodes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    b = s.ptr.shape[0]
    depth = s.stack_row.shape[0]
    if nodes.dim() != 2 or nodes.shape[1] not in (96, 48):
        raise ValueError(f"nodes: expected (N, 96) or leaf8 (N, 48), got {tuple(nodes.shape)}")
    cuda_build.check_tensor(nodes, "nodes", torch.float32, nodes.shape, dev)
    if nodes.data_ptr() % 16:
        raise ValueError("nodes: the kernels load rows as 16-byte vectors; pass a "
                         "16-byte-aligned table")
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
    if has_instances:
        for name in ("inst", "hit_inst", "sp_enter"):
            cuda_build.check_tensor(getattr(s, name), name, torch.int32, (b,), dev)
        for name in ("local_o", "local_d", "local_inv"):
            cuda_build.check_tensor(getattr(s, name), name, torch.float32, (3, b), dev)


def arrival_step16_cuda(nodes: torch.Tensor, oT: torch.Tensor, dT: torch.Tensor,
                        invT: torch.Tensor, s: Wide16State,
                        active: torch.Tensor | None = None,
                        has_instances: bool = False) -> Wide16State:
    """One arrival for every lane, out of place; ``oT``/``dT``/``invT`` are
    (3, B).  ``has_instances`` must be set exactly for two-level tables.
    The inputs are checked against the kernel's contract on either device.
    On CUDA tensors: a copy of the fields the arrival updates (each
    contiguous, with a storage of its own; the others pass through), then
    one launch of the multi-arrival kernel on it with ``steps=1`` and
    ``live=active``."""
    _check(nodes, oT, dT, invT, s, active, has_instances)
    if nodes.device.type == "cpu":
        return arrival_step16(nodes, oT.T, dT.T, invT.T, s, active, has_instances)

    fields = _FLAT_FIELDS + (_INST_FIELDS if has_instances else ())
    out = s._replace(**{f: getattr(s, f).clone() for f in fields})
    launch_steps(cuda_build.load()["arrival16"], nodes, oT, dT, invT, out, 1, active, None,
                 has_instances)
    arrival_step16_cuda.launches[KERNELS[(nodes.shape[1], has_instances)]] += 1
    return out


def arrival_steps16_cuda(nodes: torch.Tensor, oT: torch.Tensor, dT: torch.Tensor,
                         invT: torch.Tensor, s: Wide16State, steps: int,
                         live: torch.Tensor | None = None,
                         stop_on_found: torch.Tensor | None = None,
                         has_instances: bool = False) -> Wide16State:
    """``steps`` arrivals, updating ``s``'s tensors in place; returns ``s``.
    Arrival k runs on the lanes with ``ptr >= 0``, ``live`` and not
    (``stop_on_found`` and ``found``), ``found`` as it stands before it:
    ``stop_on_found`` stops a shadow lane at its first hit (None: no
    lane; ``live`` None: every lane).  Each field ``steps`` updates must
    be contiguous with a storage of its own (``has_instances`` adds the
    instance registers).  On CUDA tensors one kernel launch, on CPU
    tensors the plain version."""
    _check(nodes, oT, dT, invT, s, live, has_instances)
    if stop_on_found is not None:
        cuda_build.check_tensor(stop_on_found, "stop_on_found", torch.bool, s.ptr.shape,
                                nodes.device)
    if steps < 1:
        raise ValueError(f"steps: expected at least 1, got {steps}")
    fields = _FLAT_FIELDS + (_INST_FIELDS if has_instances else ())
    cuda_build.check_in_place(s, fields, dict(nodes=nodes, oT=oT, dT=dT, invT=invT, live=live,
                                              stop_on_found=stop_on_found))
    if nodes.device.type == "cpu":
        return arrival_steps16(nodes, oT.T, dT.T, invT.T, s, steps, live, stop_on_found,
                               has_instances)

    lib = cuda_build.load()["arrival16"]
    name = launch_steps(lib, nodes, oT, dT, invT, s, steps, live, stop_on_found, has_instances)
    arrival_steps16_cuda.launches[name] += 1
    return s


def launch_steps(lib: ctypes.CDLL, nodes, oT, dT, invT, s: Wide16State, steps: int, live,
                 stop_on_found, has_instances: bool) -> str:
    """Launch the multi-arrival entry of ``lib`` (a build of
    ``csrc/arrival16.cu``) on CUDA tensors that ``arrival_steps16_cuda``
    has checked; returns the kernel's name.  Counts nothing."""
    name = RUN_KERNELS[(nodes.shape[1], has_instances)]
    args = _run_args(nodes, oT, dT, invT, s, steps, live, stop_on_found)
    stream = torch.cuda.current_stream(nodes.device).cuda_stream
    launch = getattr(lib, name + "_launch")
    if has_instances:
        planes = [getattr(s, n).data_ptr() for n in _INST_FIELDS]
        err = launch(ctypes.byref(args), ctypes.byref(_InstArgs(*planes, *planes)), stream)
    else:
        err = launch(ctypes.byref(args), stream)
    cuda_build.check(lib, err, name)
    return name


def _run_args(nodes, oT, dT, invT, s: Wide16State, steps: int, live, stop_on_found) -> _RunArgs:
    return _RunArgs(nodes.data_ptr(), oT.data_ptr(), dT.data_ptr(), invT.data_ptr(),
                    0 if live is None else live.data_ptr(),
                    0 if stop_on_found is None else stop_on_found.data_ptr(),
                    *(getattr(s, n).data_ptr() for n in _FLAT_FIELDS),
                    s.ptr.shape[0], s.stack_row.shape[0], steps)


def arrival_probe_cuda(nodes: torch.Tensor, rows: torch.Tensor, oT: torch.Tensor,
                       dT: torch.Tensor, invT: torch.Tensor, s: Wide16State,
                       active: torch.Tensor | None = None, mode: str = "full") -> Wide16State:
    """One arrival of probe ``mode`` on flat (N, 96) rows, lane i on row
    ``rows[i]`` (int32 (B,)): updates ``s``'s flat fields in place and
    returns ``s``, with the contract of ``arrival_steps16_cuda`` (each
    field contiguous, with a storage of its own, shared with no input)."""
    if mode not in PROBE_KERNELS or nodes.dim() != 2 or nodes.shape[1] != 96:
        raise ValueError(f"probe mode {mode!r} on {tuple(nodes.shape)}: expected one of "
                         f"{tuple(PROBE_KERNELS)} on (N, 96) rows")
    _check(nodes, oT, dT, invT, s, active, False)
    cuda_build.check_tensor(rows, "rows", torch.int32, s.ptr.shape, nodes.device)
    cuda_build.check_in_place(s, _FLAT_FIELDS, dict(nodes=nodes, rows=rows, oT=oT, dT=dT,
                                                    invT=invT, active=active))
    if nodes.device.type == "cpu":
        out = arrival_probe_plain(nodes, rows, oT, dT, invT, s, active, mode)
        for f in _FLAT_FIELDS:
            getattr(s, f).copy_(getattr(out, f))
        return s
    launch_probe(cuda_build.load()["arrival16"], nodes, rows, oT, dT, invT, s, active, mode)
    arrival_probe_cuda.launches[PROBE_KERNELS[mode]] += 1
    return s


def launch_probe(lib: ctypes.CDLL, nodes, rows, oT, dT, invT, s: Wide16State, active,
                 mode: str) -> None:
    """Launch probe ``mode`` from ``lib`` (a build of ``csrc/arrival16.cu``):
    the diet's entry for its modes, ``arrival16_run_probe_launch`` for the
    leaf decodes, on CUDA tensors that ``arrival_probe_cuda`` has checked,
    updating ``s`` in place.  Counts nothing."""
    args = _run_args(nodes, oT, dT, invT, s, 1, active, None)
    entry = lib.arrival16_diet_launch if mode in DIET_MODES else lib.arrival16_run_probe_launch
    err = entry(PROBE_NUMBERS[mode], ctypes.byref(args), rows.data_ptr(),
                torch.cuda.current_stream(nodes.device).cuda_stream)
    cuda_build.check(lib, err, PROBE_KERNELS[mode])


def arrival_probe_plain(nodes: torch.Tensor, rows: torch.Tensor, oT: torch.Tensor,
                        dT: torch.Tensor, invT: torch.Tensor, s: Wide16State,
                        active: torch.Tensor | None = None, mode: str = "full") -> Wide16State:
    """The plain version of ``arrival_probe_cuda``."""
    if mode in DIET_MODES:
        from unity_webgpu_pathtracer_torch.experiments.round14_kernel_diet import diet_step16

        return diet_step16(nodes, rows, oT.T, dT.T, invT.T, s, active, mode)
    return arrival_step16(nodes, oT.T, dT.T, invT.T, s, active, rows=rows,
                          bf16_leaf=mode == "bf16leaf")


# Launch count of each kernel entry.
arrival_step16_cuda.launches = dict.fromkeys(KERNELS.values(), 0)
arrival_steps16_cuda.launches = dict.fromkeys(RUN_KERNELS.values(), 0)
arrival_probe_cuda.launches = dict.fromkeys(PROBE_KERNELS.values(), 0)
