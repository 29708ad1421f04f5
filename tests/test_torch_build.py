"""What can be checked of the CUDA kernels without a GPU: the ctypes
argument structs match the C structs member for member, and every
constant the sources use is defined once, on the Python side."""

import ctypes
import os
import re

import pytest

from unity_webgpu_pathtracer_torch.ops import cuda_arrival, cuda_build, cuda_transition


def _c_struct(source: str, name: str) -> list[tuple[str, bool]]:
    """``(member, is_pointer)`` of ``struct name { ... };`` in a .cu file
    (one member per declaration, as the sources write them)."""
    with open(os.path.join(cuda_build.SRC_DIR, source)) as f:
        text = f.read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [(re.findall(r"\w+", d)[-1], "*" in d)
            for d in (d.strip() for d in body.split(";")) if d]


@pytest.mark.parametrize("source,cname,pystruct", [
    ("arrival16.cu", "RunArgs", cuda_arrival._RunArgs),
    ("arrival16.cu", "InstArgs", cuda_arrival._InstArgs),
    ("transition16.cu", "TransitionArgs", cuda_transition._TransitionArgs),
])
def test_ctypes_struct_matches_c(source, cname, pystruct):
    c = _c_struct(source, cname)
    py = [(n, t is ctypes.c_void_p) for n, t in pystruct._fields_]
    assert len(c) == len(py)
    for (cn, cptr), (pn, pptr) in zip(c, py):
        # C drops the "T" suffix of the Python plane names.
        assert cptr == pptr and pn.rstrip("T") == cn.rstrip("T"), (cn, pn)


def test_kernel_constants_come_from_python():
    defined = {d.split("=")[0][2:] for d in cuda_build._defines()}
    used = set()
    for name in cuda_build.SOURCES:
        with open(os.path.join(cuda_build.SRC_DIR, name)) as f:
            used |= set(re.findall(r"\bUWPT_\w+", f.read()))
    assert used and used <= defined, used - defined
    assert "-DUWPT_MODE_DEAD=%d" % cuda_transition.MODE_DEAD in cuda_build._defines()
