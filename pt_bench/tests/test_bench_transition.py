"""The frozen plain transition (``pt_bench/reference/transition.py``)
against the port's ``transition16_plain`` on seeded lane states over the
port's own tables: every field, ``died`` and ``rad_out`` equal to the bit;
and the reference's attribute rows against the port's for the same
triangles."""

import numpy as np
import pytest
import torch

from unity_webgpu_pathtracer_torch.config import RenderConfig
from unity_webgpu_pathtracer_torch.ops import cuda_transition as ct
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

from pt_bench import port, scenes
from pt_bench.reference import replay
from pt_bench.reference import scene as rscene
from pt_bench.reference import transition as rt
from pt_bench.tests.tiny import SEED, cell, cells, fused, overrides

NAME = [n for n in cells() if fused(n)][0]


@pytest.fixture(scope="module")
def world():
    ov = overrides(NAME)
    cfg = {**cell(NAME).config, **ov["config"]}
    spec = scenes.generate(cfg)
    sd = port.port_scene(spec).build("wide16", device=torch.device("cpu"))
    params = make_camera_params(width=48, height=27, seed_root=12345,
                                device=torch.device("cpu"), **spec.camera)
    return spec, cfg, sd, params


def _state(sd, b: int, seed: int) -> dict:
    """Lane states of every case K2 meets: primary segments ended on a hit
    or a miss, shadow segments ended free or occluded, lanes between
    segments, dead lanes; depths past the bounce budget, lane caps run out."""
    g = torch.Generator().manual_seed(seed)
    ntri = sd.attr_normals.shape[0]

    def f(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    def i(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    def unit(*shape):
        d = torch.randn((3,) + shape, generator=g)
        return d / d.norm(dim=0, keepdim=True)

    u = f(b, hi=0.5)
    return dict(
        mode=torch.tensor([0, 1, 3], dtype=torch.int32)[i(0, 3, b).long()],
        ptr=torch.where(f(b) < 0.7, torch.full((b,), -1, dtype=torch.int32), i(0, 50, b)),
        pend=i(0, 0x10000, b), sp=i(0, 4, b), t=f(b, lo=0.1, hi=20.0), u=u,
        v=f(b) * (1.0 - u), tri=torch.where(f(b) < 0.8, i(0, ntri, b),
                                            torch.full((b,), -1, dtype=torch.int32)),
        found=f(b) < 0.3, trav_o=f(3, b, lo=-3.0, hi=3.0), trav_d=unit(b),
        path_o=f(3, b, lo=-3.0, hi=3.0), path_d=unit(b), hit_t=f(b, lo=0.1, hi=20.0),
        hit_bary=torch.stack([u, f(b) * (1.0 - u)]), hit_tri=i(0, ntri, b),
        pending=f(3, b), throughput=f(3, b, hi=2.0), radiance=f(3, b),
        rng=torch.randint(0, 2**32, (b,), generator=g, dtype=torch.int64),
        depth=i(0, 7, b), max_rough=f(b), prev_pdf=f(b, hi=4.0), lane_cap=i(-1, 40, b),
        rays=torch.zeros((), dtype=torch.int64))


@pytest.mark.parametrize("attr_compact", [0, 2, 3])
@pytest.mark.parametrize("flags", [dict(), dict(use_firefly_filter=True, debug_nan_canary=True,
                                                use_russian_roulette=False)])
def test_frozen_transition_equals_the_ports(world, attr_compact, flags):
    _spec, cfg, sd, params = world
    config = RenderConfig(width=48, height=27, integrator="fused",
                          **{**cfg["render"], **flags, "attr_compact": attr_compact})
    for seed in (SEED, SEED + 1):
        base = _state(sd, 4096, seed)
        mine = rt.TransitionState(**{k: v.clone() for k, v in base.items()})
        theirs = ct.TransitionState(**{k: v.clone() for k, v in base.items()})
        died_m, rad_m = rt.transition16_plain(sd, config, params, mine)
        died_t, rad_t = ct.transition16_plain(sd, config, params, theirs)
        for k in rt.TransitionState._fields:
            a, b = getattr(mine, k), getattr(theirs, k)
            assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b), k
        assert torch.equal(died_m, died_t)
        assert torch.equal(rad_m.view(torch.int32), rad_t.view(torch.int32))
        # The states moved: lanes were processed, and every lane's PCG stepped.
        assert not torch.equal(mine.rng, base["rng"])
        assert not torch.equal(mine.radiance, base["radiance"])


def test_reference_rows_are_the_ports_rows(world):
    """Each triangle's f16 attribute row packed by the reference from its
    own triangles equals the port's row of the triangle with the same
    corners (the port keeps its rows in its BVH's order)."""
    spec, _cfg, sd, _params = world
    rs = rscene.build(spec, torch.device("cpu"))
    tabs = replay.tables(rs)
    ntri = rs.v0.shape[0]
    ref_key = {tuple(np.round(x, 5)): k for k, x in
               enumerate(torch.cat([rs.v0, rs.v0 + rs.e1, rs.v0 + rs.e2], 1).numpy())}
    tris = sd.tris.numpy()                                   # [e2, e1, v0] records
    e2, e1, v0 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    hits = 0
    for row in range(ntri):
        key = tuple(np.round(np.concatenate([v0[row], v0[row] + e1[row], v0[row] + e2[row]]), 5))
        k = ref_key.get(key)
        if k is None:
            continue
        hits += 1
        r = sd.tri_index[row]
        assert torch.equal(tabs.attr_shade_c[k], sd.attr_shade_c[r])
    assert hits >= 0.99 * ntri
