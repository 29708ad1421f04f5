"""The multi-arrival wrapper ``arrival_steps16_cuda`` on CPU tensors (where
it runs its plain version ``traverse_wide16.arrival_steps16``): against
``steps`` calls of the reference's Pallas arrival in interpret mode, with
``active`` recomputed before each arrival as the reference's fused loop
does (``render/fused.py:1373-1379``); against ``steps`` calls of the
port's one-arrival wrapper; its update in place and what it refuses;
the fused pass through it against the pass through the one-arrival loop
it replaced; and ``experiments/_common.arrivals_work``, the bound of the
multi-arrival kernels.

Tables: the 3,000-triangle soup of ``tests/test_torch_arrival.py`` as
96-float and leaf8 rows, and the two-instance tables of
``tests/test_torch_tlas.py`` and ``tests/test_torch_leaf8.py``.  Half of
the lanes stop at their first hit (``stop_on_found``), so shadow lanes
stop inside a launch; a tenth are not live.

Tolerances (``tests/test_torch_arrival.py``'s): after one arrival every
integer field and ``t`` are equal; after 8, ``t`` agrees within rtol/atol
1e-5 and the integer fields on >= 99.5% of lanes (XLA contracts FMAs where
PyTorch does not, shifting Möller-Trumbore t by an ulp, which can flip
near-tie winners).  Against the port's own one-arrival wrapper and the
one-arrival pass: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from tests.test_torch_arrival import _rays, _recs, _torch_state, _tris
from tests.test_torch_leaf8 import _instanced_rays, _two_instances
from tests.test_torch_tlas import _two_instance_fixture
from unity_webgpu_pathtracer_torch.config import RenderConfig
from unity_webgpu_pathtracer_torch.experiments import _common
from unity_webgpu_pathtracer_torch.experiments._common import one_step_loop
from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
from unity_webgpu_pathtracer_torch.models.examples import tlas_scene
from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as ttw
from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_steps16_cuda
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
from unity_webgpu_pathtracer_torch.utils.math import safe_rcp
from unity_webgpu_pathtracer_tpu.accel import wide16 as jw16
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as jtw
from unity_webgpu_pathtracer_tpu.ops.pallas_arrival import arrival_step16_pallas
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE

torch.set_num_threads(2)

_pallas_step = jax.jit(arrival_step16_pallas, static_argnames=("interpret", "has_instances"))

B = 2048
KINDS = ("flat", "leaf8", "instanced", "instanced_leaf8")
INT_FIELDS = ("ptr", "pend", "sp", "tri", "found")
INST_INT_FIELDS = ("inst", "hit_inst", "sp_enter")


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def tables():
    """kind -> (nodes, stack depth, has_instances, o, d), built by the
    reference (the port's tables are byte-identical)."""
    tris = _tris(3000, seed=21)
    o, d = _rays(B, tris, seed=22)
    oi, di = _instanced_rays(B, seed=31)
    two = _two_instance_fixture(jw16)[0]
    two8 = _two_instances(jw16)[0]
    return {
        "flat": (jw16.build_scene_wide16(tris, _recs(tris)).nodes, 12, False, o, d),
        "leaf8": (jw16.build_scene_wide16(tris, _recs(tris), leaf8=True).nodes, 12, False, o, d),
        "instanced": (two.nodes, two.depth + 2, True, oi, di),
        "instanced_leaf8": (two8.nodes, two8.depth + 2, True, oi, di),
    }


def _masks():
    rng = np.random.default_rng(7)
    return rng.random(B) < 0.9, rng.random(B) < 0.5     # live, stop_on_found


def _inputs(table):
    nodes, depth, has_inst, o, d = table
    to, td = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    return torch.from_numpy(nodes), to, td, safe_rcp(td), depth, has_inst


def _clone(s):
    return s._replace(**{f: getattr(s, f).clone() for f in s._fields})


def _assert_bit_equal(got, want, what):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{what}.{f}"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("steps", [1, 8])
def test_steps_match_pallas(tables, kind, steps):
    nodes, depth, has_inst, o, d = tables[kind]
    live, stop = _masks()
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jinv = 1.0 / jnp.where(jd == 0.0, 1e-30, jd)
    js = jtw.init_state16(B, jnp.float32(FAR_PLANE), depth=depth)
    ts = _torch_state(js)
    jn, jlive, jstop = jnp.asarray(nodes), jnp.asarray(live), jnp.asarray(stop)
    for _ in range(steps):
        js = _pallas_step(jn, jo.T, jd.T, jinv.T, js, jlive & ~(jstop & js.found),
                          interpret=True, has_instances=has_inst)
    tn, to, td, tinv, _depth, _ = _inputs(tables[kind])
    out = arrival_steps16_cuda(tn, to, td, tinv, ts, steps, torch.from_numpy(live),
                               torch.from_numpy(stop), has_inst)
    assert out is ts
    names = INT_FIELDS + (INST_INT_FIELDS if has_inst else ())
    if steps == 1:
        for name in names + ("stack_row", "stack_mask"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=name)
        np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))
        return
    # Shadow lanes stopped inside the launch: found, stop set, not ended.
    assert bool((torch.from_numpy(stop) & ts.found & (ts.ptr >= 0)).any())
    np.testing.assert_allclose(ts.t.numpy(), np.asarray(js.t), rtol=1e-5, atol=1e-5)
    for name in names:
        frac = (getattr(ts, name).numpy() == np.asarray(getattr(js, name))).mean()
        assert frac >= 0.995, (name, frac)


@pytest.mark.parametrize("kind", KINDS)
def test_steps_equal_one_step_wrapper(tables, kind):
    """Two launches of 8 arrivals against 16 calls of the one-arrival
    wrapper, bit for bit, every field."""
    tn, to, td, tinv, depth, has_inst = _inputs(tables[kind])
    live, stop = (torch.from_numpy(m) for m in _masks())
    s = ttw.init_state16(B, FAR_PLANE, depth=depth, device="cpu")
    ref = _clone(s)
    for _ in range(2):
        arrival_steps16_cuda(tn, to, td, tinv, s, 8, live, stop, has_inst)
        ref = one_step_loop(tn, to, td, tinv, ref, 8, live, stop, has_inst)
        _assert_bit_equal(s, ref, kind)
    assert bool(s.found.any()) and bool((s.sp > 0).any())


@pytest.mark.parametrize("kind", ["flat", "instanced"])
@pytest.mark.parametrize("masks", ["none", "stop_only"])
def test_steps_equal_one_step_loop_without_live(tables, kind, masks):
    """``live`` None (every lane) with and without ``stop_on_found``, as
    ``closest_hit`` and ``occluded`` call the wrapper: the wrapper and
    ``_common.one_step_loop`` bit for bit."""
    tn, to, td, tinv, depth, has_inst = _inputs(tables[kind])
    stop = None if masks == "none" else torch.from_numpy(_masks()[1])
    s = ttw.init_state16(B, FAR_PLANE, depth=depth, device="cpu")
    ref = one_step_loop(tn, to, td, tinv, _clone(s), 8, None, stop, has_inst)
    arrival_steps16_cuda(tn, to, td, tinv, s, 8, None, stop, has_inst)
    _assert_bit_equal(s, ref, f"{kind} {masks}")
    assert bool(s.found.any())


@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_update_in_place(tables, kind):
    """The same tensors come back; lanes that do not step are untouched;
    of the stack planes only the levels pushed at change."""
    tn, to, td, tinv, depth, has_inst = _inputs(tables[kind])
    live, stop = (torch.from_numpy(m) for m in _masks())
    s = one_step_loop(tn, to, td, tinv, ttw.init_state16(B, FAR_PLANE, depth=depth,
                                                         device="cpu"),
                      3, live, stop, has_inst)
    before = _clone(s)
    tensors = {f: getattr(s, f) for f in s._fields}
    # The levels each lane pushes, arrival by arrival (plain one-arrival steps).
    pushed = torch.zeros_like(s.stack_row, dtype=torch.bool)
    cur = before
    for _ in range(8):
        active = live & ~(stop & cur.found)
        nxt = ttw.arrival_step16(tn, to.T, td.T, tinv.T, cur, active, has_inst)
        lanes = torch.nonzero(nxt.sp > cur.sp)[:, 0]
        pushed[cur.sp[lanes].long(), lanes] = True
        cur = nxt
    steps_lanes = (before.ptr >= 0) & live & ~(stop & before.found)
    assert bool(steps_lanes.any()) and bool((~steps_lanes).any()) and bool(pushed.any())

    out = arrival_steps16_cuda(tn, to, td, tinv, s, 8, live, stop, has_inst)
    assert out is s and all(getattr(s, f) is tensors[f] for f in s._fields)
    idle = ~steps_lanes
    for f in s._fields:
        a, b = getattr(s, f), getattr(before, f)
        assert torch.equal(a[..., idle], b[..., idle]), f
    for f in ("stack_row", "stack_mask"):
        assert torch.equal(getattr(s, f)[~pushed], getattr(before, f)[~pushed]), f
    assert not torch.equal(s.stack_row, before.stack_row)


@pytest.mark.parametrize("case", ["non_contiguous", "expanded", "same_tensor",
                                  "shared_storage", "input_alias", "steps_zero"])
def test_wrapper_refuses(tables, case):
    tn, to, td, tinv, depth, _ = _inputs(tables["flat"])
    s = ttw.init_state16(B, FAR_PLANE, depth=depth, device="cpu")
    steps = 8
    if case == "non_contiguous":
        s = s._replace(stack_row=s.stack_row.T.contiguous().T)
    elif case == "expanded":
        s = s._replace(t=torch.tensor(FAR_PLANE).expand(B))
    elif case == "same_tensor":
        s = s._replace(v=s.u)
    elif case == "shared_storage":
        uv = torch.zeros((2, B))
        s = s._replace(u=uv[0], v=uv[1])
    elif case == "input_alias":
        s = s._replace(t=to[0])
    else:
        steps = 0
    before = _clone(s)
    with pytest.raises(ValueError):
        arrival_steps16_cuda(tn, to, td, tinv, s, steps)
    _assert_bit_equal(s, before, case)


@pytest.mark.parametrize("case", ["bench2k", "tlas"])
def test_fused_pass_same_as_one_step_loop(monkeypatch, case):
    """A whole pass through the multi-arrival wrapper gives the rays,
    arrivals, super-iterations and film of the pass through the
    one-arrival loop, bit for bit."""
    if case == "bench2k":
        scene, cam = million_triangle_scene(2000)
        cfg = RenderConfig(width=40, height=24, samples_per_pass=4, max_bounces=5,
                           pool_size=1024, transition_every=4)
    else:
        scene, cam, over = tlas_scene(n=4)
        cfg = RenderConfig(width=32, height=32, samples_per_pass=2, max_bounces=4,
                           pool_size=1024, transition_every=4, **over)
    sd = scene.build("wide16", device="cpu")
    params = make_camera_params(width=cfg.width, height=cfg.height, device="cpu", **cam)
    film, occ, rays, arrivals, iters = tfused.fused_pass_with_stats(sd, cfg, params, 0)
    monkeypatch.setattr(tfused, "arrival_steps16_cuda", one_step_loop)
    film1, occ1, rays1, arrivals1, iters1 = tfused.fused_pass_with_stats(sd, cfg, params, 0)
    assert (int(rays), int(arrivals), iters) == (int(rays1), int(arrivals1), iters1)
    assert int(rays) > 0 and iters > 1
    assert float(occ) == float(occ1)
    assert torch.equal(film.view(torch.int32), film1.view(torch.int32))


@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_arrivals_work(tables, kind):
    """``experiments/_common.arrivals_work``, the bound of the multi-arrival
    kernels: lanes that step, distinct rows over the arrivals, pushes and
    the pops that read memory (not those right after a push), counted
    here lane by lane from the one-arrival steps; its bytes and
    operations from those counts; the state is left as it was."""
    tn, to, td, tinv, depth, has_inst = _inputs(tables[kind])
    live, stop = (torch.from_numpy(m) for m in _masks())
    s = one_step_loop(tn, to, td, tinv, ttw.init_state16(B, FAR_PLANE, depth=depth,
                                                         device="cpu"),
                      3, live, stop, has_inst)
    before = _clone(s)
    nbytes, ops, distinct, n = _common.arrivals_work(tn, to, td, tinv, s, 8, live, stop,
                                                     has_inst)
    _assert_bit_equal(s, before, "state")

    meta_of = tn.view(torch.int32)[:, 3]
    rows, deltas, entered = set(), [], np.zeros(B, bool)
    want_ops, cur = 0, s
    for _ in range(8):
        act = (cur.ptr >= 0) & live & ~(stop & cur.found)
        meta = meta_of[cur.ptr[act].long()]
        rows |= set(cur.ptr[act].tolist())
        want_ops += int(576 * (meta == 0).sum() + 55 * meta[meta > 0].clamp(max=16).sum()
                        + (30 * (meta < 0).sum() if has_inst else 0))
        entered[act.numpy()] |= (meta < 0).numpy()
        nxt = ttw.arrival_step16(tn, to.T, td.T, tinv.T, cur, act, has_inst)
        deltas.append(((nxt.sp - cur.sp) * act).numpy())
        cur = nxt
    pushes = pops = 0
    for lane in range(B):
        after_push = False
        for d in (dd[lane] for dd in deltas):
            if d > 0:
                pushes, after_push = pushes + 1, True
            elif d < 0:
                pops += not after_push
                after_push = False
    lanes = int(((s.ptr >= 0) & live & ~(stop & s.found)).sum())
    assert n == dict(lanes=lanes, pushes=pushes, pops=pops) and pushes > 0 and pops > 0
    assert distinct == len(rows) and ops == want_ops
    want = 4 * B + 2 * B + lanes * (2 * 29 - 4 + 36) + distinct * 384 + 8 * (pushes + pops)
    if has_inst:
        in_blas = int(((s.ptr >= 0) & live & ~(stop & s.found) & (s.inst >= 0)).sum())
        want += lanes * 24 + 36 * (in_blas + int(entered.sum()))
    assert nbytes == want
