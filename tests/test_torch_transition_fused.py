"""K2's entry ``transition16_cuda`` on CPU tensors (its plain version,
``transition16_plain``: the env sample, the attribute and material fetch
and the per-lane step, updating the lane state in place) against the
reference.

The lane state before each of transitions 2, 5 and 9 of a 40x24, 4-spp
reference pass (the 2,000-triangle bench scene, pool 1024, HDRI; the
reference's ``fused_pass_with_stats`` with its Pallas kernels, run
eagerly) is copied to the host by a callback traced next to the
reference's ``_transition_pallas``, with the kernel inputs its own env
sample and gathers make.  The port's entry runs on that state; the
reference's ``transition_step16_pallas`` (interpret mode) on those
inputs, with Russian roulette on and off.  Attribute rows: f16
(``attr_compact=2``, ``attr_in_kernel`` off and on) and oct
(``attr_compact=3``).  Contract (``tests/test_torch_transition.py``'s):
integer fields equal; float fields all within rtol 1e-3 / atol 1e-5 and
>= 99.5% within rtol 1e-5 / atol 1e-6.  ``rad_out`` is compared where a
lane died (the only columns the record append keeps).

Also: lanes between segments change only their RNG state (7 PCG steps,
6 without RR); the entry refuses a non-contiguous field, a field sharing
storage, a misaligned table and a wrong dtype; ``transition_work`` (K2's
bound) against a lane-by-lane count; ``attr_in_kernel`` gives the same
film.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.experiments import _common
from unity_webgpu_pathtracer_torch.ops import cuda_transition as tct
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.scene import envmap as tenv
from unity_webgpu_pathtracer_torch.scene.scene import scene_from_numpy
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.models.benchmark import million_triangle_scene
from unity_webgpu_pathtracer_tpu.ops import pallas_transition as jpt
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params

torch.set_num_threads(2)

W, H = 40, 24
CAPTURE_AT = (2, 5, 9)
STATIC = ("use_rr", "max_bounces", "firefly", "nan_canary", "interpret", "tile3d")
ROWS = {"f16": dict(attr_compact=2), "f16_attr_in_kernel": dict(attr_compact=2,
                                                                   attr_in_kernel=True),
        "oct": dict(attr_compact=3)}
SLICE = dict(width=W, height=H, samples_per_pass=4, max_bounces=5, pool_size=1024,
             transition_every=4)
# TransitionState field -> the reference's kernel output.
OUT = dict(mode="mode", ptr="ptr", pend="pend", sp="sp", t="t", u="u", v="v", tri="tri",
           found="found", trav_o="trav_oT", trav_d="trav_dT", path_o="path_oT",
           path_d="path_dT", hit_t="hit_t", hit_bary="hit_baryT", hit_tri="hit_tri",
           pending="pendingT", throughput="throughputT", radiance="radianceT", rng="rng",
           depth="depth", max_rough="max_rough", prev_pdf="prev_pdf", lane_cap="lane_cap")


@pytest.fixture(scope="module")
def bench():
    """The reference's scene tables and camera, and the port's copies."""
    scene, cam = million_triangle_scene(2000)
    sd = scene.build("wide16")
    params = make_camera_params(width=W, height=H, **cam)
    arrays = {f: np.asarray(getattr(sd, f)) for f in
              ("wide16_nodes", "wide16_top", "stack_levels", "attr_shade_c", "attr_shade_o",
               "materials")}
    arrays["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    tparams = tconfig.params_from_numpy(
        {f: np.asarray(getattr(params, f)) for f in
         ("cam_to_world", "cam_inv_proj", "environment_intensity", "environment_rotation",
          "max_firefly_luminance", "seed_root")}, device="cpu")
    return sd, params, scene_from_numpy(arrays, device="cpu"), tparams


def _capture(bench, rows: dict) -> list:
    """(pre-transition state, kernel inputs) at transitions CAPTURE_AT."""
    sd, params, _tsd, _tparams = bench
    cfg = jconfig.RenderConfig(traversal="wide16", sky_mode=jconfig.SKY_MODE_ENVIRONMENT,
                               has_environment_texture=True, integrator="fused",
                               use_pallas_arrival=True, use_pallas_transition=True,
                               **SLICE, **rows)
    states, kws, n = [], [], {"s": 0, "k": 0}
    orig_t, orig_k = jfused._transition_pallas, jpt.transition_step16_pallas

    def transition(scene, config, prm, s, budget, current_sample, trav_done, *a, **kw):
        names = ("mode", "ptr", "pend", "sp", "t", "u", "v", "tri", "found", "trav_o",
                 "trav_d", "path_o", "path_d", "hit_t", "hit_uv_bary", "hit_tri", "pending",
                 "throughput", "radiance", "rng", "depth", "max_roughness", "prev_pdf",
                 "lane_cap", "trav_done")
        vals = [getattr(s.trav, f) if f in ("ptr", "pend", "sp", "t", "u", "v", "tri",
                                             "found") else getattr(s, f, None)
                for f in names[:-1]] + [trav_done]

        def save(*v):
            n["s"] += 1
            if n["s"] in CAPTURE_AT:
                states.append(dict(zip(names, (np.array(x) for x in v))))

        jax.debug.callback(save, *vals, ordered=True)
        return orig_t(scene, config, prm, s, budget, current_sample, trav_done, *a, **kw)

    def kernel(**kw):
        names = [k for k in kw if k not in STATIC and kw[k] is not None]
        statics = {k: kw[k] for k in STATIC}

        def save(*v):
            n["k"] += 1
            if n["k"] in CAPTURE_AT:
                kws.append({**dict(zip(names, (np.array(x) for x in v))), **statics})

        jax.debug.callback(save, *(kw[k] for k in names), ordered=True)
        return orig_k(**kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(jfused, "_transition_pallas", transition)
    mp.setattr(jpt, "transition_step16_pallas", kernel)
    try:
        film, *_ = jfused.fused_pass_with_stats(sd, cfg, params, 0)
        np.asarray(film)
        jax.effects_barrier()
    finally:
        mp.undo()
    assert len(states) == len(kws) == len(CAPTURE_AT), n
    return list(zip(states, kws))


@pytest.fixture(scope="module", params=list(ROWS))
def captured(request, bench):
    return request.param, _capture(bench, ROWS[request.param])


def _state(c: dict) -> tct.TransitionState:
    """The captured reference state as the port's TransitionState."""
    def t(a, plane=False):
        a = np.array(a.T if plane else a, order="C")   # a copy: the entry works in place
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)

    planes = ("trav_o", "trav_d", "path_o", "path_d", "hit_uv_bary", "pending", "throughput",
              "radiance")
    kw = {f: t(c[f], f in planes) for f in c if f != "trav_done"}
    kw["hit_bary"] = kw.pop("hit_uv_bary")
    kw["max_rough"] = kw.pop("max_roughness")
    return tct.TransitionState(**kw, rays=torch.zeros((), dtype=torch.int64))


def _clone(st):
    return st._replace(**{f: getattr(st, f).clone() for f in st._fields})


def _config(rows: dict, **kw):
    return tconfig.RenderConfig(**SLICE, **ROWS[rows], **kw)


def _close(got: np.ndarray, want: np.ndarray, name: str) -> None:
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5, err_msg=name)
        close = np.isclose(got, want, rtol=1e-5, atol=1e-6).mean()
        assert close >= 0.995, (name, close)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("use_rr", [True, False])
@pytest.mark.parametrize("which", range(len(CAPTURE_AT)))
def test_entry_matches_reference(bench, captured, which, use_rr):
    _sd, _params, tsd, tparams = bench
    rows, caps = captured
    state, kw = caps[which]
    assert np.array_equal(state["trav_done"], state["ptr"] < 0)
    static = {k: kw[k] for k in ("max_bounces", "firefly", "nan_canary")}
    want = jpt.transition_step16_pallas(
        **{k: jax.numpy.asarray(v) for k, v in kw.items() if k not in STATIC},
        use_rr=use_rr, **static, interpret=True)
    st = _state(state)
    died, rad_out = tct.transition16_cuda(tsd, _config(rows, use_russian_roulette=use_rr),
                                          tparams, st)
    for name, ref in OUT.items():
        g = getattr(st, name).numpy()
        _close(g.astype(np.uint32) if name == "rng" else g, np.asarray(getattr(want, ref)),
               name)
    w_died = np.asarray(want.died)
    np.testing.assert_array_equal(died.numpy(), w_died)
    assert w_died.any() or which == 0
    _close(rad_out.numpy()[:, w_died], np.asarray(want.rad_outT)[:, w_died], "rad_out")
    assert int(st.rays) == int(np.asarray(want.nray).sum()) > 0


@pytest.mark.parametrize("use_rr", [True, False])
def test_idle_lanes_change_only_their_rng(bench, captured, use_rr):
    """Lanes neither at a finished primary segment nor at a finished shadow
    segment: every field as it was, the RNG advanced by every draw."""
    _sd, _params, tsd, tparams = bench
    rows, caps = captured
    st = _state(caps[1][0])
    before = _clone(st)
    done = st.ptr < 0
    busy = (((st.mode == tct.MODE_PRIMARY) & done)
            | ((st.mode == tct.MODE_SHADOW_ENV) & (done | st.found)))
    idle = ~busy
    assert idle.sum() > 100 and busy.sum() > 100
    died, _rad = tct.transition16_cuda(tsd, _config(rows, use_russian_roulette=use_rr), tparams,
                                       st)
    for f in st._fields:
        if f in ("rng", "rays"):
            continue
        x, y = getattr(st, f), getattr(before, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x[..., idle], y[..., idle]), f
    want = before.rng
    for _ in range(7 if use_rr else 6):
        want = urng.next_state(want)
    assert torch.equal(st.rng[idle], want[idle])
    assert not died[idle].any()


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to an address 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)
    off = (-flat.data_ptr() // t.element_size()) % (16 // t.element_size()) + 1
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("fault", ["non_contiguous", "shared_storage", "misaligned_table",
                                   "wrong_dtype", "wrong_env_rows"])
def test_entry_refuses_bad_inputs(bench, captured, fault):
    _sd, _params, tsd, tparams = bench
    rows, caps = captured
    st = _state(caps[0][0])
    scene = tsd
    if fault == "non_contiguous":
        st = st._replace(trav_o=st.trav_o.T.contiguous().T)
        match = "non-contiguous"
    elif fault == "shared_storage":
        st = st._replace(v=st.u)
        match = "shares its storage"
    elif fault == "misaligned_table":
        scene = tsd._replace(materials=_misaligned(tsd.materials))
        match = "16-byte"
    elif fault == "wrong_dtype":
        st = st._replace(t=st.t.double())
        match = "expected contiguous"
    else:
        scene = tsd._replace(env=tsd.env._replace(merged_rows=tsd.env.merged_rows[:-1]))
        match = "merged rows"
    before = _clone(st)
    with pytest.raises(ValueError, match=match):
        tct.transition16_cuda(scene, _config(rows), tparams, st)
    assert all(torch.equal(getattr(st, f), getattr(before, f)) for f in st._fields)


def test_transition_work(bench, captured):
    """``experiments/_common.transition_work`` against a count made lane by
    lane: the lanes of each case, the distinct attribute, material, alias
    and footprint rows, the bytes read and written, the operations."""
    _sd, _params, tsd, tparams = bench
    rows, caps = captured
    cfg = _config(rows)
    st0 = _state(caps[2][0])
    after = _clone(st0)
    died, _rad = tct.transition16_plain(tsd, cfg, tparams, after)
    nbytes, ops, counts = _common.transition_work(_common.K2Launch(tsd, cfg, tparams, st0),
                                                  after, died)

    s = {f: getattr(st0, f).numpy() for f in st0._fields}
    e = {f: getattr(after, f).numpy() for f in after._fields}
    env = tsd.env
    h, w = env.image.shape[0], env.image.shape[1]
    table = (tsd.attr_shade_o if cfg.attr_compact == 3 else tsd.attr_shade_c).numpy()
    row_bytes = 16 if cfg.attr_compact == 3 else 32
    n = dict(idle=0, miss=0, hit=0, shadow=0)
    attr_rows, mat_rows, alias, foot = set(), set(), set(), set()
    reads = writes = want_ops = 0
    k2 = _common.K2_OPS
    for i in range(s["mode"].shape[0]):
        done = s["ptr"][i] < 0
        reads, writes = reads + 17, writes + 9
        if s["mode"][i] == tct.MODE_PRIMARY and done:
            case = "hit" if s["tri"][i] >= 0 else "miss"
        elif s["mode"][i] == tct.MODE_SHADOW_ENV and (done or s["found"][i]):
            case = "shadow"
        else:
            n["idle"] += 1
            continue
        n[case] += 1
        reads += 52 + {"miss": 4, "hit": 28, "shadow": 40}[case]
        want_ops += k2["lane"]
        if case == "miss":
            want_ops += k2["miss"]
            d = torch.from_numpy(s["path_d"][:, i:i + 1])
            theta = torch.acos(torch.clamp(d[1], -1.0, 1.0))
            uv = torch.stack([(tenv.PI + torch.atan2(d[2], d[0])) * tenv.INV_TWO_PI
                              + tparams.environment_rotation, 1.0 - theta * tenv.INV_PI], -1)
            x0i, y0i, _fx, _fy = tenv._bilerp_coords(h, w, uv)
            foot.add(int(y0i[0]) * w + int(x0i[0]))
            continue
        tri = s["tri"][i] if case == "hit" else s["hit_tri"][i]
        attr_rows.add(max(int(tri), 0))
        word = table[max(int(tri), 0), 3 if cfg.attr_compact == 3 else 7]
        mat_rows.add(int(word) if cfg.attr_compact == 3 else (int(word) >> 16) & 0xFFFF)
        want_ops += k2["normal"][cfg.attr_compact] + k2["material"] + k2["eval"]
        if case == "hit":
            want_ops += k2["hit"]
            u1 = urng.random_float(torch.tensor([int(s["rng"][i])]))[0]
            alias.add(min(max(int((u1 * (h * w)).to(torch.int32)), 0), h * w - 1))
        else:
            want_ops += k2["sample"] + k2["rr"]
    for f in st0._fields:
        if f in ("rng", "rays"):
            continue
        x, y = s[f], e[f]
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        for i in range(x.shape[-1]):
            writes += int((x[..., i] != y[..., i]).sum()) * x.itemsize
    reads += (row_bytes * len(attr_rows) + 88 * len(mat_rows) + 32 * len(alias)
              + 48 * len(foot) + 16)
    writes += 12 * int(died.sum()) + 8
    assert counts == dict(**n, attr_rows=len(attr_rows), material_rows=len(mat_rows),
                          alias_rows=len(alias), footprint_rows=len(foot))
    assert min(n.values()) > 0 and ops == want_ops and nbytes == reads + writes


def test_attr_in_kernel_gives_the_same_film(bench):
    """On the port ``attr_in_kernel`` selects the same kernel (its plain
    version on the CPU): the same film, rays and arrivals, bit for bit."""
    _sd, _params, tsd, tparams = bench
    out = [tfused.fused_pass_with_stats(tsd, _config("f16", attr_in_kernel=k), tparams, 0)
           for k in (False, True)]
    (fa, _oa, ra, aa, ia), (fb, _ob, rb, ab, ib) = out
    assert torch.equal(fa.view(torch.int32), fb.view(torch.int32))
    assert (int(ra), int(aa), ia) == (int(rb), int(ab), ib)


def test_kernel_route_runs_no_glue(bench, monkeypatch):
    """The kernel route calls ``transition16_cuda`` once per
    super-iteration and nothing of the old glue: the env sample and the
    attribute rows are the entry's own."""
    _sd, _params, tsd, tparams = bench
    calls = []
    entry = tfused.transition16_cuda

    def counted(*a, **k):
        calls.append(1)
        return entry(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the kernel route ran the general transition's glue")

    monkeypatch.setattr(tfused, "transition16_cuda", counted)
    monkeypatch.setattr(tfused, "sample_env_transition", refuse)
    monkeypatch.setattr(tfused, "shade_rows", refuse)
    monkeypatch.setattr(tfused, "attr_index", refuse)
    cfg = dataclasses.replace(_config("f16"), samples_per_pass=1)
    film, _occ, _rays, _arr, iters = tfused.fused_pass_with_stats(tsd, cfg, tparams, 0)
    assert len(calls) == iters > 0 and float(film.mean()) > 0
