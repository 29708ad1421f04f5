"""The port's compact attribute rows against the reference: kernel K2's
raw-row form (``attr_in_kernel``: the kernel decodes the f16 normals
itself) and the oct-normal rows of ``attr_compact=3``.

- The f16 decode (``cuda_transition.f16_decode``, the kernel's integer
  decode) bit for bit against numpy's f16 -> f32 and the reference's
  ``_f16_decode`` over all 65,536 patterns.
- K2's per-lane body (``transition_step16_plain``) in the raw form
  against the reference's
  ``transition_step16_pallas(pairT=..., parity=..., interpret=True)`` on
  inputs captured from a real reference pass with ``attr_in_kernel``:
  integers exact, floats as in ``tests/test_torch_transition.py``
  (rtol 1e-5 / atol 1e-6 on >= 99.5% of elements, all within rtol 1e-3 /
  atol 1e-5).  The body's raw and ``shade_rowT`` forms agree bit for bit.
- ``_pack_attr_shade_o`` byte-identical; ``oct_decode`` within one ulp.
- Fused passes with ``attr_compact=3`` through K2 (the HDRI on the
  2,000-triangle bench scene) and through the general transition (the
  Cornell box, no sky) against the reference's fused pass: the
  ``tests/test_torch_fused.py`` contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.ops import cuda_transition as tct
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params as tcamera
from unity_webgpu_pathtracer_torch.scene import scene as tscene
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.models.benchmark import million_triangle_scene
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
from unity_webgpu_pathtracer_tpu.ops import pallas_transition as jpt
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params as jcamera
from unity_webgpu_pathtracer_tpu.scene import scene as jscene

torch.set_num_threads(2)

CAPTURE_AT = (3, 7)   # transitions of the pass whose inputs are kept
STATIC = ("use_rr", "max_bounces", "firefly", "nan_canary", "interpret", "tile3d")
FIELDS = ("wide16_nodes", "wide16_top", "stack_levels", "attr_shade_c", "attr_shade_o",
          "materials")


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _arrays(sd) -> dict:
    out = {f: np.asarray(getattr(sd, f)) for f in FIELDS}
    out["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    return out


# ---- the f16 decode ----

def test_f16_decode_bit_exact_over_all_patterns():
    h = np.arange(65536, dtype=np.int64)
    got = tct.f16_decode(torch.from_numpy(h)).numpy().view(np.uint32)
    want = h.astype(np.uint16).view(np.float16).astype(np.float32).view(np.uint32)
    ref = np.asarray(jpt._f16_decode(jnp.asarray(h, jnp.int32))).view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


# ---- K2's raw form ----

@pytest.fixture(scope="module")
def captured_raw():
    """Kernel inputs of transitions CAPTURE_AT of a 32x16, 2 spp reference
    pass with ``attr_in_kernel`` (so they hold ``pairT`` and ``parity``),
    copied to the host by a callback traced next to the kernel call."""
    scene, cam = million_triangle_scene(2000)
    sd = scene.build("wide16")
    params = jcamera(width=32, height=16, **cam)
    cfg = jconfig.RenderConfig(
        width=32, height=16, samples_per_pass=2, max_bounces=5, traversal="wide16",
        sky_mode=jconfig.SKY_MODE_ENVIRONMENT, has_environment_texture=True,
        integrator="fused", pool_size=1024, transition_every=4, attr_compact=2,
        attr_in_kernel=True, use_pallas_arrival=True, use_pallas_transition=True)
    out = []
    calls = [0]
    orig = jpt.transition_step16_pallas

    def record(**kw):
        names = [k for k in kw if k not in STATIC and kw[k] is not None]
        statics = {k: kw[k] for k in STATIC}

        def save(*vals):
            calls[0] += 1
            if calls[0] in CAPTURE_AT:
                out.append({**dict(zip(names, (np.array(v) for v in vals))), **statics})

        jax.debug.callback(save, *(kw[k] for k in names), ordered=True)
        return orig(**kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(jpt, "transition_step16_pallas", record)
    try:
        film, *_ = jfused.fused_pass_with_stats(sd, cfg, params, 0)
        np.asarray(film)
        jax.effects_barrier()
    finally:
        mp.undo()
    assert len(out) == len(CAPTURE_AT) and "pairT" in out[0], calls
    return out


def _raw_form(kw) -> dict:
    """The reference's pair rows and parity as the port's raw form: each
    lane's 64-byte pair as two rows of a table, ``attr`` picking its half."""
    pair = np.ascontiguousarray(np.asarray(kw["pairT"]).T)          # (B, 16) u32
    b = pair.shape[0]
    return dict(attr_table=torch.from_numpy(pair.reshape(2 * b, 8).view(np.int32)),
                attr=torch.from_numpy((2 * np.arange(b) + kw["parity"]).astype(np.int32)))


def _port_inputs(kw) -> dict:
    ins = {}
    for name, dtype, _rows in tct._INPUTS:
        a = kw[name].astype(np.int64) if dtype == torch.int64 else kw[name]
        ins[name] = torch.from_numpy(np.array(a))
    return ins


def _run_twin(kw, **form):
    static = {k: kw[k] for k in ("use_rr", "max_bounces", "firefly", "nan_canary")}
    return tct.transition_step16_plain(**_port_inputs(kw), **form, **static,
                                      firefly_max=torch.tensor(float(kw["firefly_max"])))


@pytest.mark.parametrize("which", range(len(CAPTURE_AT)))
def test_raw_twin_matches_pallas(captured_raw, which):
    kw = captured_raw[which]
    static = {k: kw[k] for k in ("use_rr", "max_bounces", "firefly", "nan_canary")}
    want = jpt.transition_step16_pallas(
        **{k: jnp.asarray(v) for k, v in kw.items() if k not in STATIC},
        **static, interpret=True)
    got = _run_twin(kw, **_raw_form(kw))
    assert int(np.asarray(want.died).sum()) > 0
    for name in tct.TransitionOut._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        if name == "rng":
            g = g.astype(np.uint32)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=name)
            close = np.isclose(g, w, rtol=1e-5, atol=1e-6).mean()
            assert close >= 0.995, (name, close)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_raw_and_shade_row_forms_agree_bit_for_bit(captured_raw):
    """The same rows handed to the twin raw and decoded by numpy."""
    kw = captured_raw[1]
    raw = _raw_form(kw)
    rows = raw["attr_table"].numpy()[raw["attr"].numpy()]          # (B, 8) int32
    shade_rowT = rows.view(np.float16)[:, 0:15].astype(np.float32).T.copy()
    a = _run_twin(kw, **raw)
    b = _run_twin(kw, shade_rowT=torch.from_numpy(shade_rowT))
    for name in tct.TransitionOut._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y), name


def test_wrapper_takes_exactly_one_attribute_form(captured_raw):
    kw = captured_raw[0]
    raw = _raw_form(kw)
    shade = dict(shade_rowT=torch.zeros((15, kw["mode"].shape[0])))
    for form in ({}, {**raw, **shade}, dict(attr_table=raw["attr_table"])):
        with pytest.raises(ValueError, match="attribute form"):
            _run_twin(kw, **form)


# ---- oct rows ----

def test_pack_attr_shade_o_byte_identical():
    rng = np.random.default_rng(5)
    n = rng.normal(size=(301, 9)).astype(np.float32)
    n[:5] = 0.0                                    # zero vectors -> +z pole
    n[5:40, 2::3] = -np.abs(n[5:40, 2::3])         # the folded hemisphere
    mat = rng.integers(0, 7, 301)
    got = tscene._pack_attr_shade_o(n, mat)
    want = jscene._pack_attr_shade_o(n, mat)
    assert got.shape == (304, 4) and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_oct_decode_within_one_ulp():
    rng = np.random.default_rng(6)
    u = rng.integers(0, 1 << 32, 20000, dtype=np.uint64).astype(np.uint32)
    u[:6] = [0, 0xFFFFFFFF, 0x80008000, 0x7FFF7FFF, 0xFFFF0000, 0x0000FFFF]
    got = tct.oct_decode(torch.from_numpy(u.view(np.int32))).numpy()
    want = np.asarray(jfused._oct_decode(jnp.asarray(u)))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ((ulps <= 1) | (np.abs(got - want) <= 1e-7)).all(), ulps.max()


def test_mode3_refuses_scene_without_oct_rows():
    scene, cam = million_triangle_scene(2000)
    arrays = _arrays(scene.build("wide16"))
    del arrays["attr_shade_o"]
    cfg = tconfig.RenderConfig(width=8, height=8, pool_size=1024, attr_compact=3)
    with pytest.raises(ValueError, match="attr_compact=3"):
        tfused.fused_pass_with_stats(tscene.scene_from_numpy(arrays, device="cpu"), cfg,
                                     tcamera(width=8, height=8, **cam, device="cpu"), 0)


# ---- fused passes with oct rows ----

@pytest.mark.parametrize("route", ["kernel", "general"])
def test_mode3_pass_matches_reference(route):
    """``attr_compact=3`` through K2 (HDRI, bench scene) and through the
    general transition (Cornell, no sky), against the reference's fused
    pass with both Pallas kernels on the same tables."""
    if route == "kernel":
        w, h = 40, 24
        scene, cam = million_triangle_scene(2000)
        extra = dict(sky_mode=0, has_environment_texture=True)
    else:
        w = h = 32
        scene, cam = cornell_box()
        extra = dict(sky_mode=2)
    sd = scene.build("wide16")
    common = dict(width=w, height=h, samples_per_pass=4, max_bounces=5, pool_size=1024,
                  transition_every=4, attr_compact=3, **extra)
    jcfg = jconfig.RenderConfig(traversal="wide16", integrator="fused",
                                use_pallas_arrival=True, use_pallas_transition=True, **common)
    tsd = tscene.scene_from_numpy(_arrays(sd), device="cpu")
    assert tfused._kernel_transition_supported(tsd, tconfig.RenderConfig(**common)) == (
        route == "kernel")
    step = jax.jit(jfused.fused_pass_with_stats, static_argnums=(1,))
    jfilm, jocc, jrays, jarr = step(sd, jcfg, jcamera(width=w, height=h, **cam), 0)
    tfilm, tocc, trays, tarr, iters = tfused.fused_pass_with_stats(
        tsd, tconfig.RenderConfig(**common), tcamera(width=w, height=h, **cam, device="cpu"), 0)
    print(f"rays port {int(trays)} reference {int(jrays)}; arrivals port {int(tarr)} "
          f"reference {int(jarr)}; super-iterations {iters}")
    assert abs(int(trays) - int(jrays)) <= 0.005 * int(jrays)
    assert abs(int(tarr) - int(jarr)) <= 0.005 * int(jarr)
    assert abs(float(tocc) - float(jocc)) <= 0.005
    got, want = tfilm.numpy(), np.asarray(jfilm)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    print(f"pixels diverged beyond rtol 1e-4: {int((~close).sum())} of {close.size}")
    assert close.mean() >= 0.99 and want.mean() > 0
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())
