"""Kernel K2's per-lane body on pre-gathered inputs
(``transition_step16_plain``, the last stage of the plain version
``transition16_plain`` that ``transition16_cuda`` runs on CPU tensors)
against the reference's Pallas transition in interpret mode, and the
port's env sample against the reference's.

The transition inputs are captured from a real JAX pass (the reference's
``fused_pass_with_stats`` with its Pallas kernels, run eagerly): the
exact pre-gathered planes its kernel receives at several transitions.
Contract: integer outputs (mode, traversal registers, RNG state, depth,
lane budget, died, ray starts) equal; float outputs within rtol 1e-5 /
atol 1e-6 on >= 99.5% of elements, and every element within rtol 1e-3 /
atol 1e-5.  The reference's rtol 1e-5 cannot hold on every lane: XLA's
sin/cos differ from PyTorch's by an ulp, and ``1 - x*x - y*y`` in the
cosine hemisphere sample cancels at grazing directions (measured: one
lane of 1024, throughput off by 4.8e-5 relative, pdf 0.021).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch.ops import cuda_transition as tct
from unity_webgpu_pathtracer_torch.scene import envmap as tenv
from unity_webgpu_pathtracer_tpu.config import SKY_MODE_ENVIRONMENT, RenderConfig
from unity_webgpu_pathtracer_tpu.models.benchmark import million_triangle_scene, procedural_hdri
from unity_webgpu_pathtracer_tpu.ops import pallas_transition as jpt
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
from unity_webgpu_pathtracer_tpu.scene import envmap as jenv

torch.set_num_threads(2)

CAPTURE_AT = (2, 5, 9)   # transitions of the pass whose inputs are kept
STATIC = ("use_rr", "max_bounces", "firefly", "nan_canary", "interpret", "tile3d")


@pytest.fixture(scope="module")
def captured():
    """Kernel inputs of transitions CAPTURE_AT of a 40x24, 4 spp pass,
    copied to the host by a callback traced next to the kernel call."""
    scene, cam = million_triangle_scene(2000)
    sd = scene.build("wide16")
    params = make_camera_params(width=40, height=24, **cam)
    cfg = RenderConfig(
        width=40, height=24, samples_per_pass=4, max_bounces=5, traversal="wide16",
        sky_mode=SKY_MODE_ENVIRONMENT, has_environment_texture=True,
        integrator="fused", pool_size=1024, transition_every=4, attr_compact=2,
        use_pallas_arrival=True, use_pallas_transition=True)
    out = []
    calls = [0]
    orig = jpt.transition_step16_pallas

    def record(**kw):
        names = [k for k in kw if k not in STATIC]
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
    assert len(out) == len(CAPTURE_AT), calls
    return out


def _to_torch(kw):
    """The captured kernel inputs as the port's keyword tensors (the
    attribute row in the form the capture has)."""
    ins = {}
    for name, dtype, _rows in tct._INPUTS:
        a = kw[name]
        if dtype == torch.int64:
            a = a.astype(np.int64)
        ins[name] = torch.from_numpy(np.array(a))
    if "shade_rowT" in kw:
        ins["shade_rowT"] = torch.from_numpy(np.array(kw["shade_rowT"]))
    return ins


@pytest.mark.parametrize("which", range(len(CAPTURE_AT)))
def test_transition_twin_matches_pallas(captured, which):
    want = _check_twin(captured[which])
    assert int(np.asarray(want.died).sum()) > 0 or which == 0


def test_transition_twin_flags_match_pallas(captured):
    """The firefly clamp, at a threshold low enough to clamp lanes, and the
    NaN canary, both off on the main path."""
    kw = {**captured[2], "firefly": True, "nan_canary": True,
          "firefly_max": np.float32(0.05)}
    want = _check_twin(kw)
    luma = np.float32([0.299, 0.587, 0.114])
    raw = np.asarray(want.radianceT).T @ luma
    clamped = np.asarray(want.rad_outT).T @ luma
    assert (raw > 0.05).any() and clamped.max() <= 0.05 * (1 + 1e-5)


def _check_twin(kw):
    """Run the reference kernel and the twin on ``kw``; hold the twin to
    the contract above; return the reference's outputs."""
    static = {k: kw[k] for k in ("use_rr", "max_bounces", "firefly", "nan_canary")}
    want = jpt.transition_step16_pallas(
        **{k: jnp.asarray(v) for k, v in kw.items() if k not in STATIC},
        **static, interpret=True)
    got = tct.transition_step16_plain(**_to_torch(kw), **static,
                                     firefly_max=torch.tensor(float(kw["firefly_max"])))
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
    return want


def test_env_sample_matches_reference():
    """Alias-sampled texels (their colours and the RNG stream) exact;
    directions, pdfs and the bilinear sky within 1e-6."""
    img = procedural_hdri(128)
    jmap = jenv.build_envmap(img)
    tmap = tenv.build_envmap(img).to_tensors("cpu")
    b = 8192
    rng = np.random.default_rng(7)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want_alias = rng.random(b) < 0.5
    need = rng.random(b) < 0.9
    state = rng.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32)
    rot = np.float32(0.1)
    jout = jenv.sample_env_transition(jmap, jnp.float32(rot), jnp.asarray(d),
                                      jnp.asarray(want_alias), jnp.asarray(state),
                                      need=jnp.asarray(need))
    tout = tenv.sample_env_transition(tmap, torch.tensor(rot), torch.from_numpy(d),
                                      torch.from_numpy(want_alias),
                                      torch.from_numpy(state.astype(np.int64)),
                                      need=torch.from_numpy(need))
    names = ("sky_color", "sky_pdf", "nee_dir", "nee_color", "nee_pdf", "state")
    j = dict(zip(names, (np.asarray(x) for x in jout)))
    t = dict(zip(names, (x.numpy() for x in tout)))
    np.testing.assert_array_equal(t["state"].astype(np.uint32), j["state"])
    nee = want_alias & need
    np.testing.assert_array_equal(t["nee_color"][nee], j["nee_color"][nee])
    np.testing.assert_allclose(t["nee_dir"][nee], j["nee_dir"][nee], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t["nee_pdf"][nee], j["nee_pdf"][nee], rtol=1e-6, atol=1e-6)
    sky = ~want_alias & need
    np.testing.assert_allclose(t["sky_color"][sky], j["sky_color"][sky], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t["sky_pdf"][sky], j["sky_pdf"][sky], rtol=1e-5, atol=1e-6)


def test_bilinear_quad_matches_reference():
    img = procedural_hdri(64)
    jmap = jenv.build_envmap(img)
    tmap = tenv.build_envmap(img).to_tensors("cpu")
    uv = np.random.default_rng(1).uniform(-0.5, 1.5, (4096, 2)).astype(np.float32)
    np.testing.assert_allclose(tenv._bilinear_quad(tmap, torch.from_numpy(uv)).numpy(),
                               np.asarray(jenv._bilinear_quad(jmap, jnp.asarray(uv))),
                               rtol=1e-6, atol=1e-7)


def test_mode_constants_match_reference():
    assert (tct.MODE_PRIMARY, tct.MODE_SHADOW_ENV, tct.MODE_DEAD) == (
        jfused.MODE_PRIMARY, jfused.MODE_SHADOW_ENV, jfused.MODE_DEAD)
    assert tct.FULL16 == jpt.FULL16
