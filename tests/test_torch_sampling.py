"""The port's sampling helpers, its environment alias sampler and its
correctly rounded square root, against the reference and numpy, on the
CPU.

* ``utils/math.py::sqrt`` is bit-equal to ``np.sqrt`` on 2^20 f32 values
  over every binade, with 0, -0, subnormals, inf and NaN; no module of the
  port calls ``torch.sqrt`` (or ``rsqrt``) outside it.
* ``gtr2``, ``uniform_sample_hemisphere``, ``sample_hg`` and ``phase_hg``
  equal the reference's within rtol 1e-5 / atol 1e-6 on seeded inputs,
  and pass the reference's NDF checks (``tests/test_sampling.py``).
* ``sample_env_map_alias`` draws the reference's texels and RNG stream
  exactly, directions and pdfs within 1e-6, and passes the reference's
  distribution and pdf checks (``tests/test_envmap.py``); so does
  ``sample_env_transition``'s branch for environments whose merged rows
  do not cover the image.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch.render import sampling as tsp
from unity_webgpu_pathtracer_torch.scene import envmap as tenv
from unity_webgpu_pathtracer_torch.utils import math as tmath
from unity_webgpu_pathtracer_tpu.render import sampling as jsp
from unity_webgpu_pathtracer_tpu.scene import envmap as jenv

torch.set_num_threads(2)

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "unity_webgpu_pathtracer_torch")
R = np.random.default_rng(0)
N = 200_000


def test_sqrt_is_correctly_rounded():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 0x7F800000, (1 << 20) - 16, dtype=np.int64).astype(np.uint32)
    special = np.array([0, 0x80000000, 1, 0x007FFFFF, 0x00800000, 0x7F7FFFFF, 0x7F800000,
                        0x7FC00000, 0xFF800000, 0xBF800000, 0x3F800000, 0x3E800000,
                        0x00000002, 0x00400000, 0x7F000000, 0x3F7FFFFF], np.uint32)
    x = np.concatenate([bits, special]).view(np.float32)
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    got = tmath.sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


def test_port_calls_no_torch_sqrt_outside_the_helper():
    """A source scan: ``torch.sqrt``, ``torch.rsqrt`` and the ``.sqrt()``
    methods appear only in ``utils/math.py::sqrt``."""
    pat = re.compile(r"torch\.r?sqrt\(|\.r?sqrt\(\)|\.sqrt_\(")
    hits = []
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    if pat.search(line.split("#")[0]):
                        hits.append((os.path.relpath(path, PORT), i, line.strip()))
    helper = [h for h in hits if h[0] == os.path.join("utils", "math.py")]
    assert len(helper) == 2 and all("return torch.sqrt(" in h[2] for h in helper), helper
    assert hits == helper, hits


def _uniform_hemisphere(n):
    z = R.uniform(size=n)
    phi = R.uniform(size=n) * 2 * np.pi
    r = np.sqrt(1 - z * z)
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1).astype(np.float32)


@pytest.mark.parametrize("a", [0.1, 0.3, 0.8])
def test_gtr2_ndf_normalization(a):
    h = _uniform_hemisphere(N)
    d = tsp.gtr2(torch.from_numpy(h[:, 2]), a).numpy()
    integral = (d * h[:, 2]).mean() * 2 * np.pi
    assert abs(integral - 1.0) < 0.03, (a, integral)


def test_gtr1_ndf_normalization():
    for a in (0.1, 0.5):
        h = _uniform_hemisphere(N)
        d = tsp.gtr1(torch.from_numpy(h[:, 2]), torch.tensor(a)).numpy()
        integral = (d * h[:, 2]).mean() * 2 * np.pi
        assert abs(integral - 1.0) < 0.05, (a, integral)


def test_gtr2_aniso_matches_iso_when_ax_eq_ay():
    h = torch.from_numpy(_uniform_hemisphere(1000))
    iso = tsp.gtr2(h[:, 2], 0.4).numpy()
    aniso = tsp.gtr2_aniso(h[:, 2], h[:, 0], h[:, 1], 0.4, 0.4).numpy()
    np.testing.assert_allclose(aniso, iso, rtol=2e-3, atol=1e-5)


def _helper_pair(name: str, n: int = 4096):
    rng = np.random.default_rng(11)
    u1, u2 = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    t1, t2 = torch.from_numpy(u1), torch.from_numpy(u2)
    if name == "gtr2":
        a = rng.uniform(0.01, 1.0, n).astype(np.float32)
        return (tsp.gtr2(t1, torch.from_numpy(a)).numpy(),
                np.asarray(jsp.gtr2(jnp.asarray(u1), jnp.asarray(a))))
    if name == "uniform_sample_hemisphere":
        return (torch.stack(tsp.uniform_sample_hemisphere(t1, t2), -1).numpy(),
                np.asarray(jsp.uniform_sample_hemisphere(jnp.asarray(u1), jnp.asarray(u2))))
    if name == "phase_hg":
        cos = rng.uniform(-1, 1, n).astype(np.float32)
        return (np.stack([tsp.phase_hg(torch.from_numpy(cos), g).numpy()
                          for g in (-0.7, 0.0, 0.3, 0.9)]),
                np.stack([np.asarray(jsp.phase_hg(jnp.asarray(cos), g))
                          for g in (-0.7, 0.0, 0.3, 0.9)]))
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    vt = tuple(torch.from_numpy(v[:, c].copy()) for c in range(3))
    return (np.stack([torch.stack(tsp.sample_hg(vt, g, t1, t2), -1).numpy()
                      for g in (-0.7, 0.0005, 0.3, 0.9)]),
            np.stack([np.asarray(jsp.sample_hg(jnp.asarray(v), g, jnp.asarray(u1),
                                               jnp.asarray(u2)))
                      for g in (-0.7, 0.0005, 0.3, 0.9)]))


@pytest.mark.parametrize("name", ["gtr2", "uniform_sample_hemisphere", "sample_hg", "phase_hg"])
def test_sampling_helper_matches_reference(name):
    got, want = _helper_pair(name)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _test_image(h=16):
    r = np.random.default_rng(0)
    img = r.uniform(0.05, 1.0, (h, 2 * h, 3)).astype(np.float32)
    img[h // 2, h] = [50.0, 40.0, 30.0]  # one bright texel
    return img


def _texel_histogram(dirs, h, w, rotation=0.0):
    d = np.asarray(dirs)
    theta = np.arccos(np.clip(d[:, 1], -1, 1))
    phi = np.arctan2(d[:, 2], d[:, 0])
    u = ((np.pi + phi) / (2 * np.pi) + rotation) % 1.0
    v = 1.0 - theta / np.pi
    x = np.clip((u * w).astype(int), 0, w - 1)
    y = np.clip((v * h).astype(int), 0, h - 1)
    hist = np.zeros((h, w))
    np.add.at(hist, (y, x), 1)
    return hist


def test_samplers_match_luminance_distribution():
    img = _test_image()
    env = tenv.build_envmap(img).to_tensors("cpu")
    h, w = img.shape[:2]
    n = 200_000
    state = torch.arange(n, dtype=torch.int64)
    lum = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    expect = lum / lum.sum()
    for sampler in (tenv.sample_env_map, tenv.sample_env_map_alias):
        dirs, _color, _pdf, _ = sampler(env, torch.tensor(0.0), state)
        hist = _texel_histogram(dirs.numpy(), h, w) / n
        assert np.abs(hist - expect).max() < 0.01, sampler.__name__
        bright = expect[h // 2, w // 2]
        assert abs(hist[h // 2, w // 2] - bright) < 0.05 * bright


def test_sample_eval_pdf_consistency():
    img = _test_image()
    env = tenv.build_envmap(img).to_tensors("cpu")
    n = 50_000
    state = (torch.arange(n, dtype=torch.int64) * 77 + 3) & 0xFFFFFFFF
    dirs, color, pdf_s, _ = tenv.sample_env_map_alias(env, torch.tensor(0.1), state)
    color_e, pdf_e = tenv.eval_env_map(env, dirs, torch.tensor(1.0), torch.tensor(0.1))
    pdf_s, pdf_e = pdf_s.numpy(), pdf_e.numpy()
    ok = np.isfinite(pdf_e)
    assert np.median((np.abs(pdf_e - pdf_s) / np.maximum(pdf_s, 1e-6))[ok]) < 0.1
    color, color_e = color.numpy(), color_e.numpy()
    relc = np.abs(color_e - color).max(-1) / np.maximum(color.max(-1), 1e-6)
    assert np.median(relc) < 0.1


def test_alias_sample_matches_reference():
    img = _test_image(32)
    jmap = jenv.build_envmap(img)
    tmap = tenv.build_envmap(img).to_tensors("cpu")
    state = np.random.default_rng(5).integers(0, 1 << 32, 8192, dtype=np.uint64).astype(np.uint32)
    jd, jc, jp, js = jenv.sample_env_map_alias(jmap, jnp.float32(0.1), jnp.asarray(state))
    td, tc, tp, ts = tenv.sample_env_map_alias(tmap, torch.tensor(0.1),
                                               torch.from_numpy(state.astype(np.int64)))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)


def test_env_transition_without_merged_rows_matches_reference():
    """The branch for environments past the merged-row limit, shown on a
    small image whose merged rows are replaced by the placeholder: the
    bilinear sky, then the alias NEE sample with two more uniforms."""
    img = _test_image(32)
    jmap = jenv.build_envmap(img)
    jmap = jmap._replace(merged_rows=jnp.zeros((1, 20), jnp.float32))
    tmap = tenv.build_envmap(img)._replace(merged_rows=np.zeros((1, 20), np.float32))
    tmap = tmap.to_tensors("cpu")
    rng = np.random.default_rng(7)
    b = 4096
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want_alias = rng.random(b) < 0.5
    state = rng.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32)
    jout = jenv.sample_env_transition(jmap, jnp.float32(0.1), jnp.asarray(d),
                                      jnp.asarray(want_alias), jnp.asarray(state))
    tout = tenv.sample_env_transition(tmap, torch.tensor(0.1), torch.from_numpy(d),
                                      torch.from_numpy(want_alias),
                                      torch.from_numpy(state.astype(np.int64)))
    names = ("sky_color", "sky_pdf", "nee_dir", "nee_color", "nee_pdf", "state")
    j = dict(zip(names, (np.asarray(x) for x in jout)))
    t = dict(zip(names, (x.numpy() for x in tout)))
    np.testing.assert_array_equal(t["state"].astype(np.uint32), j["state"])
    np.testing.assert_array_equal(t["nee_color"], j["nee_color"])
    for name in ("nee_dir", "nee_pdf"):
        np.testing.assert_allclose(t[name], j[name], rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ("sky_color", "sky_pdf"):
        np.testing.assert_allclose(t[name], j[name], rtol=1e-5, atol=1e-6, err_msg=name)
