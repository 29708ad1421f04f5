"""The port's Disney BSDF (``render/bsdf.py``) on its own, against the
reference's (``tests/test_bsdf.py``), on the CPU.

``eval_brdf`` of both packages (the reference run eagerly, op by op) on
the same seeded materials (every parameter drawn over its range),
normals, view and light directions: f and pdf within rtol 1e-5 / atol
1e-6 on every lane.
Then the reference's checks on the port, on the same inputs: the pdf
integrates to ~1 for diffuse, metal, glass and the clearcoat mix;
sampling agrees with evaluation; the white furnace; no NaN across the
material space.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch.render import bsdf as tbsdf
from unity_webgpu_pathtracer_tpu.render import bsdf as jbsdf

torch.set_num_threads(2)

NORMAL = np.asarray([0.0, 0.0, 1.0], np.float32)


def _planes(a: np.ndarray):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, c])) for c in range(a.shape[1]))


def _mat(n, **kw):
    """The reference's ``make_material`` and the same material as the
    port's ``Material`` (colours as planes)."""
    jm = jbsdf.make_material(batch_shape=(n,), **kw)
    fields = {}
    for f in tbsdf.Material._fields:
        a = np.asarray(jnp.broadcast_to(getattr(jm, f), (n, 3) if f in ("base_color",
                                                                         "emission") else (n,)))
        fields[f] = _planes(a) if a.ndim == 2 else torch.from_numpy(np.array(a))
    return jm, tbsdf.Material(**fields)


def _uniform_sphere(n, seed=0):
    r = np.random.default_rng(seed)
    z = 1 - 2 * r.uniform(size=n)
    phi = r.uniform(size=n) * 2 * np.pi
    rad = np.sqrt(np.maximum(0, 1 - z * z))
    return np.stack([rad * np.cos(phi), rad * np.sin(phi), z], -1).astype(np.float32)


def _fixed_v(n, v=(0.2, 0.1, 0.97)):
    v = np.asarray(v, np.float32)
    return np.broadcast_to(v / np.linalg.norm(v), (n, 3)).copy()


def _random_material(n, seed):
    r = np.random.default_rng(seed)
    u = lambda lo=0.0, hi=1.0, shape=(n,): r.uniform(lo, hi, shape).astype(np.float32)  # noqa: E731
    return dict(base_color=u(shape=(n, 3)), roughness=u(), metallic=u(), opacity=u(),
                clearcoat=u(), clearcoat_gloss=u(), sheen=u(), sheen_tint=u(),
                subsurface=u(), specular_tint=u(), anisotropic=u(-1, 1), ior=u(1.0, 2.5))


def _eval(pkg_mat, v, nrm, l, port):
    if port:
        f, pdf = tbsdf.eval_brdf(pkg_mat, _planes(v), _planes(nrm), _planes(l))
        return torch.stack(f, -1).numpy(), pdf.numpy()
    f, pdf = jbsdf.eval_brdf(pkg_mat, jnp.asarray(v), jnp.asarray(nrm), jnp.asarray(l))
    return np.asarray(f), np.asarray(pdf)


def test_eval_brdf_matches_reference():
    """Random materials, tilted normals, views above the surface."""
    n = 4096
    jm, tm = _mat(n, **_random_material(n, 21))
    nrm = _uniform_sphere(n, 22)
    v = _uniform_sphere(n, 23)
    v = np.where((v * nrm).sum(-1, keepdims=True) < 0, -v, v)
    l = _uniform_sphere(n, 24)
    wf, wp = _eval(jm, v, nrm, l, port=False)
    gf, gp = _eval(tm, v, nrm, l, port=True)
    assert np.isfinite(gf).all() and np.isfinite(gp).all()
    np.testing.assert_allclose(gf, wf, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gp, wp, rtol=1e-5, atol=1e-6)
    assert (gp > 0).mean() > 0.3 and (gf > 0).any()


def _pdf_integral(mat_kwargs, n=400_000):
    """MC estimate of the pdf's integral over the sphere (should be ~1)."""
    _jm, tm = _mat(n, **mat_kwargs)
    _, pdf = _eval(tm, _fixed_v(n), np.broadcast_to(NORMAL, (n, 3)).copy(),
                   _uniform_sphere(n, 3), port=True)
    return float(pdf.mean() * 4 * np.pi)


def test_pdf_normalizes_diffuse():
    assert abs(_pdf_integral(dict(base_color=(0.8, 0.6, 0.4), roughness=0.6)) - 1.0) < 0.03


def test_pdf_normalizes_metal():
    assert abs(_pdf_integral(dict(metallic=1.0, roughness=0.05)) - 1.0) < 0.05
    # Rough metal loses the below-horizon mass, never exceeds 1.
    v = _pdf_integral(dict(metallic=1.0, roughness=0.5))
    assert 0.7 < v <= 1.02, v


def test_pdf_normalizes_glass():
    v = _pdf_integral(dict(base_color=(1, 1, 1), opacity=0.0, roughness=0.4, ior=1.5))
    assert abs(v - 1.0) < 0.06


def test_pdf_normalizes_clearcoat_mix():
    v = _pdf_integral(dict(base_color=(0.5, 0.5, 0.5), roughness=0.4, clearcoat=1.0,
                           clearcoat_gloss=0.5))
    assert abs(v - 1.0) < 0.05


def _states(n, mul, add):
    return (np.arange(n, dtype=np.uint64) * mul + add).astype(np.uint32).astype(np.int64)


def test_sample_eval_consistency():
    """E over samples of 1{pdf>0} g(L) equals the uniform estimate of the
    integral of g pdf, for the same g."""
    n = 300_000
    _jm, tm = _mat(n, base_color=(0.7, 0.7, 0.7), roughness=0.3, metallic=0.3)
    v, nrm = _fixed_v(n), np.broadcast_to(NORMAL, (n, 3)).copy()

    def g(l):
        return 1.0 + l[..., 2] ** 2

    _f, l_s, pdf_s, _ = tbsdf.sample_brdf(tm, _planes(v), _planes(nrm),
                                          torch.from_numpy(_states(n, 2654435761, 1)))
    l_s = torch.stack(l_s, -1).numpy()
    route_a = float((g(l_s) * (pdf_s.numpy() > 1e-6)).mean())
    l_u = _uniform_sphere(n, 11)
    _, pdf_u = _eval(tm, v, nrm, l_u, port=True)
    route_b = float((g(l_u) * pdf_u).mean() * 4 * np.pi)
    assert abs(route_a - route_b) < 0.02, (route_a, route_b)


def test_furnace_diffuse_energy():
    """Directional-hemispherical reflectance of the diffuse lobe within
    [0.8, 1.15] x albedo."""
    n = 200_000
    albedo = 0.6
    _jm, tm = _mat(n, base_color=(albedo,) * 3, roughness=1.0, metallic=0.0, ior=1.3)
    f, _, pdf, _ = tbsdf.sample_brdf(tm, _planes(_fixed_v(n, (0.0, 0.0, 1.0))),
                                     _planes(np.broadcast_to(NORMAL, (n, 3)).copy()),
                                     torch.from_numpy(_states(n, 747796405, 99)))
    f, pdf = torch.stack(f, -1).numpy(), pdf.numpy()
    w = np.where(pdf[:, None] > 1e-6, f / np.maximum(pdf[:, None], 1e-6), 0.0)
    refl = w.mean(axis=0)
    assert (refl > albedo * 0.8).all() and (refl < albedo * 1.15).all(), refl


def test_no_nans_across_material_space():
    n = 20_000
    _jm, tm = _mat(n, **_random_material(n, 5))
    v = _uniform_sphere(n, 13)
    v = np.where(v[..., 2:3] < 0, -v, v)
    nrm = np.broadcast_to(NORMAL, (n, 3)).copy()
    f, l, pdf, _ = tbsdf.sample_brdf(tm, _planes(v), _planes(nrm),
                                     torch.from_numpy(np.arange(n, dtype=np.int64)))
    for arr in (*f, *l, pdf):
        assert torch.isfinite(arr).all()
    le, pe = _eval(tm, v, nrm, _uniform_sphere(n, 17), port=True)
    assert np.isfinite(le).all() and np.isfinite(pe).all()
