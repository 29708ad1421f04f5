"""Kernel K1's plain twin (what ``arrival_step16_cuda`` runs on CPU
tensors) against the reference's Pallas arrival in interpret mode, and
the port's prestep against the reference's, on identical inputs.

Contracts (the reference's own, ``tests/test_pallas_arrival.py``): after
one arrival from a fresh state every integer field is equal; after 8 and
40 arrivals ``t`` agrees within rtol/atol 1e-5 and the integer fields on
>= 99.5% of lanes (XLA contracts FMAs where PyTorch does not, shifting
Möller-Trumbore t by an ulp, which can flip near-tie winners).  The
prestep has no such ties at these sizes and is bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as ttw
from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_step16_cuda
from unity_webgpu_pathtracer_torch.utils.math import safe_rcp
from unity_webgpu_pathtracer_tpu.accel.wide16 import build_scene_wide16, derive_top16
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as jtw
from unity_webgpu_pathtracer_tpu.ops.pallas_arrival import arrival_step16_pallas
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE

torch.set_num_threads(2)

# One compiled interpret-mode arrival, reused for every step.
_pallas_step = jax.jit(arrival_step16_pallas, static_argnames=("interpret",))

INT_FIELDS = ("ptr", "pend", "sp", "tri", "found")


def _tris(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5.0, 5.0, (n, 1, 3))
    return (c + rng.uniform(-0.4, 0.4, (n, 3, 3))).astype(np.float32)


def _recs(tris):
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    return np.concatenate([v2 - v0, v1 - v0, v0], axis=1).astype(np.float32)


def _rays(b, tris, seed):
    """Half free rays, half aimed at triangle centroids."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8.0, 8.0, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    cent = tris.mean(axis=1)
    aim = cent[rng.integers(0, cent.shape[0], b)] + rng.normal(size=(b, 3)) * 0.05 - o
    d[: b // 2] = aim[: b // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _torch_state(js) -> ttw.Wide16State:
    """The reference's state in the port's layout (local rays as planes)."""
    return ttw.Wide16State(**{f: torch.from_numpy(np.array(getattr(js, f)).T.copy()
                                                  if f.startswith("local_")
                                                  else np.array(getattr(js, f)))
                              for f in ttw.Wide16State._fields})


@pytest.fixture(scope="module")
def table():
    tris = _tris(3000, seed=21)
    return build_scene_wide16(tris, _recs(tris)).nodes, tris


def _run(nodes, tris, b, steps, seed, active_frac=None):
    o, d = _rays(b, tris, seed)
    active = None
    if active_frac is not None:
        active = np.random.default_rng(0).random(b) < active_frac
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jinv = 1.0 / jnp.where(jd == 0.0, 1e-30, jd)
    js = jtw.init_state16(b, jnp.float32(FAR_PLANE), depth=12)
    tnodes = torch.from_numpy(nodes)
    to, td = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    tinv = safe_rcp(td)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv).T)
    ts = _torch_state(js)
    tact = None if active is None else torch.from_numpy(active)
    jact = None if active is None else jnp.asarray(active)
    for _ in range(steps):
        js = _pallas_step(jnp.asarray(nodes), jo.T, jd.T, jinv.T, js, jact,
                          interpret=True)
        ts = arrival_step16_cuda(tnodes, to, td, tinv, ts, tact)
    return js, ts


def test_one_arrival_exact(table):
    nodes, tris = table
    js, ts = _run(nodes, tris, 2048, 1, seed=5)
    for name in INT_FIELDS + ("stack_row", "stack_mask"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))


@pytest.mark.parametrize("steps", [8, 40])
def test_many_arrivals_match(table, steps):
    nodes, tris = table
    js, ts = _run(nodes, tris, 2048, steps, seed=22)
    np.testing.assert_allclose(ts.t.numpy(), np.asarray(js.t), rtol=1e-5, atol=1e-5)
    for name in INT_FIELDS:
        frac = (getattr(ts, name).numpy() == np.asarray(getattr(js, name))).mean()
        print(name, frac)
        assert frac >= 0.995, (name, frac)


def test_arrivals_with_active_mask(table):
    nodes, tris = table
    js, ts = _run(nodes, tris, 2048, 6, seed=5, active_frac=0.7)
    np.testing.assert_allclose(ts.t.numpy(), np.asarray(js.t), rtol=1e-5, atol=1e-5)
    for name in ("ptr", "sp", "found"):
        assert (getattr(ts, name).numpy() == np.asarray(getattr(js, name))).mean() >= 0.995


def test_prestep_bit_exact():
    """Both prestep levels from fresh lanes, on the benchmark scene's
    table and root slot table, with rays from its camera."""
    from unity_webgpu_pathtracer_tpu.models.benchmark import million_triangle_scene

    scene, cam = million_triangle_scene(2000)
    sd = scene.build("wide16")
    nodes = np.array(sd.wide16_nodes)
    top = derive_top16(nodes)
    assert top is not None
    b = 2048
    rng = np.random.default_rng(3)
    eye = np.asarray(cam["eye"], np.float32)
    o = np.tile(eye[None, :], (b, 1))
    d = (rng.uniform(-0.4, 0.4, (b, 3)) - eye).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    fresh = rng.random(b) < 0.8
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    js = jtw.init_state16(b, jnp.float32(FAR_PLANE), depth=sd.stack_levels.shape[0])
    js = jtw.prestep16(jnp.asarray(nodes), jnp.asarray(top), jo, jd,
                       1.0 / jnp.where(jd == 0.0, 1e-30, jd), js, jnp.asarray(fresh))
    td = torch.from_numpy(d)
    ts = ttw.init_state16(b, FAR_PLANE, depth=sd.stack_levels.shape[0], device="cpu")
    ts = ttw.prestep16(torch.from_numpy(nodes), torch.from_numpy(top),
                       torch.from_numpy(o), td, safe_rcp(td), ts, torch.from_numpy(fresh))
    assert (ts.ptr.numpy() > 0).mean() > 0.3   # the test exercises both levels
    for name in ("ptr", "sp", "stack_row", "stack_mask"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
