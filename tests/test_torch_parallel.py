"""The port's multi-GPU layer on the CPU: the fused pass's ``shard``,
``parallel/film_tiling.py`` over gloo processes, and ``utils/profiling.py``.

Seeds are keyed by the global (pixel, sample), so shards of a pass put
together are the single pass (the reference's ``tests/test_multichip.py``
and ``tests/test_config5.py``):

* in process, each shard of a (tile=4, spp=2) split through
  ``fused_pass_with_stats(shard=...)``, summed over its sample blocks and
  put in tile order, equals the single pass of the same samples (rtol
  3e-7, atol 1e-7, rays exact; >= 99% of values bitwise against the
  single-device passes of the two sample blocks, added as the grid adds
  them: the single pass sums a pixel's four samples in another
  association), on the HDRI
  scene (kernel K2's route) and on the Cornell box (the general
  transition); one shard equals the reference's shard (rays and arrivals
  exact, film mean within 1%, >= 99% of pixels within rtol 1e-4); a
  tile-sharded 256x256 pass is bitwise the single pass;
* over gloo, four CPU processes (``tests/torch_parallel_worker.py``, a
  ``file://`` rendezvous under ``tmp_path``) on a (tile=2, spp=2) grid:
  ``multichip_fused_pass`` (on wide16 and on wide8) and
  ``multichip_render_pass`` equal the single-device passes and are the
  same on every rank; the config-5
  composition (sharded pass, ``reproject_film``, sharded pass) equals the
  single-device flow (counts exact, accum rtol 1e-4, atol 1e-5).
"""

import dataclasses
import datetime
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests import torch_parallel_worker as worker
from tests.test_torch_fused import both  # noqa: F401  (the HDRI scene of both packages)
from tests.test_torch_fused import _film_close
from unity_webgpu_pathtracer_torch.parallel import film_tiling as ft
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.render.integrator import render_pass
from unity_webgpu_pathtracer_tpu.render import fused as jfused

torch.set_num_threads(2)

RANKS = 4
SPAWN_TIMEOUT = 240   # seconds for the four ranks, start-up included
TOL = dict(rtol=3e-7, atol=1e-7)


def _close(got: np.ndarray, want: np.ndarray) -> float:
    """Within rtol 3e-7, atol 1e-7 (the reference's record-film multi-chip
    tolerance); returns the share of values bitwise equal."""
    share = float((got == want).mean())
    print(f"bitwise equal: {share:.4%} of {got.size} values; max abs "
          f"{float(np.abs(got - want).max()):g}")
    np.testing.assert_allclose(got, want, **TOL)
    return share


def _close_bitwise(got: np.ndarray, want: np.ndarray) -> None:
    """Within the tolerance, and >= 99% of values bitwise equal."""
    assert _close(got, want) >= 0.99


@pytest.fixture(scope="module")
def cornell32():
    sd, cam = worker.cornell(32)
    return sd, worker.camera(cam, size=32), worker.config(4, 32)


def _assembled(sd, cfg, params, n_tile, n_spp):
    """The pass of ``cfg`` as ``n_tile * n_spp`` shards, each tile's sample
    blocks summed in order, tiles in order: ``(film, rays)``."""
    npix_l, spp_l = cfg.pixel_count() // n_tile, cfg.samples_per_pass // n_spp
    tiles, rays = [], 0
    for t in range(n_tile):
        acc = None
        for s in range(n_spp):
            f, _occ, r, _arr, _it = tfused.fused_pass_with_stats(
                sd, cfg, params, 0, shard=(t * npix_l, npix_l, s * spp_l, spp_l))
            assert f.shape == (npix_l, 3)
            acc = f if acc is None else acc + f
            rays += int(r)
        tiles.append(acc)
    return torch.cat(tiles).numpy(), rays


@pytest.mark.parametrize("case", ["hdri", "cornell"])
def test_shards_assemble_to_single_pass(case, request):
    if case == "hdri":
        *_, sd, params, cfg = request.getfixturevalue("both")
    else:
        sd, params, cfg = request.getfixturevalue("cornell32")
    # The HDRI scene takes K2's route, the Cornell box the general one.
    assert tfused._kernel_transition_supported(sd, cfg) == (case == "hdri")
    single, _occ, rays, _arr, _it = tfused.fused_pass_with_stats(sd, cfg, params, 0)
    film, shard_rays = _assembled(sd, cfg, params, 4, 2)
    assert shard_rays == int(rays)
    # The sample blocks' sums add in another association than the single
    # pass's sum of four: within the tolerance.  Summed as the grid sums
    # them, the single-device passes over samples [0, 2) and [2, 4) are the
    # shards bit for bit: every sample's radiance is the single pass's.
    _close(film, single.numpy())
    half = dataclasses.replace(cfg, samples_per_pass=2)
    blocks = [tfused.fused_pass_with_stats(sd, half, params, cur)[0] for cur in (0, 2)]
    _close_bitwise(film, (blocks[0] + blocks[1]).numpy())


_JAX_SHARD = {}


def _jax_shard(jcfg, npix_l: int, spp_l: int):
    """The reference's sharded pass, jitted once for every shard of this
    size (the bases are traced)."""
    key = (jcfg, npix_l, spp_l)
    if key not in _JAX_SHARD:
        _JAX_SHARD[key] = jax.jit(lambda sd, p, pb, sb: jfused.fused_pass_with_stats(
            sd, jcfg, p, 0, shard=(pb, npix_l, sb, spp_l)))
    return _JAX_SHARD[key]


@pytest.mark.parametrize("tile,spp", [(1, 0), (2, 1)])
def test_shard_matches_reference(both, tile, spp):  # noqa: F811
    sd, params, jcfg, tsd, tparams, tcfg = both
    npix_l, spp_l = tcfg.pixel_count() // 4, 2
    shard = (tile * npix_l, npix_l, spp * spp_l, spp_l)
    jfilm, _jocc, jrays, jarr = _jax_shard(jcfg, npix_l, spp_l)(
        sd, params, np.uint32(shard[0]), np.uint32(shard[2]))
    tfilm, _tocc, trays, tarr, _it = tfused.fused_pass_with_stats(tsd, tcfg, tparams, 0,
                                                                  shard=shard)
    print(f"shard {shard}: rays port {int(trays)} reference {int(jrays)}; arrivals port "
          f"{int(tarr)} reference {int(jarr)}")
    assert int(trays) == int(jrays) and int(tarr) == int(jarr)
    assert tfilm.shape == jfilm.shape == (npix_l, 3)
    _film_close(tfilm.numpy(), np.asarray(jfilm))


def test_tile_sharded_256_is_the_single_pass():
    """256x256, one sample a pixel, four tiles: each pixel's one record is
    the single pass's, bit for bit."""
    sd, cam = worker.cornell(256)
    params, cfg = worker.camera(cam, size=256), worker.config(1, 256)
    single, _occ, rays, _arr, _it = tfused.fused_pass_with_stats(sd, cfg, params, 0,
                                                                 pool_size=16384)
    npix_l = cfg.pixel_count() // 4
    tiles = [tfused.fused_pass_with_stats(sd, cfg, params, 0, pool_size=16384,
                                          shard=(t * npix_l, npix_l, 0, 1)) for t in range(4)]
    assert sum(int(r) for _f, _o, r, _a, _i in tiles) == int(rays)
    np.testing.assert_array_equal(torch.cat([f for f, *_ in tiles]).numpy(), single.numpy())


def test_shard_off_the_film_is_refused(cornell32):
    sd, params, cfg = cornell32
    with pytest.raises(ValueError, match="off the film"):
        tfused.fused_pass_with_stats(sd, cfg, params, 0, shard=(1000, 100, 0, 1))


def test_tile_axis_must_divide_the_film(cornell32):
    sd, params, cfg = cornell32
    mesh = ft.Mesh({"tile": 3, "spp": 1}, 0, 0, None, None)
    with pytest.raises(ValueError, match="must divide the tile axis"):
        ft.multichip_fused_pass(sd, cfg, params, 0, mesh)


@pytest.fixture
def one_rank(tmp_path):
    """A gloo process group of this process alone (``file://`` rendezvous
    under ``tmp_path``), destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_too_small(one_rank):
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        ft.make_mesh(n_tile=2, n_spp=1)


def test_one_rank_mesh_is_the_single_pass(one_rank, cornell32):
    sd, params, cfg = cornell32
    mesh = ft.make_mesh(1, 1)
    assert (mesh.shape, mesh.tile, mesh.spp) == ({"tile": 1, "spp": 1}, 0, 0)
    film, occ, rays, arr, iters = ft.multichip_fused_pass(sd, cfg, params, 0, mesh)
    single, socc, srays, sarr, siters = tfused.fused_pass_with_stats(sd, cfg, params, 0)
    assert torch.equal(film, single) and iters == siters
    assert (int(rays), int(arr), float(occ)) == (int(srays), int(sarr), float(socc))
    assert torch.equal(ft.multichip_render_pass(sd, worker.config(1, 32), params, 0, mesh),
                       render_pass(sd, worker.config(1, 32), params, 0))


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Each rank's saved results of ``torch_parallel_worker.main``, from
    four gloo processes on the CPU.  A rank that fails or outlives the
    timeout fails the fixture with its stderr, and the others are
    killed."""
    worker.cornell()   # the parent builds the table first: the ranks read the cache
    out = tmp_path_factory.mktemp("gloo")
    init = f"file://{out}/rendezvous"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    procs = []
    for rank in range(RANKS):
        err = open(out / f"rank{rank}.err", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, worker.__file__, str(rank), str(RANKS), init, str(out)],
            cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err), err))
    try:
        for rank, (p, err) in enumerate(procs):
            try:
                rc = p.wait(timeout=SPAWN_TIMEOUT)
            except subprocess.TimeoutExpired:
                rc = "timed out"
            if rc != 0:
                err.seek(0)
                pytest.fail(f"gloo rank {rank}: exit {rc}\n{err.read()}")
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_gloo_grid_coordinates(gloo_ranks):
    # rank = tile * n_spp + spp on (2, 2); rank = tile on (4, 1); ranks 2
    # and 3 lie past a (2, 1) grid.
    assert [r["coords"] for r in gloo_ranks] == [(0, 0, 0, False), (0, 1, 1, False),
                                                 (1, 0, 2, True), (1, 1, 3, True)]


def test_gloo_identical_on_every_rank(gloo_ranks):
    first = gloo_ranks[0]
    for r in gloo_ranks[1:]:
        for key in ("megakernel_tile_spp", "megakernel_tile", "config5"):
            assert _same(r[key], first[key]), key
        # The film and the pooled counters; the super-iterations are the rank's own.
        assert _same(r["fused"][:4], first["fused"][:4])


def test_gloo_fused_equals_single_pass(gloo_ranks):
    sd, cam = worker.cornell()
    film, occ, rays, arr, _iters = gloo_ranks[0]["fused"]
    single, _socc, srays, _sarr, _it = tfused.fused_pass_with_stats(
        sd, worker.config(4), worker.camera(cam), 0)
    assert film.shape == (worker.SIZE * worker.SIZE, 3)
    assert int(rays) == int(srays) and int(arr) > 0 and 0 < float(occ) <= 1
    _close(film.numpy(), single.numpy())
    # The spp axis adds the two sample blocks' sums: the single-device
    # passes over samples [0, 2) and [2, 4), added, bit for bit.
    blocks = [tfused.fused_pass_with_stats(sd, worker.config(2), worker.camera(cam), cur)[0]
              for cur in (0, 2)]
    _close_bitwise(film.numpy(), (blocks[0] + blocks[1]).numpy())


def test_gloo_wide8_fused_equals_single_pass(gloo_ranks):
    """The wide8 cross-check backend on the (tile=2, spp=2) grid (the
    reference's ``tests/test_multichip.py`` shards its fused pass on
    wide8): the single wide8 pass, and the same on every rank."""
    sd, cam = worker.cornell(traversal="wide8")
    film, _occ, rays, _arr, _iters = gloo_ranks[0]["fused_wide8"]
    single, _socc, srays, _sarr, _it = tfused.fused_pass_with_stats(
        sd, worker.config(4, traversal="wide8"), worker.camera(cam), 0)
    assert int(rays) == int(srays)
    _close(film.numpy(), single.numpy())
    for r in gloo_ranks[1:]:
        assert _same(r["fused_wide8"][:4], gloo_ranks[0]["fused_wide8"][:4])


def test_gloo_megakernel_tile_is_bitwise(gloo_ranks):
    sd, cam = worker.cornell()
    single = render_pass(sd, worker.config(1), worker.camera(cam), 0)
    np.testing.assert_array_equal(gloo_ranks[0]["megakernel_tile"].numpy(), single.numpy())


def test_gloo_megakernel_tile_and_spp(gloo_ranks):
    # The spp axis sums two sample blocks: the passes from samples 0 and 1.
    sd, cam = worker.cornell()
    cfg, params = worker.config(1), worker.camera(cam)
    want = render_pass(sd, cfg, params, 0) + render_pass(sd, cfg, params, 1)
    _close_bitwise(gloo_ranks[0]["megakernel_tile_spp"].numpy(), want.numpy())


def test_gloo_config5_flow(gloo_ranks):
    """Sharded pass, reprojection, sharded pass against the single-device
    flow over the same (pixel, sample) set: the grid's sample blocks [0, 2)
    and [2, 4) are one pass of 4 samples."""
    sd, cam = worker.cornell()
    p0, p1 = worker.camera(cam), worker.camera(cam, moved=True)
    cfg4 = worker.config(4)

    def single(p, cur):
        return tfused.fused_pass_with_stats(sd, cfg4, p, cur, pool_size=worker.POOL)[0]

    accum, counts, sample_count, spp_pass = gloo_ranks[0]["config5"]
    want = worker.config5_flow(sd, worker.config(2), p0, p1, single, spp_pass)
    assert spp_pass == 4 and sample_count == want.sample_count
    assert torch.isfinite(accum).all()
    assert float((counts > spp_pass).float().mean()) > 0.7, "history lost on a tiny move"
    assert torch.equal(counts, want.pixel_counts)
    np.testing.assert_allclose(accum.numpy(), want.accum.numpy(), rtol=1e-4, atol=1e-5)


def test_profiling_utilities():
    """The mirror of ``tests/test_features.py::test_profiling_utilities``."""
    from unity_webgpu_pathtracer_torch.models.cornell import cornell_box
    from unity_webgpu_pathtracer_torch.utils.profiling import RenderStats, Timer, scene_summary

    scene, _ = cornell_box()
    data = scene.build("wide16", device="cpu")
    stats = scene_summary(data)
    assert stats["triangles"] == int(data.tris.shape[0])
    assert stats["hbm_bytes"] > 0
    rs = RenderStats()
    rs.update(1_000_000, 5_000_000, 0.8, 0.5)
    assert abs(rs.mrays_per_sec - 2.0) < 1e-6
    with Timer("t", log=None) as t:
        pass
    assert t.elapsed >= 0


def test_profiling_feeds_from_a_pass(cornell32, tmp_path):
    """RenderStats from the fused pass's device counters, Timer on its
    film, the trace written, and the summary's counts and bytes."""
    from unity_webgpu_pathtracer_torch.utils.profiling import RenderStats, Timer, scene_summary
    from unity_webgpu_pathtracer_torch.utils.profiling import trace

    sd, params, cfg = cornell32
    rs = RenderStats()
    with trace(str(tmp_path / "prof")), Timer("pass", log=None) as t:
        film, occ, rays, arr, _it = tfused.fused_pass_with_stats(sd, cfg, params, 0)
        t.sync_on = film
    rs.update(rays, arr, occ, t.elapsed)
    assert rs.passes == 1 and rs.rays == int(rays) and rs.occupancy == pytest.approx(float(occ))
    assert "rays in" in rs.summary()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    summary = scene_summary(sd)
    assert summary["hbm_bytes"] == sum(x.numel() * x.element_size() for x in sd
                                       if isinstance(x, torch.Tensor)) + sum(
        x.numel() * x.element_size() for x in sd.env)
    assert (summary["materials"], summary["instances"], summary["lights"]) == (
        sd.materials.shape[0], 0, 0)
