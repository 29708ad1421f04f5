"""Multi-GPU rendering over a (tile, spp) grid of ranks
(``parallel/film_tiling.py`` of the reference).

Two orthogonal axes, as in the reference:

* ``tile``: the film's pixels are cut into ``n_tile`` contiguous ranges
  and each rank traces only its own.  The scene tables are replicated on
  every rank's device; nothing is communicated until the film is
  assembled (an all-gather over the tile axis, in tile order).
* ``spp``: samples are sharded.  The ranks of one tile render the same
  pixels with disjoint sample ranges, and their films are summed (an
  all-reduce over the spp axis).

The reference runs both as one ``shard_map`` program with XLA's
collectives.  Here each rank is a process of the ``torch.distributed``
process group that the caller has initialised (``torchrun`` with NCCL,
one rank per card; gloo for several ranks on one card or on the CPU), and
the collectives are explicit calls over the two axes' groups.  Seeds stay
keyed by the global (pixel, sample), so a tile-sharded film is the single
pass's film, and a sample-sharded film sums the same samples in another
association (a few ulps).

Collectives run on the tensors' own device: NCCL's on the card, and
gloo's too (PyTorch 2.11's gloo takes CUDA tensors for all_reduce and
all_gather, measured on the H100; ``PERF.md`` §6).  The film's all-gather
goes into a list of tiles, which every backend takes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from unity_webgpu_pathtracer_torch.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_torch.render.fused import fused_pass_with_stats
from unity_webgpu_pathtracer_torch.render.integrator import render_pass


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (tile, spp) grid of ranks ``0 .. n_tile *
    n_spp - 1`` (rank ``tile * n_spp + spp``, the reference's device
    order), and the groups of its two axes."""

    shape: dict          # {"tile": n_tile, "spp": n_spp}
    tile: int            # this rank's tile index
    spp: int             # this rank's sample-block index
    tile_group: object   # the ranks of this sample block, in tile order
    spp_group: object    # the ranks of this tile


def make_mesh(n_tile: int, n_spp: int = 1) -> Mesh | None:
    """The (tile, spp) grid over the initialised default process group.

    Every rank of the group must call it (each axis group is created on
    every rank, in the same order).  Raises ``ValueError`` when the group
    has fewer than ``n_tile * n_spp`` ranks; a rank past the grid gets
    None."""
    need = n_tile * n_spp
    have = dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} devices, have {have}")
    spp_groups = [dist.new_group([t * n_spp + s for s in range(n_spp)]) for t in range(n_tile)]
    tile_groups = [dist.new_group([t * n_spp + s for t in range(n_tile)]) for s in range(n_spp)]
    rank = dist.get_rank()
    if rank >= need:
        return None
    t, s = divmod(rank, n_spp)
    return Mesh({"tile": n_tile, "spp": n_spp}, t, s, tile_groups[s], spp_groups[t])


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, in place (the reference's
    ``psum``); a group of one rank leaves it as it is."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def _gather_tiles(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in the group's rank order
    (the reference's ``all_gather``), on ``x``'s device."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def _tile_pixels(config: RenderConfig, mesh: Mesh) -> int:
    npix = config.pixel_count()
    if npix % mesh.shape["tile"]:
        raise ValueError(f"pixel count {npix} must divide the tile axis "
                         f"({mesh.shape['tile']} tiles)")
    return npix // mesh.shape["tile"]


def multichip_render_pass(scene, config: RenderConfig, params: RenderParams,
                          current_sample: int, mesh: Mesh) -> torch.Tensor:
    """One megakernel pass (``render/integrator.py::render_pass``) sharded
    over ``mesh``: this rank renders its tile's pixels with samples from
    ``current_sample + spp * samples_per_pass``.

    Returns the full film's radiance sum (npix, 3), the same on every rank,
    over the pass's ``samples_per_pass * n_spp`` samples; the caller's
    accumulation counts that many (``multichip_samples_per_pass``)."""
    npix_l = _tile_pixels(config, mesh)
    pixels = torch.arange(mesh.tile * npix_l, (mesh.tile + 1) * npix_l, dtype=torch.int64,
                          device=scene.attr_normals.device)
    tile_sum = render_pass(scene, config, params,
                           current_sample + mesh.spp * config.samples_per_pass,
                           pixel_indices=pixels)
    return _gather_tiles(_sum_over(tile_sum.contiguous(), mesh.spp_group), mesh.tile_group)


def multichip_samples_per_pass(config: RenderConfig, mesh: Mesh) -> int:
    return config.samples_per_pass * mesh.shape["spp"]


def multichip_fused_pass(scene, config: RenderConfig, params: RenderParams,
                         current_sample: int, mesh: Mesh, pool_size: int | None = None):
    """One fused-wavefront pass sharded over ``mesh``: this rank runs its own
    work queue over its tile's pixels and its block of
    ``samples_per_pass`` samples (``fused_pass_with_stats(shard=...)``).

    Returns ``(film (npix, 3), occupancy, rays, arrivals,
    super_iterations)``: the film, the same on every rank, sums
    ``samples_per_pass * n_spp`` samples a pixel; occupancy is the mean of
    the ranks', rays and arrivals their sums (device tensors, as the
    single pass returns them), and the super-iterations this rank's own."""
    npix_l = _tile_pixels(config, mesh)
    spp_l = config.samples_per_pass
    film, occ, rays, arr, iters = fused_pass_with_stats(
        scene, config, params, current_sample, pool_size=pool_size,
        shard=(mesh.tile * npix_l, npix_l, mesh.spp * spp_l, spp_l))
    film = _gather_tiles(_sum_over(film.contiguous(), mesh.spp_group), mesh.tile_group)
    # One reduction a group for the three counters: f64 holds the int64
    # counts exactly (below 2^53).
    stats = torch.stack([occ.to(torch.float64), rays.to(torch.float64),
                         arr.to(torch.float64)])
    stats = _sum_over(_sum_over(stats, mesh.spp_group), mesh.tile_group)
    n = mesh.shape["tile"] * mesh.shape["spp"]
    return (film, (stats[0] / n).to(torch.float32), stats[1].to(torch.int64),
            stats[2].to(torch.int64), iters)
