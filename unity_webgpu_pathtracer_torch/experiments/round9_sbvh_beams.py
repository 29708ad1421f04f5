"""Tree quality A/B on the beams (``experiments/round9_sbvh_beams.py`` of
the reference): ``models/benchmark.py::beam_scene``, long thin quads
crossing a cube, the workload class where spatial splits pay.

``round6_sbvh_ab.ab`` on that scene: full 1920x1080 passes of the fused
main path (K1 + K2) at each quality, one throwaway pass, seeds varied,
the qualities alternated A/B/A/B, the minimum of the timed passes kept.

    python -m unity_webgpu_pathtracer_torch.experiments.round9_sbvh_beams

Env, as the reference reads them: BEAM_TRIS (default 400k), SPP (8), TE
(8), POOL (262,144).
"""

from __future__ import annotations

import os

from unity_webgpu_pathtracer_torch.experiments._common import cuda_device
from unity_webgpu_pathtracer_torch.experiments.round6_sbvh_ab import ab, card

TRIS = int(os.environ.get("BEAM_TRIS", 400_000))
SPP = int(os.environ.get("SPP", 8))
TE = int(os.environ.get("TE", 8))
POOL = int(os.environ.get("POOL", 262_144))
SEED = 0xBEA7


def run(qualities=(0, 1), device=None, **kw) -> dict:
    """``ab`` on ``beam_scene(TRIS)`` on the card, at this script's
    settings unless ``kw`` names others."""
    from unity_webgpu_pathtracer_torch.models.benchmark import beam_scene

    dev = cuda_device(device)
    scene, cam = beam_scene(TRIS)
    kw = dict(dict(spp=SPP, te=TE, pool=POOL, seed=SEED), **kw)
    return ab(scene, cam, qualities, dev, **kw)


def main() -> None:
    from unity_webgpu_pathtracer_torch.ops import cuda_build

    cuda_build.load()
    print(f"BEAM_TRIS={TRIS} SPP={SPP} TE={TE} POOL={POOL}; card: {card()}", flush=True)
    run(log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
