"""The control of a cell's check: the plain reference computed in bfloat16
put in the program's place, judged by the same numbers against the float32
reference, at the cell's own size.

    python3 -m pt_bench.control --workload <cell> --passes <n> --seeds <s> [<s> ...]

``--passes`` is the number of passes the cell's window renders (the film's
samples a pixel).  Prints one JSON line a seed with the numbers and the
cell's limits; the benchmark's own runs never run this.  The control's
film is the bfloat16 reference's (geometry, ray casts and the path state
between bounces in bfloat16); its image is the presentation computed in
bfloat16 of the float32 reference's film, at the sampled pixels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from pt_bench import check, registry, scenes
from pt_bench.reference import camera as rcamera
from pt_bench.reference import config as rconfig
from pt_bench.reference import render as rrender
from pt_bench.reference import scene as rscene
from pt_bench.reference import tonemap
from pt_bench.run import seed_root

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def present_lsb(film_px: torch.Tensor, dtype) -> np.ndarray:
    """uint8 presentation of (P, 3) radiance computed in ``dtype``."""
    out = torch.clamp(tonemap.present(film_px.to(dtype)[None], rconfig.PostParams()),
                      0.0, 1.0) * 255 + 0.5
    return out.float().to(torch.uint8)[0].cpu().numpy().astype(np.int16)


def control_numbers(cell, seed: int, passes: int, device, overrides=None) -> dict:
    """The check's numbers with the bfloat16 reference as the program."""
    ov = overrides or {}
    cfg = {**cell.config, **ov.get("config", {})}
    traffic = {**cell.traffic, **ov.get("traffic", {})}
    w, h = traffic["width"], traffic["height"]
    spec = scenes.generate(cfg)
    rs = rscene.build(spec, device)
    rc = rconfig.RenderConfig(width=w, height=h, samples_per_pass=traffic["samples_per_pass"],
                              integrator="megakernel", **cfg["render"])
    rp = rcamera.make_camera_params(width=w, height=h, seed_root=seed_root(seed),
                                    device=device, **spec.camera)
    pix = torch.from_numpy(check.sample_pixels(seed, w * h, int(traffic["check_pixels"])))
    pix = pix.to(device)
    ref = rrender.film_at(rs, rc, rp, pix, passes)
    low = rrender.film_at(rs, rc, rp, pix, passes, torch.bfloat16)
    numbers = check.film_numbers(low, ref)
    if traffic["present"]:
        numbers["image_lsb_max"] = float(np.abs(present_lsb(ref, torch.bfloat16)
                                                - present_lsb(ref, torch.float32)).max())
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--passes", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = registry.cell(registry.load_manifest(ROOT), args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        numbers = control_numbers(cell, seed, args.passes, device)
        correct, report = check.judge(numbers, cell.check["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "passes": args.passes,
                          "correct": correct, "check": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
