"""Command-line renderer (``cli.py`` of the reference): ``render`` and
``examples``.

Examples::

    python -m unity_webgpu_pathtracer_torch.cli render builtin:cornell \
        --spp 256 --size 512 --out cornell.png
    python -m unity_webgpu_pathtracer_torch.cli render builtin:brdf --env sky.hdr
    python -m unity_webgpu_pathtracer_torch.cli render builtin:quad --size 32 \
        --spp 4 --device cpu --out quad.png
    python -m unity_webgpu_pathtracer_torch.cli examples

It renders on the CUDA device unless ``--device`` names another (``cpu``
for the CPU); without a CUDA device it exits with an error.  The OBJ and
glTF loaders, the ``view`` and ``animate`` commands and the reference's
other integrators and traversal backends are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time

TONEMAPS = {"none": 0, "aces": 1, "filmic": 2, "reinhard": 3, "lottes": 4}


def _load_scene(spec: str):
    from unity_webgpu_pathtracer_torch.models.examples import EXAMPLES

    if spec.startswith("builtin:"):
        name = spec.split(":", 1)[1]
        if name not in EXAMPLES:
            raise SystemExit(f"unknown builtin '{name}'; try: {', '.join(EXAMPLES)}")
        return EXAMPLES[name]()
    if spec.endswith((".obj", ".glb", ".gltf")):
        raise SystemExit(f"{spec}: the OBJ and glTF loaders (scene/obj.py, scene/gltf.py) are "
                         "not ported to the PyTorch package yet; render a builtin:<name> scene")
    raise SystemExit(f"unrecognized scene spec: {spec}")


def cmd_render(args):
    import torch

    from unity_webgpu_pathtracer_torch.api import Renderer
    from unity_webgpu_pathtracer_torch.config import SKY_MODE_ENVIRONMENT, PostParams, RenderConfig
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
    from unity_webgpu_pathtracer_torch.utils.image import read_hdr

    scene, cam, overrides = _load_scene(args.scene)
    if args.env:
        scene.set_environment(read_hdr(args.env))
        overrides = dict(overrides, sky_mode=SKY_MODE_ENVIRONMENT, has_environment_texture=True)
    if args.eye:
        cam["eye"] = tuple(float(x) for x in args.eye.split(","))
    if args.target:
        cam["target"] = tuple(float(x) for x in args.target.split(","))
    if args.fov:
        cam["fov_y_deg"] = args.fov

    overrides = dict(overrides)
    overrides["has_lights"] = bool(scene.lights) or overrides.get("has_lights", False)
    overrides["has_textures"] = bool(scene.textures) or overrides.get("has_textures", False)
    overrides["has_normal_maps"] = (
        overrides["has_textures"] and any(m.normal_texture >= 0 for m in scene.materials)
    ) or overrides.get("has_normal_maps", False)
    # The production cadence: 8 arrivals a transition.
    overrides.setdefault("transition_every", 8)
    config = RenderConfig(width=args.size, height=args.size,
                          samples_per_pass=min(args.spp, args.spp_per_pass),
                          max_bounces=args.bounces, **overrides)
    params = make_camera_params(width=config.width, height=config.height, device=args.device,
                                **cam)
    r = Renderer(scene, config, params, device=args.device)

    t0 = time.time()
    passes = max(1, args.spp // config.samples_per_pass)
    for i in range(passes):
        r.step()
        if args.verbose:
            print(f"pass {i + 1}/{passes} ({r.sample_count} spp, "
                  f"{time.time() - t0:.1f}s)", file=sys.stderr)
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    print(f"rendered {r.sample_count} spp in {time.time() - t0:.1f}s", file=sys.stderr)

    r.save_png(args.out, PostParams(mode=TONEMAPS[args.tonemap], exposure=args.exposure))
    print(args.out)
    return r


def cmd_examples(_args):
    from unity_webgpu_pathtracer_torch.models.examples import EXAMPLES

    for name in EXAMPLES:
        print(f"builtin:{name}")


def main(argv=None):
    """Parse ``argv`` and run the command; ``render`` returns its
    ``Renderer`` (callers in-process read its statistics)."""
    p = argparse.ArgumentParser(prog="unity_webgpu_pathtracer_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("scene", help="builtin:<name>")
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--size", type=int, default=512)
    pr.add_argument("--spp", type=int, default=64)
    pr.add_argument("--spp-per-pass", type=int, default=4)
    pr.add_argument("--bounces", type=int, default=5)
    pr.add_argument("--env", help="HDRI .hdr environment map")
    pr.add_argument("--tonemap", default="aces", choices=list(TONEMAPS))
    pr.add_argument("--exposure", type=float, default=1.0)
    pr.add_argument("--eye", help="camera eye 'x,y,z'")
    pr.add_argument("--target", help="camera target 'x,y,z'")
    pr.add_argument("--fov", type=float)
    pr.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    pr.add_argument("-v", "--verbose", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pe = sub.add_parser("examples", help="list builtin scenes")
    pe.set_defaults(fn=cmd_examples)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
