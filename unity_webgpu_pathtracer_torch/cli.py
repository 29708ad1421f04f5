"""Command-line renderer (``cli.py`` of the reference): ``render``,
``view``, ``animate`` and ``examples``.

Examples::

    python -m unity_webgpu_pathtracer_torch.cli render builtin:cornell \
        --spp 256 --size 512 --out cornell.png
    python -m unity_webgpu_pathtracer_torch.cli render builtin:brdf --env sky.hdr
    python -m unity_webgpu_pathtracer_torch.cli render model.glb --spp 64 \
        --integrator megakernel
    python -m unity_webgpu_pathtracer_torch.cli render builtin:quad --size 32 \
        --spp 4 --device cpu --out quad.png
    python -m unity_webgpu_pathtracer_torch.cli view builtin:cornell --reproject --port 8000
    python -m unity_webgpu_pathtracer_torch.cli animate builtin:tlas --orbit --bounce \
        --frames 8 --out frame.png
    python -m unity_webgpu_pathtracer_torch.cli examples

A scene is a builtin (``builtin:<name>``) or a model file (``.obj`` with
its ``.mtl``, ``.glb`` or ``.gltf``), framed by a camera fitted to its
bounds.  It renders on the CUDA device unless ``--device`` names another
(``cpu`` for the CPU); without a CUDA device it exits with an error.
``render``'s ``--integrator`` picks fused (the default), megakernel or
wavefront; ``--traversal`` wide16 (the default, kernel K1) or one of the
reference's other backends, in plain PyTorch: wide8, wide, wide2 and, for
megakernel and wavefront, mbvh, skip and the brute-force oracle; a
builtin's own choice (the reference's ``tlas`` asks for ``wide``) is kept
only where the port's builtin makes it (the port's ``tlas`` keeps wide16,
K1's two-level table).  ``view`` serves the browser viewer (``viewer.py``: fly camera,
material sliders, ``--reproject`` to carry the film through camera moves)
on ``--host``/``--port`` (0: an ephemeral port; the URL is printed) until
interrupted; ``animate`` writes ``stem-0000.png`` ... with an orbiting
camera (``--orbit``) and, on a TLAS scene, bouncing instances
(``--bounce``, ``Renderer.update_instance_transform``).  Both run the fused
integrator, ``view`` on the reference's ``view`` choices of ``--traversal``
(the fused ones: mbvh, skip and bruteforce have no fused route and exit
with the config's error), ``animate`` on wide, wide2, wide8 or wide16.
Every command sets ``has_normal_maps`` from the scene's materials (the
reference's ``view`` and ``animate`` leave it off).
"""

from __future__ import annotations

import argparse
import sys
import time

from unity_webgpu_pathtracer_torch.config import FUSED_TRAVERSALS, SKY_MODE_BASIC

# The reference's ``render``/``view`` choices (``bvh2`` is ``mbvh``'s
# alias in the config, not offered on the command line).
RENDER_TRAVERSALS = ("bruteforce", "mbvh", "skip", "wide", "wide2", "wide8", "wide16")

TONEMAPS = {"none": 0, "aces": 1, "filmic": 2, "reinhard": 3, "lottes": 4}


def _load_scene(spec: str):
    from unity_webgpu_pathtracer_torch.models.examples import EXAMPLES

    if spec.startswith("builtin:"):
        name = spec.split(":", 1)[1]
        if name not in EXAMPLES:
            raise SystemExit(f"unknown builtin '{name}'; try: {', '.join(EXAMPLES)}")
        return EXAMPLES[name]()
    # A model renders under the reference config's default sky (the basic
    # gradient; --env sets the HDRI).
    model_sky = dict(sky_mode=SKY_MODE_BASIC, has_environment_texture=False)
    if spec.endswith(".obj"):
        from unity_webgpu_pathtracer_torch.scene.obj import load_obj

        scene = load_obj(spec)
        return scene, _frame_camera(scene), model_sky
    if spec.endswith((".glb", ".gltf")):
        from unity_webgpu_pathtracer_torch.scene.gltf import load_gltf

        scene = load_gltf(spec)
        return scene, _frame_camera(scene), model_sky
    raise SystemExit(f"unrecognized scene spec: {spec}")


def _frame_camera(scene) -> dict:
    """Frame a loaded model from its world AABB (a 3/4 view that fits the
    whole bounding sphere at 40 deg vfov), overridable by --eye/--target."""
    import numpy as np

    lo, hi = scene.world_bounds()
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) / 2 or 1.0
    dist = radius / np.sin(np.radians(40.0) / 2) * 1.1
    d = np.array([0.55, 0.35, 0.76])
    d /= np.linalg.norm(d)
    return dict(eye=tuple(center + d * dist), target=tuple(center), fov_y_deg=40.0)


def _renderer(args, scene, cam: dict, overrides: dict, integrator: str,
              samples_per_pass: int):
    """A ``Renderer`` of ``scene`` at ``args.size``, ``args.bounces`` and
    ``args.traversal`` on ``args.device``, its features set from the
    scene (lights, textures, normal maps)."""
    from unity_webgpu_pathtracer_torch.api import Renderer
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    overrides = dict(overrides)
    overrides.setdefault("traversal", args.traversal)
    overrides["has_lights"] = bool(scene.lights) or overrides.get("has_lights", False)
    overrides["has_textures"] = bool(scene.textures) or overrides.get("has_textures", False)
    overrides["has_normal_maps"] = (
        overrides["has_textures"] and any(m.normal_texture >= 0 for m in scene.materials)
    ) or overrides.get("has_normal_maps", False)
    # The fused integrator's production cadence: 8 arrivals a transition.
    if integrator == "fused":
        overrides.setdefault("transition_every", 8)
    try:
        config = RenderConfig(width=args.size, height=args.size,
                              samples_per_pass=samples_per_pass, max_bounces=args.bounces,
                              integrator=integrator, **overrides)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    params = make_camera_params(width=config.width, height=config.height, device=args.device,
                                **cam)
    return Renderer(scene, config, params, device=args.device)


def cmd_render(args):
    import torch

    from unity_webgpu_pathtracer_torch.config import SKY_MODE_ENVIRONMENT, PostParams
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

    r = _renderer(args, scene, cam, overrides, args.integrator,
                  min(args.spp, args.spp_per_pass))

    t0 = time.time()
    passes = max(1, args.spp // r.config.samples_per_pass)
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


def cmd_view(args):
    """The browser viewer (``viewer.py``): a progressive render with a fly
    camera and material sliders (``FreeViewCamera.cs``,
    ``DisneyBRDFTest.cs``), served until interrupted or until its render
    loop ends (``Viewer.stop()``, or a failure, which is raised here).
    Returns the ``Viewer``."""
    from unity_webgpu_pathtracer_torch.config import PostParams
    from unity_webgpu_pathtracer_torch.viewer import Viewer, serve

    scene, cam, overrides = _load_scene(args.scene)
    r = _renderer(args, scene, cam, overrides, "fused", args.spp_per_pass)
    v = Viewer(r, cam, post=PostParams(mode=TONEMAPS[args.tonemap]), max_spp=args.max_spp,
               reproject=args.reproject)
    server = serve(v, host=args.host, port=args.port, block=False)
    print(f"http://{args.host}:{server.server_address[1]}/", file=sys.stderr, flush=True)
    try:
        v.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        v.stop()
    return v


def cmd_animate(args):
    """A frame sequence: an orbiting camera (``FreeViewCamera.cs``,
    headless) and/or instances bouncing on a TLAS scene (``Bounce.cs``:
    the TLAS rows re-emitted each frame); accumulation restarts each
    frame.  Writes ``stem-0000.png`` ...; returns the ``Renderer``."""
    import os

    import numpy as np

    from unity_webgpu_pathtracer_torch.config import PostParams
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    scene, cam, overrides = _load_scene(args.scene)
    r = _renderer(args, scene, cam, overrides, "fused", args.spp)
    width = height = args.size
    base, ext = os.path.splitext(args.out)
    ext = ext or ".png"
    eye0 = np.asarray(cam["eye"], np.float32)
    target = np.asarray(cam.get("target", (0, 0, 0)), np.float32)
    bounce_ids = list(range(len(scene.instances) - 1)) if args.bounce else []

    for f in range(args.frames):
        phase = 2.0 * np.pi * f / max(args.frames, 1)
        if args.orbit:
            rel = eye0 - target
            c, s = np.cos(phase), np.sin(phase)
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            eye = target + rot @ rel
            r.update_camera(make_camera_params(
                width=width, height=height, device=r.device,
                **{**cam, "eye": tuple(float(x) for x in eye)}))
        for i in bounce_ids:
            _mid, t0, _m = scene.instances[i]
            t = np.array(t0, np.float32)
            t[1, 3] = 0.4 + abs(np.sin(phase + i)) * 1.2
            r.update_instance_transform(i, t)
        r.render(1)
        path = f"{base}-{f:04d}{ext}"
        r.save_png(path, PostParams(mode=TONEMAPS[args.tonemap]))
        print(path, file=sys.stderr)
    print(f"{base}-0000{ext} .. {base}-{args.frames - 1:04d}{ext}")
    return r


def cmd_examples(_args):
    from unity_webgpu_pathtracer_torch.models.examples import EXAMPLES

    for name in EXAMPLES:
        print(f"builtin:{name}")


def main(argv=None):
    """Parse ``argv`` and run the command; ``render`` and ``animate``
    return their ``Renderer``, ``view`` its ``Viewer`` (callers in-process
    read their statistics)."""
    p = argparse.ArgumentParser(prog="unity_webgpu_pathtracer_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("scene", help="builtin:<name> | path.obj | path.glb | path.gltf")
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--size", type=int, default=512)
    pr.add_argument("--spp", type=int, default=64)
    pr.add_argument("--spp-per-pass", type=int, default=4)
    pr.add_argument("--bounces", type=int, default=5)
    pr.add_argument("--integrator", default="fused",
                    choices=["megakernel", "wavefront", "fused"])
    pr.add_argument("--traversal", default="wide16", choices=RENDER_TRAVERSALS,
                    help="mbvh, skip and bruteforce run under megakernel and wavefront only")
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

    pv = sub.add_parser("view", help="interactive browser viewer "
                                     "(fly camera + material sliders)")
    pv.add_argument("scene", help="builtin:<name> | path.obj | path.glb | path.gltf")
    pv.add_argument("--size", type=int, default=256)
    pv.add_argument("--spp-per-pass", type=int, default=2)
    pv.add_argument("--max-spp", type=int, default=4096)
    pv.add_argument("--bounces", type=int, default=4)
    pv.add_argument("--traversal", default="wide16", choices=RENDER_TRAVERSALS)
    pv.add_argument("--tonemap", default="aces", choices=list(TONEMAPS))
    pv.add_argument("--reproject", action="store_true",
                    help="fly-cam moves warp accumulated history "
                         "(temporal reprojection) instead of resetting")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8000, help="0: an ephemeral port")
    pv.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    pv.set_defaults(fn=cmd_view)

    pa = sub.add_parser("animate",
                        help="render a frame sequence (orbit camera / bounce instances)")
    pa.add_argument("scene", help="builtin:<name> | path.obj | path.glb | path.gltf")
    pa.add_argument("--out", default="frame.png",
                    help="frame path stem; writes stem-0000.png ...")
    pa.add_argument("--frames", type=int, default=8)
    pa.add_argument("--size", type=int, default=256)
    pa.add_argument("--spp", type=int, default=8)
    pa.add_argument("--bounces", type=int, default=4)
    pa.add_argument("--traversal", default="wide16", choices=FUSED_TRAVERSALS)
    pa.add_argument("--orbit", action="store_true",
                    help="orbit the camera around the target per frame")
    pa.add_argument("--bounce", action="store_true",
                    help="animate instance heights (TLAS scenes; Bounce.cs)")
    pa.add_argument("--tonemap", default="aces", choices=list(TONEMAPS))
    pa.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    pa.set_defaults(fn=cmd_animate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
