"""A scene file that carries textures and analytic lights: the harness
hands both to the port (``port.port_scene``) and to the reference
(``reference/scene.py``), and the megakernel's check passes on a tiny lit,
textured scene with normal maps; with the lights or the textures dropped
from the reference alone, it fails.  Without either, the scene's tables are
what they were."""

import copy

import pytest
import torch

from pt_bench import check, port, scenes
from pt_bench.reference import camera as rcamera
from pt_bench.reference import config as rconfig
from pt_bench.reference import render as rrender
from pt_bench.reference import scene as rscene
from pt_bench.tests.tiny import OVERRIDES, SEED, cell
from pt_bench.run import seed_root

W = H = 16
PASSES = 2
CPU = torch.device("cpu")


def _config() -> dict:
    base = cell("grid1m.mega_1spp")
    cfg = copy.deepcopy({**base.config, **OVERRIDES["config"]})
    cfg["hdri_height"] = 16
    cfg["textures"] = [
        {"kind": "checker", "size": 32, "cells": 8,
         "colors": [[0.9, 0.9, 0.9, 1.0], [0.1, 0.3, 0.8, 1.0]]},
        {"kind": "bumps", "size": 32, "cells": 4, "strength": 1.0}]
    for m in cfg["materials"]:
        m["base_color_texture"] = 0
        m["normal_texture"] = 1
    cfg["lights"] = [
        {"type": 3, "position": [0.0, 3.0, 0.0], "color": [1.0, 0.9, 0.8], "intensity": 40.0,
         "size": [2.0, 2.0], "right": [1.0, 0.0, 0.0], "up": [0.0, 0.0, 1.0]},
        {"type": 2, "position": [1.5, 2.0, 1.5], "color": [1.0, 0.4, 0.2], "intensity": 60.0},
        {"type": 0, "position": [-1.5, 2.5, 0.0], "color": [0.3, 1.0, 0.4], "intensity": 80.0,
         "forward": [0.3, -1.0, 0.0], "spot_angle": 70.0, "inner_spot_angle": 40.0}]
    cfg["render"] = dict(cfg["render"], has_lights=True, has_textures=True,
                         has_normal_maps=True)
    return cfg


@pytest.fixture(scope="module")
def rendered():
    """The port's film after two megakernel passes at 16x16, at the checked
    pixels, with the scene and the pixels."""
    cfg = _config()
    spec = scenes.generate(cfg)
    traffic = dict(cell("grid1m.mega_1spp").traffic, width=W, height=H)
    pr = port.PortRenderer(spec, cfg, traffic, W, H, seed_root(SEED), CPU)
    assert pr.scene.lights.shape[0] == 3 and pr.scene.texture_data.shape[0] > 0
    for _ in range(PASSES):
        pr.step()
    pix = torch.from_numpy(check.sample_pixels(SEED, W * H, 64))
    return cfg, spec, pr.film.reshape(-1, 3)[pix].clone(), pix


def _numbers(cfg, spec, film_px, pix) -> dict:
    rs = rscene.build(spec, CPU)
    rc = rconfig.RenderConfig(width=W, height=H, samples_per_pass=1, integrator="megakernel",
                              **cfg["render"])
    rp = rcamera.make_camera_params(width=W, height=H, seed_root=seed_root(SEED), device=CPU,
                                    **spec.camera)
    return check.film_numbers(film_px, rrender.film_at(rs, rc, rp, pix, PASSES))


def test_lit_textured_scene_passes_the_check(rendered):
    cfg, spec, film_px, pix = rendered
    correct, report = check.judge(_numbers(cfg, spec, film_px, pix),
                                  cell("grid1m.mega_1spp").check["limits"])
    assert correct, report


@pytest.mark.parametrize("drop", ["lights", "textures"])
def test_reference_without_them_fails_the_check(rendered, drop):
    cfg, spec, film_px, pix = rendered
    spec = copy.copy(spec)
    setattr(spec, drop, [])
    correct, report = check.judge(_numbers(cfg, spec, film_px, pix),
                                  cell("grid1m.mega_1spp").check["limits"])
    assert not correct, report


@pytest.mark.parametrize("name", ["grid1m", "tlas_grid1m"])
def test_scene_without_them_keeps_its_tables(name):
    """The benchmark's configurations name no texture and no light: their
    scene's textures and lights are empty, the reference's tables the empty
    ones of old, and the port's scene adds none."""
    from pt_bench.tests.tiny import manifest
    from pt_bench import registry

    cname = {"grid1m": "grid1m.mega_1spp", "tlas_grid1m": "tlas_grid1m.mega_1spp"}[name]
    cfg = {**registry.cell(manifest(), cname).config, **OVERRIDES["config"]}
    spec = scenes.generate(cfg)
    assert spec.textures == [] and spec.lights == []
    rs = rscene.build(spec, CPU)
    assert rs.texture_data.dtype == torch.float32 and rs.texture_data.shape == (0,)
    assert rs.lights.dtype == torch.float32 and rs.lights.shape == (0, 16)
    host = port.port_scene(spec)
    assert host.textures == [] and host.lights == []
