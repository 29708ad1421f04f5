"""A cell's path at a size the CPU runs in a test: the configuration's
shapes with 9 spheres of 528 triangles, a 48x27 film, 64 checked pixels."""

import os
import time

import torch

from pt_bench import registry, run

ROOT = os.path.dirname(registry.BENCH_DIR)
OVERRIDES = dict(config=dict(target_tris=528 * 9, sphere=dict(radius=0.45, stacks=12, slices=24)),
                 traffic=dict(width=48, height=27, check_pixels=64, trace_passes=2))
SEED = 2**31 + 977


def manifest() -> dict:
    return registry.load_manifest(ROOT)


def cells():
    return [w["name"] for w in manifest()["workloads"]]


def cell(name):
    return registry.cell(manifest(), name)


def run_tiny(name, trace=False, seconds=0.5, seed=SEED):
    """``run.run_cell`` on the CPU at the tiny size: (result, stderr lines)."""
    lines = []
    result = run.run_cell(cell(name), seed, seconds, trace, torch.device("cpu"),
                          log=lines.append, overrides=OVERRIDES,
                          t_start=time.perf_counter())
    return result, lines
