"""The control of each cell's check, at a test's size: the reference in
bfloat16 put in the program's place comes out not correct, and, for a fused
cell, the program's own answers on the same inputs come out correct."""

import pytest
import torch

from pt_bench import check, control
from pt_bench.tests.tiny import SEED, cell, cells, fused, overrides


@pytest.mark.parametrize("name", [n for n in cells() if not fused(n)])
def test_bf16_reference_fails_the_check(name):
    c = cell(name)
    numbers = control.control_numbers(c, SEED, 3, torch.device("cpu"), overrides(name))
    correct, report = check.judge(numbers, c.check["limits"])
    assert not correct, report
    assert numbers["px_err_median"] > c.check["limits"]["px_err_median"]


@pytest.mark.parametrize("name", [n for n in cells() if fused(n)])
def test_bf16_replay_fails_the_fused_check(name):
    c = cell(name)
    program, numbers = control.fused_numbers(c, SEED, 2, torch.device("cpu"), overrides(name))
    assert check.judge(program, c.check["limits"])[0], program
    correct, report = check.judge(numbers, c.check["limits"])
    assert not correct, report
    # Each part of the check: K1's hits, K2's outputs, the new samples'
    # rays, the records, the film.
    for k in ("k1_hit_off_share", "k2_off_share", "regen_ray_gap_max", "rec_gap_max",
              "film_gap_max"):
        assert numbers[k] > c.check["limits"][k], (k, numbers[k])
