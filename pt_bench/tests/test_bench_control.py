"""The control of each cell's check, at a test's size: the reference in
bfloat16 put in the program's place comes out not correct."""

import pytest
import torch

from pt_bench import check, control
from pt_bench.tests.tiny import OVERRIDES, SEED, cell, cells


@pytest.mark.parametrize("name", cells())
def test_bf16_reference_fails_the_check(name):
    c = cell(name)
    numbers = control.control_numbers(c, SEED, 3, torch.device("cpu"), OVERRIDES)
    correct, report = check.judge(numbers, c.check["limits"])
    assert not correct, report
    assert numbers["px_err_median"] > c.check["limits"]["px_err_median"]
