"""A run with its timed path broken underneath comes out not correct, for
each fault a cell can have: a pass that leaves the film unchanged, half of
the samples left out with the mean taken over the rest, and a pixel value
altered where the pass produces it."""

import pytest

from unity_webgpu_pathtracer_torch.render import film as ufilm

from pt_bench.tests.tiny import cells, run_tiny

ACCUMULATE = ufilm.accumulate


def _unchanged(monkeypatch):
    monkeypatch.setattr(ufilm, "accumulate", lambda film, pass_sum, samples: film)


def _half_left_out(monkeypatch):
    calls = {"n": 0}

    def every_other(film, pass_sum, samples):
        calls["n"] += 1
        return ACCUMULATE(film, pass_sum, samples) if calls["n"] % 2 == 0 else film

    monkeypatch.setattr(ufilm, "accumulate", every_other)


def _altered(monkeypatch):
    monkeypatch.setattr(ufilm, "accumulate",
                        lambda film, pass_sum, samples: ACCUMULATE(film, pass_sum * 1.01,
                                                                   samples))


CASES = [(name, fault) for name in cells() for fault in (_unchanged, _half_left_out, _altered)]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    # At least two passes in the window, however loaded the host is.
    seconds = 6.0
    result, _lines = run_tiny(name, seconds=seconds)
    while result["attempted"] < 2 and seconds < 100:
        seconds *= 4
        result, _lines = run_tiny(name, seconds=seconds)
    assert result["attempted"] >= 2
    assert result["correct"] is False, result["check"]
