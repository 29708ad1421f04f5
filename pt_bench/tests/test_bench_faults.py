"""A run with its timed path broken underneath comes out not correct, for
each fault a cell can have: a pass that leaves the film unchanged, half of
the samples left out with the mean taken over the rest, and a pixel value
altered where the pass produces it; in a fused cell also a transition that
advances a lane's PCG state once more, a BSDF lobe weight off by 1%, a new
sample that keeps the last sample's radiance, and every sample of a pixel
seeded alike."""

import pytest
import torch

from unity_webgpu_pathtracer_torch.ops import cuda_transition
from unity_webgpu_pathtracer_torch.render import bsdf
from unity_webgpu_pathtracer_torch.render import film as ufilm
from unity_webgpu_pathtracer_torch.render import fused as ufused
from unity_webgpu_pathtracer_torch.utils import rng as urng

from pt_bench.tests.tiny import cells, fused, run_tiny

ACCUMULATE = ufilm.accumulate
TRANSITION = cuda_transition.transition16_plain
LOBES = bsdf.lobe_probabilities
REGENERATE = ufused._record_and_regenerate
SEED = urng.seed


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


def _pcg_stepped_once_more(monkeypatch):
    """K2 (its plain version, which runs on the CPU) steps every lane's PCG
    state once more than it draws."""
    def stepped(scene, config, params, st):
        out = TRANSITION(scene, config, params, st)
        st.rng.copy_(urng.next_state(st.rng))
        return out

    monkeypatch.setattr(cuda_transition, "transition16_plain", stepped)


def _lobe_weight_off(monkeypatch):
    """The dielectric lobe's weight 1% high in every BSDF evaluation and
    sample."""
    def lobes(mat, v):
        probs, (dielectric, metal, glass), rest = LOBES(mat, v)
        return probs, (dielectric * 1.01, metal, glass), rest

    monkeypatch.setattr(bsdf, "lobe_probabilities", lobes)


def _new_sample_keeps_radiance(monkeypatch):
    """A lane that starts a new sample keeps the radiance it held (its last
    sample's) instead of starting from none."""
    def keeps(config, params, s, budget, current_sample, died, rad_out):
        dead, radiance = s.mode == ufused.MODE_DEAD, s.radiance
        REGENERATE(config, params, s, budget, current_sample, died, rad_out)
        s.radiance = torch.where(dead & (s.mode != ufused.MODE_DEAD), radiance, s.radiance)

    monkeypatch.setattr(ufused, "_record_and_regenerate", keeps)


def _samples_seeded_alike(monkeypatch):
    """Every sample of a pixel gets the PCG seed of its first."""
    monkeypatch.setattr(urng, "seed", lambda pixel, sample, root: SEED(pixel, 0, root))


FILM_FAULTS = (_unchanged, _half_left_out, _altered)
FUSED_FAULTS = (_pcg_stepped_once_more, _lobe_weight_off, _new_sample_keeps_radiance,
                _samples_seeded_alike)
CASES = [(name, fault) for name in cells()
         for fault in FILM_FAULTS + (FUSED_FAULTS if fused(name) else ())]


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
