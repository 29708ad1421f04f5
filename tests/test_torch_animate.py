"""``cli animate`` of the port against the reference's, on the CPU.

- ``animate builtin:cornell --orbit``, 2 frames at 32x32, 1 spp: each
  frame's PNG against the reference's frame (uint8; within one level on
  >= 99% of pixels; the passes agree to ~1e-6, so a level flips only
  where a value sits on a rounding edge).
- ``animate builtin:tlas --orbit --bounce``: the frames differ, the
  instances are seen (the reference's wide16 build of an instanced scene
  sees only the sky; ROADMAP.md queue 3), and after the last frame the
  port's node table and instance transforms are byte-identical to the
  reference's two-level build (``Scene._build_instanced_wide16``) after
  the same ``set_instance_transform`` calls.
- Without a CUDA device ``animate`` and ``view`` raise unless given
  ``--device cpu``.
"""

import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch import cli as tcli
from unity_webgpu_pathtracer_torch.render.reproject import primary_depth
from unity_webgpu_pathtracer_torch.utils.image import read_png
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE
from unity_webgpu_pathtracer_tpu import cli as jcli
from unity_webgpu_pathtracer_tpu.models import examples as jexamples

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _frames(stem, n):
    return [read_png(f"{stem}-{i:04d}.png") for i in range(n)]


def test_animate_orbit_matches_reference(tmp_path, capsys):
    args = ["builtin:cornell", "--orbit", "--frames", "2", "--size", "32", "--spp", "1"]
    jcli.main(["animate", *args, "--out", str(tmp_path / "j.png")])
    r = tcli.main(["animate", *args, "--device", "cpu", "--out", str(tmp_path / "t.png")])
    assert capsys.readouterr().out.strip().endswith("t-0001.png")
    want, got = _frames(tmp_path / "j", 2), _frames(tmp_path / "t", 2)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == np.uint8 and g.shape == (32, 32, 3)
        diff = np.abs(g.astype(np.int16) - w.astype(np.int16)).max(-1)
        print(f"frame {i}: {int((diff > 1).sum())} of {diff.size} pixels more than one level "
              f"off, max {diff.max()}")
        assert (diff <= 1).mean() >= 0.99
    np.testing.assert_array_equal(got[1], r.image())
    # Half a turn round the open box: its unlit back (sky mode none).
    assert got[0].mean() > 1 and got[1].max() == 0


def test_animate_bounce_rows_match_reference(tmp_path):
    frames = 2
    r = tcli.main(["animate", "builtin:tlas", "--orbit", "--bounce", "--frames", str(frames),
                   "--size", "32", "--spp", "1", "--bounces", "2", "--device", "cpu",
                   "--out", str(tmp_path / "f.png")])
    a, b = _frames(tmp_path / "f", frames)
    assert np.abs(a.astype(np.int16) - b).max() > 0
    hits = primary_depth(r.scene, r.config, r.params) < FAR_PLANE
    assert hits.float().mean() > 0.2, "the instances and the floor are seen"
    # The reference's two-level tables after the same transforms.
    jscene, _cam, _over = jexamples.tlas_scene()
    phase = 2.0 * np.pi * (frames - 1) / frames
    for i in range(len(jscene.instances) - 1):
        t = np.array(jscene.instances[i][1], np.float32)
        t[1, 3] = 0.4 + abs(np.sin(phase + i)) * 1.2
        jscene.set_instance_transform(i, t)
    want = jscene._build_instanced_wide16()
    for f in ("wide16_nodes", "inst_l2w", "inst_w2l"):
        g, w = getattr(r.scene, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), f


@pytest.mark.parametrize("cmd", ["animate", "view"])
def test_commands_run_on_the_card_by_default(cmd, tmp_path, monkeypatch):
    """Without a CUDA device, ``animate`` and ``view`` raise unless given
    ``--device cpu``; neither writes a frame or opens a port first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [cmd, "builtin:quad", "--size", "8", "--port", "0"] if cmd == "view" else \
        [cmd, "builtin:quad", "--size", "8", "--frames", "1", "--out", str(tmp_path / "f.png")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
    assert not list(tmp_path.iterdir())
