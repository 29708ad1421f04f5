"""The port's browser viewer (``viewer.py``) through its real server on an
ephemeral port, on the CPU at 24x24, and ``cli view`` started in process
and stopped.  The reference's viewer tests (``tests/test_viewer.py``)
race the render loop against the POST; here ``max_spp`` caps the loop so
that it idles, and each check waits for ``Viewer.passes`` and the sample
count to settle.  ``/state`` has the reference's keys and values on the
same scene, and the page is the reference's.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch import cli as tcli
from unity_webgpu_pathtracer_torch import viewer as tviewer
from unity_webgpu_pathtracer_torch.api import Renderer
from unity_webgpu_pathtracer_torch.config import RenderConfig
from unity_webgpu_pathtracer_torch.models.cornell import cornell_box
from unity_webgpu_pathtracer_torch.models.examples import tlas_scene
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
from unity_webgpu_pathtracer_torch.utils.image import decode_png

torch.set_num_threads(2)

SIZE = 24
MAX_SPP = 4      # two passes of 2, then the loop idles


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.read(), r.headers.get("Content-Type")


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _status(fn, *a) -> int:
    try:
        fn(*a)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def _renderer(scene=None, cam=None, over=None):
    if scene is None:
        (scene, cam), over = cornell_box(), dict(sky_mode=2)
    config = RenderConfig(width=SIZE, height=SIZE, samples_per_pass=2, max_bounces=2,
                          pool_size=512, **over)
    return Renderer(scene, config, make_camera_params(width=SIZE, height=SIZE, **cam,
                                                      device="cpu"), device="cpu"), cam


def _settle(v, passes, spp, timeout=120):
    """Wait until the loop has run ``passes`` passes and idles at ``spp``."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        with v.lock:
            if v.passes >= passes and v.r.sample_count >= spp:
                return
        time.sleep(0.05)
    raise AssertionError(f"passes {v.passes}, spp {v.r.sample_count}; wanted {passes}, {spp}")


@pytest.fixture(scope="module")
def viewer_server():
    r, cam = _renderer()
    v = tviewer.Viewer(r, cam, max_spp=MAX_SPP)
    server = tviewer.serve(v, port=0, block=False)
    yield v, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    v.stop()


def test_viewer_serves_page_and_frames(viewer_server):
    from unity_webgpu_pathtracer_tpu import viewer as jviewer

    v, base = viewer_server
    page, ctype = _get(base, "/")
    assert ctype == "text/html" and b"tpu pathtracer" in page
    assert tviewer._PAGE == jviewer._PAGE and tviewer._SLIDER_FIELDS == jviewer._SLIDER_FIELDS
    _settle(v, 2, MAX_SPP)
    png, ctype = _get(base, "/frame.png")
    assert ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
    img = decode_png(png)
    assert img.shape == (SIZE, SIZE, 3) and img.mean() > 1
    with v.lock:
        np.testing.assert_array_equal(img, v.r.image(v.post))


def test_viewer_state_matches_reference(viewer_server):
    """``/state`` against the reference's ``Viewer.state()`` on the same
    scene: the same keys at every level, the same camera and materials."""
    from unity_webgpu_pathtracer_tpu import config as jconfig
    from unity_webgpu_pathtracer_tpu.api import Renderer as JRenderer
    from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box as jcornell
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params as jparams
    from unity_webgpu_pathtracer_tpu.viewer import Viewer as JViewer

    v, base = viewer_server
    jscene, cam = jcornell()
    jr = JRenderer(jscene, jconfig.RenderConfig(width=SIZE, height=SIZE, sky_mode=2,
                                                traversal="wide16"),
                   jparams(width=SIZE, height=SIZE, **cam), compile_cache=False)
    want = JViewer(jr, cam, tiered_start=False).state()
    got = json.loads(_get(base, "/state")[0])
    assert got.keys() == want.keys()
    assert got["stats"].keys() == want["stats"].keys() and got["stats"]["tier"] == "production"
    assert got["materials"] == json.loads(json.dumps(want["materials"]))
    assert got["width"] == want["width"] and got["height"] == want["height"]
    assert got["bounce"] is False
    _settle(v, 2, MAX_SPP)
    got = json.loads(_get(base, "/state")[0])
    assert got["spp"] == MAX_SPP and got["passes"] >= 2 and got["stats"]["pass_s"] > 0
    assert got["stats"]["mrays_per_s"] >= 0 and 0 < got["stats"]["occupancy"] <= 1


def test_viewer_camera_edit_resets_accumulation(viewer_server):
    v, base = viewer_server
    _settle(v, 2, MAX_SPP)
    with v.lock:
        passes = v.passes
    assert _post(base, "/camera", {"eye": [0.1, 1.0, 3.4]})["ok"]
    # Accumulation restarted: the idle loop renders MAX_SPP again.
    _settle(v, passes + 2, MAX_SPP)
    state = json.loads(_get(base, "/state")[0])
    assert state["cam"]["eye"] == [0.1, 1.0, 3.4] and state["spp"] == MAX_SPP
    assert v.passes == passes + 2 and v.r.film.pixel_counts is None


def test_viewer_material_edit(viewer_server):
    v, base = viewer_server
    _settle(v, 2, MAX_SPP)
    with v.lock:
        passes = v.passes
    mid = json.loads(_get(base, "/state")[0])["materials"][0]["id"]
    assert _post(base, "/material", {"id": mid, "roughness": 0.123,
                                     "base_color": [0.9, 0.1, 0.1, 1.0]})["ok"]
    host = v.r._host_scene
    assert host.materials[mid].roughness == pytest.approx(0.123)
    assert host.materials[mid].base_color[0] == pytest.approx(0.9)
    with v.lock:   # the device table (roughness at 9, base colour at 0)
        assert float(v.r.scene.materials[mid, 9]) == pytest.approx(0.123)
        assert float(v.r.scene.materials[mid, 0]) == pytest.approx(0.9)
    _settle(v, passes + 2, MAX_SPP)
    assert json.loads(_get(base, "/state")[0])["materials"][0]["roughness"] == \
        pytest.approx(0.123)


def test_viewer_rejects_unknown_material_field(viewer_server):
    _v, base = viewer_server
    assert _status(_post, base, "/material", {"id": 0, "nope": 1}) == 400
    assert _status(_get, base, "/nowhere") == 404


def test_viewer_reprojecting_flycam_keeps_history():
    r, cam = _renderer()
    v = tviewer.Viewer(r, cam, max_spp=MAX_SPP, reproject=True, max_history=64)
    server = tviewer.serve(v, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _settle(v, 2, MAX_SPP)
        eye = list(cam["eye"])
        eye[0] += 0.01
        assert _post(base, "/camera", {"eye": eye})["ok"]
        state = json.loads(_get(base, "/state")[0])
        assert state["spp"] >= MAX_SPP - 1, "history must survive a tiny fly-cam move"
        with v.lock:
            counts = v.r.film.pixel_counts.numpy()
        assert counts.shape == (SIZE, SIZE, 1) and (counts[..., 0] > 0).mean() > 0.5
    finally:
        server.shutdown()
        server.server_close()
        v.stop()


def test_viewer_bounce_moves_instances():
    scene, cam, over = tlas_scene(n=3)
    r, _ = _renderer(scene, cam, over)
    y0 = [float(scene.instances[i][1][1, 3]) for i in range(2)]
    v = tviewer.Viewer(r, cam, max_spp=2)
    server = tviewer.serve(v, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _settle(v, 1, 2)
        assert _post(base, "/bounce", {"on": True})["ok"]
        with v.lock:
            passes = v.passes
        _settle(v, passes + 1, 2)
        assert _post(base, "/bounce", {"on": False})["ok"]
        assert json.loads(_get(base, "/state")[0])["bounce"] is False
        with v.lock:
            y = [float(scene.instances[i][1][1, 3]) for i in range(2)]
            assert y != y0
            np.testing.assert_array_equal(v.r.scene.inst_l2w[0].numpy().reshape(3, 4),
                                          scene.instances[0][1][:3])
    finally:
        server.shutdown()
        server.server_close()
        v.stop()


def test_render_loop_failure_surfaces():
    """An exception in the render thread is kept: the next request gets a
    500, and ``stop()`` raises it."""
    r, cam = _renderer()

    def broken_step():
        raise RuntimeError("boom")

    r.step = broken_step
    v = tviewer.Viewer(r, cam, max_spp=MAX_SPP)
    server = tviewer.serve(v, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        v.wait(timeout=120)   # the loop ends with the failure
        assert not v._thread.is_alive() and isinstance(v.error, RuntimeError)
        assert _status(_get, base, "/state") == 500
        assert _status(_get, base, "/frame.png") == 500
        assert _status(_post, base, "/camera", {"eye": [0, 1, 3]}) == 500
    finally:
        server.shutdown()
        server.server_close()
    with pytest.raises(tviewer.ViewerError, match="boom"):
        v.stop()


def test_concurrent_edits_keep_the_film_whole():
    """Handler threads reproject and encode frames while the loop renders,
    with a short switch interval: every request succeeds, and the film's
    count and per-pixel counts stay in step (an edit torn by another
    thread would leave them apart)."""
    import sys

    r, cam = _renderer()
    v = tviewer.Viewer(r, cam, max_spp=10 ** 6, reproject=True, max_history=64)
    server = tviewer.serve(v, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    codes, interval = [], sys.getswitchinterval()

    def client(i):
        for k in range(4):
            eye = [cam["eye"][0] + 0.002 * (i + k), cam["eye"][1], cam["eye"][2]]
            codes.append(_status(_post, base, "/camera", {"eye": eye}))
            codes.append(_status(_get, base, "/frame.png"))

    sys.setswitchinterval(1e-5)
    try:
        _settle(v, 1, 2)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        server.shutdown()
        server.server_close()
        v.stop()
    assert codes == [200] * 48
    assert v.r.film.pixel_counts is not None
    assert int(v.r.film.pixel_counts.max()) == v.r.sample_count


def test_cli_view_starts_and_stops(monkeypatch):
    """``cli view --port 0`` in process: it serves until its viewer stops."""
    made = {}
    serve = tviewer.serve

    def spy(v, **kw):
        made["server"] = serve(v, **kw)
        made["viewer"] = v
        return made["server"]

    monkeypatch.setattr(tviewer, "serve", spy)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", tcli.main(
        ["view", "builtin:cornell", "--size", "16", "--spp-per-pass", "1", "--max-spp", "1",
         "--bounces", "1", "--port", "0", "--device", "cpu"])))
    t.start()
    deadline = time.time() + 120
    while "viewer" not in made and time.time() < deadline:
        time.sleep(0.05)
    v = made["viewer"]
    base = f"http://127.0.0.1:{made['server'].server_address[1]}"
    _settle(v, 1, 1)
    state = json.loads(_get(base, "/state")[0])
    assert state["width"] == 16 and state["spp"] == 1
    v.stop()
    t.join(timeout=60)
    assert not t.is_alive() and out["v"] is v
    with pytest.raises(urllib.error.URLError):
        _get(base, "/state")
