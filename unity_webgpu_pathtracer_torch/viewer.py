"""Interactive web viewer: fly camera and live material editing
(``viewer.py`` of the reference).

The interactive surface the reference's renderer spreads across its
example scripts, hosted as a local web app with no dependency beyond the
standard library:

- ``FreeViewCamera.cs:1-50``: WASD and mouse-drag fly camera; a camera
  edit restarts accumulation (``PathTracer.cs:217-222``) through
  ``Renderer.update_camera``, or, with ``reproject=True``, warps the film
  through the move (``render/reproject.py``).
- ``DisneyBRDFTest.cs:49-89``: the 12 material sliders, pushed into the
  running render by ``Renderer.update_material``.
- ``Bounce.cs:1-18``: optional instance animation on TLAS scenes
  (``Renderer.update_instance_transform``: the TLAS rows only on wide16
  and wide8, a rebuild over the cached BLASes on wide and wide2).

One render thread steps the ``Renderer`` under ``Viewer.lock``; the HTTP
handler threads (``ThreadingHTTPServer``) apply edits and encode frames
under the same lock, so all device work is serialised (and the kernels'
launch counters see one launching thread at a time).  Every thread does
its device work on the renderer's device.  An exception in the render
thread ends the loop and is kept: the next ``state()``, ``frame_png()``,
edit or ``stop()`` raises ``ViewerError`` from it, which the handler
answers with a 500.

Endpoints: ``GET /`` (the app), ``GET /frame.png`` (the tonemapped
frame), ``GET /state`` (spp, camera, statistics, materials as JSON),
``POST /camera {eye, target, fov_y_deg}``, ``POST /material {id, ...}``,
``POST /bounce {on}``; an unknown material field is a 400.

Left out of the reference's viewer, which does them only for XLA: the
tiered start on the ``arrival_fori`` executable while the production one
compiles (reference ``viewer.py:72-123``; ``arrival_fori`` is not ported,
and the port has no executable to compile: its kernels are built once at
first use), and ``enable_compile_cache`` (:351-353).  ``state()``'s
``stats.tier`` is always ``"production"``, so the page's script is the
reference's unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.config import PostParams
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
from unity_webgpu_pathtracer_torch.utils.image import encode_png

_SLIDER_FIELDS = (
    # The 12 DisneyBRDFTest.cs sliders (:49-89), same parameter names.
    "metallic", "roughness", "ior", "transmission", "anisotropic",
    "specular", "specular_tint", "sheen", "sheen_tint", "subsurface",
    "clearcoat", "clearcoat_gloss",
)


class ViewerError(RuntimeError):
    """The render loop failed; raised by every later call of the viewer."""


class Viewer:
    """Progressive render loop and edit queue around a ``Renderer``."""

    def __init__(self, renderer, cam: dict, post: PostParams = PostParams(mode=1),
                 max_spp: int = 4096, bounce: bool = False, reproject: bool = False,
                 max_history: int = 256):
        self.r = renderer
        self.cam = dict(cam)
        self.post = post
        self.max_spp = max_spp
        self.bounce = bounce
        self.reproject = reproject
        self.max_history = max_history
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.error: Exception | None = None
        self.passes = 0
        # Live statistics (the reference's Graphy panel): an EMA of the
        # seconds a pass, rays/s and occupancy of the last pass, and the
        # super-iterations summed over the loop's passes.
        self.pass_s = 0.0
        self.rays_per_s = 0.0
        self.occupancy = 0.0
        self.super_iterations = 0

    def _on_device(self):
        if self.r.device.type == "cuda":
            return torch.cuda.device(self.r.device)
        return contextlib.nullcontext()

    def _check(self) -> None:
        if self.error is not None:
            raise ViewerError(f"the render loop failed: {self.error!r}") from self.error

    # -- render loop ---------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="viewer-render", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """End the loop; raises ``ViewerError`` if it had failed."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        self._check()

    def wait(self, timeout: float | None = None) -> None:
        """Block until the loop ends (``stop()`` or a failure), or for at
        most ``timeout`` seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._thread is not None and self._thread.is_alive():
            if deadline is not None and time.monotonic() >= deadline:
                return
            self._thread.join(0.5)

    def _loop(self) -> None:
        try:
            with self._on_device():
                self._run()
        except Exception as e:   # kept; the next call raises it
            self.error = e

    def _bounce_instances(self, seconds: float) -> None:
        host = self.r._host_scene
        if host is None or not host.instances:
            return
        phase = 2.0 * np.pi * seconds / 4.0
        for i in range(len(host.instances) - 1):
            _mid, tr0, _m = host.instances[i]
            tr = np.array(tr0, np.float32)
            tr[1, 3] = 0.4 + abs(np.sin(phase + i)) * 1.2
            self.r.update_instance_transform(i, tr)

    def _run(self) -> None:
        t0 = time.time()
        while not self._stop.is_set():
            with self.lock:
                if self.bounce:
                    self._bounce_instances(time.time() - t0)
                work = self.r.sample_count < self.max_spp
                if work:
                    t1 = time.perf_counter()
                    self.r.step()
                    if self.r.device.type == "cuda":
                        torch.cuda.synchronize(self.r.device)
                    dt = time.perf_counter() - t1
                    self.passes += 1
                    self.pass_s += (0.3 if self.pass_s else 1.0) * (dt - self.pass_s)
                    st = self.r.stats()
                    # The fused pass's counters (a megakernel pass has others).
                    if "super_iterations" in st and self.pass_s > 0:
                        self.rays_per_s = st["rays"] / self.pass_s
                        self.occupancy = st["occupancy"]
                        self.super_iterations += st["super_iterations"]
            # Between passes the handler threads get the lock: a released
            # threading.Lock is not handed to a waiter, so a loop that
            # re-took it at once would starve them.
            time.sleep(0.001 if work else 0.05)

    # -- edits (called from HTTP handler threads) ----------------------
    def set_camera(self, eye=None, target=None, fov_y_deg=None) -> None:
        with self.lock, self._on_device():
            self._check()
            if eye is not None:
                self.cam["eye"] = tuple(float(x) for x in eye)
            if target is not None:
                self.cam["target"] = tuple(float(x) for x in target)
            if fov_y_deg is not None:
                self.cam["fov_y_deg"] = float(fov_y_deg)
            params = make_camera_params(width=self.r.config.width, height=self.r.config.height,
                                        device=self.r.device, **self.cam)
            self.r.update_camera(params, reproject=self.reproject, max_history=self.max_history)

    def set_material(self, material_id: int, **fields) -> None:
        with self.lock, self._on_device():
            self._check()
            host = self.r._require_host_scene()
            desc = host.materials[material_id]
            clean = {}
            for k, v in fields.items():
                if not hasattr(desc, k):
                    raise KeyError(k)
                cur = getattr(desc, k)
                clean[k] = tuple(float(x) for x in v) if isinstance(cur, tuple) else type(cur)(v)
            self.r.update_material(material_id, dataclasses.replace(desc, **clean))

    def set_bounce(self, on: bool) -> None:
        with self.lock:
            self._check()
            self.bounce = on

    # -- reads ---------------------------------------------------------
    def frame_png(self) -> bytes:
        with self.lock, self._on_device():
            self._check()
            return encode_png(self.r.image(self.post))

    def state(self) -> dict:
        with self.lock:
            self._check()
            host = self.r._host_scene
            mats = [{"id": i, "base_color": list(m.base_color[:3]),
                     **{f: getattr(m, f) for f in _SLIDER_FIELDS}}
                    for i, m in enumerate(host.materials if host else [])]
            return {"spp": int(self.r.sample_count), "passes": self.passes,
                    "cam": {k: list(v) if isinstance(v, tuple) else v
                            for k, v in self.cam.items()},
                    "width": self.r.config.width,
                    "height": self.r.config.height,
                    "bounce": self.bounce,
                    "stats": {"pass_s": round(self.pass_s, 3),
                              "mrays_per_s": round(self.rays_per_s / 1e6, 2),
                              "occupancy": round(self.occupancy, 3),
                              "tier": "production"},
                    "materials": mats}


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpu pathtracer</title><style>
body{margin:0;display:flex;font:13px system-ui;background:#191b1f;color:#d8dade}
#view{flex:1;display:flex;align-items:center;justify-content:center;min-height:100vh}
#img{image-rendering:pixelated;max-width:90%;max-height:95vh;outline:1px solid #333}
#panel{width:270px;padding:12px;background:#22252a;overflow-y:auto;height:100vh;box-sizing:border-box}
label{display:block;margin:6px 0 0}input[type=range]{width:100%}
#spp{color:#7a8}select,button{width:100%;margin:4px 0}
.hint{color:#778;font-size:11px}
</style></head><body>
<div id="view"><img id="img" tabindex="0"></div>
<div id="panel">
  <div id="spp">–</div>
  <div class="hint">click image, then WASD+QE to fly, drag to look</div>
  <label>material <select id="mat"></select></label>
  <div id="sliders"></div>
  <label>base color <input type="color" id="color" value="#cccccc"></label>
  <button id="bounce">toggle bounce</button>
</div>
<script>
const FIELDS = %FIELDS%;
let cam=null, mats=[], cur=0, yaw=0, pitch=0, dist=1;
const img=document.getElementById('img');
function refresh(){ img.src='/frame.png?t='+Date.now(); }
img.onload=()=>setTimeout(refresh, 250); img.onerror=()=>setTimeout(refresh, 1000);
async function post(u,b){ await fetch(u,{method:'POST',body:JSON.stringify(b)}); }
function vsub(a,b){return a.map((x,i)=>x-b[i]);} function vadd(a,b){return a.map((x,i)=>x+b[i]);}
function dirFrom(yaw,pitch){return [Math.cos(pitch)*Math.sin(yaw),Math.sin(pitch),-Math.cos(pitch)*Math.cos(yaw)];}
async function state(){
  const s=await (await fetch('/state')).json();
  let t=s.spp+' spp';
  if(s.stats && s.stats.pass_s>0){
    t+=' · '+s.stats.pass_s.toFixed(2)+' s/pass · '+s.stats.mrays_per_s.toFixed(1)
      +' Mrays/s · occ '+s.stats.occupancy.toFixed(2)
      +(s.stats.tier=='fori'?' · warming…':'');
  }
  document.getElementById('spp').textContent=t;
  if(!cam){ cam=s.cam; const d=vsub(cam.target,cam.eye);
    dist=Math.hypot(...d); yaw=Math.atan2(d[0],-d[2]); pitch=Math.asin(d[1]/dist);
    mats=s.materials; const sel=document.getElementById('mat');
    sel.innerHTML=mats.map(m=>`<option value="${m.id}">material ${m.id}</option>`).join('');
    buildSliders(); }
  setTimeout(state, 2000);
}
function buildSliders(){
  const div=document.getElementById('sliders'); const m=mats[cur]; if(!m) return;
  div.innerHTML=FIELDS.map(f=>`<label>${f} <span id="v_${f}">${m[f].toFixed(2)}</span>
    <input type="range" id="s_${f}" min="0" max="${f=='ior'?3:1}" step="0.01" value="${m[f]}"></label>`).join('');
  FIELDS.forEach(f=>{ document.getElementById('s_'+f).oninput=e=>{
    const v=parseFloat(e.target.value); document.getElementById('v_'+f).textContent=v.toFixed(2);
    mats[cur][f]=v; post('/material',{id:cur,[f]:v}); };});
}
document.getElementById('mat').onchange=e=>{cur=+e.target.value; buildSliders();};
document.getElementById('color').oninput=e=>{
  const h=e.target.value; const rgb=[1,3,5].map(i=>parseInt(h.substr(i,2),16)/255);
  post('/material',{id:cur,base_color:[...rgb,1]});};
document.getElementById('bounce').onclick=()=>post('/bounce',{toggle:true});
let drag=false,lx=0,ly=0;
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;img.focus();};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{ if(!drag||!cam) return;
  yaw+=(e.clientX-lx)*0.005; pitch-=(e.clientY-ly)*0.005;
  pitch=Math.max(-1.5,Math.min(1.5,pitch)); lx=e.clientX; ly=e.clientY;
  cam.target=vadd(cam.eye,dirFrom(yaw,pitch).map(x=>x*dist));
  post('/camera',{eye:cam.eye,target:cam.target}); };
window.onkeydown=e=>{ if(!cam) return; const sp=0.15;
  const fwd=dirFrom(yaw,pitch), right=[Math.cos(yaw),0,Math.sin(yaw)];
  const mv={'w':fwd,'s':fwd.map(x=>-x),'d':right,'a':right.map(x=>-x),
            'e':[0,1,0],'q':[0,-1,0]}[e.key]; if(!mv) return;
  cam.eye=vadd(cam.eye,mv.map(x=>x*sp));
  cam.target=vadd(cam.eye,dirFrom(yaw,pitch).map(x=>x*dist));
  post('/camera',{eye:cam.eye,target:cam.target}); };
state(); refresh();
</script></body></html>"""


def make_handler(viewer: Viewer):
    page = _PAGE.replace("%FIELDS%", json.dumps(list(_SLIDER_FIELDS))).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _fail(self, e: Exception):
            self._send(500, json.dumps({"error": str(e)}).encode())

        def do_GET(self):
            try:
                if self.path.startswith("/frame.png"):
                    self._send(200, viewer.frame_png(), "image/png")
                elif self.path.startswith("/state"):
                    self._send(200, json.dumps(viewer.state()).encode())
                elif self.path == "/" or self.path.startswith("/index"):
                    self._send(200, page, "text/html")
                else:
                    self._send(404, b"{}")
            except BrokenPipeError:
                pass
            except Exception as e:
                self._fail(e)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path.startswith("/camera"):
                    viewer.set_camera(body.get("eye"), body.get("target"), body.get("fov_y_deg"))
                elif self.path.startswith("/material"):
                    mid = int(body.pop("id"))
                    viewer.set_material(mid, **body)
                elif self.path.startswith("/bounce"):
                    viewer.set_bounce(bool(body.get("on", not viewer.bounce)))
                else:
                    return self._send(404, b"{}")
                self._send(200, b'{"ok": true}')
            except ViewerError as e:
                self._fail(e)
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, json.dumps({"error": str(e)}).encode())
            except Exception as e:
                self._fail(e)

    return Handler


def serve(viewer: Viewer, host: str = "127.0.0.1", port: int = 8000,
          block: bool = True) -> ThreadingHTTPServer:
    """Start the render loop and the HTTP server (port 0: an ephemeral
    port, ``server.server_address[1]``).  ``block``: serve until
    interrupted, then stop the loop; otherwise serve from a daemon thread
    and return the server (the caller ends it with ``server.shutdown()``
    and ``viewer.stop()``)."""
    server = ThreadingHTTPServer((host, port), make_handler(viewer))
    viewer.start()
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
            viewer.stop()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
