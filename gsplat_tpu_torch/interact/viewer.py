"""Live scene viewer: the card renders, the browser displays.

Counterpart of ``gsplat_tpu.interact.viewer`` with the same routes, query
parameters, JSON payloads, status codes and page. Re-architecture of the
reference's WebGL viewer (L4): instead of shipping the scene to the client
and rasterizing in GLSL, the renderer runs here (kernels B4 and B1 through
``render`` on the card; their plain versions on the CPU) and the browser is
a thin client that displays the frames and posts input. Interaction parity
with the reference's viewer (Web_Viewer_Gaussians_Selection):

- mouse drag orbit + wheel zoom (gaussians_selection.js:1188-1255)
- right/shift drag pan (js:1209-1255)
- keys 0-9 / +/- jump between dataset cameras from cameras.json
  (js:1159-1171) -- pass ``cameras=`` / ``--camera_file``
- ESC toggles selection mode, click selects a label (js:1342-1388)
- selection-info panel with ADE20K class name + gaussian count
  (js:981-1004, 1875-1881; index.html:328-331)
- color picker + apply/reset recoloring the selected label
  (index.html:316-320, js:15-64, 973-1004)
- Delete hides the selected label (js:1352-1359)
- H/K/U/J and arrows displace the selected label (js:1464-1482)
- R resets displacements, V resets visibility, C resets colors (js:1360-69)
- touch, gamepad, idle carousel, URL-hash view save/restore and drag-drop
  ingestion of .ply/.json/.splat (js:1257-1316, 1484-1566, 848-852,
  1646-1700)
- label map overlay toggle (L) -- a capability the reference lacks
- session persistence to a JSON file (the localStorage analogue)

Where the port differs from the JAX viewer:

- frames are PNG (``io/png.py`` at zlib level :data:`PNG_LEVEL`), not PIL
  JPEG: the card's machine has no PIL, and PNG is lossless, so a frame
  over HTTP equals :meth:`ViewerServer.frame_pixels` bit for bit;
- the server resolves its device once and names it in every call:
  ``ThreadingHTTPServer`` answers each request on a new thread, whose
  current CUDA device is 0 whatever card the viewer was started on;
- no budgets: the port sizes its buffers exactly, so ``num_dropped`` is 0
  and no frame is rendered twice.

Run: ``python -m gsplat_tpu_torch.cli.view --ply_file scene.ply``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gsplat_tpu_torch.assets.ade20k import label_name
from gsplat_tpu_torch.config import DEFAULT, NO_SELECTION, Config
from gsplat_tpu_torch.interact.edit import EditState, apply_edits, hit_test
from gsplat_tpu_torch.io import native, png
from gsplat_tpu_torch.io.cameras import Camera, look_at_camera
from gsplat_tpu_torch.io.ply import load_scene_bytes
from gsplat_tpu_torch.render.api import render
from gsplat_tpu_torch.scene import DeviceLike, GaussianScene, resolve_device
from gsplat_tpu_torch.utils.profiling import span

# zlib level of the served PNG frames. Level 1 was to be kept if it
# encoded the 2M scene's 800x608 frame in <= 5 ms on the card's host; it
# takes 42 ms there (level 0 1.9 ms, 1.46 MB against level 1's 1.33 MB:
# a frame of random splats is noise to zlib), so frames go stored
# (chip_smoke.py phase V times levels 0, 1 and 6; PERF.md)
PNG_LEVEL = 0

_PAGE = """<!doctype html>
<html><head><title>gsplat-tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px;
     border-radius:6px;white-space:pre}
#info{position:fixed;bottom:8px;left:8px;background:#000a;padding:6px 10px;
      border-radius:6px;display:none}
#colorbox{position:fixed;top:8px;right:8px;background:#000a;padding:6px 10px;
      border-radius:6px;display:none}
#colorbox button{margin-left:4px}
#drop{position:fixed;inset:0;display:none;align-items:center;
      justify-content:center;background:#000c;font-size:20px}
img{display:block;width:100vw;height:100vh;object-fit:contain;
    image-rendering:auto;cursor:crosshair;touch-action:none}
</style></head><body>
<img id="v" draggable="false">
<div id="hud"></div>
<div id="info"></div>
<div id="colorbox">
  <input type="color" id="pick" value="#ff0000">
  <button id="apply">Apply</button><button id="creset">Reset</button>
</div>
<div id="drop">drop .ply / .json / .splat to load</div>
<script>
// view state (restored from the URL hash like the reference's #[matrix])
let th=0.8, ph=0.3, r=3.0, px=0, py=0, pz=0, cam=-1;
let sel=false, lab=null, labname='', labcount=0, labels=false;
let busy=false, dirty=true, ncams=0, lastInput=Date.now(), fps=0;
const img=document.getElementById('v'), hud=document.getElementById('hud');
const info=document.getElementById('info'), cbox=document.getElementById('colorbox');
try{ const h=JSON.parse(decodeURIComponent(location.hash.slice(1)));
     [th,ph,r,px,py,cam,pz=0]=h; }catch(e){}
function qs(){return `theta=${th}&phi=${ph}&r=${r}&px=${px}&py=${py}&pz=${pz}`+
  `&cam=${cam}&labels=${labels?1:0}&sel=${sel?1:0}`}
function savehash(){location.hash=encodeURIComponent(
  JSON.stringify([th,ph,r,px,py,cam,pz]))}
async function refresh(){
  if(busy){dirty=true;return} busy=true;dirty=false;savehash();
  const t0=performance.now();
  img.src='/render?'+qs()+'&t='+Date.now();
  await img.decode().catch(()=>{});
  // FPS EMA 0.9*avg + 0.1*cur (gaussians_selection.js:1582-1583)
  fps=0.9*fps+0.1*(1000/Math.max(performance.now()-t0,1));
  hudtext();
  busy=false; if(dirty) refresh();
}
function touched(){lastInput=Date.now(); }
function hudtext(){hud.textContent=
 `orbit: drag | pan: shift/right-drag | zoom: wheel | cam: ${cam<0?'free':cam}/${ncams}`+
 ` | ${fps.toFixed(1)} fps`+
 `\\nESC select-mode(${sel?'ON':'off'}) | Del hide | H/K/U/J move | L labels(${labels?'ON':'off'})`+
 `\\n0-9 +/- dataset cams | WASD/QE fly | R/V/C reset disp/vis/color`}
function showinfo(){
  if(lab===null){info.style.display='none';cbox.style.display='none';return}
  info.textContent=`selected: ${lab} (${labname}) — ${labcount} gaussians`;
  info.style.display='block'; cbox.style.display='block'}
// --- dataset camera presets (reference js:1159-1171)
fetch('/cameras').then(r=>r.json()).then(d=>{ncams=d.count;hudtext()});
async function setcam(i){
  if(ncams===0)return; cam=((i%ncams)+ncams)%ncams;
  const d=await (await fetch(`/campose?cam=${cam}`)).json();
  th=d.theta; ph=d.phi; r=d.r; px=0; py=0; hudtext(); refresh()}
// --- mouse: left orbit, right/shift pan (js:1188-1255)
let drag=0,lx=0,ly=0;
img.oncontextmenu=e=>e.preventDefault();
img.onmousedown=e=>{drag=(e.button===2||e.shiftKey)?2:1;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=0;
window.onmousemove=e=>{if(!drag)return;touched();
  const dx=e.clientX-lx, dy=e.clientY-ly; lx=e.clientX;ly=e.clientY;
  if(drag===2){px-=dx;py-=dy}
  else{cam=-1;th+=dx*0.01;ph=Math.max(-1.4,Math.min(1.4,ph+dy*0.01))}
  refresh()};
window.onwheel=e=>{touched();r=Math.max(0.1,r*(1+e.deltaY*0.001));refresh()};
// --- touch: 1-finger orbit, 2-finger pinch zoom + pan (js:1257-1316)
let tpts=new Map(), tdist=0;
img.onpointerdown=e=>{if(e.pointerType!=='touch')return;
  tpts.set(e.pointerId,[e.clientX,e.clientY]);
  if(tpts.size===2){const p=[...tpts.values()];
    tdist=Math.hypot(p[0][0]-p[1][0],p[0][1]-p[1][1])}};
img.onpointerup=img.onpointercancel=e=>tpts.delete(e.pointerId);
img.onpointermove=e=>{
  if(e.pointerType!=='touch'||!tpts.has(e.pointerId))return;
  touched();e.preventDefault();
  const old=tpts.get(e.pointerId);tpts.set(e.pointerId,[e.clientX,e.clientY]);
  if(tpts.size===1){cam=-1;th+=(e.clientX-old[0])*0.01;
    ph=Math.max(-1.4,Math.min(1.4,ph+(e.clientY-old[1])*0.01))}
  else if(tpts.size===2){const p=[...tpts.values()];
    const d=Math.hypot(p[0][0]-p[1][0],p[0][1]-p[1][1]);
    if(tdist>0)r=Math.max(0.1,r*tdist/d); tdist=d;
    px-=(e.clientX-old[0])*0.5; py-=(e.clientY-old[1])*0.5}
  refresh()};
// --- selection (js:1373-1388) + info panel (js:981-1004)
img.onclick=async e=>{
  if(!sel||drag)return;touched();
  const rect=img.getBoundingClientRect();
  const x=(e.clientX-rect.left)/rect.width, y=(e.clientY-rect.top)/rect.height;
  const res=await (await fetch(`/select?x=${x}&y=${y}&`+qs())).json();
  lab=res.label; labname=res.name; labcount=res.count;
  hudtext(); showinfo(); refresh()};
// --- color picker (index.html:316-320)
document.getElementById('apply').onclick=async()=>{
  if(lab===null)return;
  const c=document.getElementById('pick').value;
  const rgb=[1,3,5].map(i=>parseInt(c.slice(i,i+2),16)/255);
  await fetch(`/edit?action=set_color&label=${lab}&r=${rgb[0]}&g=${rgb[1]}&b=${rgb[2]}`);
  refresh()};
document.getElementById('creset').onclick=async()=>{
  await fetch('/edit?action=reset_color');refresh()};
// --- keyboard (js:1342-1369, 1464-1482, presets js:1159-1171)
window.onkeydown=async e=>{
  touched();
  const post=async a=>{await fetch('/edit?action='+a+(lab!==null?'&label='+lab:''));refresh()};
  if(e.key==='Escape'){sel=!sel;hudtext();refresh()}
  else if(e.key>='0'&&e.key<='9')setcam(parseInt(e.key));
  else if(e.key==='+'||e.key==='=')setcam((cam<0?0:cam+1));
  else if(e.key==='-'||e.key==='_')setcam((cam<0?0:cam-1));
  else if(e.key==='Delete'&&lab!==null)post('hide');
  else if(e.key==='l'||e.key==='L'){labels=!labels;hudtext();refresh()}
  else if(e.key==='r'||e.key==='R')post('reset_disp');
  else if(e.key==='v'||e.key==='V')post('reset_vis');
  else if(e.key==='c'||e.key==='C')post('reset_color');
  // WASD free-fly + Q/E rotate (gaussians_selection.js:1440-1462)
  else if(e.key==='w'||e.key==='W'){cam=-1;pz+=40;refresh()}
  else if(e.key==='s'||e.key==='S'){cam=-1;pz-=40;refresh()}
  else if(e.key==='a'||e.key==='A'){cam=-1;px-=40;refresh()}
  else if(e.key==='d'||e.key==='D'){cam=-1;px+=40;refresh()}
  else if(e.key==='q'||e.key==='Q'){cam=-1;th-=0.1;refresh()}
  else if(e.key==='e'||e.key==='E'){cam=-1;th+=0.1;refresh()}
  else if(lab!==null){
    const step={h:[-1,0,0],k:[1,0,0],u:[0,-1,0],j:[0,1,0],
      ArrowLeft:[-1,0,0],ArrowRight:[1,0,0],ArrowUp:[0,-1,0],ArrowDown:[0,1,0]}[e.key];
    if(step)post('displace&dx='+step[0]+'&dy='+step[1]+'&dz='+step[2]);
  }};
// --- gamepad poll (js:1484-1546) + idle carousel (js:1558-1566)
let pad=false;
window.addEventListener('gamepadconnected',()=>pad=true);
setInterval(()=>{
  if(pad){const g=navigator.getGamepads()[0];
    if(g){const [ax,ay]=g.axes, az=g.axes[3]||0;
      if(Math.abs(ax)>0.15||Math.abs(ay)>0.15||Math.abs(az)>0.15){
        touched();cam=-1;th+=ax*0.05;
        ph=Math.max(-1.4,Math.min(1.4,ph+ay*0.05));
        r=Math.max(0.1,r*(1+az*0.02));refresh()}}}
  if(Date.now()-lastInput>15000){cam=-1;th+=0.01;refresh()}
},66);
// --- drag-drop live ingestion (js:1646-1700)
const drop=document.getElementById('drop');
window.ondragover=e=>{e.preventDefault();drop.style.display='flex'};
window.ondragleave=e=>{if(e.relatedTarget===null)drop.style.display='none'};
window.ondrop=async e=>{
  e.preventDefault();drop.style.display='none';
  const f=e.dataTransfer.files[0]; if(!f)return;
  const res=await fetch('/load',{method:'POST',body:await f.arrayBuffer()});
  const d=await res.json();
  if(d.cameras!==undefined){ncams=d.cameras}
  lab=null;hudtext();showinfo();refresh()};
hudtext();refresh();
</script></body></html>"""


def assemble_frame(image: torch.Tensor, label_map: Optional[torch.Tensor],
                   palette: torch.Tensor) -> np.ndarray:
    """The [H, W, 3] uint8 frame of a render on the host, built where the
    render lies and copied once. The dtypes are those of the JAX viewer's
    numpy path, so the frame equals its formula bit for bit: the clip in
    f32; with a label map the mix ``0.4 * img + 0.6 * overlay`` with
    ``0.4 * img`` in f32 (numpy keeps an array's f32 against a Python
    float) and the rest in f64; ``img * 255`` truncated to uint8."""
    img = image.clamp(0, 1)
    if label_map is not None:
        overlay = palette[label_map.abs() % 256] * (label_map != -1)[..., None]
        img = (0.4 * img).double() + 0.6 * overlay
    return (img * 255).to(torch.uint8).cpu().numpy()


class ViewerServer:
    """Threaded HTTP viewer around one scene + EditState.

    ``cameras`` (a cameras.json list) enables the reference's 0-9 / +/-
    dataset-camera navigation (gaussians_selection.js:1159-1171).
    ``device`` is where the scene, its renders and its edits live (the card
    unless the caller names another).
    """

    def __init__(
        self,
        scene: GaussianScene,
        *,
        cfg: Config = DEFAULT,
        width: int = 640,
        height: int = 480,
        session_path: Optional[str] = None,
        center: Optional[np.ndarray] = None,
        cameras: Optional[Sequence[Camera]] = None,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.width, self.height = width, height
        self.session_path = session_path
        self.edits = (EditState.load(session_path)
                      if session_path and os.path.exists(session_path)
                      else EditState())
        self.cameras: List[Camera] = list(cameras or [])
        # the label overlay's 256 f64 colours, the JAX viewer's
        self.palette = torch.from_numpy(np.random.default_rng(0).uniform(
            0.25, 1.0, size=(256, 3))).to(self.device)
        self.lock = threading.Lock()
        self.set_scene(scene, center=center)

    def set_scene(self, scene: GaussianScene,
                  center: Optional[np.ndarray] = None) -> None:
        """Swap the scene (live ingestion; js:1666-1673). The centre and
        orbit radius are reduced on the host in f32 numpy, as the JAX viewer
        does: every camera depends on them."""
        scene = scene.to(self.device)
        m = scene.means.detach().cpu().numpy()
        center = np.asarray(center) if center is not None else m.mean(axis=0)
        # client default orbit radius is 3.0 (see _PAGE)
        radius = (max(3.0, 1.5 * float(
            np.linalg.norm(m - center, axis=-1).max())) if m.size else 3.0)
        with self.lock:
            self.scene, self.center, self.radius = scene, center, radius

    def prewarm(self) -> None:
        """Build the native PLY codec (live ingestion) and render one frame
        before the first client request; on the card that frame builds the
        render's kernels (nvcc at first use)."""
        native.build()
        self.render_frame(0.0, 0.3, self.radius)

    def _on_device(self):
        """The viewer's card as the thread's current CUDA device: the
        kernels launch on the calling thread's device."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # --- rendering ------------------------------------------------------
    def _camera(self, theta: float, phi: float, radius: float,
                pan_x: float = 0.0, pan_y: float = 0.0,
                cam_idx: int = -1, pan_z: float = 0.0) -> Camera:
        if 0 <= cam_idx < len(self.cameras):
            cam = self.cameras[cam_idx].resized(self.width, self.height)
        else:
            eye = self.center + radius * np.array([
                np.cos(phi) * np.cos(theta), np.sin(phi),
                np.cos(phi) * np.sin(theta)])
            cam = look_at_camera(eye, self.center, width=self.width,
                                 height=self.height)
        if pan_x or pan_y or pan_z:
            # pan in the camera plane + WASD dolly along the view axis
            # (js:1440-1462): rows of R are right / down / forward
            s = radius / cam.fx
            delta = (pan_x * s * cam.rotation[0]
                     + pan_y * s * cam.rotation[1]
                     + pan_z * s * cam.rotation[2])
            cam = dataclasses.replace(cam, position=cam.position + delta)
        return cam

    def campose(self, cam_idx: int) -> dict:
        """Orbit-rig angles matching dataset camera ``cam_idx``'s position,
        so client-side orbiting continues smoothly from a preset jump."""
        cam = self.cameras[cam_idx]
        d = np.asarray(cam.position, np.float64) - self.center
        r = float(np.linalg.norm(d))
        if r < 1e-9:
            return dict(theta=0.0, phi=0.0, r=1.0)
        phi = float(np.arcsin(np.clip(d[1] / r, -1, 1)))
        theta = float(np.arctan2(d[2], d[0]))
        return dict(theta=theta, phi=phi, r=r)

    def frame_pixels(self, theta, phi, radius, labels=False,
                     pan_x=0.0, pan_y=0.0, cam_idx=-1, pan_z=0.0,
                     selection=None) -> np.ndarray:
        """The [H, W, 3] uint8 frame of a view with the current edits."""
        with self.lock, self._on_device(), span("gsplat.frame"):
            if selection is not None:
                # the client's ESC toggle rides the query string; with the
                # mode on, apply_edits mixes the selected label red at 0.5
                # (gaussians_selection.js:795-797)
                self.edits.selection_mode = bool(selection)
            with span("gsplat.edits"):
                scene = apply_edits(self.scene, self.edits)
            cam = self._camera(theta, phi, radius, pan_x, pan_y, cam_idx,
                               pan_z)
            out = render(scene, cam, self.cfg, with_labels=labels,
                         device=self.device)
            with span("gsplat.assemble"):
                return assemble_frame(out["image"],
                                      out["label_map"] if labels else None,
                                      self.palette)

    def render_frame(self, theta, phi, radius, labels=False,
                     pan_x=0.0, pan_y=0.0, cam_idx=-1, pan_z=0.0,
                     selection=None) -> bytes:
        """The PNG file of :meth:`frame_pixels`."""
        return png.encode_png(
            self.frame_pixels(theta, phi, radius, labels, pan_x, pan_y,
                              cam_idx, pan_z, selection), PNG_LEVEL)

    def select(self, xf: float, yf: float, theta, phi, radius,
               pan_x=0.0, pan_y=0.0, cam_idx=-1, pan_z=0.0) -> dict:
        """Hit-test + the selection-info payload (label, class name, count —
        js:981-1004). A successful select arms the red highlight: the next
        /render with sel=1 mixes the label red (js:795-797)."""
        with self.lock, self._on_device():
            cam = self._camera(theta, phi, radius, pan_x, pan_y, cam_idx,
                               pan_z)
            scene = apply_edits(self.scene, self.edits)
            lab = hit_test(scene, cam, xf * self.width, yf * self.height,
                           radius_px=self.cfg.interact.hit_radius_px)
            self.edits.selected_label = lab
            self.edits.selection_mode = True
            if lab == NO_SELECTION:
                return dict(label=None, name="", count=0)
            count = int((self.scene.labels == lab).sum())
        return dict(label=int(lab), name=label_name(int(lab)), count=count)

    def edit(self, action: str, label: Optional[int], dxyz,
             rgb=None) -> None:
        with self.lock:
            if action == "hide" and label is not None:
                self.edits.toggle_visibility(label)
            elif action == "displace" and label is not None:
                self.edits.displace(
                    label, dxyz, step=self.cfg.interact.displacement_step)
            elif action == "set_color" and label is not None and rgb:
                self.edits.set_color(label, rgb)
            elif action == "reset_disp":
                self.edits.reset_displacements()
            elif action == "reset_vis":
                self.edits.reset_visibility()
            elif action == "reset_color":
                self.edits.reset_colors()
            if self.session_path:
                self.edits.save(self.session_path)

    def load_bytes(self, data: bytes) -> dict:
        """Live file ingestion (drag-drop dispatch, js:1646-1679):
        cameras.json replaces the camera set; PLY/.splat replace the scene,
        parsed outside the lock and swapped under it."""
        head = data.lstrip()[:1]
        if head in (b"[", b"{"):
            cams = [Camera.from_json(d) for d in json.loads(data)]
            with self.lock:
                self.cameras = cams
            return dict(cameras=len(cams))
        scene = load_scene_bytes(data, device=self.device)
        self.set_scene(scene)
        return dict(gaussians=int(scene.num_gaussians))

    # --- http -----------------------------------------------------------
    def make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                u = urlparse(self.path)
                try:
                    if u.path == "/load":
                        n = int(self.headers.get("Content-Length", 0))
                        res = viewer.load_bytes(self.rfile.read(n))
                        self._send(200, json.dumps(res).encode())
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:
                    self._send(500, str(e).encode(), "text/plain")

            def do_GET(self):
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}

                def viewq():
                    return (float(q.get("theta", 0)), float(q.get("phi", 0)),
                            float(q.get("r", 3)))

                def panq():
                    return (float(q.get("px", 0)), float(q.get("py", 0)),
                            int(q.get("cam", -1)), float(q.get("pz", 0)))

                try:
                    if u.path == "/":
                        self._send(200, _PAGE.encode(), "text/html")
                    elif u.path == "/render":
                        th, ph, r = viewq()
                        px, py, ci, pz = panq()
                        sel = (None if "sel" not in q
                               else q.get("sel") == "1")
                        frame = viewer.render_frame(
                            th, ph, r, q.get("labels") == "1",
                            pan_x=px, pan_y=py, cam_idx=ci, pan_z=pz,
                            selection=sel)
                        self._send(200, frame, "image/png")
                    elif u.path == "/select":
                        th, ph, r = viewq()
                        px, py, ci, pz = panq()
                        res = viewer.select(float(q["x"]), float(q["y"]),
                                            th, ph, r, pan_x=px, pan_y=py,
                                            cam_idx=ci, pan_z=pz)
                        self._send(200, json.dumps(res).encode())
                    elif u.path == "/cameras":
                        self._send(200, json.dumps(
                            {"count": len(viewer.cameras)}).encode())
                    elif u.path == "/campose":
                        ci = int(q.get("cam", 0))
                        if not 0 <= ci < len(viewer.cameras):
                            self._send(404, b"no such camera", "text/plain")
                        else:
                            self._send(200,
                                       json.dumps(viewer.campose(ci)).encode())
                    elif u.path == "/edit":
                        rgb = None
                        if "r" in q and "g" in q and "b" in q:
                            rgb = (float(q["r"]), float(q["g"]),
                                   float(q["b"]))
                        viewer.edit(
                            q.get("action", ""),
                            int(q["label"]) if "label" in q else None,
                            (float(q.get("dx", 0)), float(q.get("dy", 0)),
                             float(q.get("dz", 0))), rgb=rgb)
                        self._send(200, b"{}")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:  # surface errors to the client
                    self._send(500, str(e).encode(), "text/plain")

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000):
        """Serve until interrupted; prints the bound port (``port=0`` takes
        a free one), flushed so that a parent reading a pipe sees it."""
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        print(f"viewer at http://{host}:{httpd.server_address[1]}/",
              flush=True)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
