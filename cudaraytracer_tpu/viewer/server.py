"""Interactive web viewer: the GLFW + Dear ImGui shell, re-architected.

The reference presents frames through CUDA->GL interop into an ImGui
dockspace with Scene / Metrics / Options / Console panels and routes
GLFW input to the fly camera (reference: CudaRayTracer/src/Cuda/
CudaLayer.cpp:389-687, ImGui/ImGuiLayer.cpp:17-137, Core/Window.cpp:37-133).
A compute node has no display, so the equivalent here is a zero-dependency
HTTP viewer: the render loop stays in-process next to the device, and any
browser becomes the display.

  * GET  /            the UI (canvas + panels, dark theme, dockable-ish)
  * GET  /frame.jpg   current progressive framebuffer (JPEG q85 — the UI's
                      poll format when Pillow is installed: ~10x fewer
                      bytes than PNG on noisy renders; ?scale=&q= knobs)
  * GET  /frame.png   lossless framebuffer (PNG, row 0 = top; standard
                      library only — the UI polls it without Pillow)
  * GET  /state       metrics + scene tree + console + options as JSON
  * POST /input       {keys, shift, mouse_dx, mouse_dy, scroll} -> FlyCamera
                      (WASD/Space/Ctrl/C, right-drag look, wheel fov —
                      Camera.cpp:28-118 semantics; P toggles pause,
                      ESC semantics = stop server)
  * POST /edit        scene CRUD: add/delete/clear/update — the Scene panel
                      (CudaLayer.cpp:470-649) incl. material/texture edits
  * POST /options     spp / max_depth / background colors / pause / save / load
"""

from __future__ import annotations

import io
import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..models import scene as scene_mod
from ..utils import logging as rtlog
from .app import Application

_PAGE = """<!DOCTYPE html>
<html><head><title>cudaraytracer-tpu</title><style>
body{background:#15161e;color:#c0caf5;font-family:ui-monospace,monospace;margin:0;display:flex}
#main{flex:1;padding:10px}
#side{width:420px;padding:10px;background:#1a1b26;height:100vh;overflow-y:auto}
canvas{border:1px solid #3b4261;image-rendering:pixelated;outline:none;max-width:100%}
h3{color:#7aa2f7;border-bottom:1px solid #3b4261;margin:12px 0 6px}
#console{background:#0f1017;height:180px;overflow-y:auto;font-size:11px;padding:4px;white-space:pre}
table{font-size:12px;width:100%} td{padding:1px 4px}
button,input,select{background:#24283b;color:#c0caf5;border:1px solid #3b4261;border-radius:3px;margin:1px;font-size:12px}
input[type=number]{width:56px} input[type=range]{width:90px;vertical-align:middle}
.prim{border:1px solid #3b4261;margin:3px 0;padding:3px;font-size:11px}
.prim summary{cursor:pointer;color:#9ece6a}
.row{margin:2px 0} .lbl{display:inline-block;width:52px;color:#7dcfff}
</style></head><body>
<div id=main>
 <h3>Viewport (click to focus &mdash; WASD/Space/Ctrl move, Shift fast, right-drag look, wheel fov, C reset, P pause)</h3>
 <canvas id=cv tabindex=1></canvas>
</div>
<div id=side>
 <div id=status style="font-size:13px;padding:4px;border:1px solid #3b4261;border-radius:3px"></div>
 <h3>Metrics</h3><table id=metrics></table>
 <h3>Options</h3>
 <div>
  depth <input id=depth type=number min=0 max=50>
  spp <input id=spp type=number min=1>
  <button onclick="setOpt()">apply</button>
  <button onclick="post('/options',{pause:true})">pause/resume</button>
 </div>
 <div><label title="display-time SVGF-lite denoiser (a-trous wavelet, G-buffer edge stopping); never touches the accumulator">
  <input id=dns type=checkbox onchange="post('/options',{denoise:this.checked})"> denoise</label>
 </div>
 <div><label title="RTOW book-3 importance-sampled light transport (cosine/light-solid-angle mixture for lambertian). A DIFFERENT estimator than the reference-parity default; toggling recompiles the pipeline (one-time, shown in the log)">
  <input id=nee type=checkbox onchange="post('/options',{nee:this.checked})"> importance sampling (NEE)</label>
 </div>
 <div><label title="R2 low-discrepancy pixel jitter (QMC): screen-space error approaches O(1/N) instead of O(1/sqrt(N)). A DIFFERENT (deterministic) pixel sampler than the reference-parity PRNG; toggling recompiles the pipeline (one-time, shown in the log)">
  <input id=qmc type=checkbox onchange="post('/options',{qmc:this.checked})"> low-discrepancy sampling (QMC)</label>
 </div>
 <div>lens <input id=apert type=number min=0 step=0.02 title="aperture (defocus blur; look_at scenes)">
  focus <input id=fdist type=number min=0.1 step=0.5 title="focus distance">
  <button onclick="post('/options',{aperture:+document.getElementById('apert').value,focus_dist:+document.getElementById('fdist').value})">set</button>
 </div>
 <div>resize <input id=rw type=number value=640>x<input id=rh type=number value=360>
  <button onclick="post('/options',{resize:[+document.getElementById('rw').value,+document.getElementById('rh').value]})">apply</button>
 </div>
 <input type=file id=texfile style="display:none" accept="image/*">
 <div>bg <input id=bg0 type=color><input id=bg1 type=color>
  <button onclick="setBg()">set</button>
 </div>
 <div>scene <select id=sceneSel onchange="post('/options',{scene:this.value})"></select></div>
 <div>file <input id=fname value="scene.json" style="width:110px">
  <button onclick="post('/options',{save:fname.value})">save scene</button>
  <button onclick="post('/options',{load:fname.value})">load scene</button>
 </div>
 <div>
  <a href="/scene.json" download="scene.json"><button>download scene</button></a>
  <button onclick="importScene()">import scene</button>
  <a href="/radiance.pfm" download="radiance.pfm"><button title="linear HDR radiance">HDR</button></a>
  <input type=file id=scenefile style="display:none" accept=".json,application/json">
 </div>
 <div>ckpt <input id=ckname value="checkpoint" style="width:110px">
  <button onclick="post('/options',{checkpoint:ckname.value})">checkpoint</button>
  <button onclick="post('/options',{resume:ckname.value})">resume</button>
 </div>
 <h3>Camera</h3>
 <div class=row><span class=lbl>pos</span><input id=cx type=number step=0.5><input id=cy type=number step=0.5><input id=cz type=number step=0.5></div>
 <div class=row><span class=lbl>yaw</span><input id=cyaw type=number step=1>
  <span class=lbl>pitch</span><input id=cpitch type=number step=1 min=-89 max=89></div>
 <div class=row><span class=lbl>fov</span><input id=cfov type=number step=1 min=1 max=120>
  <button onclick="setCam()">set</button></div>
 <h3>Scene</h3>
 <div class=row>+ add <select id=addtype><option>sphere</option><option>xy_rect</option><option>xz_rect</option><option>yz_rect</option><option>icosphere</option><option>torus</option><option>box</option><option value=smoke_box>smoke box</option></select>
  <select id=addmat><option>lambertian</option><option>metal</option><option>dielectric</option><option>diffuse_light</option><option>isotropic</option></select>
  <button onclick="addPrim()">add</button>
  <button onclick="uploadObj()">load OBJ</button>
  <button onclick="post('/edit',{op:'clear'})">clear</button></div>
 <input type=file id=objfile style="display:none" accept=".obj">
 <div id=scene></div>
 <h3>Console</h3>
 <div>filter <input id=cfilter style="width:140px" oninput="cflt=this.value">
  <button onclick="post('/options',{console_clear:true})">clear</button>
  <button onclick="copyConsole()">copy</button></div>
 <div id=console></div>
</div>
<script>
const cv=document.getElementById('cv');const ctx2=cv.getContext('2d');
let keys=new Set(),shift=false,dragging=false,lx=0,ly=0;
const keymap={w:'w',a:'a',s:'s',d:'d',' ':'space',Control:'ctrl',c:'c'};
cv.addEventListener('keydown',e=>{if(e.key==='p'){post('/options',{pause:true});return}
 if(keymap[e.key]!==undefined)keys.add(keymap[e.key]);shift=e.shiftKey;e.preventDefault()});
cv.addEventListener('keyup',e=>{keys.delete(keymap[e.key]);shift=e.shiftKey});
cv.addEventListener('mousedown',e=>{if(e.button===2){dragging=true;lx=e.clientX;ly=e.clientY}});
window.addEventListener('mouseup',e=>{if(e.button===2)dragging=false});
cv.addEventListener('contextmenu',e=>e.preventDefault());
let mdx=0,mdy=0,wheel=0;
cv.addEventListener('mousemove',e=>{if(dragging){mdx+=e.clientX-lx;mdy+=ly-e.clientY;lx=e.clientX;ly=e.clientY}});
cv.addEventListener('wheel',e=>{wheel+=Math.sign(e.deltaY);e.preventDefault()});
async function post(u,b){await fetch(u,{method:'POST',body:JSON.stringify(b)})}
setInterval(()=>{if(keys.size||mdx||mdy||wheel){
 post('/input',{keys:[...keys],shift,mouse_dx:mdx,mouse_dy:mdy,scroll:-wheel});mdx=mdy=wheel=0}},33);
let fscale=1;
async function frame(){const t0=performance.now();const img=new Image();
 img.onload=()=>{const dt=performance.now()-t0;
  // adaptive downscale for slow links: keep frame fetches under ~600ms
  if(dt>600&&fscale<8)fscale*=2;else if(dt<120&&fscale>1)fscale/=2;
  cv.width=img.width*fscale;cv.height=img.height*fscale;
  ctx2.imageSmoothingEnabled=false;ctx2.drawImage(img,0,0,cv.width,cv.height);
  setTimeout(frame,50)};img.onerror=()=>setTimeout(frame,500);
 // JPEG poll: ~10x fewer bytes than PNG on noisy renders (q85 default);
 // without Pillow on the server (/state says jpeg:false) poll the PNG
 img.src=(S.options&&S.options.jpeg===false?'/frame.png':'/frame.jpg')+'?scale='+fscale+'&t='+Date.now()}
frame();
function esc(s){return s.replace(/&/g,'&amp;').replace(/</g,'&lt;')}
let S={scene:[]},sceneSig='';
function rgb2hex(c){return '#'+c.map(v=>Math.round(v*255).toString(16).padStart(2,'0')).join('')}
function hex2rgb(h){return [1,3,5].map(i=>parseInt(h.substr(i,2),16)/255)}
function upd(id,field,value){post('/edit',{op:'update',id,field,value})}
function updC(id,k,v){const p=S.scene.find(q=>String(q.id)===String(id));p.center[k]=v;upd(id,'center',p.center)}
function updHE(id,k,v){const p=S.scene.find(q=>String(q.id)===String(id));p.half_ext[k]=Math.max(0.005,v/2);upd(id,'half_ext',p.half_ext)}
function num(id,k,v,step){return `<input type=number step=${step||0.1} value=${v} onchange="updC('${id}',${k},+this.value)">`}
function primPanel(p){
 const mats=['lambertian','metal','dielectric','diffuse_light','isotropic'];
 const texs=['constant','checker','image','noise'];
 let rows=`<div class=row><span class=lbl>pos</span>${[0,1,2].map(k=>num(p.id,k,p.center[k])).join('')}</div>`;
 if(p.prim==='sphere')
  rows+=`<div class=row><span class=lbl>radius</span><input type=number step=0.05 value=${p.size[0]} onchange="upd('${p.id}','radius',+this.value)"></div>`;
 else if(p.prim==='box')
  rows+=`<div class=row><span class=lbl>extent</span>${[0,1,2].map(k=>`<input type=number step=0.1 min=0.01 value=${2*p.half_ext[k]} title="full box size, axis ${k}" onchange="updHE('${p.id}',${k},+this.value)">`).join('')}</div>`;
 else if(p.prim!=='mesh')
  rows+=`<div class=row><span class=lbl>size</span><input type=number step=0.1 value=${p.size[0]} onchange="upd('${p.id}','width',+this.value)">x<input type=number step=0.1 value=${p.size[1]} onchange="upd('${p.id}','height',+this.value)"></div>`;
 else
  rows+=`<div class=row><span class=lbl>xform</span><input type=number step=0.1 min=0.01 value=1 title="scale multiplier" onchange="upd('${p.id}','scale',+this.value);this.value=1">&times; <input type=number step=5 value=0 title="yaw degrees" onchange="upd('${p.id}','rotate_y',+this.value);this.value=0">&deg;</div>`;
 rows+=p.prim==='box'
  ?`<div class=row><span class=lbl>mat</span><span title="a box is always a constant-medium boundary">isotropic (medium)</span></div>`
  :`<div class=row><span class=lbl>mat</span><select onchange="upd('${p.id}','mat',this.value)">${mats.map(m=>`<option ${m===p.mat?'selected':''}>${m}</option>`).join('')}</select>
  <select onchange="if(this.value==='image'){uploadTex('${p.id}')}else{upd('${p.id}','tex',this.value)}">${texs.map(t=>`<option ${t===p.tex?'selected':''}>${t}</option>`).join('')}</select></div>`;
 rows+=`<div class=row><span class=lbl>albedo</span><input type=color value=${rgb2hex(p.albedo)} onchange="upd('${p.id}','albedo',hex2rgb(this.value))">`;
 if(p.tex==='checker'||p.tex==='noise')rows+=`<input type=color value=${rgb2hex(p.albedo2)} onchange="upd('${p.id}','albedo2',hex2rgb(this.value))">`;
 rows+=`</div>`;
 if(p.tex==='noise')rows+=`<div class=row><span class=lbl>scale</span><input type=number step=1 min=1 value=${Math.max(p.tex_id||1,1)} title="marble scale (tex_id reused)" onchange="upd('${p.id}','tex_id',Math.max(1,Math.round(+this.value)))"></div>`;
 if(p.mat==='metal')rows+=`<div class=row><span class=lbl>fuzz</span><input type=range min=0 max=1 step=0.01 value=${p.fuzz} onchange="upd('${p.id}','fuzz',+this.value)"><span>${p.fuzz.toFixed(2)}</span></div>`;
 if(p.mat==='dielectric')rows+=`<div class=row><span class=lbl>ior</span><input type=number step=0.05 value=${p.ior} onchange="upd('${p.id}','ior',+this.value)"></div>`;
 if(p.mat==='diffuse_light')rows+=`<div class=row><span class=lbl>light</span><input type=range min=0 max=10 step=1 value=${p.light} onchange="upd('${p.id}','light',+this.value)"><span>${p.light}</span></div>`;
 if(p.mat==='isotropic')rows+=`<div class=row><span class=lbl>density</span><input type=number step=0.1 min=0.01 value=${p.density||1} title="constant-medium density (smoke/fog)" onchange="upd('${p.id}','density',Math.max(0.01,+this.value))"></div>`;
 const label=p.prim==='mesh'?`${p.id} mesh (${p.tris} tris)`:`#${p.id} ${p.prim}`;
 return `<details class=prim data-id=${p.id}><summary>${label} / ${p.mat}
  <button onclick="event.preventDefault();post('/edit',{op:'delete',id:'${p.id}'})">x</button></summary>${rows}</details>`}
function renderScene(){
 const el=document.getElementById('scene');
 const open=new Set([...el.querySelectorAll('details[open]')].map(d=>d.dataset.id));
 el.innerHTML=S.scene.map(primPanel).join('');
 for(const d of el.querySelectorAll('details'))if(open.has(d.dataset.id))d.open=true}
let cflt='';
async function copyConsole(){const r=await fetch('/console.txt?filter='+encodeURIComponent(cflt));
 const t=await r.text();try{await navigator.clipboard.writeText(t)}catch(e){
  const a=document.createElement('a');a.href='data:text/plain,'+encodeURIComponent(t);
  a.download='console.txt';a.click()}}
async function state(){try{const r=await fetch('/state?filter='+encodeURIComponent(cflt));const s=await r.json();S=s;
 const st=document.getElementById('status');
 st.textContent=(s.options.paused?'\\u23f8 PAUSED':'\\u25b6 RUNNING')+' \\u00b7 '+s.options.accumulated_spp+' spp accumulated';
 st.style.color=s.options.paused?'#e0af68':'#9ece6a';
 document.getElementById('metrics').innerHTML=Object.entries(s.metrics).map(([k,v])=>`<tr><td>${k}</td><td>${v}</td></tr>`).join('');
 document.getElementById('console').innerHTML=s.console.map(esc).join('\\n');
 const sig=JSON.stringify(s.scene);
 if(sig!==sceneSig&&!document.getElementById('scene').contains(document.activeElement)){
  sceneSig=sig;renderScene()}
 const ss=document.getElementById('sceneSel');
 if(!ss.options.length&&s.options.scenes)for(const n of s.options.scenes){const o=document.createElement('option');o.textContent=n;ss.add(o)}
 if(document.activeElement!==ss)ss.value=s.options.scene;
 if(document.activeElement.id!=='depth')document.getElementById('depth').value=s.options.max_depth;
 if(document.activeElement.id!=='spp')document.getElementById('spp').value=s.options.spp;
 if(document.activeElement.id!=='apert')document.getElementById('apert').value=s.options.aperture;
 if(document.activeElement.id!=='fdist')document.getElementById('fdist').value=s.options.focus_dist;
 if(document.activeElement.id!=='dns')document.getElementById('dns').checked=!!s.options.denoise;
 if(document.activeElement.id!=='nee')document.getElementById('nee').checked=!!s.options.nee;
 if(document.activeElement.id!=='qmc')document.getElementById('qmc').checked=!!s.options.qmc;
 for(const [el,v] of [['cx',s.camera.position[0]],['cy',s.camera.position[1]],['cz',s.camera.position[2]],
  ['cyaw',s.camera.yaw],['cpitch',s.camera.pitch],['cfov',s.camera.fov]])
  if(document.activeElement.id!==el)document.getElementById(el).value=v;
}catch(e){} setTimeout(state,700)}
state();
function setCam(){post('/options',{camera:{position:[+cx.value,+cy.value,+cz.value],
 yaw:+cyaw.value,pitch:+cpitch.value,fov:+cfov.value}})}
function setOpt(){post('/options',{max_depth:+document.getElementById('depth').value,
 spp:+document.getElementById('spp').value})}
function setBg(){post('/options',{background_start:hex2rgb(document.getElementById('bg0').value),
 background_end:hex2rgb(document.getElementById('bg1').value)})}
function addPrim(){const t=document.getElementById('addtype').value,m=document.getElementById('addmat').value;
 if(t==='smoke_box'){post('/edit',{op:'add',prim:'box',mat:'isotropic',center:[0,1,0]});return}
 if(['icosphere','torus','box'].includes(t))post('/edit',{op:'add_mesh',shape:t,mat:m,center:[0,1,0],scale:0.7});
 else post('/edit',{op:'add',prim:t,mat:m,center:[0,1,0],radius:0.5,width:2,height:2})}
function uploadObj(){const f=document.getElementById('objfile');f.value='';
 f.onchange=async()=>{if(f.files[0]){await fetch('/mesh?mat='+document.getElementById('addmat').value,{method:'POST',body:f.files[0]})}};
 f.click()}
function importScene(){const f=document.getElementById('scenefile');f.value='';
 f.onchange=async()=>{if(f.files[0]){const t=await f.files[0].text();
  await fetch('/scene.json',{method:'POST',body:t})}};
 f.click()}
function uploadTex(id){const f=document.getElementById('texfile');f.value='';
 f.onchange=async()=>{if(f.files[0]){await fetch('/texture?id='+id,{method:'POST',body:f.files[0]})}};
 f.click()}
</script></body></html>"""

from ..models.scenes import SCENES as _SCENE_REGISTRY

try:  # JPEG encoding and image-file decoding are Pillow's (optional)
    import PIL.Image  # noqa: F401

    _HAVE_PILLOW = True
except ImportError:
    _HAVE_PILLOW = False


def _mesh_mid(obj_id) -> int | None:
    """Panel object ids are slot ints (plain primitives) or "m<gid>"
    strings (mesh groups, state_json); returns the group id or None."""
    s = str(obj_id)
    if s.startswith("m"):
        return int(s[1:])
    return None


_PRIM_IDS = {v: k for k, v in scene_mod.PRIM_NAMES.items()}
_MAT_IDS = {v: k for k, v in scene_mod.MAT_NAMES.items()}
_TEX_IDS = {v: k for k, v in scene_mod.TEX_NAMES.items()}


class ViewerServer:
    def __init__(self, app: Application, host: str = "127.0.0.1", port: int = 8000,
                 data_dir: str | None = None):
        self.app = app
        self.host = host
        self.port = port
        # scene/checkpoint files are confined to data_dir: a client that can
        # reach the port must not get arbitrary filesystem read/write
        self.data_dir = os.path.abspath(data_dir or os.getcwd())
        self._httpd: ThreadingHTTPServer | None = None

    def _safe_path(self, name) -> str:
        p = os.path.normpath(str(name))
        if os.path.isabs(p) or p == ".." or p.startswith(".." + os.sep):
            raise ValueError(f"path {name!r} escapes the viewer data directory")
        return os.path.join(self.data_dir, p)

    # ------------------------------------------------------------ state
    def state_json(self, console_filter: str = "") -> dict:
        rl = self.app.render_layer
        scene = rl.scene
        prims = []
        for i in scene.active_indices():
            if scene.mesh_id[i] >= 0:
                continue  # grouped below: a mesh is ONE object in the panel
            entry = {
                "id": int(i),
                "prim": scene_mod.PRIM_NAMES[int(scene.prim_type[i])],
                "mat": scene_mod.MAT_NAMES[int(scene.mat_type[i])],
                "tex": scene_mod.TEX_NAMES[int(scene.tex_type[i])],
                "center": [round(float(v), 4) for v in scene.center[i]],
                "size": [round(float(v), 4) for v in scene.size[i]],
                "albedo": [round(float(v), 4) for v in scene.albedo[i]],
                "albedo2": [round(float(v), 4) for v in scene.albedo2[i]],
                "tex_id": int(scene.tex_id[i]),
                "density": round(float(scene.density[i]), 4),
                "fuzz": round(float(scene.fuzz[i]), 4),
                "ior": round(float(scene.ior[i]), 4),
                "light": round(float(scene.light[i]), 4),
            }
            if int(scene.prim_type[i]) == scene_mod.BOX:
                # medium boxes edit their half-extents (edge1 rows)
                entry["half_ext"] = [round(float(v), 4)
                                     for v in scene.edge1[i]]
            prims.append(entry)
        for mid in scene.mesh_group_ids():
            idx = scene.mesh_indices(mid)
            i = int(idx[0])  # add_mesh gives every triangle one material
            prims.append({
                "id": f"m{mid}",
                "prim": "mesh",
                "tris": int(idx.size),
                "mat": scene_mod.MAT_NAMES[int(scene.mat_type[i])],
                "tex": scene_mod.TEX_NAMES[int(scene.tex_type[i])],
                # editable position = v0 centroid; updates translate the mesh
                "center": [round(float(v), 4)
                           for v in scene.center[idx].mean(0)],
                "size": [0.0, 0.0],
                "albedo": [round(float(v), 4) for v in scene.albedo[i]],
                "albedo2": [round(float(v), 4) for v in scene.albedo2[i]],
                "tex_id": int(scene.tex_id[i]),
                "density": round(float(scene.density[i]), 4),
                "fuzz": round(float(scene.fuzz[i]), 4),
                "ior": round(float(scene.ior[i]), 4),
                "light": round(float(scene.light[i]), 4),
            })
        return {
            "metrics": rl.metrics.snapshot(),
            "camera": {
                "position": [round(float(v), 4) for v in rl.fly.position],
                "yaw": round(rl.fly.yaw, 2),
                "pitch": round(rl.fly.pitch, 2),
                "fov": round(rl.fly.fov_deg, 2),
            },
            "scene": prims,
            # server-side text filter: the ImGuiTextFilter behavior of the
            # reference Console panel (Console.h:41-82)
            "console": self.app.console.lines(console_filter)[-60:],
            "options": {
                "max_depth": rl.cfg.max_depth,
                "spp": rl.cfg.spp,
                "paused": self.app.paused,
                "accumulated_spp": rl._spp_done,
                "scene": rl.cfg.scene,
                "scenes": list(_SCENE_REGISTRY),
                "aperture": round(float(rl.cfg.aperture), 4),
                "focus_dist": round(float(rl.cfg.focus_dist), 4),
                "denoise": bool(getattr(rl.cfg, "denoise", False)),
                "nee": bool(getattr(rl.cfg, "nee", False)),
                "qmc": bool(getattr(rl.cfg, "qmc", False)),
                # /frame.jpg needs Pillow; the page polls /frame.png
                # when it is absent
                "jpeg": _HAVE_PILLOW,
            },
        }

    def handle_input(self, data: dict):
        rl = self.app.render_layer
        keys = data.get("keys", [])
        if keys:
            rl.fly.process_keys(keys, shift=bool(data.get("shift")))
        dx, dy = data.get("mouse_dx", 0), data.get("mouse_dy", 0)
        if dx or dy:
            rl.fly.process_mouse(float(dx), float(dy))
        if data.get("scroll"):
            rl.fly.process_scroll(float(data["scroll"]))

    def handle_edit(self, data: dict):
        rl = self.app.render_layer
        scene = rl.scene
        op = data.get("op")
        if op in ("add", "add_mesh", "update"):
            # reject non-finite numerics up front: one NaN center/radius
            # poisons the packed tables for every later frame (the browser
            # number inputs can submit NaN via 'e'/empty strings)
            def _chk(v):
                if isinstance(v, (int, float)) and not math.isfinite(v):
                    raise ValueError(f"non-finite value in edit: {data!r}")
                if isinstance(v, (list, tuple)):
                    for x in v:
                        _chk(x)

            for key in ("center", "radius", "width", "height", "value",
                        "scale", "fuzz", "ior", "light"):
                if key in data:
                    _chk(data[key])
        if op == "add":
            prim = _PRIM_IDS.get(data.get("prim", "sphere"), 0)
            mat = _MAT_IDS.get(data.get("mat", "lambertian"), 0)
            center = data.get("center", [0.0, 1.0, 0.0])
            kw = dict(mat_type=mat)
            if prim == scene_mod.BOX:
                # medium box (always ISOTROPIC): full extents, default 1.5
                ext = data.get("extents", (1.5, 1.5, 1.5))
                scene.add_medium_box(
                    center, ext, density=float(data.get("density", 1.0)))
            elif prim == scene_mod.SPHERE:
                scene.add_sphere(center, float(data.get("radius", 0.5)), **kw)
            else:
                add = {1: scene.add_xy_rect, 2: scene.add_xz_rect, 3: scene.add_yz_rect}[prim]
                add(center, float(data.get("width", 2.0)), float(data.get("height", 2.0)), **kw)
            rtlog.rt_info("Added %s (%s)", data.get("prim"), data.get("mat"))
        elif op == "add_mesh":
            # procedural mesh shapes from the panel (BEYOND-REFERENCE: the
            # reference's AddHittable knows spheres/rects only)
            from ..utils import mesh as meshlib

            shape = data.get("shape", "icosphere")
            builders = {
                "icosphere": (lambda: meshlib.icosphere(2), True),
                "torus": (lambda: meshlib.torus(1.0, 0.35, segments=16,
                                                sides=10), True),
                "box": (lambda: meshlib.box((1.0, 1.0, 1.0)), False),
            }
            if shape not in builders:
                raise ValueError(f"unknown mesh shape {shape!r}")
            build, smooth = builders[shape]
            v, f = build()
            ids = scene.add_mesh(
                meshlib.transformed(v, scale=float(data.get("scale", 0.7)),
                                    translate=data.get("center", (0, 1, 0))),
                f, smooth=smooth,
                mat_type=_MAT_IDS.get(data.get("mat", "lambertian"), 0))
            rtlog.rt_info("Added %s mesh m%d (%d tris)", shape,
                          int(scene.mesh_id[ids[0]]), len(ids))
        elif op == "delete":
            mid = _mesh_mid(data["id"])
            if mid is not None:
                scene.delete_mesh(mid)
                rtlog.rt_info("Deleted mesh m%d", mid)
            else:
                scene.delete(int(data["id"]))
                rtlog.rt_info("Deleted hittable %d", int(data["id"]))
        elif op == "clear":
            keep = [int(scene.active_indices()[0])] if scene.num_active else []
            scene.clear(keep=keep)
            rtlog.rt_info("Scene cleared (ground kept)")
        elif op == "update":
            mid = _mesh_mid(data["id"])
            if mid is not None:
                field, value = data["field"], data["value"]
                if field == "center":
                    # translate the whole mesh: shift every triangle's v0 by
                    # the delta from the current centroid (edges move with it)
                    idx = scene.mesh_indices(mid)
                    delta = (np.asarray(value, np.float32)
                             - scene.center[idx].mean(0))
                    for j in idx:
                        scene.update(int(j), center=scene.center[j] + delta)
                elif field == "scale":
                    scene.transform_mesh(mid, scale=max(1e-3, float(value)))
                elif field == "rotate_y":
                    scene.transform_mesh(
                        mid, rotate_y=math.radians(float(value)))
                elif field in ("mat", "material"):
                    scene.update_mesh(mid, mat_type=_MAT_IDS[value])
                elif field in ("tex", "texture"):
                    scene.update_mesh(mid, tex_type=_TEX_IDS[value])
                elif field == "fuzz":
                    scene.update_mesh(
                        mid, fuzz=min(1.0, max(0.0, float(value))))
                elif field in ("radius", "width", "height"):
                    raise ValueError(f"meshes have no {field!r} field")
                else:
                    scene.update_mesh(mid, **{field: value})
                rtlog.rt_info("Updated mesh m%d: %s", mid, field)
                return
            i, field, value = int(data["id"]), data["field"], data["value"]
            if field == "half_ext":
                # medium-BOX geometry: half-extents live in the edge1 rows;
                # size mirrors (he_x, he_y) (the add_medium_box invariant)
                he = np.abs(np.asarray(value, np.float32)).reshape(3)
                he = np.maximum(he, 1e-3)
                scene.update(i, edge1=he, size=(float(he[0]), float(he[1])))
            elif field == "radius":
                scene.update(i, size=(float(value), float(value)))
            elif field == "width":
                scene.update(i, size=(float(value), float(scene.size[i][1])))
            elif field == "height":
                scene.update(i, size=(float(scene.size[i][0]), float(value)))
            elif field in ("mat", "material"):
                scene.update(i, mat_type=_MAT_IDS[value])
            elif field in ("tex", "texture"):
                # TextureNode combo switch (CudaLayer.cpp:806-872)
                scene.update(i, tex_type=_TEX_IDS[value])
            elif field == "fuzz":
                # reference Metal ctor clamps fuzz to [0, 1] (Material.cuh:70)
                scene.update(i, fuzz=min(1.0, max(0.0, float(value))))
            else:
                scene.update(i, **{field: value})
            rtlog.rt_info("Updated hittable %d: %s", i, field)

    def handle_options(self, data: dict):
        rl = self.app.render_layer
        # non-finite numerics poison the camera vector or scene tables
        # for every later frame (same guard as /edit): reject up front.
        # The browser's number inputs post NaN for 'e'/empty strings.
        def _chk(v):
            if isinstance(v, (int, float)) and not math.isfinite(v):
                raise ValueError(f"non-finite value in options: {data!r}")
            if isinstance(v, (list, tuple)):
                for x in v:
                    _chk(x)
            if isinstance(v, dict):
                for x in v.values():
                    _chk(x)

        for key in ("aperture", "focus_dist", "camera", "background_start",
                    "background_end", "resize", "max_depth", "spp"):
            if key in data:
                _chk(data[key])
        if "max_depth" in data:
            # UI caps depth at 50 like the reference (CudaLayer.cpp:681)
            rl.cfg.max_depth = max(0, min(50, int(data["max_depth"])))
            rl.reset_accumulation()
        if "spp" in data:
            rl.cfg.spp = max(1, int(data["spp"]))
            rl.reset_accumulation()
        if "denoise" in data:
            # DISPLAY-time toggle: the accumulator is untouched, so no
            # accumulation restart and no pipeline rebuild — the next
            # frame fetch simply routes through ops/denoise.py
            rl.cfg.denoise = bool(data["denoise"])
            rtlog.rt_info("Denoiser %s",
                          "enabled" if rl.cfg.denoise else "disabled")
        if "nee" in data:
            want = bool(data["nee"])
            if want != bool(getattr(rl.cfg, "nee", False)):
                # the estimator switch is STATIC (it compiles a different
                # transport into the renderer): rebuild the Renderer,
                # which captures nee at construction
                rl.cfg.nee = want
                rl.rebuild_renderer()
                rtlog.rt_info(
                    "Importance sampling (NEE) %s — pipeline recompiles "
                    "once (estimator is a static graph switch)",
                    "enabled" if want else "disabled")
        if "qmc" in data:
            want = bool(data["qmc"])
            if want != bool(getattr(rl.cfg, "qmc", False)):
                # the pixel sampler is STATIC (it compiles the R2 jitter
                # into the raygen): rebuild, same as the NEE toggle.
                rl.cfg.qmc = want
                rl.rebuild_renderer()
                rtlog.rt_info(
                    "Low-discrepancy pixel sampling (QMC) %s — pipeline "
                    "recompiles once (sampler is a static graph switch)",
                    "enabled" if want else "disabled")
        if "aperture" in data or "focus_dist" in data:
            # thin-lens defocus blur (look_at camera; RTOW 12.2 semantics).
            # aperture/focus ride the per-frame camera vector — a traced
            # change, no recompile; bump the camera version (accumulator
            # restart) only when a value actually changes.  A non-positive
            # focus (e.g. an empty panel input posting 0) is ignored, not
            # clamped to a degenerate lens.
            ap = max(0.0, float(data.get("aperture", rl.cfg.aperture)))
            fd = float(data.get("focus_dist", rl.cfg.focus_dist))
            if fd <= 0.0:
                fd = rl.cfg.focus_dist
            if (ap, fd) != (rl.cfg.aperture, rl.cfg.focus_dist):
                rl.cfg.aperture, rl.cfg.focus_dist = ap, fd
                rl.fly.version += 1
        if "background_start" in data:
            rl.scene.background_start = np.asarray(data["background_start"], np.float32)
            rl.scene.version += 1
        if "background_end" in data:
            rl.scene.background_end = np.asarray(data["background_end"], np.float32)
            rl.scene.version += 1
        if "camera" in data:
            # numeric camera editing (the reference Options panel's
            # position/orientation/fov fields, CudaLayer.cpp:655-671)
            c = data["camera"]
            if "position" in c:
                rl.fly.position = [float(v) for v in c["position"]]
            if "yaw" in c:
                rl.fly.yaw = float(c["yaw"])
            if "pitch" in c:
                rl.fly.pitch = max(-89.0, min(89.0, float(c["pitch"])))
            if "fov" in c:
                rl.fly.fov_deg = max(1.0, min(120.0, float(c["fov"])))
            rl.fly._update_orientation()
            rl.fly.version += 1
        if "scene" in data:
            name = str(data["scene"])
            if name not in _SCENE_REGISTRY:
                raise ValueError(f"unknown scene {name!r}")
            if name != rl.cfg.scene:
                rl.set_scene(name)
        if "resize" in data:
            w, h = data["resize"]
            rl.resize(int(w), int(h))
        if data.get("pause"):
            self.app.toggle_pause()
        if data.get("console_clear"):
            # the Console panel's Clear button (Console.h:50)
            self.app.console.clear()
        if "save" in data:
            path = self._safe_path(data["save"])
            rl.scene.save(path)
            rtlog.rt_info("Scene saved to %s", path)
        if "load" in data:
            rl.scene = scene_mod.Scene.load(self._safe_path(data["load"]))
            rl._scene_version = -1
            rtlog.rt_info("Scene loaded from %s", data["load"])
        if "checkpoint" in data:
            rl.save_state(self._safe_path(data["checkpoint"]))
        if "resume" in data:
            rl.load_state(self._safe_path(data["resume"]))

    def handle_texture_upload(self, prim_id, image_bytes: bytes):
        """Image-texture upload: the file-dialog + ImageAllocation path
        (CudaLayer.cpp:846-916) — decode, stage into the atlas, point the
        primitive's (or whole mesh's) texture at the slot."""
        import io as _io

        from ..utils.image import require_pillow

        Image = require_pillow("image-texture upload")
        mid = _mesh_mid(prim_id)
        if mid is not None:
            scene = self.app.render_layer.scene
            img = Image.open(_io.BytesIO(image_bytes)).convert("RGB")
            idx = scene.mesh_indices(mid)
            old = int(scene.tex_id[idx[0]]) if idx.size else -1
            slot = scene.load_image_texture(img)
            scene.update_mesh(mid, tex_type=scene_mod.IMAGE, tex_id=slot)
            if old >= 0:
                scene.free_image_texture(old)
            rtlog.rt_info("Loaded %dx%d image texture into slot %d (mesh m%d)",
                          img.width, img.height, slot, mid)
            return
        prim_id = int(prim_id)

        rl = self.app.render_layer
        scene = rl.scene
        img = Image.open(_io.BytesIO(image_bytes)).convert("RGB")
        old = int(scene.tex_id[prim_id])
        slot = scene.load_image_texture(img)
        scene.update(prim_id, tex_type=scene_mod.IMAGE, tex_id=slot)
        if old >= 0:
            scene.free_image_texture(old)
        rtlog.rt_info("Loaded %dx%d image texture into slot %d (hittable %d)",
                      img.width, img.height, slot, prim_id)

    def handle_mesh_upload(self, body: bytes, mat: str = "lambertian",
                           scale: float = 1.0) -> dict:
        """OBJ upload: parse, normalize to a unit bounding box centered at
        the panel spawn point, and add as one mesh group (the mesh analog
        of the reference's ImGuiFileDialog texture loading)."""
        import io as _io

        from ..utils import mesh as meshlib

        m = meshlib.load_obj_full(
            _io.StringIO(body.decode("utf-8", "replace")))
        v = m.vertices
        lo, hi = v.min(0), v.max(0)
        extent = float((hi - lo).max())
        v = (v - (lo + hi) * 0.5) / max(extent, 1e-12)  # fit a unit box
        scene = self.app.render_layer.scene
        ids = scene.add_mesh(
            meshlib.transformed(v, scale=float(scale),
                                translate=(0.0, 1.0, 0.0)),
            m.faces, **m.attrs(),
            mat_type=_MAT_IDS.get(mat, 0))
        mid = int(scene.mesh_id[ids[0]])
        rtlog.rt_info("Loaded OBJ mesh m%d (%d tris)", mid, len(ids))
        return {"id": f"m{mid}", "tris": len(ids)}

    def frame_png(self, scale: int = 1) -> bytes:
        """Encode the current framebuffer; cached per (spp, scale) so
        repeated polls between progressive frames cost no device pull."""
        from ..utils.image import encode_png

        rl = self.app.render_layer
        key = (rl._spp_done, rl._frame_index, int(scale))
        cached = getattr(self, "_png_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        # level 1: on a noisy frame zlib's higher levels cost several
        # times the time for a few per cent fewer bytes
        data = encode_png(rl.framebuffer_rgba8(scale=int(scale)), level=1)
        self._png_cache = (key, data)
        return data

    def frame_jpeg(self, scale: int = 1, quality: int = 85) -> bytes:
        """JPEG framebuffer — the viewer's poll format when Pillow is
        installed: on big noisy scenes the lossless PNG is several times
        the bytes, while MC render noise is exactly what JPEG's DCT
        quantization hides.  The progressive accumulator is untouched —
        /frame.png and /radiance.pfm remain the lossless paths.  Cached
        per (spp, frame, scale, q) like the PNG."""
        from ..utils.image import require_pillow

        Image = require_pillow("/frame.jpg")

        rl = self.app.render_layer
        quality = max(1, min(100, int(quality)))
        key = (rl._spp_done, rl._frame_index, int(scale), quality)
        cached = getattr(self, "_jpg_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        img = rl.framebuffer_rgba8(scale=int(scale))
        buf = io.BytesIO()
        Image.fromarray(img[..., :3], "RGB").save(
            buf, "JPEG", quality=quality)
        data = buf.getvalue()
        self._jpg_cache = (key, data)
        return data

    # ------------------------------------------------------------ server
    def make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if self.path.startswith("/frame.png"):
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        scale = max(1, int(q.get("scale", ["1"])[0]))
                        self._send(200, viewer.frame_png(scale), "image/png")
                    elif self.path.startswith("/frame.jpg"):
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        scale = max(1, int(q.get("scale", ["1"])[0]))
                        qual = int(q.get("q", ["85"])[0])
                        self._send(200, viewer.frame_jpeg(scale, qual),
                                   "image/jpeg")
                    elif self.path.startswith("/state"):
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        flt = q.get("filter", [""])[0]
                        self._send(200, json.dumps(
                            viewer.state_json(flt)).encode(), "application/json")
                    elif self.path.startswith("/radiance.pfm"):
                        # HDR download: linear mean radiance as color PFM
                        # (matches `render -o out.pfm`)
                        import io as _io

                        from ..utils.image import save_pfm

                        buf = _io.BytesIO()
                        save_pfm(buf,
                                 viewer.app.render_layer.radiance_mean())
                        self._send(200, buf.getvalue(),
                                   "application/octet-stream")
                    elif self.path.startswith("/scene.json"):
                        # portable scene download: ONE document with the
                        # atlas embedded (docs/SCENE_FORMAT.md atlas_b64)
                        doc = viewer.app.render_layer.scene.to_doc(
                            embed_atlas=True)
                        body = json.dumps(doc).encode()
                        self._send(200, body, "application/json")
                    elif self.path.startswith("/console.txt"):
                        # full filtered buffer for the Copy button
                        # (Console.h:51 LogToClipboard)
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        flt = q.get("filter", [""])[0]
                        self._send(200, viewer.app.console.copy_text(
                            flt).encode(), "text/plain; charset=utf-8")
                    else:
                        self._send(200, _PAGE.encode(), "text/html")
                except Exception as e:  # keep the viewer alive
                    self._send(500, str(e).encode(), "text/plain")

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    data_raw = self.rfile.read(n)
                    raw_body = (self.path.startswith("/texture")
                                or self.path.startswith("/mesh"))
                    data = json.loads(data_raw or b"{}") if not raw_body else None
                    if self.path.startswith("/mesh"):
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        out = viewer.handle_mesh_upload(
                            data_raw,
                            mat=q.get("mat", ["lambertian"])[0],
                            scale=float(q.get("scale", ["1.0"])[0]))
                        self._send(200, json.dumps(out).encode(),
                                   "application/json")
                        return
                    if self.path.startswith("/texture"):
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        viewer.handle_texture_upload(q["id"][0], data_raw)
                        self._send(200, b"{}", "application/json")
                        return
                    if self.path == "/scene.json":
                        # portable scene import (inverse of GET /scene.json).
                        # Bound the document before allocating: a malformed
                        # capacity would OOM the render server on this
                        # HTTP thread (SoA arrays are capacity-sized)
                        cap = int(data.get("capacity", 0))
                        nprim = len(data.get("primitives", []))
                        if not (0 < cap <= 65536 and nprim <= 65536):
                            raise ValueError(
                                f"scene document out of bounds: "
                                f"capacity={cap} primitives={nprim}")
                        rl = viewer.app.render_layer
                        rl.scene = scene_mod.Scene.from_doc(data)
                        rl._scene_version = -1
                        rtlog.rt_info(
                            "Scene imported from browser (%d primitives)",
                            rl.scene.num_active)
                    elif self.path == "/input":
                        viewer.handle_input(data)
                    elif self.path == "/edit":
                        viewer.handle_edit(data)
                    elif self.path == "/options":
                        viewer.handle_options(data)
                    self._send(200, b"{}", "application/json")
                except Exception as e:
                    self._send(500, str(e).encode(), "text/plain")

        return Handler

    def start(self):
        self._httpd = ThreadingHTTPServer((self.host, self.port), self.make_handler())
        self.port = self._httpd.server_address[1]  # port 0 = ephemeral
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        rtlog.rt_info("Viewer at http://%s:%d", self.host, self.port)
        return self._httpd

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
