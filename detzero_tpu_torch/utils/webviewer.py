"""Interactive sequence viewer — single-file HTML, zero dependencies
(port of detzero_tpu/utils/webviewer.py: NumPy, JSON and an HTML string,
copied unchanged but for this docstring; `tools/run_offboard.py
--viewer_html` calls it).

`export_sequence_html` writes a self-contained .html (point clouds
base64-embedded as Float32Array, renderer in inline vanilla JS — no CDN,
works offline) with:

  * orbit / zoom / pan camera over the 3D cloud (drag / wheel /
    shift-drag) + one-click BEV / front / reset presets;
  * play / pause / speed / frame-slider sequence playback;
  * point color modes: uniform, height (z), intensity (4th channel when
    present) through a turbo-style colormap, binned for canvas speed;
  * point-size control;
  * per-class show/hide checkboxes and live color pickers (the label-LUT
    edit), GT wireframes in white; score-threshold slider;
  * predicted boxes colored by class or by track id; click a box to
    FOLLOW that track across frames and inspect it (center / dims /
    heading / score panel);
  * PNG screenshot download of the current view.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np

CLASS_COLOR_JS = {
    "Vehicle": "#33cc55", "Pedestrian": "#ff5533", "Cyclist": "#4488ff",
}


def _pack_points(points, max_points, rng):
    """Pack xyz (+ intensity when a 4th column exists) as base64 f32."""
    pts = np.asarray(points, np.float32)
    nch = 4 if pts.ndim == 2 and pts.shape[1] >= 4 else 3
    pts = pts[:, :nch] if len(pts) else pts.reshape(0, nch)
    if len(pts) > max_points:
        pts = pts[rng.choice(len(pts), max_points, replace=False)]
    return base64.b64encode(np.ascontiguousarray(pts).tobytes()).decode(), nch


def _boxes_payload(boxes, names=None, scores=None, ids=None):
    boxes = np.asarray(boxes, np.float32).reshape(-1, 7)
    out = []
    for i, b in enumerate(boxes):
        out.append({
            "b": [round(float(v), 3) for v in b],
            "n": str(names[i]) if names is not None else "Vehicle",
            "s": round(float(scores[i]), 3) if scores is not None else 1.0,
            "id": int(ids[i]) if ids is not None else -1,
        })
    return out


def export_sequence_html(frames, out_path, title="detzero_tpu sequence",
                         max_points=15000, seed=0):
    """frames: list of dicts {'points' (N,3+), 'boxes' (M,7)?, 'names'?,
    'scores'?, 'obj_ids'?, 'gt_boxes'?, 'gt_names'?}. Writes out_path."""
    rng = np.random.RandomState(seed)
    payload = []
    for fr in frames:
        pts_b64, nch = _pack_points(fr.get("points", np.zeros((0, 3))),
                                    max_points, rng)
        entry = {"pts": pts_b64, "pc": nch}
        if fr.get("boxes") is not None and len(np.asarray(fr["boxes"])):
            entry["det"] = _boxes_payload(fr["boxes"], fr.get("names"),
                                          fr.get("scores"),
                                          fr.get("obj_ids"))
        if fr.get("gt_boxes") is not None and len(np.asarray(fr["gt_boxes"])):
            entry["gt"] = _boxes_payload(fr["gt_boxes"], fr.get("gt_names"))
        payload.append(entry)
    html = _TEMPLATE.replace("__TITLE__", title) \
        .replace("__DATA__", json.dumps(payload)) \
        .replace("__COLORS__", json.dumps(CLASS_COLOR_JS))
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(html)
    return out_path


def export_from_offboard(final_frames, frame_points, class_names=(
        "Vehicle", "Pedestrian", "Cyclist"), poses=None, gt_boxes=None,
        gt_names=None, out_path="sequence.html", **kw):
    """Adapter for pipeline artifacts: combine_output frames + raw points.

    combine_output boxes live in the GLOBAL frame; pass the per-frame
    lidar->global `poses` so the (lidar-frame) points are transformed to
    match — without them, any sequence with real ego motion renders boxes
    far from the cloud."""
    frames = []
    for i, fr in enumerate(final_frames):
        labels = np.asarray(fr.get("labels", np.zeros(len(fr["boxes"]))))
        names = [class_names[int(l)] if not isinstance(l, str) else l
                 for l in labels]
        pts = (np.asarray(frame_points[i], np.float32)
               if i < len(frame_points) else np.zeros((0, 3), np.float32))
        if poses is not None and i < len(poses) and len(pts):
            pose = np.asarray(poses[i], np.float32)
            pts = pts.copy()
            pts[:, :3] = pts[:, :3] @ pose[:3, :3].T + pose[:3, 3]
        frames.append({
            "points": pts,
            "boxes": fr["boxes"], "names": names, "scores": fr["scores"],
            "obj_ids": fr.get("obj_ids"),
            "gt_boxes": gt_boxes[i] if gt_boxes is not None else None,
            "gt_names": gt_names[i] if gt_names is not None else None,
        })
    return export_sequence_html(frames, out_path, **kw)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
 body{margin:0;background:#0b0e14;color:#cdd6e4;font:13px system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#141a26cc;border:1px solid #2a3550;
      border-radius:8px;padding:10px 12px;line-height:1.9;user-select:none;z-index:2}
 #hud input[type=range]{vertical-align:middle;width:110px}
 #hud input[type=color]{width:18px;height:18px;border:none;background:none;padding:0;
      vertical-align:middle;cursor:pointer}
 #hud button,select{background:#22304d;color:#cdd6e4;border:1px solid #3a4a70;border-radius:5px;
      padding:2px 10px;cursor:pointer;margin-right:4px}
 #hud button:hover{background:#2c3d63}
 #info{position:fixed;bottom:8px;left:8px;color:#8494b4;z-index:2}
 #inspect{position:fixed;top:8px;right:8px;background:#141a26cc;border:1px solid #2a3550;
      border-radius:8px;padding:10px 12px;line-height:1.6;z-index:2;display:none;
      font-family:ui-monospace,monospace;font-size:12px;min-width:190px}
 canvas{display:block}
 .sw{display:inline-block;width:10px;height:10px;border-radius:2px;margin:0 4px -1px 8px}
</style></head><body>
<div id="hud">
 <div><b>__TITLE__</b></div>
 <div><button id="play">&#9654;</button>
  frame <input id="frame" type="range" min="0" value="0" step="1">
  <span id="fno">0</span> &middot; <select id="fps">
   <option>2</option><option selected>5</option><option>10</option><option>20</option></select> fps</div>
 <div>score &ge; <input id="thr" type="range" min="0" max="100" value="0">
  <span id="thrv">0.00</span></div>
 <div>color <select id="cmode"><option value="uniform">uniform</option>
   <option value="z">height</option><option value="i">intensity</option></select>
  &middot; size <input id="psize" type="range" min="5" max="40" value="12"></div>
 <div><label><input id="showdet" type="checkbox" checked> pred</label>
  <label><input id="showgt" type="checkbox" checked> gt</label>
  <label><input id="showpts" type="checkbox" checked> points</label>
  <label><input id="bytrack" type="checkbox"> color by track</label></div>
 <div id="legend"></div>
 <div>view <button id="vbev">bev</button><button id="vfront">front</button>
  <button id="vreset">reset</button><button id="shot">&#128247; png</button></div>
 <div id="follow" style="color:#7fd08f"></div>
</div>
<div id="inspect"></div>
<div id="info">drag orbit &middot; wheel zoom &middot; shift-drag pan &middot; click box = follow + inspect &middot; esc = unfollow</div>
<canvas id="cv"></canvas>
<script>
const DATA=__DATA__, COLORS=__COLORS__;
const cv=document.getElementById('cv'), ctx=cv.getContext('2d');
let W,H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
addEventListener('resize',resize);
// decode base64 Float32Array point clouds once; per-frame channel count in .pc
const clouds=DATA.map(f=>{const raw=atob(f.pts);const buf=new ArrayBuffer(raw.length);
 const u8=new Uint8Array(buf);for(let i=0;i<raw.length;i++)u8[i]=raw.charCodeAt(i);
 return new Float32Array(buf);});
const NCH=DATA.map(f=>f.pc||3);
if(!DATA.some((f,i)=>NCH[i]>=4))document.querySelector('#cmode option[value=i]').disabled=true;
// camera state
let yaw=-0.9,pitch=0.9,dist=60,target=[0,0,0],followId=null,inspected=null;
let fi=0,playing=false;
const el=id=>document.getElementById(id);
el('frame').max=DATA.length-1;
// per-class label LUT: visibility checkbox + live color picker (the
// reference's LabelLUTEdit). Classes = palette keys U names in the data.
const classSet=new Set(Object.keys(COLORS));
DATA.forEach(f=>(f.det||[]).concat(f.gt||[]).forEach(o=>classSet.add(o.n)));
const clsVis={};
el('legend').innerHTML=[...classSet].map(k=>{clsVis[k]=true;
 return `<label><input type="checkbox" class="cvis" data-k="${k}" checked>`+
  `<input type="color" class="ccol" data-k="${k}" value="${COLORS[k]||'#33cc55'}"> ${k}</label>`;
}).join(' ')+' <span class="sw" style="background:#fff"></span>GT';
document.querySelectorAll('.cvis').forEach(b=>b.oninput=e=>{clsVis[e.target.dataset.k]=e.target.checked;draw();});
document.querySelectorAll('.ccol').forEach(b=>b.oninput=e=>{COLORS[e.target.dataset.k]=e.target.value;draw();});
// turbo-style 6-stop colormap, quantized to 24 bins for batched canvas draws
const STOPS=[[48,18,59],[65,69,171],[57,140,247],[31,201,163],[114,239,74],[250,235,34]];
const NBIN=24, BINCOL=[];
for(let b=0;b<NBIN;b++){const t=b/(NBIN-1)*(STOPS.length-1),j=Math.min(STOPS.length-2,t|0),u=t-j;
 BINCOL.push('rgb('+STOPS[j].map((v,k)=>Math.round(v+(STOPS[j+1][k]-v)*u)).join(',')+')');}
// lazy per-frame bin index per color mode (z: channel 2, i: channel 3)
const binCache={};
function bins(fi,mode){const key=fi+mode;if(binCache[key])return binCache[key];
 const P=clouds[fi],n=NCH[fi],ch=mode==='z'?2:3,N=P.length/n;
 let lo=1e30,hi=-1e30;
 for(let i=0;i<N;i++){const v=P[i*n+ch];if(v<lo)lo=v;if(v>hi)hi=v;}
 if(mode==='z'){lo=Math.max(lo,-3);hi=Math.min(hi,lo+8);} // clip road..canopy
 const s=hi>lo?(NBIN-1)/(hi-lo):0, out=new Uint8Array(N);
 for(let i=0;i<N;i++){const b=(P[i*n+ch]-lo)*s;out[i]=b<0?0:b>NBIN-1?NBIN-1:b;}
 return binCache[key]=out;}
function proj(x,y,z){ // world -> screen (orbit camera, perspective)
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 let dx=x-target[0],dy=y-target[1],dz=z-target[2];
 let x1=dx*cy+dy*sy, y1=-dx*sy+dy*cy;          // yaw about z
 let y2=y1*cp+dz*sp, z2=-y1*sp+dz*cp;          // pitch
 const d=x1+dist;                              // camera looks along -x1
 if(d<0.5)return null;
 const f=0.9*Math.min(W,H);
 return [W/2+f*y2/d, H/2-f*z2/d, d];
}
function boxCorners(b){const[x,y,z,dx,dy,dz,h]=b;const c=Math.cos(h),s=Math.sin(h);
 const out=[];for(const sx of[.5,-.5])for(const sy of[.5,-.5])for(const sz of[.5,-.5]){
  const lx=sx*dx,ly=sy*dy;out.push([x+lx*c-ly*s,y+lx*s+ly*c,z+sz*dz]);}return out;}
const EDGES=[[0,1],[0,2],[1,3],[2,3],[4,5],[4,6],[5,7],[6,7],[0,4],[1,5],[2,6],[3,7]];
function trackColor(id){const h=(id*2654435761>>>0)%360;return `hsl(${h},75%,60%)`;}
let boxHits=[]; // for click-to-follow/inspect
function drawBoxes(list,useTrack,defWhite){
 for(const o of list){
  if(!clsVis[o.n])continue;
  const thr=+el('thr').value/100; if(!defWhite&&o.s<thr)continue;
  const col=defWhite?'#ffffff':(useTrack&&o.id>=0?trackColor(o.id):(COLORS[o.n]||'#33cc55'));
  const cs=boxCorners(o.b).map(p=>proj(...p)); if(cs.some(p=>!p))continue;
  ctx.strokeStyle=col;ctx.lineWidth=defWhite?1:1.6;ctx.setLineDash(defWhite?[4,3]:[]);
  ctx.beginPath();
  for(const[a,b2]of EDGES){ctx.moveTo(cs[a][0],cs[a][1]);ctx.lineTo(cs[b2][0],cs[b2][1]);}
  ctx.stroke();ctx.setLineDash([]);
  const cx=cs.reduce((s,p)=>s+p[0],0)/8, cy2=cs.reduce((s,p)=>s+p[1],0)/8;
  if(!defWhite){boxHits.push([cx,cy2,o]);
   if(o.id>=0){ctx.fillStyle=col;ctx.font='11px monospace';
    ctx.fillText('#'+o.id+' '+o.s.toFixed(2),cx+4,cy2-4);}}
 }}
function drawPoints(){
 const P=clouds[fi],n=NCH[fi],N=P.length/n,szk=+el('psize').value/12;
 let mode=el('cmode').value; if(mode==='i'&&n<4)mode='z';
 if(mode==='uniform'){ctx.fillStyle='#7d8db0';
  for(let i=0;i<N;i++){const p=proj(P[i*n],P[i*n+1],P[i*n+2]);
   if(p){const s=szk*Math.max(1,Math.min(2.5,90/p[2]));ctx.fillRect(p[0],p[1],s,s);}}
  return;}
 const B=bins(fi,mode);      // one fillStyle per bin, points batched by bin
 for(let b=0;b<NBIN;b++){ctx.fillStyle=BINCOL[b];
  for(let i=0;i<N;i++){if(B[i]!==b)continue;
   const p=proj(P[i*n],P[i*n+1],P[i*n+2]);
   if(p){const s=szk*Math.max(1,Math.min(2.5,90/p[2]));ctx.fillRect(p[0],p[1],s,s);}}}}
function showInspect(o){const p=el('inspect');
 if(!o){p.style.display='none';return;}
 const[x,y,z,dx,dy,dz,h]=o.b;
 p.style.display='block';
 p.innerHTML=`<b>${o.n}</b>${o.id>=0?' &middot; track #'+o.id:''}<br>`+
  `score ${o.s.toFixed(3)}<br>ctr (${x.toFixed(2)}, ${y.toFixed(2)}, ${z.toFixed(2)})<br>`+
  `dims ${dx.toFixed(2)} &times; ${dy.toFixed(2)} &times; ${dz.toFixed(2)}<br>`+
  `heading ${(h*180/Math.PI).toFixed(1)}&deg;`;}
function draw(){
 ctx.fillStyle='#0b0e14';ctx.fillRect(0,0,W,H);boxHits=[];
 const f=DATA[fi];
 if(followId!=null&&f.det){const o=f.det.find(o=>o.id===followId);
  if(o){target=[o.b[0],o.b[1],o.b[2]];showInspect(o);}}
 if(el('showpts').checked&&clouds[fi].length)drawPoints();
 if(el('showgt').checked&&f.gt)drawBoxes(f.gt,false,true);
 if(el('showdet').checked&&f.det)drawBoxes(f.det,el('bytrack').checked,false);
 el('fno').textContent=fi;el('frame').value=fi;
 el('thrv').textContent=(+el('thr').value/100).toFixed(2);
 el('follow').textContent=followId!=null?('following track #'+followId):'';
}
// interactions
let drag=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];};
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){const cy=Math.cos(yaw),sy=Math.sin(yaw),k=dist/600;
  target[0]-=(-dx*sy)*k; target[1]-=(dx*cy)*k; target[2]+=dy*k; followId=null;}
 else{yaw+=dx*0.008;pitch=Math.max(0.05,Math.min(1.55,pitch+dy*0.008));}
 drag=[e.clientX,e.clientY,drag[2]];draw();});
cv.onwheel=e=>{dist=Math.max(5,Math.min(400,dist*(e.deltaY>0?1.12:0.89)));draw();e.preventDefault();};
cv.onclick=e=>{let best=null,bd=25*25;
 for(const[x,y,o]of boxHits){const d=(x-e.clientX)**2+(y-e.clientY)**2;
  if(d<bd){bd=d;best=o;}}
 if(best!=null){if(best.id>=0)followId=best.id;inspected=best;showInspect(best);draw();}};
addEventListener('keydown',e=>{if(e.key==='Escape'){followId=null;showInspect(null);draw();}
 if(e.key===' '){togglePlay();e.preventDefault();}
 if(e.key==='ArrowRight'){fi=Math.min(DATA.length-1,fi+1);draw();}
 if(e.key==='ArrowLeft'){fi=Math.max(0,fi-1);draw();}});
el('frame').oninput=e=>{fi=+e.target.value;draw();};
['thr','showdet','showgt','showpts','bytrack','cmode','psize'].forEach(id=>el(id).oninput=draw);
el('vbev').onclick=()=>{pitch=1.55;yaw=-Math.PI/2;dist=90;draw();};
el('vfront').onclick=()=>{pitch=0.12;yaw=0;dist=45;draw();};
el('vreset').onclick=()=>{yaw=-0.9;pitch=0.9;dist=60;target=[0,0,0];followId=null;showInspect(null);draw();};
el('shot').onclick=()=>{const a=document.createElement('a');
 a.download='frame'+fi+'.png';a.href=cv.toDataURL('image/png');a.click();};
let timer=null;
function togglePlay(){playing=!playing;el('play').innerHTML=playing?'&#10074;&#10074;':'&#9654;';
 if(timer)clearInterval(timer);
 if(playing)timer=setInterval(()=>{fi=(fi+1)%DATA.length;draw();},1000/+el('fps').value);}
el('play').onclick=togglePlay;
el('fps').onchange=()=>{if(playing){togglePlay();togglePlay();}};
resize();
</script></body></html>
"""
