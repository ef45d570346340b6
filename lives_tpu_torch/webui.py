"""Thin web UI: browser front-end over the existing control substrate.

Counterpart of `lives_tpu/webui.py` (`PreviewTap` :37-164, the page
:166-1484, `WebUI` :1487-2344): the page is the JAX package's, byte for
byte, and the routes are the same over the port's `osc.server.OSCServer`
(its player, multitrack, clip sets, transcode and rendered effects).

The reference's interactive surface is ~50k LoC of GTK (`src/rte_window.c`
key grid, `src/paramwindow.c` auto-generated parameter dialogs,
`src/multitrack.c` timeline). This serves the same *capabilities* at
minimum viable depth over HTTP with zero extra dependencies:

- live MJPEG preview of the player's output (a teeing sink),
- clip open/select (fg/bg), transport + trickplay controls,
- effect-key grid (toggle/mode) with auto-generated parameter sliders
  from `paramui.param_window_spec` (the paramwindow.c successor),
- timeline/stats readout, blend factor,
- every command routes through the OSC method table (osc/server.py) —
  the web UI is just another OSC client that happens to speak HTTP.

The preview's device lane: a frame on a CUDA device is converted to RGB24
(`ops.colorspace.convert_layer`), shrunk to `max_width` where it is wider
(`ops.resize.resize_layer`) and encoded by `io.jpeg_encode.
JpegDeviceEncoder` (transform, quantisation and pack on the device; only
coefficients cross to the host) on the tap's worker thread, which waits
for the serving stream on its own stream. A frame on the CPU is encoded by
PIL. `device_encodes` and `host_encodes` count each route; a conversion,
resize or encode of a CUDA frame that fails ends the preview with its
exception (kept in `error`, raised by `wait_jpeg`), it never falls back to
PIL; a CPU frame PIL cannot take is skipped, as in the JAX UI. Frames
reach the host with `.cpu().numpy()` where the JAX UI calls `np.asarray`:
thumbnails, strips and the multitrack preview.

Usage:
    ui = WebUI(osc_server)          # wraps the server's player
    ui.start()                      # http://127.0.0.1:<port>/
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np
import torch

from .layer import Layer
from .player.sinks import Sink


class PreviewTap(Sink):
    """Tee sink: forwards to the wrapped sink and keeps the latest frame
    as JPEG bytes for the MJPEG stream.

    Encoding runs on its own worker thread (latest-frame-wins) so the
    player's loop never blocks on it. A frame on a CUDA device takes the
    device JPEG lane (`io/jpeg_encode.py`), a frame on the CPU PIL (see
    the module's docstring)."""

    def __init__(self, inner: Sink | None = None, quality: int = 80,
                 max_fps: float = 15.0, max_width: int = 960):
        self.inner = inner
        self.quality = quality
        self.max_width = max_width   # 0/None = ship full resolution
        # latest-wins handoff: cap the rate so the tap never outpaces
        # its worker
        self.min_interval = 1.0 / max_fps if max_fps else 0.0
        self._last_enc = 0.0
        self._jpeg: Optional[bytes] = None
        self._seq = 0
        self._cv = threading.Condition()
        self._pend = None
        self._pcv = threading.Condition()
        self._worker = None
        self._stop = False
        self._dev_enc = None           # JpegDeviceEncoder of the last size
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self.device_encodes = 0
        self.host_encodes = 0
        #: the exception that ended the worker, if one did
        self.error: Optional[BaseException] = None

    def init_screen(self, width, height, fps):
        if self.inner:
            self.inner.init_screen(width, height, fps)

    def exit_screen(self):
        self._stop = True
        with self._pcv:
            self._pcv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5)
            self._worker = None
        if self.inner:
            self.inner.exit_screen()

    def play_frame(self, layer: Layer, tc: float) -> bool:
        ok = self.inner.play_frame(layer, tc) if self.inner else True
        now = time.monotonic()
        if self.error is not None or (self._jpeg is not None and now
                                      - self._last_enc < self.min_interval):
            return ok
        self._last_enc = now
        try:
            from .constants import Palette
            from .ops.colorspace import convert_layer
            rgb = convert_layer(layer, Palette.RGB24)
            if self.max_width and rgb.width > self.max_width:
                # preview panel is small: resize before encoding (a
                # 1080p->960 halving cuts the DCT and the fetch 4x)
                from .ops.resize import resize_layer
                sc = self.max_width / rgb.width
                rgb = resize_layer(rgb, self.max_width,
                                   max(2, int(rgb.height * sc)) // 2 * 2)
            plane = rgb.planes[0]
        except Exception as e:
            if layer.planes[0].device.type == "cuda":
                # the device lane failed: the preview ends on it
                with self._cv:
                    self.error = e
                    self._cv.notify_all()
            return ok
        ev = None
        if plane.device.type == "cuda":
            # the worker reads the plane on its own stream, once the
            # serving stream has produced it
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(plane.device))
        with self._pcv:
            self._pend = (plane, ev)
            self._pcv.notify()
        if self.error is None and (self._worker is None
                                   or not self._worker.is_alive()):
            self._stop = False
            self._worker = threading.Thread(target=self._encode_loop,
                                            daemon=True,
                                            name="preview-encode")
            self._worker.start()
        return ok

    def _encode_loop(self):
        try:
            while not self._stop:
                with self._pcv:
                    if self._pend is None:
                        self._pcv.wait(1.0)
                    pend, self._pend = self._pend, None
                if pend is None:
                    continue
                data = self._encode_one(*pend)
                if data is None:
                    continue
                with self._cv:
                    self._jpeg = data
                    self._seq += 1
                    self._cv.notify_all()
        except BaseException as e:      # noqa: BLE001  (kept, re-raised)
            self.error = e
            with self._cv:
                self._cv.notify_all()
            raise

    def _encode_one(self, plane, ev=None) -> Optional[bytes]:
        h, w = int(plane.shape[-2]), int(plane.shape[-1])
        if plane.device.type == "cuda":
            from .io.jpeg_encode import JpegDeviceEncoder
            dev = plane.device
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = torch.cuda.Stream(dev)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_event(ev)
                plane.record_stream(stream)
                if self._dev_enc is None \
                        or self._dev_enc.device != dev \
                        or self._dev_enc.meta.height != h \
                        or self._dev_enc.meta.width != w:
                    self._dev_enc = JpegDeviceEncoder(
                        w, h, quality=self.quality, batch=1, device=dev)
                data = self._dev_enc.encode_batch(plane[None])[0]
            self.device_encodes += 1
            return data
        try:
            from PIL import Image
            rgb = plane.numpy()
            img = Image.fromarray(np.moveaxis(rgb, 0, -1))
            buf = io.BytesIO()
            img.save(buf, "JPEG", quality=self.quality)
            self.host_encodes += 1
            return buf.getvalue()
        except Exception:
            return None

    def wait_jpeg(self, last_seq: int, timeout: float = 1.0):
        """The newest JPEG and its sequence number, once one newer than
        `last_seq` has landed or `timeout` seconds have passed; raises
        if the worker ended on an error."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._jpeg is None or self._seq == last_seq:
                if self.error is not None:
                    raise RuntimeError("preview encode failed") \
                        from self.error
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            return self._jpeg, self._seq


_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>lives_tpu</title><style>
body{font-family:system-ui;margin:0;display:flex;background:#16161a;color:#eee}
#side{width:340px;padding:12px;overflow-y:auto;height:100vh;box-sizing:border-box}
#main{flex:1;padding:12px}
img{max-width:100%;background:#000;border-radius:6px}
button{margin:2px;padding:4px 10px;border-radius:4px;border:1px solid #555;
 background:#26262c;color:#eee;cursor:pointer}
button.on{background:#3a7d44}
input[type=range]{width:100%}
.param{margin:6px 0}.param label{font-size:12px;color:#aaa}
#stats{font:12px monospace;color:#8f8;white-space:pre}
h3{margin:12px 0 4px;font-size:14px;color:#9cf}
select{background:#26262c;color:#eee;border:1px solid #555;padding:3px}
</style></head><body>
<div id="side">
 <h3>Transport</h3>
 <button onclick="cmd('/video/play')">&#9654; play</button>
 <button onclick="cmd('/video/stop')">&#9632; stop</button>
 <button onclick="cmd('/video/play/reverse')">rev</button>
 <button onclick="cmd('/video/play/faster')">+fps</button>
 <button onclick="cmd('/video/play/slower')">-fps</button>
 <button id="recbtn" onclick="cmd('/record/toggle')">rec</button>
 <button onclick="cmd('/record/preview')"
  title="preview the last recorded take in the preview pane">preview take</button>
 <button onclick="cmd('/record/render')"
  title="render the last recorded take to a new clip">render take</button>
 <button onclick="cmd('/record/discard')"
  title="drop the last recorded take">discard take</button>
 <div class="param"><label>fps <span id="fpsv"></span></label>
  <input type="range" id="fps" min="-60" max="60" step="0.5"
   oninput="cmd('/video/fps/set',[+this.value])"></div>
 <div class="param"><label>scrub</label>
  <input type="range" id="scrub" min="0" max="100" step="1"
   oninput="cmd('/clip/goto',[+this.value+1])"></div>
 <div class="param"><label>fg/bg blend</label>
  <input type="range" min="0" max="1" step="0.01" value="0.5"
   oninput="setBlend(+this.value)"></div>
 <div>
  <button id="loopbtn" onclick="toggleSt('loop','/video/loop/set')">loop</button>
  <button id="ppbtn" onclick="toggleSt('pingpong','/video/pingpong/set')">ping-pong</button>
  <button id="mutebtn" onclick="toggleSt('muted','/audio/mute/set')">mute</button>
 </div>
 <div class="param"><label>volume</label>
  <input type="range" id="vol" min="0" max="1" step="0.01"
   oninput="cmd('/audio/volume/set',[+this.value])"></div>
 <h3>Selection</h3>
 <div title="first / last frame of the selection — the clip editor's
 start and end preview images (interface.c load_start_image /
 load_end_image)">
  <img id="selimg_s" style="max-height:72px;border-radius:3px;display:none">
  <img id="selimg_e" style="max-height:72px;border-radius:3px;display:none">
 </div>
 <div title="frame selection [start..end], 1-based like the reference's
 start/end spinbuttons; end -1 = to the last frame">
  <input type="number" id="selstart" style="width:70px" min="1"
   onchange="cmd('/clip/start/set',[+this.value-1])">
  <input type="number" id="selend" style="width:70px" min="-1"
   onchange="cmd('/clip/end/set',[+this.value<0?-1:+this.value-1])">
  <button onclick="cmd('/clip/select_all')">all</button>
  <button onclick="cmd('/video/selection/play')">&#9654; sel</button>
 </div>
 <div>
  <button onclick="cmd('/clip/selection/copy')">copy</button>
  <button onclick="cmd('/clip/selection/cut')">cut</button>
  <button onclick="cmd('/clip/selection/delete')">del</button>
  <button id="pastebtn" onclick="cmd('/clipboard/paste')">paste</button>
  <button onclick="cmd('/clipboard/paste_as_new',[]).then(refresh)"
   title="paste the clipboard as a new clip">paste new</button>
  <button onclick="cmd('/clipboard/reverse')"
   title="reverse the clipboard's frames and audio (Tools menu)">rev cb</button>
  <button onclick="clipSpeed()"
   title="change the clip's own fps — same frames, new duration
 (Change Playback/Save Speed)">speed&#8230;</button>
 </div>
 <div>
  <button id="mergebtn" onclick="openMerge()"
   title="merge the clipboard into the selection through a transition
 (the Merge dialog, src/merge.c)">merge&#8230;</button>
  <button onclick="openSaveAs()"
   title="encode the clip to a file (Save clip as)">save as&#8230;</button>
  <button onclick="resampleClip()"
   title="retime the clip to a new fps (resample/reorder)">resample&#8230;</button>
  <button onclick="clipInfo()" title="clip properties">info</button>
 </div>
 <div>
  <button onclick="loadSubs()"
   title="load .srt/.sub subtitles composited during playback">subs&#8230;</button>
  <button onclick="cmd('/clip/subtitles/erase')"
   title="remove the subtitle overlay">no subs</button>
 </div>
 <div title="clip audio editing (the Audio menu: fades, normalize,
 silence over the selection, trim/pad to selection, sync offset)">
  <button onclick="audioEdit('fadein')">a.fade in</button>
  <button onclick="audioEdit('fadeout')">a.fade out</button>
  <button onclick="cmd('/clip/audio/normalize')">a.norm</button>
  <button onclick="cmd('/clip/audio/insert_silence')">a.sil</button>
  <button onclick="cmd('/clip/audio/trim')">a.trim</button>
  <button onclick="cmd('/clip/audio/delete')">a.del</button>
  <button onclick="audioEdit('sync')">a.sync&#8230;</button>
  <button onclick="cmd('/clip/audio/undo')">a.undo</button>
 </div>
 <h3>Clips</h3>
 <div>
  <input id="uri" placeholder="/path/to/media.mkv" style="width:65%">
  <button onclick="openClip()">open</button>
  <div style="margin-top:2px">
   <select id="gensel" style="max-width:55%"></select>
   <button onclick="openGen()"
    title="open a generator filter as a clip source (.milk presets load
 via a path ending in .milk in the URI box)">gen</button>
   <button onclick="cmd('/clip/generator/next',[])"
    title="cycle the fg clip's preset playlist (milkdir)">next preset</button>
  </div>
 </div>
 <div id="clips"></div>
 <h3>Sets</h3>
 <div title="named clip sets under the workdir (save set / reload set)">
  <input id="setname" placeholder="set name" style="width:38%">
  <button onclick="saveSet()">save</button>
  <select id="setsel" style="max-width:30%"></select>
  <button onclick="loadSet()">load</button>
 </div>
 <h3>Rendered effects</h3>
 <div>
  <select id="rfx"></select>
  <button onclick="applyRfx()">apply</button>
  <button onclick="cmd('/clip/undo')">undo</button>
 </div>
 <h3>Effect keys</h3><div id="keys"></div>
 <h3>Parameters</h3><div id="params"></div>
 <h3>Audio fx</h3><div id="audiofx"></div>
 <h3>Timeline</h3><div id="timeline"></div>
 <h3>Stats</h3><div id="stats"></div>
 <h3>Console
  <select id="conlvl" onchange="drawConsole()" style="font-size:11px">
   <option>debug</option><option selected>info</option>
   <option>warn</option><option>error</option></select>
  <button style="font-size:11px"
   onclick="cmd('/messages/clear').then(drawConsole)">clear</button></h3>
 <div id="console" title="message console (d_print ring) — clip opens,
 playback, record and render events; level-filtered"
  style="font-size:11px;font-family:monospace;max-height:140px;
  overflow-y:auto;background:#111;padding:4px;border-radius:3px"></div>
</div>
<div id="main">
 <div id="pwrap" style="position:relative;display:inline-block;max-width:100%">
  <img id="preview" src="/preview.mjpg"
   title="drag: set the active key's position params (framedraw)">
  <div id="fdov" style="position:absolute;inset:0;cursor:crosshair"></div>
 </div>
 <div id="stripwrap" style="margin-top:6px">
  <img id="strip" style="width:100%;display:none;cursor:ew-resize"
   title="clip-editor thumbnail strip — drag to scrub (ce_thumbs)">
 </div>
 <h3>Key map <button onclick="saveKeymap()">save</button>
  <button onclick="loadKeymap()">load</button></h3>
 <div id="rte" style="font-size:12px"></div>
 <h3>Data connections</h3>
 <div id="conns" style="font-size:12px"
  title="wire out params / alpha channels into other keys (pconx/cconx)">
 </div>
 <h3>RFX builder</h3>
 <div id="rfxb" style="font-size:12px"
  title="author a rendered effect: bind a filter's params to expressions
 over your script params + t (0..1 across the range) — rfx-builder role">
  <input id="rfxb_name" placeholder="effect name" style="width:46%">
  <select id="rfxb_filter" style="max-width:48%"></select>
  <textarea id="rfxb_params" rows="2" style="width:96%"
   placeholder="params: name kind default min max (one per line)"></textarea>
  <textarea id="rfxb_map" rows="2" style="width:96%"
   placeholder="mapping: filter_param = expr (one per line)"></textarea>
  <button onclick="rfxDefine(0)">define</button>
  <button onclick="rfxDefine(1)">define + save .script</button>
  <span id="rfxb_msg"></span>
 </div>
 <h3>MIDI / joystick learn</h3>
 <div id="omc" style="font-size:12px"
  title="OMC learner: click learn, move the control, it binds
 (omc-learn window role). Virtual events feed via /omc/feed_midi.">
  <select id="omc_macro"></select>
  <button onclick="omcLearn()">learn</button>
  <span id="omc_status"></span>
  <div id="omc_maps"></div>
  <button onclick="cmd('/omc/mapping/clear').then(drawOmc)">clear</button>
 </div>
 <h3>Preferences
  <button onclick="cmd('/pref/apply_future',[]).then(drawPrefs)"
   title="apply the deferred (future_prefs) buffer">apply deferred</button>
  <button onclick="cmd('/pref/save',[])">save</button></h3>
 <div id="prefs" style="font-size:12px"></div>
</div>
<script>
let curKey=1;
async function api(path,args){
 const r=await (await fetch('/api/cmd',{method:'POST',
  body:JSON.stringify({path:path,args:args||[]})})).json();
 return r;
}
async function drawOmc(){
 const macros=await api('/omc/macro/list');
 if(macros.ok){
  const sel=document.getElementById('omc_macro');
  if(!sel.options.length)
   macros.ret.split(' ').filter(Boolean).forEach((n)=>{
    const o=document.createElement('option');o.value=n;o.textContent=n;
    sel.appendChild(o);});
 }
 const st=await api('/omc/learn/status');
 document.getElementById('omc_status').textContent=
  st.ret?('learning: '+st.ret+' — move the control'):'';
 const maps=await api('/omc/mappings/list');
 if(maps.ok)
  document.getElementById('omc_maps').textContent=
   (maps.ret||'').split(';').filter(Boolean).join('  ');
}
async function omcLearn(){
 await api('/omc/learn/start',[document.getElementById('omc_macro').value]);
 drawOmc();
}
setTimeout(drawOmc, 900); setInterval(drawOmc, 3000);
async function rfxDefine(save){
 const name=document.getElementById('rfxb_name').value.trim();
 const filt=document.getElementById('rfxb_filter').value;
 if(!name||!filt)return;
 const params=document.getElementById('rfxb_params').value.split('\n')
   .map(l=>l.trim()).filter(Boolean).map(l=>{
    const b=l.split(/\\s+/);
    return [b[0],b[1]||'num2',parseFloat(b[2]||'0'),
            parseFloat(b[3]||'0'),parseFloat(b[4]||'1')];});
 const map={};
 document.getElementById('rfxb_map').value.split('\n')
   .map(l=>l.trim()).filter(l=>l.includes('=')).forEach(l=>{
    const i=l.indexOf('='); map[l.slice(0,i).trim()]=l.slice(i+1).trim();});
 const r=await (await fetch('/api/cmd',{method:'POST',
   body:JSON.stringify({path:'/rfx/define',
    args:[name,filt,JSON.stringify(params),JSON.stringify(map),save]})}
  )).json();
 const msg=document.getElementById('rfxb_msg');
 msg.textContent=r.ok?('registered '+r.ret):('error: '+r.error);
 if(r.ok){const sel=document.getElementById('rfx');
  const o=document.createElement('option');o.value=name;o.textContent=name;
  sel.appendChild(o);}
}
async function loadRfxbFilters(){
 const r=await (await fetch('/api/cmd',{method:'POST',
   body:JSON.stringify({path:'/effects/list',args:[]})})).json();
 if(!r.ok||!r.ret)return;
 const sel=document.getElementById('rfxb_filter');
 r.ret.split(' ').filter(Boolean).forEach((n)=>{
  const o=document.createElement('option'); o.value=n; o.textContent=n;
  sel.appendChild(o);});
}
setTimeout(loadRfxbFilters, 800);
async function loadRfx(){
 const r=await (await fetch('/api/cmd',{method:'POST',
   body:JSON.stringify({path:'/rfx/list',args:[]})})).json();
 if(!r.ok||!r.ret)return;
 const sel=document.getElementById('rfx');
 r.ret.split(' ').filter(Boolean).forEach((n)=>{
  const o=document.createElement('option'); o.value=n; o.textContent=n;
  sel.appendChild(o);});
}
async function applyRfx(){
 // the RFX paramwindow (make_param_box + paramspecial hints): widgets
 // from the script's consumable params, specials adjust the inputs
 const n=document.getElementById('rfx').value;
 if(!n)return;
 const spec=await (await fetch('/api/rfx_spec/'+n)).json();
 const c=modal('Apply: '+(spec.title||n));
 const sp=(t,p)=>spec.specials.some(s=>s.type===t&&s.params.includes(p));
 const inputs={};
 spec.widgets.forEach(w=>{
  const row=document.createElement('div'); row.className='param';
  const lab=document.createElement('label');
  lab.textContent=(w.label||w.name)+' ';
  row.appendChild(lab);
  let inp;
  if(w.kind==='bool'){
   inp=document.createElement('input'); inp.type='checkbox';
   inp.checked=!!w.default;
  }else if(w.kind==='string_list'){
   inp=document.createElement('select');
   (w.choices||[]).forEach((ch,i)=>{const o=document.createElement('option');
    o.value=i;o.textContent=ch;inp.appendChild(o);});
   inp.value=w.default||0;
  }else if(w.kind==='string'){
   inp=document.createElement('input');
   inp.type=sp('password',w.name)?'password':'text';
   inp.value=w.default||'';
   if(sp('fileread',w.name))inp.placeholder='/path/to/file';
   if(sp('fontchooser',w.name)){
    const dl=document.getElementById('fontlist')||(()=>{
     const d=document.createElement('datalist'); d.id='fontlist';
     ['sans-serif','serif','monospace','cursive'].forEach(f=>{
      const o=document.createElement('option');o.value=f;d.appendChild(o);});
     document.body.appendChild(d); return d;})();
    inp.setAttribute('list','fontlist');
   }
  }else{
   inp=document.createElement('input'); inp.type='number';
   if(w.min!==undefined)inp.min=w.min;
   if(w.max!==undefined)inp.max=w.max;
   inp.step=w.kind==='int'?1:'any';
   inp.value=w.default;
   inp.style.width='90px';
  }
  inp.id='rfxp_'+w.name; inputs[w.name]=inp;
  row.appendChild(inp); c.appendChild(row);
 });
 // aspect special: keep-aspect lock between the linked pair
 const asp=spec.specials.find(s=>s.type==='aspect');
 if(asp&&inputs[asp.params[0]]&&inputs[asp.params[1]]){
  const row=document.createElement('div');
  const lk=document.createElement('input'); lk.type='checkbox';
  lk.id='rfx_aspect'; lk.checked=true;
  row.appendChild(lk);
  row.appendChild(document.createTextNode(' keep aspect ratio'));
  c.appendChild(row);
  const a=inputs[asp.params[0]], b=inputs[asp.params[1]];
  let ratio=(+a.value||1)/(+b.value||1);
  a.onchange=()=>{if(lk.checked&&+a.value)b.value=
   Math.round(+a.value/ratio)||1; else ratio=(+a.value||1)/(+b.value||1);};
  b.onchange=()=>{if(lk.checked&&+b.value)a.value=
   Math.round(+b.value*ratio)||1; else ratio=(+a.value||1)/(+b.value||1);};
 }
 if(spec.specials.some(s=>s.type==='framedraw')){
  const note=document.createElement('div');
  note.style.cssText='font-size:11px;color:#888';
  note.textContent='tip: this effect also supports framedraw drag on'+
   ' the preview when mapped to an effect key';
  c.appendChild(note);
 }
 const go=document.createElement('button'); go.textContent='apply';
 const msg=document.createElement('span');
 go.onclick=async()=>{
  const args=[n];
  spec.widgets.forEach(w=>{
   const inp=inputs[w.name];
   let v=w.kind==='bool'?(inp.checked?1:0):inp.value;
   args.push(w.name, v);
  });
  msg.textContent='applying…';
  const r=await api('/rfx/apply',args);
  msg.textContent=r.ok?('done ('+r.ret+' frames)'):r.error;
  refresh();
 };
 c.appendChild(go); c.appendChild(msg);
}
loadRfx(); loadGens();
setTimeout(drawAudioFx, 300);
// framedraw (src/framedraw.c + paramspecial.c specials): the active
// key's position params render as draggable markers over the preview;
// multipoint picks the nearest point (compositor input placement)
let fdSpec=null;  // {type, points:[[xname,yname],...]} of the shown key
function fdDraw(){
 const ov=document.getElementById('fdov'); ov.innerHTML='';
 if(!fdSpec||!fdSpec.widgets)return;
 fdSpec.points.forEach((pt,pi)=>{
  const wx=fdSpec.widgets.find(q=>q.name===pt[0]);
  const wy=fdSpec.widgets.find(q=>q.name===pt[1]);
  if(!wx||!wy)return;
  const m=document.createElement('div');
  m.style.cssText='position:absolute;width:11px;height:11px;margin:-6px;'+
   'border:2px solid #ff0;border-radius:50%;pointer-events:none;'+
   'left:'+(wx.value*100)+'%;top:'+(wy.value*100)+'%';
  m.title=pt[0]+','+pt[1];
  ov.appendChild(m);
  const t=document.createElement('div');
  t.textContent=pi;
  t.style.cssText='position:absolute;font-size:9px;color:#ff0;'+
   'pointer-events:none;left:calc('+(wx.value*100)+'% + 6px);'+
   'top:calc('+(wy.value*100)+'% - 14px)';
  ov.appendChild(t);
 });
}
document.addEventListener('DOMContentLoaded',()=>{
 const ov=document.getElementById('fdov');
 ov.onmousedown=(e)=>{
  if(!fdSpec||!fdSpec.points.length)return;
  e.preventDefault();
  const r=ov.getBoundingClientRect();
  const pos=(ev)=>[(ev.clientX-r.left)/r.width,(ev.clientY-r.top)/r.height];
  let [nx,ny]=pos(e);
  // nearest point wins the drag (multipoint)
  let best=0,bd=9;
  fdSpec.points.forEach((pt,pi)=>{
   const wx=fdSpec.widgets.find(q=>q.name===pt[0]);
   const wy=fdSpec.widgets.find(q=>q.name===pt[1]);
   if(!wx||!wy)return;
   const d=Math.hypot(wx.value-nx,wy.value-ny);
   if(d<bd){bd=d;best=pi;}
  });
  const pt=fdSpec.points[best];
  const wx=fdSpec.widgets.find(q=>q.name===pt[0]);
  const wy=fdSpec.widgets.find(q=>q.name===pt[1]);
  if(!wx||!wy)return;
  let last=0;
  const put=async(x,y,force)=>{
   const now=Date.now();
   if(!force&&now-last<60)return;
   last=now;
   wx.value=Math.min(1,Math.max(0,x)); wy.value=Math.min(1,Math.max(0,y));
   fdDraw();
   await cmd('/effect_key/parameter/value/set',[curKey,wx.index,wx.value]);
   await cmd('/effect_key/parameter/value/set',[curKey,wy.index,wy.value]);
  };
  put(nx,ny,true);
  const move=(ev)=>{const [x,y]=pos(ev);put(x,y,false);};
  const up=async(ev)=>{
   document.removeEventListener('mousemove',move);
   document.removeEventListener('mouseup',up);
   const [x,y]=pos(ev); await put(x,y,true); loadParams(curKey);
  };
  document.addEventListener('mousemove',move);
  document.addEventListener('mouseup',up);
 };
 // thumbnail strip scrub (ce_thumbs.c): drag maps x-fraction -> frame
 const st=document.getElementById('strip');
 st.onmousedown=(e)=>{
  e.preventDefault();
  const r=st.getBoundingClientRect();
  let last=0;
  const go=async(ev,force)=>{
   const now=Date.now();
   if(!force&&now-last<80)return;
   last=now;
   const frac=Math.min(1,Math.max(0,(ev.clientX-r.left)/r.width));
   const frames=window._frames||1;
   await cmd('/clip/goto',[Math.round(frac*(frames-1))+1]);
  };
  go(e,true);
  const move=(ev)=>go(ev,false);
  const up=(ev)=>{document.removeEventListener('mousemove',move);
   document.removeEventListener('mouseup',up);go(ev,true);};
  document.addEventListener('mousemove',move);
  document.addEventListener('mouseup',up);
 };
});
async function drawStrip(){
 const img=document.getElementById('strip');
 const st=await (await fetch('/api/state')).json();
 const fg=st.clips.find(c=>c.fg);
 window._frames=st.frames;
 if(!fg||st.frames<2){img.style.display='none';return;}
 const key=fg.id+'_'+st.frames;
 if(img.dataset.key!==key){
  img.dataset.key=key;
  img.src='/api/strip/'+fg.id+'?v='+st.frames;
 }
 img.style.display='block';
}
// rte_window.c key-map editor: per-key mode chips, map/unmap, toggle
async function drawKeymap(){
 const el=document.getElementById('rte'); if(!el)return;
 const kmr=await (await fetch('/api/keymap')).json();
 el.innerHTML='';
 kmr.keys.forEach(k=>{
  const row=document.createElement('div');
  row.style.cssText='display:flex;align-items:center;gap:3px;margin:1px 0';
  const lab=document.createElement('span');
  lab.textContent='k'+k.key;
  lab.style.cssText='width:26px;color:'+(k.active?'#8f8':'#888');
  row.appendChild(lab);
  k.modes.forEach((nm,mi)=>{
   if(!nm)return;
   const c=document.createElement('button');
   c.textContent=(mi+1)+':'+nm;
   c.style.fontSize='11px';
   if(mi===k.mode)c.className='on';
   c.title='click: select mode';
   c.onclick=async()=>{await cmd('/effect_key/mode/set',[k.key,mi+1]);
    drawKeymap();};
   row.appendChild(c);
  });
  const sel=document.createElement('select');
  sel.style.fontSize='11px';
  (window._fxnames||[]).forEach(n=>{const o=document.createElement('option');
   o.value=n;o.textContent=n;sel.appendChild(o);});
  row.appendChild(sel);
  const mb=document.createElement('button'); mb.textContent='map';
  mb.title='bind the filter to this key\\'s next free mode';
  mb.onclick=async()=>{await cmd('/effect_key/map',[k.key,sel.value]);
   drawKeymap();};
  row.appendChild(mb);
  const tb=document.createElement('button');
  tb.textContent=k.active?'on':'off';
  if(k.active)tb.className='on';
  tb.onclick=async()=>{await cmd('/effect_key/toggle',[k.key]);
   drawKeymap();};
  row.appendChild(tb);
  const xb=document.createElement('button'); xb.textContent='\\u2715';
  xb.title='unmap all modes of this key';
  xb.onclick=async()=>{await cmd('/effect_key/unmap',[k.key]);
   drawKeymap();};
  row.appendChild(xb);
  el.appendChild(row);
 });
}
// effects-data.c connections window (lives_conx_w role): list + edit
// pconx (out param -> in param) and cconx (alpha channel -> in slot).
// Both keys must be toggled ON (live instances) to add a connection.
async function drawConns(){
 const el=document.getElementById('conns'); if(!el)return;
 const dc=await (await fetch('/api/datacons')).json();
 el.innerHTML='';
 const row=(txt)=>{const d=document.createElement('div');
  d.style.cssText='margin:1px 0';
  d.appendChild(document.createTextNode(txt)); return d;};
 dc.pconx.forEach(c=>{
  const r=row('param k'+c.src+'.'+c.out+' → k'+c.dst+'.'+c['in']+
   (c.autoscale?' [autoscale]':'')+' ');
  const x=document.createElement('button'); x.textContent='✕';
  x.onclick=async()=>{await cmd('/effect_key/outparameter/connection/delete',
   [c.src,c.out_idx]); drawConns();};
  r.appendChild(x); el.appendChild(r);
 });
 dc.cconx.forEach(c=>{
  const r=row('alpha k'+c.src+'.'+c.out+' → k'+c.dst+' slot '+c.slot+' ');
  const x=document.createElement('button'); x.textContent='✕';
  x.onclick=async()=>{await cmd('/effect_key/outchannel/connection/delete',
   [c.src,c.out_idx]); drawConns();};
  r.appendChild(x); el.appendChild(r);
 });
 // add rows: src key/out -> dst key/in (+autoscale) and alpha variant
 const srcs=dc.keys.filter(k=>k.out_params.length);
 const asrcs=dc.keys.filter(k=>k.alpha_outs.length);
 const dsts=dc.keys.filter(k=>k.in_params.length);
 const adsts=dc.keys.filter(k=>k.alpha_ins>0);
 const sel=(items,fmt)=>{const s=document.createElement('select');
  s.style.fontSize='11px';
  items.forEach((it,i)=>{const o=document.createElement('option');
   o.value=i; o.textContent=fmt(it); s.appendChild(o);});
  return s;};
 if(srcs.length&&dsts.length){
  const r=row('');
  const sk=sel(srcs,k=>'k'+k.key+' '+k.filter);
  const so=sel(srcs[0].out_params,n=>n);
  sk.onchange=()=>{so.innerHTML='';srcs[+sk.value].out_params.forEach((n,i)=>{
   const o=document.createElement('option');o.value=i;o.textContent=n;
   so.appendChild(o);});};
  const dk=sel(dsts,k=>'k'+k.key+' '+k.filter);
  const di=sel(dsts[0].in_params,n=>n);
  dk.onchange=()=>{di.innerHTML='';dsts[+dk.value].in_params.forEach((n,i)=>{
   const o=document.createElement('option');o.value=i;o.textContent=n;
   di.appendChild(o);});};
  const as=document.createElement('input'); as.type='checkbox'; as.checked=true;
  as.title='autoscale the source range onto the target range';
  const b=document.createElement('button'); b.textContent='+param';
  b.title='connect (both keys must be on)';
  b.onclick=async()=>{await cmd('/effect_key/outparameter/connection/add',
   [srcs[+sk.value].key,+so.value,dsts[+dk.value].key,+di.value,
    as.checked?1:0]); drawConns();};
  [sk,so,document.createTextNode('→'),dk,di,as,b]
   .forEach(e=>r.appendChild(e));
  el.appendChild(r);
 }
 if(asrcs.length&&adsts.length){
  const r=row('');
  const sk=sel(asrcs,k=>'k'+k.key+' '+k.filter);
  const so=sel(asrcs[0].alpha_outs,n=>n);
  sk.onchange=()=>{so.innerHTML='';asrcs[+sk.value].alpha_outs.forEach((n,i)=>{
   const o=document.createElement('option');o.value=i;o.textContent=n;
   so.appendChild(o);});};
  const dk=sel(adsts,k=>'k'+k.key+' '+k.filter);
  const di=sel([...Array(adsts[0].alpha_ins).keys()],n=>'slot '+n);
  dk.onchange=()=>{di.innerHTML='';
   [...Array(adsts[+dk.value].alpha_ins).keys()].forEach(n=>{
    const o=document.createElement('option');o.value=n;o.textContent='slot '+n;
    di.appendChild(o);});};
  const b=document.createElement('button'); b.textContent='+alpha';
  b.title='connect alpha channel (both keys must be on)';
  b.onclick=async()=>{await cmd('/effect_key/outchannel/connection/add',
   [asrcs[+sk.value].key,+so.value,adsts[+dk.value].key,+di.value]);
   drawConns();};
  [sk,so,document.createTextNode('→'),dk,di,b]
   .forEach(e=>r.appendChild(e));
  el.appendChild(r);
 }
}
// preferences dialog (src/preferences.c GUI role): live prefs editable
// in place, deferred (future_prefs) values marked, add-row with the
// full PREF_ key namespace as a datalist
async function drawPrefs(){
 const el=document.getElementById('prefs'); if(!el)return;
 const pr=await (await fetch('/api/prefs')).json();
 el.innerHTML='';
 const flt=document.createElement('input');
 flt.placeholder='filter keys (enter)'; flt.value=window._prefflt||'';
 flt.onchange=()=>{window._prefflt=flt.value;drawPrefs();};
 el.appendChild(flt);
 const q=(window._prefflt||'').toLowerCase();
 const ent=Object.entries(pr.live)
  .filter(([k])=>!q||k.toLowerCase().includes(q));
 ent.slice(0,30).forEach(([k,v])=>{
  const r=document.createElement('div'); r.style.cssText='margin:1px 0';
  r.appendChild(document.createTextNode(k+' '));
  const inp=document.createElement('input');
  inp.value=v; inp.style.cssText='width:100px;font-size:11px';
  inp.onchange=async()=>{await cmd('/pref/set',[k,inp.value,0]);};
  r.appendChild(inp);
  if(k in pr.future)r.appendChild(
   document.createTextNode(' [deferred: '+pr.future[k]+']'));
  el.appendChild(r);
 });
 if(ent.length>30)el.appendChild(document.createTextNode(
  '… '+(ent.length-30)+' more (filter to narrow)'));
 const add=document.createElement('div'); add.style.cssText='margin:2px 0';
 const dl=document.createElement('datalist'); dl.id='prefkeys';
 pr.keys.forEach(k=>{const o=document.createElement('option');o.value=k;
  dl.appendChild(o);});
 const kin=document.createElement('input');
 kin.setAttribute('list','prefkeys'); kin.placeholder='pref key';
 kin.style.fontSize='11px';
 const vin=document.createElement('input'); vin.placeholder='value';
 vin.style.cssText='width:80px;font-size:11px';
 const df=document.createElement('input'); df.type='checkbox';
 df.title='deferred: lands in future_prefs until apply';
 const b=document.createElement('button'); b.textContent='set';
 b.onclick=async()=>{if(kin.value){
  await cmd('/pref/set',[kin.value,vin.value,df.checked?1:0]);
  drawPrefs();}};
 [dl,kin,vin,df,b].forEach(e=>add.appendChild(e));
 el.appendChild(add);
}
async function saveKeymap(){
 const p=prompt('save keymap to path:','/tmp/default.keymap');
 if(p)await cmd('/keymap/save',[p]);
}
async function loadKeymap(){
 const p=prompt('load keymap from path:','/tmp/default.keymap');
 if(p){await cmd('/keymap/load',[p]);drawKeymap();}
}
async function cmd(path,args){
 await fetch('/api/cmd',{method:'POST',
  body:JSON.stringify({path:path,args:args||[]})});
 refresh();
}
function setBlend(v){fetch('/api/blend',{method:'POST',body:v});}
async function openClip(){
 const uri=document.getElementById('uri').value;
 if(!uri) return;
 // .milk preset files open as MilkDrop generator clips
 if(uri.endsWith('.milk')) await cmd('/clip/open/milk',[uri]);
 else await cmd('/clip/open/file',[uri]);
}
async function loadGens(){
 const r=await (await fetch('/api/cmd',{method:'POST',
   body:JSON.stringify({path:'/effects/generators/list',args:[]})})).json();
 if(!r.ok||!r.ret)return;
 const sel=document.getElementById('gensel');
 r.ret.split(' ').filter(Boolean).forEach(n=>{
  const o=document.createElement('option'); o.value=n; o.textContent=n;
  sel.appendChild(o);});
}
async function openGen(){
 const n=document.getElementById('gensel').value;
 if(n) await cmd('/clip/open/generator',[n]);
}
async function refresh(){
 const st=await (await fetch('/api/state')).json();
 const rb=document.getElementById('recbtn');
 if(rb)rb.className=st.recording?'on':'';
 document.getElementById('fpsv').textContent=st.fps.toFixed(2);
 document.getElementById('stats').textContent=
  'frame '+st.frame+' / '+st.frames+'\\nshown '+st.shown+' dropped '+
  st.dropped+'\\ninst_fps '+st.inst_fps.toFixed(1)+'  p99 '+
  st.p99_ms.toFixed(1)+'ms\\nt '+st.time.toFixed(2)+'s';
 const sc=document.getElementById('scrub');
 sc.max=Math.max(st.frames-1,1); if(document.activeElement!==sc)sc.value=st.frame;
 ['loop','pingpong','muted'].forEach((f,j)=>{
  const b=document.getElementById(['loopbtn','ppbtn','mutebtn'][j]);
  if(b)b.className=st[f]?'on':'';
 });
 const vol=document.getElementById('vol');
 if(vol&&document.activeElement!==vol)vol.value=st.volume;
 const ss=document.getElementById('selstart'),
       se=document.getElementById('selend');
 if(ss&&document.activeElement!==ss)ss.value=st.sel_start+1;
 if(se&&document.activeElement!==se)
  se.value=st.sel_end<0?-1:st.sel_end+1;
 // start/end preview frames (interface.c load_start_image/load_end_image)
 const fgc=st.clips.find(c=>c.fg);
 [['selimg_s',st.sel_start],
  ['selimg_e',st.sel_end<0?st.frames-1:st.sel_end]].forEach(([id,f])=>{
  const im=document.getElementById(id); if(!im)return;
  if(!fgc||st.frames<1){im.style.display='none';return;}
  const u='/api/thumb/'+fgc.id+'?frame='+f+'&w=128';
  if(im.dataset.u!==u){im.dataset.u=u;im.src=u;}
  im.style.display='inline';
 });
 const pb=document.getElementById('pastebtn');
 if(pb)pb.disabled=!st.has_clipboard;
 const mb=document.getElementById('mergebtn');
 if(mb)mb.disabled=!st.has_clipboard;
 const ks=document.getElementById('keys'); ks.innerHTML='';
 st.keys.forEach(k=>{
  const b=document.createElement('button');
  b.textContent=k.key+': '+(k.filter||'—');
  if(k.active)b.className='on';
  b.onclick=()=>{curKey=k.key;cmd('/effect_key/toggle',[k.key]);loadParams(k.key);};
  ks.appendChild(b);
 });
 const cl=document.getElementById('clips'); cl.innerHTML='';
 st.clips.forEach(c=>{
  const b=document.createElement('button');
  const t=document.createElement('img');
  t.src='/api/thumb/'+c.id; t.style.cssText=
   'height:24px;vertical-align:middle;margin-right:4px;border-radius:2px';
  t.onerror=()=>t.remove();
  b.appendChild(t);
  b.appendChild(document.createTextNode(
   c.id+': '+c.name+(c.fg?' [fg]':'')+(c.bg?' [bg]':'')));
  b.title=c.w+'x'+c.h+' @ '+(+c.fps).toFixed(2)+' fps, '+
   c.frames+' frames';   // clip-info line (main window clip label)
  if(c.fg)b.className='on';
  b.onclick=()=>cmd('/clip/select',[c.id]);
  b.oncontextmenu=(e)=>{e.preventDefault();cmd('/clip/background/select',[c.id]);};
  cl.appendChild(b);
 });
}
// --- multitrack editing surface (multitrack.c roles, all via OSC) ------
let mtSel=null;  // client mirror of the region selection
async function drawTimeline(){
 const tl=await (await fetch('/api/timeline')).json();
 const el=document.getElementById('timeline'); el.innerHTML='';
 const total=Math.max(tl.frames,1), fps=tl.fps||25;
 // mode bar: gravity / insert-mode / region fx / gaps / undo
 const bar=document.createElement('div');
 bar.style.cssText='margin:2px 0;font-size:11px';
 const gsel=document.createElement('select');
 [['normal',0],['left',1],['right',2]].forEach(([n,v])=>{
  const o=document.createElement('option');o.value=v;o.textContent='grav:'+n;
  gsel.appendChild(o);});
 gsel.value=tl.gravity;
 gsel.onchange=()=>cmd('/mt/gravity/set',[+gsel.value]);
 bar.appendChild(gsel);
 const isel=document.createElement('select');
 [['normal',0],['overwrite',2],['fill',4]].forEach(([n,v])=>{
  const o=document.createElement('option');o.value=v;o.textContent='ins:'+n;
  isel.appendChild(o);});
 isel.value=tl.insert_mode;
 isel.onchange=()=>cmd('/mt/insert_mode/set',[+isel.value]);
 bar.appendChild(isel);
 const fsel=document.createElement('select'); fsel.id='mtfx';
 (window._fxnames||[]).forEach(n=>{const o=document.createElement('option');
  o.value=n;o.textContent=n;fsel.appendChild(o);});
 bar.appendChild(fsel);
 const fxb=document.createElement('button'); fxb.textContent='fx on selection';
 fxb.onclick=async()=>{
  if(!mtSel)return alert('shift-drag a region first');
  await cmd('/mt/fx/region',[fsel.value,mtSel.start,mtSel.end,mtSel.track]);
  drawTimeline();};
 bar.appendChild(fxb);
 const asel=document.createElement('select'); asel.id='mtafx';
 (window._afxnames||[]).forEach(n=>{const o=document.createElement('option');
  o.value=n;o.textContent='a:'+n;asel.appendChild(o);});
 bar.appendChild(asel);
 const afb=document.createElement('button'); afb.textContent='audio fx';
 afb.title='audio-filter region on the selection (master bus if none)';
 afb.onclick=async()=>{
  const s=mtSel?mtSel.start:0, e=mtSel?mtSel.end:total;
  const args=mtSel?[asel.value,s,e,mtSel.track]:[asel.value,0,total];
  await cmd('/mt/afx/region',args); drawTimeline();};
 bar.appendChild(afb);
 const gapb=document.createElement('button'); gapb.textContent='close gaps';
 gapb.onclick=async()=>{await cmd('/mt/gap/remove');drawTimeline();};
 bar.appendChild(gapb);
 const ub=document.createElement('button'); ub.textContent='undo';
 ub.onclick=async()=>{await cmd('/mt/undo');drawTimeline();};
 bar.appendChild(ub);
 const rb=document.createElement('button'); rb.textContent='render';
 rb.title='render the timeline to a new clip (render progress dialog)';
 rb.onclick=mtRender;
 bar.appendChild(rb);
 el.appendChild(bar);
 // playhead scrubber + rendered-frame preview (multitrack preview pane)
 if(total>1){
  const ph=document.createElement('input'); ph.type='range';
  ph.min=0; ph.max=total-1; ph.style.width='100%';
  ph.value=window._mtPlayhead||0;
  const pv=document.createElement('img');
  pv.style.cssText='max-width:240px;display:block;margin:2px 0;'+
   'border-radius:4px';
  pv.src='/api/mt_preview/'+(window._mtPlayhead||0);
  pv.onerror=()=>{pv.style.display='none';};
  ph.oninput=()=>{window._mtPlayhead=+ph.value;
   pv.src='/api/mt_preview/'+ph.value; pv.style.display='block';};
  el.appendChild(ph); el.appendChild(pv);
 }
 const allRows=[];
 const mkRow=(tr,isAudio)=>{
  const wrap=document.createElement('div');
  wrap.style.cssText='display:flex;align-items:center;gap:4px;margin:2px 0';
  const lab=document.createElement('span');
  lab.textContent=(isAudio?'A':'V')+Math.abs(tr.track);
  lab.style.cssText='width:20px;font-size:10px;color:#888';
  wrap.appendChild(lab);
  const row=document.createElement('div');
  row.dataset.track=tr.track;
  row.style.cssText='position:relative;height:16px;background:#222;'+
   'flex:1;border-radius:3px;cursor:copy';
  allRows.push(row);
  if(isAudio){  // waveform strip behind the blocks (audio.c peaks)
   const cv=document.createElement('canvas');
   cv.width=600; cv.height=16;
   cv.style.cssText='position:absolute;inset:0;width:100%;height:100%;'+
    'pointer-events:none;opacity:.7';
   row.appendChild(cv);
   fetch('/api/audio_wave/'+tr.track+'?w=600').then(r=>r.ok?r.json():null)
    .then(wv=>{ if(!wv)return;
     const g=cv.getContext('2d'); g.strokeStyle='#6a9';
     g.beginPath();
     for(let c=0;c<wv.width;c++){
      g.moveTo(c+.5, 8-wv.maxs[c]*7.5);
      g.lineTo(c+.5, 8-wv.mins[c]*7.5);
     }
     g.stroke();
    }).catch(()=>{});
  }
  // click: insert fg clip; shift-drag: region select
  row.onmousedown=(e)=>{
   if(!e.shiftKey)return;
   e.preventDefault();
   const r=row.getBoundingClientRect();
   const f0=Math.round((e.clientX-r.left)/r.width*total);
   const move=(ev)=>{
    const f1=Math.round((ev.clientX-r.left)/r.width*total);
    mtSel={track:tr.track,start:Math.min(f0,f1),end:Math.max(f0,f1)};
   };
   const up=async()=>{document.removeEventListener('mousemove',move);
    document.removeEventListener('mouseup',up);
    if(mtSel)await cmd('/mt/region/select',[mtSel.start,mtSel.end,mtSel.track]);
    drawTimeline();};
   document.addEventListener('mousemove',move);
   document.addEventListener('mouseup',up);
  };
  row.onclick=async(e)=>{
   if(e.shiftKey)return;
   const st=await (await fetch('/api/state')).json();
   const fg=st.clips.find(c=>c.fg); if(!fg)return;
   const frac=(e.clientX-row.getBoundingClientRect().left)/row.offsetWidth;
   await cmd(isAudio?'/mt/ablock/insert':'/block/insert',
    isAudio?[fg.id,tr.track,frac*total/fps]:[fg.id,tr.track,frac*total/fps]);
   drawTimeline();
  };
  // selection highlight
  if(mtSel&&mtSel.track===tr.track){
   const s=document.createElement('div');
   s.style.cssText='position:absolute;top:0;bottom:0;background:#fff2;'+
    'left:'+(mtSel.start/total*100)+'%;width:'+
    ((mtSel.end-mtSel.start)/total*100)+'%;pointer-events:none';
   row.appendChild(s);
  }
  tr.blocks.forEach((b,bi)=>{
   const d=document.createElement('div');
   d.title='clip '+b.clip+' ['+b.start+'-'+b.end+') — drag moves, '+
    'edge-drag trims, right-click deletes';
   d.style.cssText='position:absolute;top:0;bottom:0;background:hsl('+
    (b.clip*67%360)+','+(isAudio?'35':'60')+'%,45%);left:'+
    (b.start/total*100)+'%;width:'+((b.end-b.start)/total*100)+'%';
   d.oncontextmenu=async(e)=>{e.preventDefault();e.stopPropagation();
    await cmd(isAudio?'/mt/ablock/delete':'/block/delete',[tr.track,bi]);
    drawTimeline();};
   d.onmousedown=(e)=>{   // drag to move / edge-drag to trim
    if(e.button!==0||e.shiftKey)return;
    e.preventDefault(); e.stopPropagation();
    const r=row.getBoundingClientRect(), x0=e.clientX, y0=e.clientY;
    const edge=(e.clientX>d.getBoundingClientRect().right-6);
    let moved=false;
    const move=(ev)=>{ if(Math.abs(ev.clientX-x0)>3||
                          Math.abs(ev.clientY-y0)>8) moved=true; };
    const up=async(ev)=>{
     document.removeEventListener('mousemove',move);
     document.removeEventListener('mouseup',up);
     if(!moved)return;
     if(edge&&!isAudio){
      const nl=((ev.clientX-r.left)/r.width*total-b.start)/fps;
      await cmd('/block/trim',[tr.track,bi,Math.max(nl,1/fps)]);
     }else if(!isAudio){
      const df=(ev.clientX-x0)/r.width*total;
      let nt=tr.track;
      const tgt=allRows.find(rw=>{const rr=rw.getBoundingClientRect();
       return ev.clientY>=rr.top&&ev.clientY<=rr.bottom;});
      if(tgt)nt=+tgt.dataset.track;
      if(nt>=0)
       await cmd('/block/move',[tr.track,bi,nt,(b.start+df)/fps]);
     }
     drawTimeline();
    };
    document.addEventListener('mousemove',move);
    document.addEventListener('mouseup',up);
   };
   row.appendChild(d);
  });
  // audio mixer slider (avol model)
  const vol=document.createElement('input');
  vol.type='range'; vol.min=0; vol.max=1.5; vol.step=0.01;
  vol.value=tr.volume; vol.title='track volume (avol)';
  vol.style.width='70px';
  vol.oninput=()=>cmd('/mt/track/volume/set',[tr.track,+vol.value]);
  wrap.appendChild(row); wrap.appendChild(vol);
  el.appendChild(wrap);
 };
 tl.tracks.forEach(tr=>mkRow(tr,false));
 (tl.atracks||[]).forEach(tr=>mkRow(tr,true));
 // effect region strips + keyframe dots
 (tl.effects||[]).forEach(fx=>{
  const row=document.createElement('div');
  row.style.cssText='position:relative;height:8px;background:#1a1a1a;'+
   'margin:1px 0 1px 24px;border-radius:2px';
  const d=document.createElement('div');
  d.title=fx.filter+' t'+fx.tracks.join(',')+' — click adds keyframe, '+
   'right-click removes fx';
  d.style.cssText='position:absolute;top:0;bottom:0;background:#777;'+
   'left:'+(fx.start/total*100)+'%;width:'+
   ((fx.end-fx.start)/total*100)+'%;border-radius:2px';
  d.oncontextmenu=async(e)=>{e.preventDefault();
   await cmd('/mt/fx/remove',[fx.id]); drawTimeline();};
  d.onclick=async(e)=>{
   const frac=(e.clientX-row.getBoundingClientRect().left)/row.offsetWidth;
   const pn=prompt('keyframe param name for '+fx.filter+':');
   if(!pn)return;
   const v=prompt('value at frame '+Math.round(frac*total)+':');
   if(v===null)return;
   await cmd('/mt/keyframe/set',[fx.id,Math.round(frac*total),pn,+v]);
   drawTimeline();};
  row.appendChild(d);
  Object.entries(fx.keyframes||{}).forEach(([pn,frames])=>{
   frames.forEach(f=>{
    const k=document.createElement('div');
    k.title=fx.filter+'.'+pn+' @'+f;
    k.style.cssText='position:absolute;top:-1px;width:5px;height:10px;'+
     'background:#ff0;border-radius:50%;left:calc('+(f/total*100)+'% - 2px)';
    row.appendChild(k);
   });
  });
  el.appendChild(row);
 });
}
// fx name lists for the region-fx dropdowns
(async()=>{
 const r=await (await fetch('/api/cmd',{method:'POST',
   body:JSON.stringify({path:'/effects/list',args:[]})})).json();
 if(r.ok&&r.ret)window._fxnames=r.ret.split(' ').filter(Boolean);
 const a=await (await fetch('/api/cmd',{method:'POST',
   body:JSON.stringify({path:'/audio/fx/names',args:[]})})).json();
 if(a.ok&&a.ret)window._afxnames=a.ret.split(' ').filter(Boolean);
})();
// live audio fx chain (weed_apply_audio_effects_rt role)
async function drawAudioFx(){
 const el=document.getElementById('audiofx'); if(!el)return;
 el.innerHTML='';
 const sel=document.createElement('select');
 (window._afxnames||[]).forEach(n=>{const o=document.createElement('option');
  o.value=n;o.textContent=n;sel.appendChild(o);});
 const add=document.createElement('button'); add.textContent='add';
 add.onclick=async()=>{await cmd('/audio/fx/add',[sel.value]);drawAudioFx();};
 el.appendChild(sel); el.appendChild(add);
 const r=await (await fetch('/api/cmd',{method:'POST',
   body:JSON.stringify({path:'/audio/fx/list',args:[]})})).json();
 if(r.ok&&r.ret)r.ret.split(' ').filter(Boolean).forEach((n,i)=>{
  const b=document.createElement('button'); b.textContent=i+': '+n+' ✕';
  b.onclick=async()=>{await cmd('/audio/fx/remove',[i]);drawAudioFx();};
  el.appendChild(b);});
}

async function loadParams(k){
 const spec=await (await fetch('/api/params/'+k)).json();
 const pd=document.getElementById('params'); pd.innerHTML='';
 if(spec.special&&spec.widgets){
  fdSpec={type:spec.special.type,points:spec.special.points||[],
          widgets:spec.widgets};
 }else fdSpec=null;
 fdDraw();
 if(!spec.widgets)return;
 spec.widgets.forEach((p)=>{
  const i=p.index;
  if(p.widget!=='color'&&(i===undefined||i<0))return;
  const d=document.createElement('div'); d.className='param';
  const l=document.createElement('label');
  l.textContent=p.label||p.name; d.appendChild(l);
  if(p.widget==='slider'){
   const s=document.createElement('input'); s.type='range';
   s.min=p.min; s.max=p.max; s.step=(p.max-p.min)/200||0.01; s.value=p.value;
   s.oninput=()=>cmd('/effect_key/parameter/value/set',[k,i,+s.value]);
   d.appendChild(s);
  }else if(p.widget==='spin'){
   const s=document.createElement('input'); s.type='number';
   s.min=p.min; s.max=p.max; s.step=p.step||1; s.value=p.value;
   s.style.width='80px';
   s.onchange=()=>cmd('/effect_key/parameter/value/set',[k,i,+s.value]);
   d.appendChild(s);
  }else if(p.widget==='checkbox'||p.widget==='toggle'){
   const b=document.createElement('input'); b.type='checkbox';
   b.checked=!!p.value;
   b.onchange=()=>cmd('/effect_key/parameter/value/set',
                      [k,i,b.checked?1:0]);
   d.appendChild(b);
  }else if(p.widget==='combo'){
   const s=document.createElement('select');
   (p.choices||[]).forEach((c,ci)=>{
    const o=document.createElement('option'); o.value=ci; o.textContent=c;
    s.appendChild(o);});
   s.value=p.value;
   s.onchange=()=>cmd('/effect_key/parameter/value/set',[k,i,+s.value]);
   d.appendChild(s);
  }else if(p.widget==='color'){
   // collapsed RGB triplet (paramwindow.c colour button role): one
   // picker writes the three underlying params (0..1 domain)
   const idx=p.indices||[]; if(idx.some(x=>x<0))return;
   const s=document.createElement('input'); s.type='color';
   const v=p.value||[0,0,0];
   s.value='#'+v.map(x=>Math.round(Math.max(0,Math.min(1,x))*255)
     .toString(16).padStart(2,'0')).join('');
   s.onchange=()=>{
    const hx=s.value;
    [1,3,5].forEach((o,c)=>cmd('/effect_key/parameter/value/set',
      [k,idx[c],parseInt(hx.slice(o,o+2),16)/255]));
   };
   d.appendChild(s);
  }else if(p.widget==='entry'){
   const s=document.createElement('input'); s.type='text';
   s.value=p.value==null?'':p.value; s.style.width='90%';
   s.onchange=()=>cmd('/effect_key/parameter/value/set',[k,i,s.value]);
   d.appendChild(s);
  }
  pd.appendChild(d);
 });
}
async function toggleSt(field,path){
 const st=await (await fetch('/api/state')).json();
 await cmd(path,[st[field]?0:1]); refresh();
}
// --- modal dialogs (Save-As / Merge / Clip-info / Sets — the GTK
// dialog surfaces, served as overlays) -----------------------------------
function modal(title){
 let ov=document.getElementById('modal_ov'); if(ov)ov.remove();
 ov=document.createElement('div'); ov.id='modal_ov';
 ov.style.cssText='position:fixed;inset:0;background:#000a;z-index:9';
 const box=document.createElement('div');
 box.style.cssText='background:#222;margin:10vh auto;padding:14px;'+
  'max-width:460px;border-radius:8px;border:1px solid #555';
 const x=document.createElement('button'); x.textContent='close';
 x.style.cssText='float:right'; x.onclick=()=>ov.remove();
 const h=document.createElement('h3'); h.textContent=title;
 box.appendChild(x); box.appendChild(h);
 const c=document.createElement('div'); box.appendChild(c);
 ov.appendChild(box); document.body.appendChild(ov);
 return c;
}
async function openSaveAs(){
 const enc=await (await fetch('/api/encoders')).json();
 const c=modal('Save clip as (encode)');
 c.innerHTML='<input id="sa_path" placeholder="/tmp/out.y4m"'+
  ' style="width:96%"><div><select id="sa_enc"></select>'+
  ' <label><input type="checkbox" id="sa_sel"> selection only</label>'+
  '</div><button id="sa_go">encode</button> '+
  '<progress id="sa_prog" max="1" value="0" style="width:55%"></progress>'+
  ' <span id="sa_msg"></span>';
 const sel=document.getElementById('sa_enc');
 enc.encoders.forEach(e=>{const o=document.createElement('option');
  o.value=e.name;
  o.textContent=e.name+(e.formats.length?' (.'+e.formats[0]+')':'');
  sel.appendChild(o);});
 document.getElementById('sa_go').onclick=async()=>{
  const r=await (await fetch('/api/encode',{method:'POST',
   body:JSON.stringify({path:document.getElementById('sa_path').value,
    encoder:sel.value,
    selection_only:document.getElementById('sa_sel').checked})})).json();
  const msg=document.getElementById('sa_msg');
  if(!r.ok){msg.textContent=r.error; return;}
  const poll=setInterval(async()=>{
   const js=await (await fetch('/api/jobs')).json();
   const j=js[r.job]; if(!j)return;
   const pg=document.getElementById('sa_prog');
   if(pg)pg.value=j.total?j.done/j.total:0;
   if(msg)msg.textContent=j.state+(j.error?': '+j.error:'');
   if(j.state!=='running')clearInterval(poll);
  },500);
 };
}
async function openMerge(){
 const r=await api('/effects/transitions/list');
 const c=modal('Merge clipboard into selection');
 c.innerHTML='<div>transition <select id="mg_t"></select></div>'+
  '<div>amount ramp <input id="mg_r0" type="number" value="0" step="0.1"'+
  ' min="0" max="1" style="width:60px"> to <input id="mg_r1"'+
  ' type="number" value="1" step="0.1" min="0" max="1"'+
  ' style="width:60px"></div>'+
  '<button id="mg_go">merge</button> <span id="mg_msg"></span>';
 const sel=document.getElementById('mg_t');
 (r.ret||'').split(' ').filter(Boolean).forEach(n=>{
  const o=document.createElement('option');o.value=n;o.textContent=n;
  sel.appendChild(o);});
 if([...sel.options].some(o=>o.value==='crossfade'))sel.value='crossfade';
 document.getElementById('mg_go').onclick=async()=>{
  const rr=await api('/clip/selection/merge',[sel.value,
   +document.getElementById('mg_r0').value,
   +document.getElementById('mg_r1').value]);
  document.getElementById('mg_msg').textContent=
   rr.ok?('merged '+rr.ret+' frames'):rr.error;
  refresh();
 };
}
async function resampleClip(){
 const f=prompt('resample clip to fps:','25');
 if(f)await cmd('/clip/resample',[+f]);
}
async function clipSpeed(){
 const f=prompt('clip fps (playback/save speed):','25');
 if(f)await cmd('/clip/fps/set',[+f]);
}
async function audioEdit(kind){
 // Audio-menu dialogs that take one number (create_audfade_dialog /
 // audio sync offset); the rest act on the selection directly
 if(kind==='fadein'||kind==='fadeout'){
  const t=prompt('fade '+(kind==='fadein'?'in':'out')+' seconds:','1.0');
  if(t)await cmd('/clip/audio/'+kind,[+t]);
 }else if(kind==='sync'){
  const o=prompt('audio sync offset seconds (+delays audio):','0.0');
  if(o!==null)await cmd('/clip/audio/sync/adjust',[+o]);
 }
}
async function mtRender(){
 const c=modal('Render timeline');
 c.innerHTML='<label><input type="checkbox" id="mtr_a" checked> mix'+
  ' audio</label> <button id="mtr_go">render</button> '+
  '<progress id="mtr_prog" max="1" value="0" style="width:55%"></progress>'+
  ' <span id="mtr_msg"></span>';
 document.getElementById('mtr_go').onclick=async()=>{
  const r=await (await fetch('/api/mt_render',{method:'POST',
   body:JSON.stringify({audio:document.getElementById('mtr_a').checked})}
   )).json();
  const msg=document.getElementById('mtr_msg');
  if(!r.ok){msg.textContent=r.error; return;}
  const poll=setInterval(async()=>{
   const js=await (await fetch('/api/jobs')).json();
   const j=js[r.job]; if(!j)return;
   const pg=document.getElementById('mtr_prog');
   if(pg)pg.value=j.total?j.done/j.total:0;
   if(msg)msg.textContent=j.state+
    (j.clip?(' -> clip '+j.clip):'')+(j.error?': '+j.error:'');
   if(j.state!=='running'){clearInterval(poll);refresh();}
  },500);
 };
}
async function loadSubs(){
 const p=prompt('subtitle file (.srt/.sub):','/tmp/subs.srt');
 if(p)await cmd('/clip/subtitles/load',[p]);
}
async function clipInfo(){
 const st=await (await fetch('/api/state')).json();
 const fg=st.clips.find(c=>c.fg); if(!fg)return;
 const info=await (await fetch('/api/clipinfo/'+fg.id)).json();
 const c=modal('Clip info: '+(info.name||fg.id));
 const t=document.createElement('table'); t.style.fontSize='12px';
 Object.entries(info).forEach(([k,v])=>{
  const tr=document.createElement('tr');
  const a=document.createElement('td');a.textContent=k;a.style.color='#9cf';
  const b=document.createElement('td');b.textContent=v;
  tr.appendChild(a);tr.appendChild(b);t.appendChild(tr);});
 c.appendChild(t);
}
async function drawSets(){
 const r=await api('/clipset/list'); if(!r.ok)return;
 const sel=document.getElementById('setsel');
 const cur=sel.value; sel.innerHTML='';
 (r.ret||'').split(' ').filter(Boolean).forEach(n=>{
  const o=document.createElement('option');o.value=n;o.textContent=n;
  sel.appendChild(o);});
 if(cur)sel.value=cur;
}
async function saveSet(){
 const n=document.getElementById('setname').value.trim();
 if(n){await cmd('/clipset/save',[n]); drawSets();}
}
async function loadSet(){
 const n=document.getElementById('setsel').value;
 if(n){await cmd('/clipset/load',[n]); refresh();}
}
refresh(); drawTimeline(); setInterval(refresh, 1000);
setInterval(drawTimeline, 3000);
setTimeout(drawKeymap, 400); setInterval(drawKeymap, 4000);
// --- message console (src/messaging.c d_print ring in the main window) -
const LVL_ORD={debug:0,info:1,warn:2,error:3};
const LVL_COL={debug:'#888',info:'#ccc',warn:'#fb3',error:'#f66'};
async function drawConsole(){
 const el=document.getElementById('console'); if(!el)return;
 const min=LVL_ORD[document.getElementById('conlvl').value]||0;
 const ms=await (await fetch('/api/messages?n=200')).json();
 const atEnd=el.scrollTop+el.clientHeight>=el.scrollHeight-4;
 el.innerHTML='';
 ms.filter(m=>LVL_ORD[m.level]>=min).forEach(m=>{
  const d=document.createElement('div');
  d.style.color=LVL_COL[m.level]||'#ccc';
  d.textContent=new Date(m.t*1000).toTimeString().slice(0,8)+' '+m.msg;
  el.appendChild(d);});
 if(atEnd)el.scrollTop=el.scrollHeight;   // follow the tail like a log view
}
setTimeout(drawConsole, 700); setInterval(drawConsole, 3000);
setTimeout(drawConns, 500); setInterval(drawConns, 5000);
setTimeout(drawPrefs, 600);
setTimeout(drawStrip, 500); setInterval(drawStrip, 2500);
setTimeout(drawSets, 800);
// --- keyboard accelerators (the main-window accel_group, gui.c:2559+;
// same bindings as the reference so VJs keep their muscle memory) -------
let grabKey=1;  // the key receiving k-grab / Alt-arrows (grabkeys_callback)
async function nudgeGrabbed(dir){
 // Alt+Up/Down: more/less on the grabbed key's first numeric param
 const spec=await (await fetch('/api/params/'+grabKey)).json();
 const w=(spec.widgets||[]).find(w=>w.index>=0&&typeof w.value==='number');
 if(!w)return;
 let v=w.value+dir*Math.max(Math.abs(w.max-w.min)*0.05,1e-3);
 v=Math.min(Math.max(v,w.min),w.max);
 cmd('/effect_key/parameter/value/set',[grabKey,w.index,v]);
}
const KEYHELP=[
 ['p','play'],['q','stop'],['y','play selection'],['r','record toggle'],
 ['f','fullscreen preview'],['s','separate play window'],
 ['d','double size'],['h','hide/show filmstrip'],
 ['l / o','loop continuous'],['g','ping-pong loop'],['z','mute audio'],
 ['x','swap fg/bg clips'],['e','retrigger clip (frame 1)'],
 ['n','nervous mode'],['k','cycle grabbed effect key'],
 ['m / M','next / prev mode on grabbed key'],
 ['F1-F12','switch to clip bookmark (stores if empty)'],
 ['Shift+F1-F12','store clip bookmark'],
 ['Ctrl+1..9','toggle effect key'],['Ctrl+0','all effects off'],
 ['Ctrl+Alt+1..9','grab effect key'],
 ['Ctrl+PgUp/PgDn','prev / next clip'],
 ['Shift+PgUp/PgDn','prev / next background clip'],
 ['Ctrl+Up/Down','faster / slower'],
 ['Shift+Up/Down','bg faster / slower'],
 ['Ctrl+Left/Right','skip back / forward ~1s'],
 ['Ctrl+Space','reverse direction'],['Shift+Space','bg reverse'],
 ['Ctrl+Enter','reset fps'],['Shift+Enter','bg reset fps'],
 ['Alt+Up/Down','more / less (grabbed key param)'],
 ['+ / _','volume up / down'],['?','this help']];
function showKeyHelp(){
 const c=modal('Keyboard shortcuts (VJ accelerators)');
 const t=document.createElement('table');
 t.style.cssText='font-size:12px;line-height:1.5';
 KEYHELP.forEach(([k,d])=>{const tr=document.createElement('tr');
  const a=document.createElement('td');a.innerHTML='<b>'+k+'</b>';
  a.style.paddingRight='12px';
  const b=document.createElement('td');b.textContent=d;
  tr.appendChild(a);tr.appendChild(b);t.appendChild(tr);});
 c.appendChild(t);
}
async function skipSecs(dir){
 const st=await (await fetch('/api/state')).json();
 const step=Math.max(Math.round(Math.abs(st.fps)||25),1);
 cmd('/clip/foreground/frame/set',
     [Math.max(0,Math.min(st.frame+dir*step,st.frames-1))]);
}
document.addEventListener('keydown',async ev=>{
 const tag=(ev.target.tagName||'').toLowerCase();
 if(tag==='input'||tag==='textarea'||tag==='select')return;
 if(ev.key==='Escape'){const ov=document.getElementById('modal_ov');
  if(ov)ov.remove(); return;}
 const k=ev.key, C=ev.ctrlKey, S=ev.shiftKey, A=ev.altKey;
 const fkey=/^F(\\d+)$/.exec(k);
 if(fkey&&!C&&!A){ev.preventDefault();
  cmd(S?'/clip/bookmark/set':'/clip/bookmark/select',[+fkey[1]]);return;}
 if(C&&!A&&/^[0-9]$/.test(k)){ev.preventDefault();
  if(k==='0')cmd('/effect_key/reset');
  else cmd('/effect_key/toggle',[+k]); return;}
 if(C&&A&&/^[1-9]$/.test(k)){ev.preventDefault();grabKey=+k;return;}
 if(C&&k==='PageUp'){ev.preventDefault();cmd('/clip/select/previous');return;}
 if(C&&k==='PageDown'){ev.preventDefault();cmd('/clip/select/next');return;}
 if(S&&k==='PageUp'){ev.preventDefault();cmd('/clip/background/previous');return;}
 if(S&&k==='PageDown'){ev.preventDefault();cmd('/clip/background/next');return;}
 if(A&&k==='ArrowUp'){ev.preventDefault();nudgeGrabbed(1);return;}
 if(A&&k==='ArrowDown'){ev.preventDefault();nudgeGrabbed(-1);return;}
 if(C&&k==='ArrowUp'){ev.preventDefault();cmd('/video/play/faster');return;}
 if(C&&k==='ArrowDown'){ev.preventDefault();cmd('/video/play/slower');return;}
 if(S&&k==='ArrowUp'){ev.preventDefault();cmd('/clip/background/fps/faster');return;}
 if(S&&k==='ArrowDown'){ev.preventDefault();cmd('/clip/background/fps/slower');return;}
 if(C&&k==='ArrowLeft'){ev.preventDefault();skipSecs(-1);return;}
 if(C&&k==='ArrowRight'){ev.preventDefault();skipSecs(1);return;}
 if(C&&k===' '){ev.preventDefault();cmd('/video/play/reverse');return;}
 if(S&&k===' '){ev.preventDefault();cmd('/clip/background/fps/reverse');return;}
 if(C&&k==='Enter'){ev.preventDefault();cmd('/video/play/reset');return;}
 if(S&&k==='Enter'){ev.preventDefault();cmd('/clip/background/fps/reset');return;}
 if(C||A)return;   // unclaimed chords stay with the browser
 switch(k){
  case 'p': cmd('/video/play'); break;
  case 'q': cmd('/video/stop'); break;
  case 'y': cmd('/video/selection/play'); break;
  case 'r': cmd('/record/toggle'); break;
  case 'f': {const pv=document.getElementById('preview');
   if(document.fullscreenElement)document.exitFullscreen();
   else if(pv&&pv.requestFullscreen)pv.requestFullscreen(); break;}
  case 's': window.open('/preview.mjpg','sepwin','width=660,height=400');
   break;
  case 'd': {const pv=document.getElementById('preview');
   pv.style.maxWidth=pv.style.maxWidth==='100%'?'':'100%'; break;}
  case 'h': {const st2=document.getElementById('strip');
   if(st2)st2.style.display=st2.style.display==='none'?'':'none'; break;}
  case 'l': case 'o': toggleSt('loop','/video/loop/set'); break;
  case 'g': toggleSt('pingpong','/video/pingpong/set'); break;
  case 'z': toggleSt('muted','/audio/mute/set'); break;
  case 'x': cmd('/clip/foreground/background/swap'); break;
  case 'e': cmd('/clip/foreground/retrigger'); break;
  case 'n': {const r=await api('/video/nervous/get',[]);
   cmd(r.ret?'/video/nervous/disable':'/video/nervous/enable'); break;}
  case 'k': grabKey=grabKey%12+1; break;
  case 'm': cmd('/effect_key/mode/next',[grabKey]); break;
  case 'M': cmd('/effect_key/mode/previous',[grabKey]); break;
  case '+': {const st3=await (await fetch('/api/state')).json();
   cmd('/audio/volume/set',[Math.min(1,st3.volume+0.05)]); break;}
  case '_': {const st4=await (await fetch('/api/state')).json();
   cmd('/audio/volume/set',[Math.max(0,st4.volume-0.05)]); break;}
  case '?': showKeyHelp(); break;
  default: return;
 }
 ev.preventDefault();
});
</script></body></html>"""


class WebUI:
    """HTTP front-end over an OSCServer's player + method table."""

    def __init__(self, osc_server, host: str = "127.0.0.1", port: int = 0,
                 keys_shown: int = 9):
        self.osc = osc_server
        self.player = osc_server.player
        self.keys_shown = keys_shown
        # background encode jobs (the Save-As progress dialog polls these)
        self.jobs: dict[int, dict] = {}
        self._job_seq = 0
        # splice the preview tap in front of the player's sink
        self.tap = PreviewTap(self.player.sink)
        self.player.sink = self.tap
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/api/state":
                    self._json(ui.state())
                elif self.path.startswith("/api/messages"):
                    try:
                        n = int(self.path.split("n=", 1)[1].split("&")[0]) \
                            if "n=" in self.path else 100
                    except ValueError:
                        n = 100
                    from .messaging import console
                    self._json([{"t": t, "level": lvl, "msg": msg}
                                for t, lvl, msg in
                                list(console.ring)[-max(1, min(n, 2000)):]])
                elif self.path == "/api/timeline":
                    self._json(ui.timeline())
                elif self.path.startswith("/api/audio_wave/"):
                    try:
                        q = self.path[len("/api/audio_wave/"):]
                        trk = int(q.split("?")[0])
                        w = 600
                        if "?" in q and "w=" in q:
                            w = max(16, min(4000, int(
                                q.split("w=")[1].split("&")[0])))
                    except ValueError:
                        self.send_response(404)
                        self.end_headers()
                        return
                    wave = ui.audio_wave(trk, w)
                    if wave is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self._json(wave)
                elif self.path.startswith("/api/params/"):
                    self._json(ui.param_spec(int(self.path.rsplit("/", 1)
                                                 [-1])))
                elif self.path == "/api/keymap":
                    self._json(ui.keymap_state())
                elif self.path == "/api/datacons":
                    self._json(ui.datacons_state())
                elif self.path == "/api/prefs":
                    self._json(ui.prefs_state())
                elif self.path == "/api/encoders":
                    self._json(ui.encoders_state())
                elif self.path == "/api/jobs":
                    self._json(ui.jobs_state())
                elif self.path.startswith("/api/rfx_spec/"):
                    spec = ui.rfx_spec(self.path.rsplit("/", 1)[-1])
                    if spec is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self._json(spec)
                elif self.path.startswith("/api/clipinfo/"):
                    try:
                        cid = int(self.path.rsplit("/", 1)[-1])
                    except ValueError:
                        self.send_response(404)
                        self.end_headers()
                        return
                    info = ui.clipinfo(cid)
                    if info is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self._json(info)
                elif self.path.startswith("/api/strip/"):
                    try:
                        cid = int(self.path[len("/api/strip/"):]
                                  .split("?")[0])
                    except ValueError:
                        self.send_response(404)
                        self.end_headers()
                        return
                    jpeg = ui.strip(cid)
                    if jpeg is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpeg)))
                    self.end_headers()
                    self.wfile.write(jpeg)
                elif self.path.startswith("/api/thumb/"):
                    try:
                        tail = self.path[len("/api/thumb/"):]
                        q = {}
                        if "?" in tail:
                            tail, qs = tail.split("?", 1)
                            q = dict(kv.split("=", 1)
                                     for kv in qs.split("&") if "=" in kv)
                        cid = int(tail)
                        frame = int(q.get("frame", 0))
                        tw = int(q.get("w", 96))
                    except ValueError:
                        self.send_response(404)
                        self.end_headers()
                        return
                    jpeg = ui.thumb(cid, frame, tw)
                    if jpeg is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Cache-Control", "max-age=30")
                    self.send_header("Content-Length", str(len(jpeg)))
                    self.end_headers()
                    self.wfile.write(jpeg)
                elif self.path.startswith("/api/mt_preview/"):
                    try:
                        fr = int(self.path.rsplit("/", 1)[-1])
                    except ValueError:
                        self.send_response(404)
                        self.end_headers()
                        return
                    jpeg = ui.mt_preview(fr)
                    if jpeg is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpeg)))
                    self.end_headers()
                    self.wfile.write(jpeg)
                elif self.path == "/preview.jpg":
                    # the encode worker is async: give the first frame a
                    # moment to land
                    jpeg, _ = ui.tap.wait_jpeg(-1, timeout=2.0)
                    if jpeg is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpeg)))
                    self.end_headers()
                    self.wfile.write(jpeg)
                elif self.path == "/preview.mjpg":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    seq = -1
                    try:
                        while ui._running:
                            jpeg, seq2 = ui.tap.wait_jpeg(seq, timeout=0.5)
                            if jpeg is None or seq2 == seq:
                                continue
                            seq = seq2
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jpeg)}\r\n\r\n"
                                .encode())
                            self.wfile.write(jpeg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if self.path == "/api/cmd":
                    req = {}
                    try:
                        req = json.loads(body)
                        ret = ui.call(req["path"], req.get("args", []))
                        self._json({"ok": True, "ret": ret})
                    except Exception as e:
                        # mirror UI-command failures onto the message
                        # console like the reference's d_print on errors
                        from .messaging import console
                        path = (req.get("path", self.path)
                                if isinstance(req, dict) else self.path)
                        console.d_print(f"{path}: {e}", "error")
                        self._json({"ok": False, "error": str(e)}, 400)
                elif self.path == "/api/blend":
                    try:
                        ui.player.state.blend_amount = float(body)
                        self._json({"ok": True})
                    except ValueError as e:
                        self._json({"ok": False, "error": str(e)}, 400)
                elif self.path == "/api/encode":
                    try:
                        req = json.loads(body)
                        self._json(ui.start_encode(req))
                    except Exception as e:
                        self._json({"ok": False, "error": str(e)}, 400)
                elif self.path == "/api/mt_render":
                    try:
                        req = json.loads(body) if body else {}
                        self._json(ui.start_mt_render(req))
                    except Exception as e:
                        self._json({"ok": False, "error": str(e)}, 400)
                else:
                    self.send_response(404)
                    self.end_headers()

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- bindings -----------------------------------------------------------
    def mt_preview(self, frame: int):
        """JPEG of ONE rendered timeline frame at `frame` — the
        multitrack preview pane (multitrack.c show_preview role). Renders
        through the real segment renderer against the server's clips."""
        mt = getattr(self.osc, "multitrack", None)
        if mt is None or mt.n_frames == 0:
            return None
        frame = max(0, min(int(frame), mt.n_frames - 1))
        try:
            import io as _io

            import numpy as _np
            from PIL import Image

            from .events.event_list import EventList
            from .events.renderer import ClipFrameSource, render_to_arrays
            from .graph.nodemodel import SinkSpec
            from .events.event_list import EventType
            ev = mt._frame_event_at(frame)
            if ev is None:
                return None
            sub = EventList(fps=mt.el.fps, width=mt.el.width,
                            height=mt.el.height)
            # one FRAME event + the filter state active at its tc
            for e in mt.el.events:
                if e.tc <= ev.tc and e.type != EventType.FRAME:
                    sub.insert(e)
            sub.insert(ev)
            uid_map = {getattr(c, "unique_id", k): c
                       for k, c in self.osc.clips.items()}
            w = min(mt.el.width or 480, 480)
            h = max(1, int((mt.el.height or 270) * w
                           / max(mt.el.width or 480, 1)))
            frames, _ = render_to_arrays(
                sub, ClipFrameSource(uid_map, device=self.player.device),
                SinkSpec(width=w, height=h), batch_size=1)
            arr = _np.moveaxis(frames[0], 0, -1)
            buf = _io.BytesIO()
            Image.fromarray(arr).save(buf, "JPEG", quality=75)
            return buf.getvalue()
        except Exception:
            return None

    def thumb(self, cid: int, frame: int = 0, tw: int = 96):
        """JPEG thumbnail of a clip frame (the ce_thumbs.c clip
        thumbnail strip; with ?frame= it is also the clip editor's
        start/end selection preview — interface.c load_start_image /
        load_end_image); cached per (clip, frame, width)."""
        clip = self.osc.clips.get(cid)
        if clip is None:
            return None
        frame = max(0, min(int(frame), getattr(clip, "frames", 1) - 1))
        tw = max(16, min(int(tw), 640))
        cache = getattr(self, "_thumbs", None)
        if cache is None:
            cache = self._thumbs = {}
        if len(cache) > 64:  # bound (closed clips accumulate otherwise)
            cache.clear()
        # id() recycles after GC and cids after close: key by the clip's
        # durable identity when it has one
        key = (cid, getattr(clip, "unique_id", None) or id(clip),
               frame, tw)
        if key not in cache:
            try:
                import io as _io

                import numpy as _np
                from PIL import Image

                from .constants import Palette as _P
                from .ops.colorspace import convert_layer as _cv
                lay = _cv(clip.get_frame(frame), _P.RGB24)
                arr = _np.moveaxis(lay.planes[0].cpu().numpy(), 0, -1)
                im = Image.fromarray(arr)
                im = im.resize((tw, max(1, tw * im.height // im.width)))
                buf = _io.BytesIO()
                im.save(buf, "JPEG", quality=70)
                cache[key] = buf.getvalue()
            except Exception:
                return None  # transient (decoder warming): don't cache
        return cache.get(key)

    def strip(self, cid: int, n: int = 12, tw: int = 96):
        """Filmstrip JPEG: `n` thumbnails evenly sampled across the clip,
        side by side in one image — the clip-editor timeline strip
        (ce_thumbs.c:262 start_thumb_panel role); drag on it scrubs.
        Cached per (clip identity, frame count)."""
        clip = self.osc.clips.get(cid)
        frames = getattr(clip, "frames", 0)
        if clip is None or frames < 2:
            return None
        cache = getattr(self, "_strips", None)
        if cache is None:
            cache = self._strips = {}
        if len(cache) > 8:
            cache.clear()
        key = (cid, getattr(clip, "unique_id", None) or id(clip), frames)
        if key not in cache:
            try:
                import io as _io

                import numpy as _np
                from PIL import Image

                from .constants import Palette as _P
                from .ops.colorspace import convert_layer as _cv
                n_th = min(n, frames)
                idxs = [round(i * (frames - 1) / (n_th - 1))
                        for i in range(n_th)]
                thumbs = []
                th = None
                for f in idxs:
                    lay = _cv(clip.get_frame(f), _P.RGB24)
                    arr = _np.moveaxis(lay.planes[0].cpu().numpy(), 0,
                                       -1)
                    im = Image.fromarray(arr)
                    th = max(1, tw * im.height // im.width)
                    thumbs.append(im.resize((tw, th)))
                out = Image.new("RGB", (tw * n_th, th))
                for i, im in enumerate(thumbs):
                    out.paste(im, (i * tw, 0))
                buf = _io.BytesIO()
                out.save(buf, "JPEG", quality=70)
                cache[key] = buf.getvalue()
            except Exception:
                return None  # transient (decoder warming): don't cache
        return cache.get(key)

    def keymap_state(self, n_keys: int = 12) -> dict[str, Any]:
        """rte_window readout: per-key mode slots, active mode, enabled
        state — for the key-map editor panel (rte_window.c:1689 role).
        Shows the first `n_keys` keys plus any mapped key beyond."""
        km = self.player.keymap
        rows = []
        for k in range(len(km.slots)):
            if k >= n_keys and not any(km.slots[k]):
                continue
            rows.append({"key": k + 1, "modes": list(km.slots[k]),
                         "mode": km.mode[k],
                         "active": bool(km.active[k])})
        return {"keys": rows}

    def datacons_state(self) -> dict[str, Any]:
        """Connections-window readout (effects-data.c lives_conx_w
        role): per mapped key the connectable out/in params and alpha
        channels, plus active pconx/cconx lists resolved back to key
        numbers (with indices, so the UI can call the OSC
        connection/add|delete methods)."""
        from .effects.host import get_filter
        km = self.player.keymap
        keys = []
        inst2key: dict[int, int] = {}
        for k in range(len(km.slots)):
            name = km.current_filter(k)
            if not name:
                continue
            try:
                filt = get_filter(name)
            except KeyError:
                continue  # slot names an unregistered filter
            inst = km.instances[k]
            if inst is not None:
                inst2key[id(inst)] = k + 1
            keys.append({
                "key": k + 1, "filter": name, "live": inst is not None,
                "out_params": [p.name for p in filt.out_params],
                "in_params": [p.name for p in filt.params],
                "alpha_outs": [t.name for t in filt.alpha_outs],
                "alpha_ins": len(filt.alpha_ins)})
        dc = getattr(self.osc, "datacons", None) \
            or getattr(self.player, "datacons", None)
        if dc is not None:
            # a mode switch / re-enable replaces the key's instance; the
            # old instance's connections die with it (reference
            # pconx_delete-on-deinit), otherwise they would list as
            # key 0 and be undeletable from the panel
            dc.prune(set(inst2key))
        pconx, cconx = [], []
        if dc is not None:
            def outs_of(inst):
                return [p.name for p in inst.filter.out_params]

            for c in getattr(dc, "conns", ()):
                sk = inst2key.get(id(c.src), 0)
                pconx.append({
                    "src": sk, "out": c.out_param,
                    "out_idx": outs_of(c.src).index(c.out_param)
                    if c.out_param in outs_of(c.src) else -1,
                    "dst": inst2key.get(id(c.dst), 0), "in": c.in_param,
                    "autoscale": bool(getattr(c, "autoscale", False))})
            for c in getattr(dc, "chan_conns", ()):
                aouts = [t.name for t in c.src.filter.alpha_outs]
                cconx.append({
                    "src": inst2key.get(id(c.src), 0),
                    "out": c.out_channel,
                    "out_idx": aouts.index(c.out_channel)
                    if c.out_channel in aouts else -1,
                    "dst": inst2key.get(id(c.dst), 0),
                    "slot": c.in_slot})
        return {"keys": keys, "pconx": pconx, "cconx": cconx}

    def prefs_state(self) -> dict[str, Any]:
        """Preferences-dialog readout (src/preferences.c GUI role): live
        prefs (typed fields + set PREF_ extras), the deferred
        future-prefs buffer, and the known key namespace for the
        add-row picker."""
        from .prefs import REFERENCE_PREF_KEYS, PrefsStore, store
        st = store()
        live = {k: v for k, v in st.prefs.to_dict().items()
                if v is not None}
        return {"live": live, "future": dict(st.future),
                "keys": sorted(set(REFERENCE_PREF_KEYS)
                               | PrefsStore.FIELDS)}

    def encoders_state(self) -> dict[str, Any]:
        """Encoder registry for the Save-As dialog (the reference
        queries encoder plugins' get_capabilities/get_formats,
        src/plugins.c:1813 check_encoder_restrictions)."""
        from .io.encoders import CAP_AUDIO, get_encoder, list_encoders
        out = []
        for name in list_encoders():
            try:
                e = get_encoder(name)
                fmts = [f.extension for f in e.get_formats()]
                caps = e.get_capabilities()
            except Exception:   # an encoder that can't instantiate here
                continue
            out.append({"name": name, "formats": fmts,
                        "audio": bool(caps & CAP_AUDIO)})
        return {"encoders": out}

    def clipinfo(self, cid: int) -> Optional[dict]:
        """Full clip properties (the File > Clip info dialog,
        src/interface.c)."""
        c = self.osc.clips.get(cid)
        if c is None:
            return None
        info: dict[str, Any] = {"id": cid}
        for k in ("name", "frames", "fps", "width", "height", "achans",
                  "arate", "asampsize", "unique_id", "source_uri"):
            v = getattr(c, k, None)
            if isinstance(v, (int, float, str, bool)):
                info[k] = v
        fps = float(info.get("fps") or 0) or 25.0
        info["duration_s"] = round(int(info.get("frames", 0)) / fps, 3)
        cd = getattr(c, "clip_dir", None)
        if cd is not None:
            info["clip_dir"] = str(cd)
        dec = getattr(c, "decoder", None)
        if dec is not None:
            info["decoder"] = type(dec).__name__
        return info

    def jobs_state(self) -> dict[str, Any]:
        return {str(j): dict(job) for j, job in self.jobs.items()}

    def start_encode(self, req: dict) -> dict[str, Any]:
        """Kick a background encode of a clip to a file — the Save-As +
        progress-dialog flow (clip_load_save.c save_file); the dialog
        polls /api/jobs."""
        from .io.encoders import list_encoders
        from .transcode import transcode
        cid = req.get("cid")
        clip = (self.osc.clips.get(int(cid)) if cid is not None
                else self.player.state.fg_clip)
        if clip is None:
            return {"ok": False, "error": "no clip"}
        path = req.get("path") or ""
        if not path:
            return {"ok": False, "error": "no output path"}
        encs = list_encoders()
        encoder = req.get("encoder") or \
            ("av" if "av" in encs else "yuv4mpeg")
        if encoder not in encs:
            return {"ok": False, "error": f"unknown encoder {encoder}"}
        start, end = 0, int(getattr(clip, "frames", 0))
        if req.get("selection_only"):
            st = self.player.state
            start = max(int(st.sel_start), 0)
            if st.sel_end >= 0:
                end = min(int(st.sel_end) + 1, end)
        self._job_seq += 1
        jid = self._job_seq
        job = {"state": "running", "done": 0,
               "total": max(end - start, 1),
               "path": path, "encoder": encoder}
        self.jobs[jid] = job

        def _progress(done, total):
            job["done"], job["total"] = done, total

        def _run():
            try:
                with self.osc._device_ctx():
                    ok = transcode(clip, path, encoder=encoder,
                                   start=start, end=end,
                                   progress_cb=_progress,
                                   device=self.player.device)
                job["state"] = "done" if ok else "error"
            except Exception as ex:    # surfaced in the dialog
                job["state"] = "error"
                job["error"] = str(ex)

        threading.Thread(target=_run, daemon=True,
                         name="encode-job").start()
        return {"ok": True, "job": jid}

    def rfx_spec(self, name: str) -> Optional[dict]:
        """Parameter-window spec for a rendered effect — the reference's
        RFX paramwindow (paramwindow.c make_param_box over the script's
        param defs + paramspecial.c special hints). Widgets use the
        names the script actually CONSUMES (mapping/runner kwargs);
        labels and ranges enrich from the reference .script block when
        the names line up. Specials resolve from the reference block or
        fall back to name heuristics (width+height -> aspect,
        file/image/path -> fileread, font -> fontchooser)."""
        from .rfx_scripts import get_script, script_specials
        try:
            sd = get_script(name)
        except KeyError:
            return None
        widgets = sd.params_spec()
        if sd.runner is None and getattr(sd, "user_spec", None) is None:
            # filter-backed: the mapping consumes the defaults names;
            # the reference block may animate differently-named pairs —
            # keep the UI honest and only enrich where names match
            ref = {q["name"]: q for q in widgets}

            def kind_of(v):
                if isinstance(v, bool):
                    return "bool"
                if isinstance(v, str):
                    return "string"
                if isinstance(v, int):
                    return "int"
                return "num"

            widgets = []
            for k, v in sd.defaults.items():
                q = ref.get(k)
                if q is None:
                    q = {"name": k, "kind": kind_of(v), "default": v}
                    if q["kind"] == "num":
                        q.update(min=0.0,
                                 max=max(1.0, float(v) * 4 or 1.0))
                    elif q["kind"] == "int":
                        q.update(min=0, max=max(100, int(v) * 4))
                widgets.append(q)
        have = {w["name"] for w in widgets}
        specials = [s for s in script_specials(name)
                    if all(q in have for q in s["params"])]

        def has(tp, pn):
            return any(s["type"] == tp and pn in s["params"]
                       for s in specials)

        for w in widgets:
            n, k = w["name"], w.get("kind")
            if k == "string":
                if any(t in n for t in ("file", "image", "path")) \
                        and not has("fileread", n):
                    specials.append({"type": "fileread", "params": [n]})
                elif "font" in n and not has("fontchooser", n):
                    specials.append({"type": "fontchooser",
                                     "params": [n]})
        if {"width", "height"} <= have \
                and not any(s["type"] == "aspect" for s in specials):
            specials.append({"type": "aspect",
                             "params": ["width", "height"]})
        return {"name": name,
                "title": name.replace("_", " ").title(),
                "widgets": widgets, "specials": specials}

    def start_mt_render(self, req: dict) -> dict[str, Any]:
        """Background multitrack render to a new clip with progress —
        the reference's render progress dialog over render_to_clip
        (events.c:4994)."""
        mt = getattr(self.osc, "multitrack", None)
        if mt is None or mt.n_frames == 0:
            return {"ok": False, "error": "empty timeline"}
        self._job_seq += 1
        jid = self._job_seq
        job = {"state": "running", "done": 0,
               "total": int(mt.n_frames), "kind": "mt_render"}
        self.jobs[jid] = job

        def _progress(done):
            job["done"] = min(done, job["total"])

        def _run():
            try:
                self.osc.render_progress = _progress
                cid = self.call("/mt/render",
                                [1 if req.get("audio", True) else 0])
                job["done"] = job["total"]
                job["clip"] = cid
                job["state"] = "done"
            except Exception as ex:    # surfaced in the dialog
                job["state"] = "error"
                job["error"] = str(ex)
            finally:
                self.osc.render_progress = None

        threading.Thread(target=_run, daemon=True,
                         name="mt-render-job").start()
        return {"ok": True, "job": jid}

    def call(self, path: str, args: list):
        """Route through the OSC method table, with the player's device
        current as the server's dispatch has it."""
        fn = self.osc.methods.get(path)
        if fn is None:
            raise KeyError(f"unknown method {path}")
        with self.osc._device_ctx():
            return fn(*args)

    def state(self) -> dict[str, Any]:
        p = self.player
        st = p.state
        stats = p.stats()
        clip = st.fg_clip
        keys = []
        for k in range(self.keys_shown):
            keys.append({"key": k + 1,
                         "filter": p.keymap.current_filter(k),
                         "active": bool(p.keymap.active[k]),
                         "mode": p.keymap.mode[k] + 1})
        clips = [{"id": cid,
                  "name": getattr(c, "name", f"clip {cid}"),
                  "fg": c is st.fg_clip, "bg": c is st.bg_clip,
                  "fps": getattr(c, "fps", 0) or 0,
                  "frames": min(getattr(c, "frames", 0), 1 << 24),
                  "w": getattr(c, "width", 0),
                  "h": getattr(c, "height", 0)}
                 for cid, c in sorted(self.osc.clips.items())]
        return {"playing": st.playing, "frame": st.frame,
                "frames": getattr(clip, "frames", 0),
                "fps": st.pb_fps, "time": st.frame / abs(st.pb_fps or 25.0),
                "shown": stats["frames_shown"],
                "dropped": stats["frames_dropped"],
                "inst_fps": stats["inst_fps"], "p99_ms": stats["p99_ms"],
                "keys": keys, "clips": clips,
                "blend": st.blend_amount,
                "recording": bool(p.record),
                "has_take": p.last_recording is not None,
                # clip-editor bar state (main window widgets: selection
                # spins, loop/pingpong/mute toggles, volume — the
                # reference's start/end spinbuttons + playcontrol row)
                "sel_start": st.sel_start, "sel_end": st.sel_end,
                "loop": bool(st.loop), "pingpong": bool(st.ping_pong),
                "muted": bool(getattr(getattr(p, "audio", None), "muted",
                                      False)),
                "volume": float(getattr(getattr(p, "audio", None),
                                        "volume", 1.0)),
                "has_clipboard": self.osc.clipboard is not None}

    def audio_wave(self, track: int, width: int = 600):
        """Per-column min/max peaks of a backing audio track across the
        timeline — the reference's waveform strips in the multitrack
        audio rows (audio.c get_audio_peaks / ce_thumbs audio drawing).
        Columns outside any block stay zero."""
        mt = getattr(self.osc, "multitrack", None)
        if mt is None or mt.n_frames <= 0:
            return None
        total = mt.n_frames
        fps = mt.el.fps or 25.0
        mins = np.zeros(width, np.float32)
        maxs = np.zeros(width, np.float32)
        try:
            blocks = mt.audio_blocks(track)
        except Exception:
            return None
        cache = getattr(self, "_wave_cache", None)
        if cache is None:
            cache = self._wave_cache = {}
        for b in blocks:
            clip = self.osc.clips.get(int(b.clip))
            if clip is None or not getattr(clip, "achans", 0):
                continue
            arate = getattr(clip, "arate", 44100) or 44100
            vel = abs(getattr(b, "vel", 1.0)) or 1.0
            ckey = (int(b.clip), getattr(clip, "version", 0),
                    b.start, b.length, round(b.seek, 4), round(vel, 4),
                    total, width)
            hit = cache.get(ckey)
            if hit is None:
                try:
                    au = clip.read_audio()
                except Exception:
                    continue
                if au.shape[0] == 0:
                    continue
                mono = au.mean(axis=1)
                c0 = max(0, int(b.start / total * width))
                c1 = min(width, max(c0 + 1, int(b.end / total * width)))
                # vectorised per-column peaks: column edges -> sample
                # offsets -> reduceat (the single host core cannot
                # afford a Python loop per pixel column)
                cols = np.arange(c0, c1 + 1, dtype=np.float64)
                tl_f = cols / width * total
                samp = ((b.seek + np.maximum(0.0, tl_f - b.start)
                         / fps * vel) * arate).astype(np.int64)
                samp = np.clip(samp, 0, max(len(mono) - 1, 0))
                starts = samp[:-1]
                valid = samp[1:] > starts
                if not valid.any() or len(mono) == 0:
                    hit = (c0, np.zeros(c1 - c0, np.float32),
                           np.zeros(c1 - c0, np.float32))
                else:
                    # reduceat over ALL edges, drop the trailing
                    # edge->end segment (reduceat's last result spans to
                    # the end of the array, not to the column boundary)
                    bmin = np.minimum.reduceat(mono, samp)[:-1]
                    bmax = np.maximum.reduceat(mono, samp)[:-1]
                    bmin = np.where(valid, bmin, 0.0)
                    bmax = np.where(valid, bmax, 0.0)
                    hit = (c0, bmin.astype(np.float32),
                           bmax.astype(np.float32))
                if len(cache) > 256:
                    cache.clear()
                cache[ckey] = hit
            c0, bmin, bmax = hit
            c1 = c0 + len(bmin)
            mins[c0:c1] = np.minimum(mins[c0:c1], bmin)
            maxs[c0:c1] = np.maximum(maxs[c0:c1], bmax)
        return {"track": track, "width": width, "frames": total,
                "mins": [round(float(v), 3) for v in mins],
                "maxs": [round(float(v), 3) for v in maxs]}

    def timeline(self) -> dict[str, Any]:
        """Multitrack readout: per-track block views, backing audio
        tracks, effect regions + keyframes, per-track volumes, modes
        (multitrack.c's timeline, as data for the editing surface)."""
        mt = getattr(self.osc, "multitrack", None)
        if mt is None:
            return {"frames": 0, "tracks": []}
        total = mt.n_frames
        tracks = []
        for t in range(mt.n_tracks):
            blocks = [{"start": b.start, "end": b.end, "clip": int(b.clip)}
                      for b in mt.blocks(t)]
            tracks.append({"track": t, "blocks": blocks,
                           "volume": mt.track_volume(t)})
        atracks = []
        for k in range(mt.n_audio_tracks):
            t = -(k + 1)
            blocks = [{"start": b.start, "end": b.end, "clip": int(b.clip)}
                      for b in mt.audio_blocks(t)]
            atracks.append({"track": t, "blocks": blocks,
                            "volume": mt.track_volume(t)})
        from .events.event_list import EventType
        effects = []
        for d in mt.effects():
            kfs: dict[str, list] = {}
            for e in mt.el.events:
                if e.type == EventType.PARAM_CHANGE \
                        and e.props.get("init_event") == d["id"]:
                    kfs.setdefault(e.props["param"], []).append(
                        mt.tc_frame(e.tc))
            effects.append({**d, "keyframes": kfs})
        return {"frames": total, "fps": mt.el.fps, "tracks": tracks,
                "atracks": atracks, "effects": effects,
                "gravity": int(mt.gravity),
                "insert_mode": int(mt.insert_mode),
                "selection": {"tracks": mt.sel_tracks,
                              "start": mt.sel_start,
                              "end": mt.sel_end}}

    def param_spec(self, key: int) -> dict[str, Any]:
        """paramwindow spec + live values for an effect key's filter."""
        from .paramui import param_window_spec
        name = self.player.keymap.current_filter(key - 1)
        if not name:
            return {}
        from .effects.host import get_filter
        spec = param_window_spec(name)
        filt = get_filter(name)
        pidx = {q.name: i for i, q in enumerate(filt.params)}
        inst = self.player.keymap.instances[key - 1]
        for pw in spec.get("widgets", []):
            if pw.get("maps_to"):
                # collapsed colour triplet: expose the three underlying
                # param indices so the colour picker writes each via
                # /effect_key/parameter/value/set
                pw["index"] = -1
                pw["indices"] = [pidx.get(n, -1) for n in pw["maps_to"]]
                dflt = pw.get("default") or [0.0, 0.0, 0.0]
                vals = []
                for n, dv in zip(pw["maps_to"], dflt):
                    v = inst.values.get(n) if inst is not None else None
                    vals.append(dv if v is None else v)
                pw["value"] = vals
                continue
            # underlying filter-param index: the wire unit of
            # /effect_key/parameter/value/set
            pw["index"] = pidx.get(pw["name"], -1)
            v = None
            if inst is not None:
                v = inst.values.get(pw["name"])
            if v is None:
                v = pw.get("default")
            pw["value"] = v
        return spec

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)
