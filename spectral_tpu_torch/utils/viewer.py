"""Live progressive-render viewer: the port's copy of the reference
package's ``spectral_tpu.utils.viewer``, with only its imports changed,
so that every endpoint answers as the reference's does, byte for byte
(``tests/test_torch_viewer.py``). ``cli.py render --serve`` drives it.

Headless re-design of the reference's Display tab (reference
``src/main.rs:2573-2611``): the tab shows each progressive frame as it
lands, a progress bar + timing labels, and an Abort button
(``src/main.rs:1238-1247``). Here that is a tiny in-process HTTP server:

* ``GET /``          — auto-refreshing page with the latest frame,
                       progress, an Abort button, and a scene editor
* ``GET /frame.png`` — latest frame as PNG
* ``GET /status``    — progress JSON
* ``POST /abort``    — request frame-granular abort (same semantics as
                       Ctrl-C: the current frame is finished first)
* ``GET /scene``     — the scene as editable JSON (the headless analog of
                       the reference's Objects / Spectra-and-Materials
                       tabs, reference ``src/main.rs:2392-2572``)
* ``POST /scene``    — submit an edited scene JSON; it is validated
                       immediately (HTTP 400 on a legality error — the
                       reference's blinking-red dispatch refusal,
                       ``src/main.rs:1452-1484``) and applied at the next
                       frame boundary: the render restarts progressive
                       accumulation with the new scene, exactly like
                       pressing Start after editing in the reference UI
* ``GET /spectra``   — per-spectrum editor state: wavelengths, sample
                       values, editability, preview colors and radiance
                       (the reference's Spectra right panel,
                       ``src/main.rs:894-1064``)
* ``POST /spectrum/preview`` — live preview: candidate sample values in,
                       observed/normalized/reflected colors out, WITHOUT
                       touching the render (the reference recomputes its
                       color squares every frame while sliders move)
* ``POST /spectrum`` — apply edited samples to one Custom spectrum
                       (validated like ``SceneSpectrum.edit``; restarts
                       accumulation at the next frame boundary — the
                       reference's Save button, ``src/main.rs:902``)
* ``GET /objects``   — per-object editor state: every object, light and
                       material with its editable fields (the
                       reference's Objects tab forms,
                       ``src/main.rs:101-1259``)
* ``POST /object``   — per-object edit: ``{kind, index, action,
                       fields}`` with action ``update`` / ``copy`` /
                       ``delete`` / ``toggle_hidden`` — the reference's
                       per-object widgets and copy/hide/delete context
                       menu (deferred via ``AfterUIActions``,
                       ``src/main.rs:2619-2666``; here the edit is
                       validated immediately and applied at the next
                       frame boundary like every other edit)

The render thread pushes frames via :meth:`LiveViewer.update` and polls
:meth:`LiveViewer.take_scene_edit` between frames; the server thread only
ever serves cached bytes / queues validated edits, so no device state
crosses threads.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html>
<html><head><title>spectral_tpu live render</title>
<style>
 body { background: #111; color: #ddd; font: 14px monospace; margin: 2em; }
 img { image-rendering: pixelated; border: 1px solid #444; max-width: 95vw; }
 button { background: #922; color: #fff; border: 0; padding: .5em 1.2em;
          font: inherit; cursor: pointer; }
 #bar { background: #333; height: 8px; width: 480px; margin: .6em 0; }
 #fill { background: #2a7; height: 8px; width: 0; }
</style></head><body>
<h3>spectral_tpu &mdash; progressive render</h3>
<div id="status">waiting for first frame&hellip;</div>
<div id="bar"><div id="fill"></div></div>
<p><img id="frame" src="/frame.png" alt="(no frame yet)"></p>
<button onclick="fetch('/abort', {method: 'POST'})">Abort
 (finishes current frame)</button>
<details style="margin-top:1.5em"><summary>Edit scene (restarts render)</summary>
 <p><textarea id="scene" rows="24" cols="100"
  style="background:#181818;color:#cdc;border:1px solid #444;font:12px monospace"
  ></textarea></p>
 <button style="background:#272" onclick="applyScene()">Apply scene</button>
 <button style="background:#444" onclick="loadScene()">Reload from server</button>
 <span id="editmsg"></span>
</details>
<details style="margin-top:1em"><summary>Spectrum editor (live previews)</summary>
 <p>
  <select id="spsel" onchange="pickSpectrum()"
   style="background:#181818;color:#cdc;border:1px solid #444;font:inherit">
  </select>
  <span id="spkind"></span>
 </p>
 <div style="display:flex;gap:1em;margin:.5em 0">
  <div><div id="sw_observed" class="swatch"></div>observed</div>
  <div><div id="sw_normalized" class="swatch"></div>normalized</div>
  <div id="reflbox" style="display:none">
   <div id="sw_reflected" class="swatch"></div>reflected</div>
 </div>
 <div id="spradiance"></div>
 <div id="sliders" style="max-height:40vh;overflow-y:auto;margin:.6em 0">
 </div>
 <button style="background:#272" onclick="applySpectrum()"
  id="spapply">Save spectrum (restarts render)</button>
 <span id="spmsg"></span>
</details>
<details style="margin-top:1em"><summary>Objects, lights &amp; materials
 (per-item editor)</summary>
 <div id="objpanel"></div>
 <span id="objmsg"></span>
</details>
<style>
 .swatch { width: 90px; height: 40px; border: 1px solid #888;
           text-align: center; line-height: 40px; }
 .srow { display: flex; gap: .6em; align-items: center; }
 .srow input[type=range] { width: 300px; }
 .orow { margin: .25em 0; padding: .2em; border-bottom: 1px solid #2a2a2a; }
 .orow.hid { opacity: .45; }
 .orow button { padding: .15em .5em; }
</style>
<script>
 async function tick() {
   try {
     const s = await (await fetch('/status')).json();
     const spf = s.frame > 0 ? s.elapsed_s / s.frame : 0;
     const eta = s.frame > 0 ? spf * (s.total - s.frame) : 0;
     document.getElementById('status').textContent =
       `frame ${s.frame}/${s.total}  elapsed ${s.elapsed_s.toFixed(1)}s` +
       (s.frame > 0
         ? `  (${(spf * 1000).toFixed(1)} ms/frame, ETA ${eta.toFixed(0)}s)`
         : '') +
       (s.aborting ? '  [abort requested]' : '');
     document.getElementById('fill').style.width =
       (100 * s.frame / Math.max(1, s.total)) + '%';
     document.getElementById('frame').src = '/frame.png?t=' + Date.now();
   } catch (e) {}
 }
 async function loadScene() {
   const r = await fetch('/scene');
   document.getElementById('scene').value =
     JSON.stringify(await r.json(), null, 1);
 }
 async function applyScene() {
   const r = await fetch('/scene', {
     method: 'POST', body: document.getElementById('scene').value});
   document.getElementById('editmsg').textContent = await r.text();
 }
 let SPECTRA = [], SPI = 0, previewTimer = null;
 function hex(c) {
   const b = v => Math.max(0, Math.min(255,
     Math.round(Math.max(0, Math.min(1, v)) * 255)));
   return '#' + [b(c[0]), b(c[1]), b(c[2])].map(
     v => v.toString(16).padStart(2, '0')).join('');
 }
 function paint(p) {
   for (const k of ['observed', 'normalized', 'reflected']) {
     const el = document.getElementById('sw_' + k);
     if (p[k]) { el.style.background = hex(p[k]);
                 el.textContent = hex(p[k]); }
   }
   document.getElementById('reflbox').style.display =
     p.reflected ? 'block' : 'none';
 }
 async function loadSpectra() {
   SPECTRA = await (await fetch('/spectra')).json();
   const sel = document.getElementById('spsel');
   sel.innerHTML = SPECTRA.map((s, i) =>
     `<option value="${i}">${s.name} (${s.kind}, ${s.effect})</option>`
   ).join('');
   sel.value = SPI = Math.min(SPI, SPECTRA.length - 1);
   pickSpectrum();
 }
 function pickSpectrum() {
   SPI = +document.getElementById('spsel').value;
   const s = SPECTRA[SPI];
   document.getElementById('spkind').textContent = s.editable ? ''
     : '(generated type: sliders read-only, like upstream)';
   document.getElementById('spapply').disabled = !s.editable;
   document.getElementById('spradiance').textContent =
     `radiance ${s.radiance.toFixed(4)} W/sr/m^2`;
   document.getElementById('sliders').innerHTML = s.wavelengths.map(
     (w, i) => `<div class="srow"><span>${w.toFixed(2)}nm</span>
      <input type="range" min="0" max="${s.slider_max}" step="0.001"
       value="${s.values[i]}" ${s.editable ? '' : 'disabled'}
       oninput="slid(${i}, this.value)">
      <span id="sv${i}">${s.values[i].toFixed(3)}</span></div>`
   ).join('');
   paint(s.previews);
 }
 function slid(i, v) {
   SPECTRA[SPI].values[i] = +v;
   document.getElementById('sv' + i).textContent = (+v).toFixed(3);
   clearTimeout(previewTimer);
   previewTimer = setTimeout(livePreview, 150);
 }
 async function livePreview() {
   const r = await fetch('/spectrum/preview', {method: 'POST',
     body: JSON.stringify({index: SPI, values: SPECTRA[SPI].values})});
   if (r.ok) {
     const p = await r.json();
     paint(p.previews);
     document.getElementById('spradiance').textContent =
       `radiance ${p.radiance.toFixed(4)} W/sr/m^2`;
   }
 }
 async function applySpectrum() {
   const r = await fetch('/spectrum', {method: 'POST',
     body: JSON.stringify({index: SPI, values: SPECTRA[SPI].values})});
   document.getElementById('spmsg').textContent = await r.text();
 }
 let OBJ = null;
 const inp = (id, v, w) => `<input id="${id}" value="${v}" ` +
   `style="background:#181818;color:#cdc;border:1px solid #444;` +
   `font:inherit;width:${w || 56}px">`;
 const selopt = (id, names, cur) => `<select id="${id}" ` +
   `style="background:#181818;color:#cdc;border:1px solid #444;` +
   `font:inherit">` + names.map(n =>
     `<option ${n === cur ? 'selected' : ''}>${n}</option>`).join('') +
   '</select>';
 function objRow(o) {
   const p = `o${o.index}`;
   const params = o.editable_params.map(k =>
     `${k} ${inp(p + '_' + k, o.params[k])}`).join(' ');
   const ro = Object.keys(o.params).filter(
     k => !o.editable_params.includes(k)).map(
     k => `${k}=${o.params[k]}`).join(' ');
   return `<div class="orow${o.hidden ? ' hid' : ''}">
    <b>#${o.index}</b> ${inp(p + '_name', o.name, 110)}
    <i>${o.kind}</i> ${ro}
    pos ${inp(p + '_x', o.position[0])}${inp(p + '_y', o.position[1])}` +
    `${inp(p + '_z', o.position[2])} ${params}
    mat ${selopt(p + '_mat', OBJ.material_names, o.material)}
    <button style="background:#272"
     onclick="objApply('object',${o.index})">Apply</button>
    <button style="background:#555"
     onclick="objAct('object',${o.index},'copy')">Copy</button>
    <button style="background:#555"
     onclick="objAct('object',${o.index},'toggle_hidden')">` +
    `${o.hidden ? 'Show' : 'Hide'}</button>
    <button onclick="objAct('object',${o.index},'delete')">Del</button>
   </div>`;
 }
 function lightRow(l) {
   const p = `l${l.index}`;
   return `<div class="orow${l.hidden ? ' hid' : ''}">
    <b>#${l.index}</b> ${inp(p + '_name', l.name, 110)}
    pos ${inp(p + '_x', l.position[0])}${inp(p + '_y', l.position[1])}` +
    `${inp(p + '_z', l.position[2])}
    spectrum ${selopt(p + '_sp', OBJ.spectrum_names, l.spectrum)}
    <button style="background:#272"
     onclick="objApply('light',${l.index})">Apply</button>
    <button style="background:#555"
     onclick="objAct('light',${l.index},'copy')">Copy</button>
    <button style="background:#555"
     onclick="objAct('light',${l.index},'toggle_hidden')">` +
    `${l.hidden ? 'Show' : 'Hide'}</button>
    <button onclick="objAct('light',${l.index},'delete')">Del</button>
   </div>`;
 }
 function matRow(m) {
   const p = `m${m.index}`;
   const f = ['metallicness', 'roughness', 'transmission', 'ior',
              'cauchy_b_um2'].map(k =>
     `${k} ${inp(p + '_' + k, m[k])}`).join(' ');
   return `<div class="orow">
    <b>#${m.index}</b> ${inp(p + '_name', m.name, 110)} ${f}
    spectrum ${selopt(p + '_sp', OBJ.spectrum_names, m.spectrum)}
    ${m.emission ? 'emission=' + m.emission : ''}
    <button style="background:#272"
     onclick="objApply('material',${m.index})">Apply</button>
    <button style="background:#555"
     onclick="objAct('material',${m.index},'copy')">Copy</button>
   </div>`;
 }
 async function loadObjects() {
   OBJ = await (await fetch('/objects')).json();
   document.getElementById('objpanel').innerHTML =
     '<h4>Objects</h4>' + OBJ.objects.map(objRow).join('') +
     '<h4>Lights</h4>' + OBJ.lights.map(lightRow).join('') +
     '<h4>Materials</h4>' + OBJ.materials.map(matRow).join('');
 }
 const val = id => document.getElementById(id).value;
 async function objPost(body) {
   const r = await fetch('/object', {method: 'POST',
     body: JSON.stringify(body)});
   document.getElementById('objmsg').textContent = await r.text();
   if (r.ok) { loadObjects(); loadScene(); }
 }
 function objAct(kind, index, action) {
   objPost({kind: kind, index: index, action: action});
 }
 function objApply(kind, index) {
   const fields = {};
   if (kind === 'object') {
     const o = OBJ.objects[index], p = `o${index}`;
     fields.name = val(p + '_name');
     fields.position = [+val(p + '_x'), +val(p + '_y'), +val(p + '_z')];
     fields.material = val(p + '_mat');
     fields.params = {};
     for (const k of o.editable_params)
       fields.params[k] = +val(p + '_' + k);
   } else if (kind === 'light') {
     const p = `l${index}`;
     fields.name = val(p + '_name');
     fields.position = [+val(p + '_x'), +val(p + '_y'), +val(p + '_z')];
     fields.spectrum = val(p + '_sp');
   } else {
     const p = `m${index}`;
     fields.name = val(p + '_name');
     fields.spectrum = val(p + '_sp');
     for (const k of ['metallicness', 'roughness', 'transmission',
                      'ior', 'cauchy_b_um2'])
       fields[k] = +val(p + '_' + k);
   }
   objPost({kind: kind, index: index, action: 'update', fields: fields});
 }
 setInterval(tick, 1000); tick(); loadScene(); loadSpectra(); loadObjects();
</script></body></html>"""


class LiveViewer:
    """Serves the latest progressive frame over HTTP; thread-safe."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._png: bytes | None = None
        self._status: dict = {"frame": 0, "total": 0, "elapsed_s": 0.0}
        self._abort = threading.Event()
        self._scene_dict: dict | None = None  # currently rendering scene
        self._pending_scene = None  # validated edit awaiting frame boundary
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    if png is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif path == "/status":
                    with viewer._lock:
                        body = dict(viewer._status)
                    body["aborting"] = viewer._abort.is_set()
                    self._send(200, "application/json",
                               json.dumps(body).encode())
                elif path == "/scene":
                    with viewer._lock:
                        scene = viewer._scene_dict
                    if scene is None:
                        self._send(404, "text/plain", b"no scene published")
                    else:
                        self._send(200, "application/json",
                                   json.dumps(scene).encode())
                elif path == "/spectra":
                    try:
                        body = viewer._spectra_state()
                    except Exception as e:
                        self._send(404, "text/plain", str(e).encode())
                        return
                    self._send(200, "application/json",
                               json.dumps(body).encode())
                elif path == "/objects":
                    try:
                        body = viewer._objects_state()
                    except Exception as e:
                        self._send(404, "text/plain", str(e).encode())
                        return
                    self._send(200, "application/json",
                               json.dumps(body).encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path == "/abort":
                    viewer._abort.set()
                    self._send(200, "text/plain", b"abort requested")
                elif self.path == "/scene":
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length)
                    try:
                        scene = viewer._validate_scene_json(raw)
                    except Exception as e:  # legality / parse errors -> 400
                        self._send(400, "text/plain",
                                   f"scene rejected: {e}".encode())
                        return
                    with viewer._lock:
                        viewer._pending_scene = scene
                    self._send(
                        200, "text/plain",
                        b"scene accepted; the render restarts with it at "
                        b"the next frame boundary",
                    )
                elif self.path == "/spectrum/preview":
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length)
                    try:
                        body = viewer._spectrum_preview(json.loads(raw))
                    except Exception as e:
                        self._send(400, "text/plain",
                                   f"preview rejected: {e}".encode())
                        return
                    self._send(200, "application/json",
                               json.dumps(body).encode())
                elif self.path == "/spectrum":
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length)
                    try:
                        viewer._apply_spectrum_edit(json.loads(raw))
                    except Exception as e:  # bounds / legality -> 400
                        self._send(400, "text/plain",
                                   f"spectrum rejected: {e}".encode())
                        return
                    self._send(
                        200, "text/plain",
                        b"spectrum saved; the render restarts with it at "
                        b"the next frame boundary",
                    )
                elif self.path == "/object":
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length)
                    try:
                        msg = viewer._apply_object_edit(json.loads(raw))
                    except Exception as e:  # legality / bounds -> 400
                        self._send(400, "text/plain",
                                   f"edit rejected: {e}".encode())
                        return
                    self._send(200, "text/plain", msg.encode())
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/"

    def abort_requested(self) -> bool:
        return self._abort.is_set()

    @staticmethod
    def _validate_scene_json(raw: bytes):
        """Parse + legality-check an edited scene (raises on any error —
        the reference refuses dispatch on an illegal scene,
        src/main.rs:1452-1484)."""
        from spectral_tpu_torch.utils import sceneio

        scene = sceneio.scene_from_dict(json.loads(raw.decode()))
        scene.update_all_spectrum_sample_sizes()
        scene.validate()
        return scene

    def publish_scene(self, scene) -> None:
        """Expose the scene currently being rendered on ``GET /scene``."""
        from spectral_tpu_torch.utils import sceneio

        d = sceneio.scene_to_dict(scene)
        with self._lock:
            self._scene_dict = d

    def _current_scene(self):
        from spectral_tpu_torch.utils import sceneio

        with self._lock:
            d = self._scene_dict
        if d is None:
            raise LookupError("no scene published")
        return sceneio.scene_from_dict(d)

    def _spectra_state(self) -> list:
        """Per-spectrum editor state (the reference's Spectra right panel,
        src/main.rs:894-1064): wavelengths + values for the sliders,
        editability (Custom only), the reference's slider bound (2x the
        max for emissive, 1.0 for reflective), preview colors, radiance."""
        from spectral_tpu_torch.scene.schema import Custom, SpectrumEffectType

        scene = self._current_scene()
        out = []
        for sp in scene.spectra:
            s = sp.spectrum
            n = s.nbr_of_samples
            vals = [float(v) for v in s.intensities[:n]]
            emissive = sp.effect_type == SpectrumEffectType.EMISSIVE
            out.append({
                "name": sp.name,
                "kind": type(sp.spectrum_type).__name__,
                "effect": sp.effect_type.value,
                "editable": isinstance(sp.spectrum_type, Custom),
                "wavelengths": [float(w) for w in s.get_wavelengths()],
                "values": vals,
                "slider_max": (
                    max(max(vals) * 2.0, 0.01) if emissive else 1.0
                ),
                "previews": {
                    k: [float(c) for c in rgb]
                    for k, rgb in sp.preview_colors().items()
                },
                "radiance": float(s.get_radiance()),
            })
        return out

    def _spectrum_preview(self, body: dict) -> dict:
        """Live preview for candidate sample values — computed on a scratch
        copy, never touching the published scene or the render."""
        import numpy as np

        from spectral_tpu_torch.scene.schema import SceneSpectrum
        from spectral_tpu_torch.spectral.spectrum import Spectrum

        scene = self._current_scene()
        sp = scene.spectra[int(body["index"])]
        vals = np.asarray(body["values"], dtype=np.float32)
        s = sp.spectrum
        if vals.shape != (s.nbr_of_samples,):
            raise ValueError(
                f"expected {s.nbr_of_samples} samples, got {vals.shape}"
            )
        if not np.isfinite(vals).all() or (vals < 0.0).any():
            raise ValueError("samples must be finite and non-negative")
        scratch = SceneSpectrum(
            sp.name, sp.spectrum_type, sp.effect_type,
            Spectrum.new_from_list(
                vals, s.lowest_wavelength, s.highest_wavelength,
                s.nbr_of_samples,
            ),
        )
        return {
            "previews": {
                k: [float(c) for c in rgb]
                for k, rgb in scratch.preview_colors().items()
            },
            "radiance": float(scratch.spectrum.get_radiance()),
        }

    def _apply_spectrum_edit(self, body: dict) -> None:
        """The reference's Save button (src/main.rs:902): validate the
        sample edit (``SceneSpectrum.edit`` bounds), re-validate the whole
        scene, queue it for the next frame boundary, and update the
        published JSON so the editor reflects the accepted state."""
        import numpy as np

        from spectral_tpu_torch.utils import sceneio

        scene = self._current_scene()
        scene.spectra[int(body["index"])].edit(
            np.asarray(body["values"], dtype=np.float32)
        )
        scene.validate()
        d = sceneio.scene_to_dict(scene)
        with self._lock:
            self._pending_scene = scene
            self._scene_dict = d

    def _objects_state(self) -> dict:
        """Per-object editor state (the reference's Objects tab forms,
        src/main.rs:101-1259): every object, light and material with the
        fields its dedicated widget edits, referenced spectra/materials
        by name."""
        import dataclasses

        from spectral_tpu_torch.scene.schema import Mesh

        scene = self._current_scene()
        objs = []
        for i, o in enumerate(scene.objects):
            t = o.object_type
            if isinstance(t, Mesh):
                params = {"n_vertices": len(t.vertices),
                          "n_faces": t.n_triangles}
                editable = []  # mesh geometry edits go through POST /scene
            else:
                params = dataclasses.asdict(t)
                editable = list(params)
            objs.append({
                "index": i, "name": o.name, "hidden": o.hidden,
                "position": [float(c) for c in o.position],
                "kind": type(t).__name__, "params": params,
                "editable_params": editable,
                "material": o.material.name,
            })
        lights = [{
            "index": i, "name": li.name, "hidden": li.hidden,
            "position": [float(c) for c in li.position],
            "spectrum": li.spectrum.name,
        } for i, li in enumerate(scene.lights)]
        mats = [{
            "index": i, "name": m.name,
            "metallicness": float(m.metallicness),
            "roughness": float(m.roughness),
            "transmission": float(m.transmission),
            "ior": float(m.ior),
            "cauchy_b_um2": float(m.cauchy_b_um2),
            "spectrum": m.spectrum.name,
            "emission": m.emission.name if m.emission else None,
        } for i, m in enumerate(scene.materials)]
        return {
            "objects": objs, "lights": lights, "materials": mats,
            "material_names": [m.name for m in scene.materials],
            "spectrum_names": [s.name for s in scene.spectra],
        }

    def _apply_object_edit(self, body: dict) -> str:
        """One per-object edit (the reference's per-object widgets and
        copy/hide/delete context menu, src/main.rs:101-1259 applied via
        AfterUIActions src/main.rs:2619-2666): mutate a scratch copy of
        the current scene, re-validate the whole scene (HTTP 400 on any
        legality error), then queue it for the next frame boundary and
        republish the accepted JSON."""
        import dataclasses

        from spectral_tpu_torch.utils import sceneio

        scene = self._current_scene()
        kind = body.get("kind", "object")
        action = body.get("action", "update")
        idx = int(body["index"])
        fields = body.get("fields", {})

        def _pos(v):
            x, y, z = (float(c) for c in v)
            return (x, y, z)

        if kind == "object":
            lst = scene.objects
        elif kind == "light":
            lst = scene.lights
        elif kind == "material":
            lst = scene.materials
        else:
            raise ValueError(f"unknown kind {kind!r}")
        if not 0 <= idx < len(lst):
            raise IndexError(f"{kind} index {idx} out of range")
        item = lst[idx]

        if action == "delete":
            if kind == "material":
                raise ValueError(
                    "materials cannot be deleted while objects may "
                    "reference them; edit the scene JSON instead"
                )
            del lst[idx]
            msg = f"{kind} {item.name!r} deleted"
        elif action == "copy":
            if kind == "material":
                dup = item.copy()
                dup.name = item.name + " copy"
            else:
                dup = dataclasses.replace(item, name=item.name + " copy")
            lst.append(dup)
            msg = f"{kind} {item.name!r} copied"
        elif action == "toggle_hidden":
            if kind == "material":
                raise ValueError("materials have no hidden flag")
            item.hidden = not item.hidden
            msg = f"{kind} {item.name!r} " + (
                "hidden" if item.hidden else "shown"
            )
        elif action == "update":
            if "name" in fields:
                item.name = str(fields["name"])
            if "position" in fields and kind != "material":
                item.position = _pos(fields["position"])
            if kind == "object":
                if "material" in fields:
                    by_name = {m.name: m for m in scene.materials}
                    if fields["material"] not in by_name:
                        raise ValueError(
                            f"unknown material {fields['material']!r}"
                        )
                    item.material = by_name[fields["material"]]
                if "params" in fields and fields["params"]:
                    item.object_type = dataclasses.replace(
                        item.object_type,
                        **{k: float(v)
                           for k, v in fields["params"].items()},
                    )
            elif kind == "light":
                if "spectrum" in fields:
                    by_name = {s.name: s for s in scene.spectra}
                    if fields["spectrum"] not in by_name:
                        raise ValueError(
                            f"unknown spectrum {fields['spectrum']!r}"
                        )
                    item.spectrum = by_name[fields["spectrum"]]
            else:  # material scalars
                for k in ("metallicness", "roughness", "transmission",
                          "ior", "cauchy_b_um2"):
                    if k in fields:
                        setattr(item, k, float(fields[k]))
                if "spectrum" in fields:
                    by_name = {s.name: s for s in scene.spectra}
                    if fields["spectrum"] not in by_name:
                        raise ValueError(
                            f"unknown spectrum {fields['spectrum']!r}"
                        )
                    item.spectrum = by_name[fields["spectrum"]]
            msg = f"{kind} {item.name!r} updated"
        else:
            raise ValueError(f"unknown action {action!r}")

        scene.validate()
        d = sceneio.scene_to_dict(scene)
        with self._lock:
            self._pending_scene = scene
            self._scene_dict = d
        return msg + "; the render restarts at the next frame boundary"

    def take_scene_edit(self):
        """Pop a pending validated scene edit (None if none). Called by
        the render loop at frame boundaries."""
        with self._lock:
            scene, self._pending_scene = self._pending_scene, None
        return scene

    def scene_edit_pending(self) -> bool:
        with self._lock:
            return self._pending_scene is not None

    def update(self, framebuffer, frame: int, total: int, elapsed_s: float):
        """Publish a new frame (called from the render thread)."""
        import io

        from PIL import Image

        from spectral_tpu_torch.render import image as image_mod

        u8 = image_mod.accum_to_u8(framebuffer)
        buf = io.BytesIO()
        Image.fromarray(u8, mode="RGBA").save(buf, format="PNG")
        with self._lock:
            self._png = buf.getvalue()
            self._status = {
                "frame": frame, "total": total, "elapsed_s": elapsed_s,
            }

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
