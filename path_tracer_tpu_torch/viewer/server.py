"""Interactive viewer + scene EDITOR: a progressive render over HTTP.

Port of path_tracer_tpu/viewer/server.py: the same page, routes,
documents and error envelope, over the port's `app.Session`. The
reference is an ImGui/GLFW editor window; headless, the front end is a
single-file web app served by the Python stdlib HTTP server:

  * the page polls /frame.png -- each poll advances the wavefront by one
    round (two after a restart) and returns the resolved image, so the
    render refines progressively like the reference's frame loop;
  * WASD/QE + arrow keys drive the camera fly-controls (-> /move, which
    restarts accumulation);
  * clicking the image mouse-picks the shape under the cursor (-> /pick)
    and selects the entity in the hierarchy panel;
  * a mode selector switches between the path-traced view and the
    false-color preview modes; tone-map and brightness controls mirror
    the render settings panel.

Editor surface (the reference's browsers + inspectors):

  * GET  /scene                  hierarchy + materials + assets
  * POST /entity/update          name / transform / material / camera
                                 (incl. camera model/aperture and
                                 render_camera)
  * POST /entity/create          {type, parent?, mesh?}
  * POST /entity/delete          {id}
  * POST /material/update        {index, field, value}
  * POST /material/create /material/clone /material/delete
  * POST /texture/import         {path} PNG/HDR
  * POST /texture/delete         {index}
  * POST /skybox/set             {index} (-1 clears)
  * POST /prefab/import          {path} OBJ+MTL
  * POST /prefab/instantiate     {index, parent?}
  * POST /mesh/delete            {index}
  * POST /scene/save /scene/open {path}; /scene/new
  * POST /move, /pick            camera fly-controls, mouse picking

Every mutation goes through the scene model's dirty flags, so the next
/frame.png triggers the incremental recompile + accumulation restart.

The HTTP server is single-threaded on purpose: requests serialize, so at
most one render runs on the card at a time. It binds to 127.0.0.1
unless the caller names another host.

Usage: python -m path_tracer_tpu_torch view scene.json [--port 8000]
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from ..utils.image import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>path_tracer_tpu_torch</title><style>
body { background:#14161a; color:#d8dce2; font:13px system-ui; margin:0;
       display:flex; height:100vh }
#side { width:300px; min-width:300px; overflow-y:auto; padding:8px;
        border-right:1px solid #2a2e35 }
#main { flex:1; display:flex; flex-direction:column }
#bar { padding:8px 12px; display:flex; gap:12px; align-items:center;
       flex-wrap:wrap }
#view { display:block; margin:0 auto; image-rendering:pixelated;
        outline:1px solid #2a2e35; max-width:100% }
select,input,button { background:#1e2127; color:#d8dce2;
        border:1px solid #2a2e35; border-radius:4px; padding:2px 6px }
input[type=number] { width:64px }
#status { margin-left:auto; opacity:.75 }
.ent { cursor:pointer; padding:1px 4px; border-radius:3px;
       white-space:nowrap; overflow:hidden }
.ent:hover { background:#1e2127 }
.ent.sel { background:#2d4a6b }
.insp { margin-top:8px; border-top:1px solid #2a2e35; padding-top:8px }
.row { display:flex; gap:4px; margin:2px 0; align-items:center }
.row label { width:110px; opacity:.8; overflow:hidden;
             white-space:nowrap; font-size:12px }
h4 { margin:8px 0 4px 0 }
</style></head><body>
<div id="side">
  <div class="row">
    <button id="newscene">New</button>
    <input id="scenepath" placeholder="scene.json" style="flex:1">
    <button id="open">Open</button><button id="save">Save</button>
  </div>
  <h4>Hierarchy</h4>
  <div class="row">
    <select id="createtype">
      <option value="container">container</option>
      <option value="camera">camera</option>
      <option value="plane">plane</option>
      <option value="sphere">sphere</option>
      <option value="cube">cube</option>
      <option value="mesh">mesh</option>
    </select>
    <select id="meshsel" style="max-width:80px"></select>
    <button id="create">+ entity</button>
    <button id="delete">delete</button>
  </div>
  <div id="tree"></div>
  <div id="inspector" class="insp"></div>
  <h4>Materials <button id="newmat">+</button>
      <select id="newmattype" style="font-size:11px">
        <option value="openpbr">openpbr</option>
        <option value="diffuse">diffuse</option>
        <option value="metal">metal</option>
        <option value="translucent">translucent</option>
      </select></h4>
  <div id="matlist"></div>
  <div id="matinspector" class="insp"></div>
  <h4>Textures</h4>
  <div class="row">
    <input id="teximport" placeholder="image.png / .hdr" style="flex:1">
    <button id="teximportbtn">import</button>
  </div>
  <div id="texlist"></div>
  <h4>Prefabs</h4>
  <div class="row">
    <input id="prefabimport" placeholder="model.obj" style="flex:1">
    <button id="prefabimportbtn">import</button>
  </div>
  <div id="prefablist"></div>
</div>
<div id="main">
<div id="bar">
  <b>path_tracer_tpu_torch</b>
  <label>mode <select id="mode">
    <option value="render">path traced</option>
    <option value="0">preview: base color</option>
    <option value="1">preview: shaded</option>
    <option value="2">preview: normal</option>
    <option value="3">preview: material id</option>
    <option value="4">preview: primitive id</option>
    <option value="5">preview: mesh complexity</option>
    <option value="6">preview: scene complexity</option>
  </select></label>
  <label>tonemap <select id="tonemap">
    <option value="0">clamp</option><option value="1">reinhard</option>
    <option value="2">hable</option><option value="3" selected>aces</option>
  </select></label>
  <label>brightness <input id="bright" type="range" min="-2" max="2"
    step="0.1" value="0"></label>
  <span id="picked"></span>
  <span id="status"></span>
</div>
<img id="view" width="WIDTH" height="HEIGHT">
</div>
<script>
const img = document.getElementById('view');
let inflight = false, gen = 0;
let sceneDoc = null, selEntity = -1, selMat = -1;

async function post(url, body) {
  const r = await fetch(url, {method:'POST', body:JSON.stringify(body)});
  return r.json();
}

async function tick() {
  if (inflight) return;
  inflight = true;
  const mode = document.getElementById('mode').value;
  const tm = document.getElementById('tonemap').value;
  const br = Math.pow(10, parseFloat(document.getElementById('bright').value));
  try {
    const sel = mode === 'render' ? -1 : selShape();
    const r = await fetch(`/frame.png?mode=${mode}&tonemap=${tm}&brightness=${br}&selected=${sel}&g=${gen++}`);
    const blob = await r.blob();
    const url = URL.createObjectURL(blob);
    img.onload = () => URL.revokeObjectURL(url);
    img.src = url;
    const s = await (await fetch('/status')).json();
    document.getElementById('status').textContent =
      `frame ${s.frame} | ${s.spp.toFixed(1)} spp`;
  } finally { inflight = false; }
}
setInterval(tick, 120);

function selShape() {
  if (!sceneDoc || selEntity < 0) return -1;
  const e = sceneDoc.entities.find(e => e.id === selEntity);
  return e ? e.shape : -1;
}

function numRow(label, vals, cb) {
  const row = document.createElement('div');
  row.className = 'row';
  const l = document.createElement('label');
  l.textContent = label;
  row.appendChild(l);
  vals.forEach((v, i) => {
    const inp = document.createElement('input');
    inp.type = 'number'; inp.step = 'any';
    inp.value = typeof v === 'number' ? +v.toFixed(4) : v;
    inp.onchange = () => cb(i, parseFloat(inp.value));
    row.appendChild(inp);
  });
  return row;
}

function colorRow(label, rgb, cb) {
  const row = document.createElement('div');
  row.className = 'row';
  const l = document.createElement('label');
  l.textContent = label;
  row.appendChild(l);
  const inp = document.createElement('input');
  inp.type = 'color';
  const hex = c => ('0' + Math.round(Math.pow(Math.min(Math.max(c,0),1),
      1/2.2)*255).toString(16)).slice(-2);
  inp.value = '#' + hex(rgb[0]) + hex(rgb[1]) + hex(rgb[2]);
  inp.onchange = () => {
    const v = inp.value;
    const c = s => Math.pow(parseInt(s, 16)/255, 2.2);
    cb([c(v.slice(1,3)), c(v.slice(3,5)), c(v.slice(5,7))]);
  };
  row.appendChild(inp);
  return row;
}

async function refreshScene() {
  sceneDoc = await (await fetch('/scene')).json();
  const tree = document.getElementById('tree');
  tree.innerHTML = '';
  for (const e of sceneDoc.entities) {
    const div = document.createElement('div');
    div.className = 'ent' + (e.id === selEntity ? ' sel' : '');
    div.style.paddingLeft = (4 + e.depth * 12) + 'px';
    div.textContent = `${e.name} (${e.type})`;
    div.onclick = () => { selEntity = e.id; renderInspector(); refreshScene(); };
    tree.appendChild(div);
  }
  const ml = document.getElementById('matlist');
  ml.innerHTML = '';
  sceneDoc.materials.forEach((m, i) => {
    const div = document.createElement('div');
    div.className = 'ent' + (i === selMat ? ' sel' : '');
    div.textContent = `${m.name} (${m.type})`;
    div.onclick = () => { selMat = i; renderMatInspector(); refreshScene(); };
    ml.appendChild(div);
  });
  const ms = document.getElementById('meshsel');
  ms.innerHTML = '';
  sceneDoc.meshes.forEach((name, i) => {
    const o = document.createElement('option');
    o.value = name; o.textContent = name;
    ms.appendChild(o);
  });
  const tl = document.getElementById('texlist');
  tl.innerHTML = '';
  sceneDoc.textures.forEach((name, i) => {
    const div = document.createElement('div');
    div.className = 'ent';
    div.textContent = name + (i === sceneDoc.skybox ? '  [skybox]' : '');
    const sky = document.createElement('button');
    sky.textContent = i === sceneDoc.skybox ? 'clear sky' : 'set sky';
    sky.style.marginLeft = '6px';
    sky.onclick = async ev => {
      ev.stopPropagation();
      await post('/skybox/set', {index: i === sceneDoc.skybox ? -1 : i});
      refreshScene();
    };
    div.appendChild(sky);
    tl.appendChild(div);
  });
  const pl = document.getElementById('prefablist');
  pl.innerHTML = '';
  sceneDoc.prefabs.forEach((name, i) => {
    const div = document.createElement('div');
    div.className = 'ent';
    div.textContent = name;
    const inst = document.createElement('button');
    inst.textContent = 'instantiate';
    inst.style.marginLeft = '6px';
    inst.onclick = async ev => {
      ev.stopPropagation();
      await post('/prefab/instantiate', {index: i});
      refreshScene();
    };
    div.appendChild(inst);
    pl.appendChild(div);
  });
  renderInspector();
  renderMatInspector();
}

function renderInspector() {
  const box = document.getElementById('inspector');
  box.innerHTML = '';
  if (!sceneDoc) return;
  const e = sceneDoc.entities.find(e => e.id === selEntity);
  if (!e) return;
  const title = document.createElement('h4');
  title.textContent = 'Entity: ' + e.name;
  box.appendChild(title);
  const upd = body => post('/entity/update', Object.assign({id: e.id}, body))
      .then(refreshScene);
  for (const f of ['position', 'rotation', 'scale']) {
    if (!e.transform[f]) continue;
    box.appendChild(numRow(f, e.transform[f], (i, v) => {
      e.transform[f][i] = v;
      upd({transform: {[f]: e.transform[f]}});
    }));
  }
  if (e.material !== null && e.material !== undefined) {
    const row = document.createElement('div');
    row.className = 'row';
    const l = document.createElement('label');
    l.textContent = 'material';
    row.appendChild(l);
    const sel = document.createElement('select');
    sceneDoc.materials.forEach((m, i) => {
      const o = document.createElement('option');
      o.value = i; o.textContent = m.name;
      if (i === e.material) o.selected = true;
      sel.appendChild(o);
    });
    sel.onchange = () => upd({material: parseInt(sel.value)});
    row.appendChild(sel);
    box.appendChild(row);
  }
  if (e.fov !== null && e.fov !== undefined)
    box.appendChild(numRow('fov', [e.fov], (i, v) => upd({fov: v})));
  if (e.camera) {
    const row = document.createElement('div');
    row.className = 'row';
    const l = document.createElement('label');
    l.textContent = 'projection';
    row.appendChild(l);
    const sel = document.createElement('select');
    ['pinhole', 'thin lens', '360'].forEach((name, i) => {
      const o = document.createElement('option');
      o.value = i; o.textContent = name;
      if (i === e.camera.model) o.selected = true;
      sel.appendChild(o);
    });
    sel.onchange = () => upd({camera_model: parseInt(sel.value)});
    row.appendChild(sel);
    box.appendChild(row);
    if (e.camera.model === 1) {
      box.appendChild(numRow('aperture mm', [e.camera.aperture_diameter_in_mm],
        (i, v) => upd({aperture_diameter_in_mm: v})));
      box.appendChild(numRow('focus dist', [e.camera.focus_distance],
        (i, v) => upd({focus_distance: v})));
    }
    const rc = document.createElement('button');
    rc.textContent = sceneDoc.render_camera === e.id
      ? 'rendering from this camera' : 'render using this camera';
    rc.disabled = sceneDoc.render_camera === e.id;
    rc.onclick = () => upd({render_camera: true});
    box.appendChild(rc);
  }
}

function renderMatInspector() {
  const box = document.getElementById('matinspector');
  box.innerHTML = '';
  if (!sceneDoc || selMat < 0 || selMat >= sceneDoc.materials.length) return;
  const m = sceneDoc.materials[selMat];
  const title = document.createElement('h4');
  title.textContent = 'Material: ' + m.name;
  box.appendChild(title);
  const bar = document.createElement('div');
  bar.className = 'row';
  const cl = document.createElement('button');
  cl.textContent = 'clone';
  cl.onclick = async () => {
    const r = await post('/material/clone', {index: selMat});
    selMat = r.index; refreshScene();
  };
  const del = document.createElement('button');
  del.textContent = 'delete';
  del.onclick = async () => {
    await post('/material/delete', {index: selMat});
    selMat = -1; refreshScene();
  };
  bar.appendChild(cl); bar.appendChild(del);
  box.appendChild(bar);
  const upd = (field, value) =>
    post('/material/update', {index: selMat, field, value})
      .then(refreshScene);
  for (const [field, spec] of Object.entries(m.params)) {
    if (spec.kind === 'color')
      box.appendChild(colorRow(field, spec.value, v => upd(field, v)));
    else if (spec.kind === 'float' || spec.kind === 'int')
      box.appendChild(numRow(field, [spec.value], (i, v) => upd(field, v)));
    else if (spec.kind === 'texture') {
      const row = document.createElement('div');
      row.className = 'row';
      const l = document.createElement('label');
      l.textContent = field;
      row.appendChild(l);
      const sel = document.createElement('select');
      const none = document.createElement('option');
      none.value = -1; none.textContent = '(none)';
      sel.appendChild(none);
      sceneDoc.textures.forEach((t, i) => {
        const o = document.createElement('option');
        o.value = i; o.textContent = t;
        if (i === spec.value) o.selected = true;
        sel.appendChild(o);
      });
      sel.onchange = () => upd(field, parseInt(sel.value));
      row.appendChild(sel);
      box.appendChild(row);
    }
  }
}

document.getElementById('create').onclick = async () => {
  const type = document.getElementById('createtype').value;
  const body = {type};
  if (type === 'mesh') {
    body.mesh = document.getElementById('meshsel').value;
    if (!body.mesh) return;
  }
  await post('/entity/create', body);
  refreshScene();
};
document.getElementById('teximportbtn').onclick = async () => {
  await post('/texture/import',
             {path: document.getElementById('teximport').value});
  refreshScene();
};
document.getElementById('prefabimportbtn').onclick = async () => {
  await post('/prefab/import',
             {path: document.getElementById('prefabimport').value});
  refreshScene();
};
document.getElementById('delete').onclick = async () => {
  if (selEntity >= 0) await post('/entity/delete', {id: selEntity});
  selEntity = -1;
  refreshScene();
};
document.getElementById('newmat').onclick = async () => {
  await post('/material/create',
             {type: document.getElementById('newmattype').value});
  refreshScene();
};
document.getElementById('save').onclick = () =>
  post('/scene/save', {path: document.getElementById('scenepath').value});
document.getElementById('open').onclick = async () => {
  await post('/scene/open', {path: document.getElementById('scenepath').value});
  selEntity = selMat = -1;
  refreshScene();
};
document.getElementById('newscene').onclick = async () => {
  await post('/scene/new', {});
  selEntity = selMat = -1;
  refreshScene();
};

const KEYS = {
  w:[0,0,-1], s:[0,0,1], a:[-1,0,0], d:[1,0,0], q:[0,-1,0], e:[0,1,0]};
const ROT = {ArrowLeft:[0,0,1], ArrowRight:[0,0,-1],
             ArrowUp:[-1,0,0], ArrowDown:[1,0,0]};
document.addEventListener('keydown', async ev => {
  if (ev.target.tagName === 'INPUT' || ev.target.tagName === 'SELECT') return;
  const step = ev.shiftKey ? 1.0 : 0.25;
  if (KEYS[ev.key]) {
    await fetch('/move', {method:'POST', body:JSON.stringify(
      {delta: KEYS[ev.key].map(v => v*step)})});
  } else if (ROT[ev.key]) {
    await fetch('/move', {method:'POST', body:JSON.stringify(
      {rotate: ROT[ev.key].map(v => v*0.1)})});
  }
});
img.addEventListener('click', async ev => {
  const r = img.getBoundingClientRect();
  const x = Math.floor((ev.clientX - r.left) * img.width / r.width);
  const y = Math.floor((ev.clientY - r.top) * img.height / r.height);
  const res = await (await fetch('/pick', {method:'POST',
    body:JSON.stringify({x, y})})).json();
  document.getElementById('picked').textContent =
    res.shape < 0 ? 'picked: (none)'
                  : `picked: ${res.name} [shape ${res.shape}]`;
  if (res.entity >= 0) { selEntity = res.entity; refreshScene(); }
});
refreshScene();
</script></body></html>
"""



def _item(seq, index, what):
    """Bounds-checked list access for editor requests: Python's silent
    negative-index wrap would make {"index": -1} edit the LAST item
    instead of erroring, so every endpoint indexes through this."""
    index = int(index)
    if not 0 <= index < len(seq):
        raise IndexError(f'{what} index {index} out of range '
                         f'(have {len(seq)})')
    return seq[index]

class ViewerServer:
    """Serve an interactive progressive render + editor of a Session."""

    def __init__(self, session, host='127.0.0.1', port=8000):
        self.session = session
        self.host = host
        self.port = port
        self._ids = {}      # id(entity) -> stable small int
        self._next_id = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype='application/json'):
                self.send_response(code)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                self.send_header('Cache-Control', 'no-store')
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition('?')
                params = dict(kv.split('=', 1) for kv in query.split('&')
                              if '=' in kv)
                if path == '/':
                    page = (_PAGE.replace('WIDTH', str(outer.session.width))
                                 .replace('HEIGHT', str(outer.session.height)))
                    self._send(200, page.encode(), 'text/html')
                elif path == '/frame.png':
                    self._send(200, outer.frame_png(params), 'image/png')
                elif path == '/status':
                    s = outer.session
                    self._send(200, json.dumps(dict(
                        frame=s.frame_index,
                        spp=s.samples_per_pixel())).encode())
                elif path == '/scene':
                    self._send(200, json.dumps(outer.scene_doc()).encode())
                else:
                    self._send(404, b'{}')

            def do_POST(self):
                # Body parsing sits INSIDE the error envelope: malformed
                # JSON (json.JSONDecodeError is a ValueError) must come
                # back as a clean 400, not a broken connection. TypeError
                # covers wrong-shaped values (e.g. a list where a number
                # belongs); the session stays renderable either way.
                try:
                    length = int(self.headers.get('Content-Length', 0))
                    body = json.loads(self.rfile.read(length) or b'{}')
                    if not isinstance(body, dict):
                        raise ValueError('request body must be a JSON object')
                    result = outer.handle_post(self.path, body)
                except (KeyError, ValueError, IndexError, OSError,
                        TypeError) as e:
                    self._send(400, json.dumps(dict(error=str(e))).encode())
                    return
                if result is None:
                    self._send(404, b'{}')
                else:
                    self._send(200, json.dumps(result).encode())

        self._server = HTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]

    # -- scene document ---------------------------------------------------

    def _eid(self, entity):
        key = id(entity)
        if key not in self._ids:
            self._ids[key] = self._next_id
            self._next_id += 1
        return self._ids[key]

    def _entity_by_id(self, eid):
        for entity in self.session.scene.walk_entities(include_inactive=True):
            if self._ids.get(id(entity)) == eid:
                return entity
        raise KeyError(f'no entity with id {eid}')

    def scene_doc(self):
        """Hierarchy + materials + assets as one JSON document (the
        reference's browser panels, imgui_main.cpp:414-763)."""
        from ..scene.model import ENTITY_TYPE_CAMERA
        from .preview import shape_entities

        scene = self.session.scene
        shape_of = {id(e): i for i, e in enumerate(shape_entities(scene))}
        mat_index = {id(m): i for i, m in enumerate(scene.materials)}
        entities = []

        def walk(entity, depth):
            tr = entity.transform
            entities.append(dict(
                id=self._eid(entity),
                name=entity.name,
                type=_TYPE_NAMES.get(entity.type, str(entity.type)),
                depth=depth,
                shape=shape_of.get(id(entity), -1),
                transform=dict(position=[float(v) for v in tr.position],
                               rotation=[float(v) for v in tr.rotation],
                               scale=[float(v) for v in tr.scale]),
                material=(mat_index.get(id(entity.material))
                          if getattr(entity, 'material', None) is not None
                          else None),
                fov=(float(entity.pinhole.field_of_view_in_degrees)
                     if entity.type == ENTITY_TYPE_CAMERA else None),
                camera=(dict(
                    model=int(entity.camera_model),
                    aperture_diameter_in_mm=float(
                        entity.thin_lens.aperture_diameter_in_mm),
                    focus_distance=float(entity.thin_lens.focus_distance),
                ) if entity.type == ENTITY_TYPE_CAMERA else None),
            ))
            for child in entity.children:
                walk(child, depth + 1)

        walk(scene.root, 0)
        cams = [e for e in scene.walk_entities()
                if e.type == ENTITY_TYPE_CAMERA]
        render_cam = (self._eid(cams[self.session.camera_index])
                      if self.session.camera_index < len(cams) else -1)
        sky = scene.root.skybox_texture
        tex_index = {id(t): i for i, t in enumerate(scene.textures)}
        return dict(
            entities=entities,
            materials=[self.material_doc(m) for m in scene.materials],
            textures=[t.name for t in scene.textures],
            meshes=[m.name for m in scene.meshes],
            prefabs=[(p.entity.name if p.entity is not None else 'Prefab')
                     for p in scene.prefabs],
            render_camera=render_cam,
            skybox=tex_index.get(id(sky), -1) if sky is not None else -1,
        )

    def material_doc(self, material):
        """Editable parameter schema of one material (the reference's
        per-material inspectors, e.g. openpbr.hpp:136-181)."""
        from ..scene.model import Material, Texture
        scene = self.session.scene
        tex_index = {id(t): i for i, t in enumerate(scene.textures)}
        params = {}
        for f in dataclasses.fields(material):
            if f.name in ('name', 'flags', 'packed_material_index'):
                continue
            value = getattr(material, f.name)
            if isinstance(value, np.ndarray) and value.shape == (3,):
                params[f.name] = dict(kind='color',
                                      value=[float(v) for v in value])
            elif isinstance(value, bool):
                continue
            elif isinstance(value, int):
                params[f.name] = dict(kind='int', value=value)
            elif isinstance(value, float):
                params[f.name] = dict(kind='float', value=value)
            elif value is None or isinstance(value, Texture):
                params[f.name] = dict(
                    kind='texture',
                    value=tex_index.get(id(value), -1) if value else -1)
        return dict(name=material.name,
                    type=type(material).__name__.replace('Material', ''),
                    params=params)

    # -- mutations --------------------------------------------------------

    def handle_post(self, path, body):
        from ..scene.model import (
            ENTITY_TYPE_CAMERA, ENTITY_TYPE_CONTAINER, ENTITY_TYPE_CUBE,
            ENTITY_TYPE_MESH_INSTANCE, ENTITY_TYPE_PLANE, ENTITY_TYPE_SPHERE,
            SCENE_DIRTY_CAMERAS, SCENE_DIRTY_MATERIALS, SCENE_DIRTY_SHAPES,
            BasicDiffuseMaterial, BasicMetalMaterial,
            BasicTranslucentMaterial, OpenPBRMaterial)

        scene = self.session.scene
        if path == '/move':
            self.session.move_camera(
                delta=body.get('delta', (0, 0, 0)),
                rotate=body.get('rotate', (0, 0, 0)))
            return {}
        if path == '/pick':
            shape = int(self.session.pick(int(body['x']), int(body['y'])))
            name, mat, eid = self.shape_info(shape)
            return dict(shape=shape, name=name, material=mat, entity=eid)
        if path == '/entity/update':
            entity = self._entity_by_id(int(body['id']))
            if 'name' in body:
                entity.name = str(body['name'])
            if 'transform' in body:
                tr = body['transform']
                for field in ('position', 'rotation', 'scale'):
                    if field in tr:
                        setattr(entity.transform, field,
                                np.asarray(tr[field], np.float32))
                scene.mark_dirty(SCENE_DIRTY_SHAPES | SCENE_DIRTY_CAMERAS)
            if 'material' in body:
                entity.material = _item(scene.materials, body['material'],
                                        'material')
                scene.mark_dirty(SCENE_DIRTY_SHAPES)
            if entity.type == ENTITY_TYPE_CAMERA:
                # Camera inspector (imgui_main.cpp:212-302): projection
                # model, per-model parameters, "render using this
                # camera".
                if 'fov' in body:
                    entity.pinhole.field_of_view_in_degrees = \
                        float(body['fov'])
                    scene.mark_dirty(SCENE_DIRTY_CAMERAS)
                if 'camera_model' in body:
                    entity.camera_model = int(body['camera_model'])
                    scene.mark_dirty(SCENE_DIRTY_CAMERAS)
                for field in ('aperture_diameter_in_mm',
                              'focus_distance'):
                    if field in body:
                        setattr(entity.thin_lens, field,
                                float(body[field]))
                        scene.mark_dirty(SCENE_DIRTY_CAMERAS)
                if body.get('render_camera'):
                    cams = [e for e in scene.walk_entities()
                            if e.type == ENTITY_TYPE_CAMERA]
                    self.session.camera_index = cams.index(entity)
                    scene.mark_dirty(SCENE_DIRTY_CAMERAS)
            return {}
        if path == '/entity/create':
            types = dict(container=ENTITY_TYPE_CONTAINER,
                         camera=ENTITY_TYPE_CAMERA,
                         plane=ENTITY_TYPE_PLANE,
                         sphere=ENTITY_TYPE_SPHERE,
                         cube=ENTITY_TYPE_CUBE,
                         mesh=ENTITY_TYPE_MESH_INSTANCE)
            parent = (self._entity_by_id(int(body['parent']))
                      if 'parent' in body else None)
            kwargs = {}
            if body['type'] == 'mesh':
                # A guarded lookup, not next() without default: an
                # unknown mesh name must surface as a clean 400 (the
                # bare StopIteration escapes the error envelope).
                matches = [m for m in scene.meshes
                           if m.name == body['mesh']]
                if not matches:
                    raise KeyError(f"no mesh named {body['mesh']!r}")
                kwargs['mesh'] = matches[0]
            entity = scene.create_entity(types[body['type']], parent=parent,
                                         **kwargs)
            entity.name = body.get('name', f"New {body['type']}")
            return dict(id=self._eid(entity))
        if path == '/entity/delete':
            scene.destroy_entity(self._entity_by_id(int(body['id'])))
            return {}
        if path == '/material/update':
            material = _item(scene.materials, body['index'], 'material')
            field = str(body['field'])
            if not any(f.name == field for f in dataclasses.fields(material)):
                raise KeyError(f'{type(material).__name__} has no '
                               f'field {field}')
            value = body['value']
            current = getattr(material, field)
            if isinstance(current, np.ndarray):
                value = np.asarray(value, np.float32)
            elif field.endswith('_texture') or current is None or \
                    hasattr(current, 'pixels'):
                value = (_item(scene.textures, value, 'texture')
                         if int(value) >= 0 else None)
            elif isinstance(current, int) and not isinstance(current, bool):
                value = int(value)
            else:
                value = float(value)
            setattr(material, field, value)
            scene.mark_dirty(SCENE_DIRTY_MATERIALS)
            return {}
        if path == '/material/create':
            ctor = dict(diffuse=BasicDiffuseMaterial,
                        metal=BasicMetalMaterial,
                        translucent=BasicTranslucentMaterial,
                        openpbr=OpenPBRMaterial)[body.get('type', 'openpbr')]
            material = ctor(name=body.get('name', 'New Material'))
            scene.materials.append(material)
            scene.mark_dirty(SCENE_DIRTY_MATERIALS)
            return dict(index=len(scene.materials) - 1)
        if path == '/material/clone':
            # The reference's material-browser Clone (imgui_main.cpp
            # :609-664): value copy, texture references shared.
            src = _item(scene.materials, body['index'], 'material')
            clone = dataclasses.replace(src, name=src.name + ' (copy)')
            for f in dataclasses.fields(clone):
                value = getattr(clone, f.name)
                if isinstance(value, np.ndarray):
                    setattr(clone, f.name, value.copy())
            scene.materials.append(clone)
            scene.mark_dirty(SCENE_DIRTY_MATERIALS)
            return dict(index=len(scene.materials) - 1)
        if path == '/material/delete':
            scene.destroy_material(
                _item(scene.materials, body['index'], 'material'))
            return {}
        if path == '/texture/import':
            from ..core.constants import (
                TEXTURE_TYPE_RADIANCE, TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA)
            from ..utils.image import load_hdr, load_png
            p = str(body['path'])
            if p.lower().endswith('.hdr'):
                pixels, ttype = load_hdr(p), TEXTURE_TYPE_RADIANCE
            else:
                pixels, ttype = load_png(p), TEXTURE_TYPE_REFLECTANCE_WITH_ALPHA
            texture = scene.create_texture(
                name=body.get('name', os.path.basename(p)),
                type=int(body.get('type', ttype)),
                pixels=np.asarray(pixels, np.float32))
            return dict(index=scene.textures.index(texture))
        if path == '/texture/delete':
            scene.destroy_texture(
                _item(scene.textures, body['index'], 'texture'))
            return {}
        if path == '/skybox/set':
            from ..scene.model import SCENE_DIRTY_SKYBOX_TEXTURE
            index = int(body['index'])
            scene.root.skybox_texture = (
                _item(scene.textures, index, 'texture')
                if index >= 0 else None)
            scene.mark_dirty(SCENE_DIRTY_SKYBOX_TEXTURE)
            return {}
        if path == '/prefab/import':
            from ..scene.objload import load_model_as_prefab
            from ..utils.image import load_hdr, load_png

            def loader(tex_path):
                load = (load_hdr if tex_path.lower().endswith('.hdr')
                        else load_png)
                return np.asarray(load(tex_path), np.float32)

            prefab = load_model_as_prefab(scene, str(body['path']),
                                          texture_loader=loader)
            return dict(index=scene.prefabs.index(prefab))
        if path == '/prefab/instantiate':
            parent = (self._entity_by_id(int(body['parent']))
                      if 'parent' in body else None)
            entity = scene.instantiate_prefab(
                _item(scene.prefabs, body['index'], 'prefab'),
                parent=parent)
            return dict(id=self._eid(entity))
        if path == '/mesh/delete':
            scene.destroy_mesh(
                _item(scene.meshes, body['index'], 'mesh'))
            return {}
        if path == '/scene/save':
            from ..scene.serializer import save_scene
            save_scene(str(body['path']), scene)
            return {}
        if path == '/scene/open':
            from ..scene.serializer import load_scene
            self.set_scene(load_scene(str(body['path'])))
            return {}
        if path == '/scene/new':
            from ..scene.procedural import make_default_scene
            self.set_scene(make_default_scene())
            return {}
        return None

    def set_scene(self, scene):
        self._ids.clear()
        self._next_id = 0
        self.session.set_scene(scene)

    def frame_png(self, params):
        mode = params.get('mode', 'render')
        brightness = float(params.get('brightness', 1.0))
        if mode == 'render':
            image = self.session.frame(
                tonemap_mode=int(params.get('tonemap', 0)),
                brightness=brightness)
        else:
            image = self.session.preview(
                mode=int(mode), brightness=brightness,
                selected_shape=int(params.get('selected', -1)))
        return encode_png(image.cpu().numpy(), compress_level=1)

    def shape_info(self, shape):
        """Entity name + material + stable id for a picked shape index."""
        if shape < 0:
            return '', '', -1
        index = 0
        from .preview import shape_entities
        for entity in shape_entities(self.session.scene):
            if index == shape:
                mat = entity.material.name if entity.material else ''
                return entity.name, mat, self._eid(entity)
            index += 1
        return '', '', -1

    def serve_forever(self):
        print(f'viewer: http://{self.host}:{self.port}/  '
              f'(WASD/QE move, arrows rotate, click to pick & select)',
              flush=True)
        self._server.serve_forever()

    def serve_background(self):
        thread = threading.Thread(target=self._server.serve_forever,
                                  daemon=True)
        thread.start()
        return thread

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


_TYPE_NAMES = {0: 'root', 1: 'container', 2: 'camera', 3: 'mesh',
               4: 'plane', 5: 'sphere', 6: 'cube'}
