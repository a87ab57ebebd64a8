"""Interactive HTTP viewer: the reference's window and editor
(Window.cpp, Camera.hpp:47-87, Editor/*) served over HTTP for a headless
card; the JAX package's ``tools/live_viewer.py`` on this package.

A browser page shows the latest frame and forwards WASD/QE fly, drag-look
and the sun angle; a click picks (``Engine.pick``, the engine's tracer: K2.1
for ``best``); a colour field edits a material's albedo live
(``ops.shade.refresh_packed``; the traversal's geometry tables stay). The
Resources panel lists meshes, instances, materials and textures with
thumbnails from the texel pool (``/thumb``); the Files panel browses the
working directory and ``$CLRT_REFERENCE_ASSETS`` and hot-swaps the scene
(``/open``: a named scene, ``.obj``, ``.clm`` or ``.clsnap.npz``).

Run:
    python -m clraytracer_tpu_torch.tools.live_viewer --scene two \
        --width 480 --height 320 --port 8765 [--device cpu]
Then open http://localhost:8765/.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

_PAGE = """<!doctype html>
<meta charset="utf-8"><title>clraytracer_tpu</title>
<style>
 /* theme variables — the Editor.cpp theme-function analogue (dark /
    light / classic selectable, persisted in localStorage) */
 body{--bg:#111;--fg:#ddd;--accent:#7aa2f7}
 body.light{--bg:#f2f2f2;--fg:#222;--accent:#2255cc}
 body.classic{--bg:#3a3a3a;--fg:#e0e0c8;--accent:#d9a443}
 body{margin:0;background:var(--bg);color:var(--fg);font:13px monospace;display:flex}
 a{color:var(--accent)}
 #v{image-rendering:pixelated;cursor:crosshair}
 #v.droptarget{outline:3px dashed var(--accent)}
 #panel{padding:10px;min-width:240px}
 input[type=range]{width:160px}
 .mat{margin:2px 0}
 .file{cursor:grab}
</style>
<img id="v" draggable="false">
<div id="panel">
  <div>WASD+QE fly &middot; drag to look &middot; click to pick &middot;
    drag a file onto the view to open it</div>
  <div>theme <select id="theme" onchange="setTheme(this.value)">
    <option value="">dark</option><option value="light">light</option>
    <option value="classic">classic</option></select></div>
  <div>sun <input id="sun" type="range" min="-3.14" max="3.14" step="0.01"></div>
  <div id="mats"></div>
  <pre id="pick"></pre>
  <pre id="stats"></pre>
  <details open><summary>Resources</summary><div id="res"></div></details>
  <details><summary>Files</summary><div id="files"></div></details>
</div>
<script>
const v = document.getElementById('v');
// theme persistence (Editor.cpp theme functions analogue)
function setTheme(t) {
  document.body.className = t;
  localStorage.setItem('clrt_theme', t);
}
setTheme(localStorage.getItem('clrt_theme') || '');
document.getElementById('theme').value = localStorage.getItem('clrt_theme') || '';
// drag-drop scene open (GUI.cpp DragUIElement analogue): Files-browser
// entries are draggable; dropping one on the viewport hot-swaps the scene
v.ondragover = e => { e.preventDefault(); v.classList.add('droptarget'); };
v.ondragleave = () => v.classList.remove('droptarget');
v.ondrop = e => {
  e.preventDefault(); v.classList.remove('droptarget');
  const p = e.dataTransfer.getData('text/clrt-path');
  if (p) openScene(p);
};
let keys = {}, dragging = false, lastX=0, lastY=0, busy=false;
onkeydown = e => keys[e.key.toLowerCase()] = true;
onkeyup = e => keys[e.key.toLowerCase()] = false;
v.onmousedown = e => { dragging = true; lastX = e.clientX; lastY = e.clientY; };
onmouseup = e => dragging = false;
let mdx = 0, mdy = 0;
onmousemove = e => {
  if (dragging) { mdx += e.clientX - lastX; mdy += e.clientY - lastY;
                  lastX = e.clientX; lastY = e.clientY; }
};
v.onclick = async e => {
  if (Math.abs(mdx) + Math.abs(mdy) > 4) return;
  const r = v.getBoundingClientRect();
  const res = await fetch('/pick?x=' + (e.clientX - r.left) + '&y=' + (e.clientY - r.top));
  document.getElementById('pick').textContent = JSON.stringify(await res.json(), null, 1);
};
document.getElementById('sun').oninput = e => fetch('/sun?v=' + e.target.value);
async function loadMats() {
  const ms = await (await fetch('/materials')).json();
  const div = document.getElementById('mats');
  div.innerHTML = ms.map((m, i) =>
    `<div class="mat">mat ${i} <input type="color" value="${m}" ` +
    `onchange="fetch('/material?i=${i}&c=' + encodeURIComponent(this.value))"></div>`).join('');
}
loadMats();
async function loadRes() {
  const r = await (await fetch('/resources')).json();
  const el = document.getElementById('res');
  const mesh = r.meshes.map(m =>
    `<div>mesh ${m.index}: ${m.tris} tris @${m.tri_start} (bvh root ${m.root})</div>`).join('');
  const inst = r.instances.map(i =>
    `<div>inst ${i.index}: mesh ${i.mesh} mat+${i.material_start} ` +
    `pos (${i.position.map(p=>p.toFixed(1)).join(', ')})</div>`).join('');
  const tex = r.textures.map(t =>
    `<div><img src="/thumb?i=${t.index}" width="32" height="32" ` +
    `style="vertical-align:middle;image-rendering:pixelated"> ` +
    `tex ${t.index}: ${t.w}x${t.h}${t.procedural ? ' (procedural)' : ''}</div>`).join('');
  const mats = r.materials.map(m =>
    `<div>mat ${m.index}: shin ${m.shininess} rough ${m.roughness} ` +
    `tex ${m.albedo_tex}/${m.specular_tex}</div>`).join('');
  el.innerHTML = `<b>${r.summary.triangles} tris &middot; ` +
    `${r.summary.bvh_nodes} bvh nodes &middot; ${r.summary.texels} texels</b>` +
    mesh + inst + tex + mats;
}
loadRes();
async function loadFiles(dir) {
  const r = await (await fetch('/files' + (dir ? '?dir=' + encodeURIComponent(dir) : ''))).json();
  const el = document.getElementById('files');
  el.innerHTML = `<div><b>${r.dir}</b></div>` +
    (r.up ? `<div><a href="#" onclick="loadFiles('${r.up}');return false">..</a></div>` : '') +
    r.dirs.map(d => `<div><a href="#" onclick="loadFiles('${d.path}');return false">[${d.name}]</a></div>`).join('') +
    r.files.map(f => `<div class="file" draggable="true" ` +
      `ondragstart="event.dataTransfer.setData('text/clrt-path','${f.path}')">` +
      `<a href="#" onclick="openScene('${f.path}');return false">${f.name}</a></div>`).join('');
}
loadFiles('');
async function openScene(p) {
  document.getElementById('stats').textContent = 'loading ' + p + ' ...';
  const r = await (await fetch('/open?path=' + encodeURIComponent(p))).json();
  document.getElementById('stats').textContent = JSON.stringify(r);
  loadMats(); loadRes();
}
async function loop() {
  if (busy) return;
  busy = true;
  const mv = [(keys.d?1:0)-(keys.a?1:0), (keys.e?1:0)-(keys.q?1:0), (keys.w?1:0)-(keys.s?1:0)];
  const q = `mx=${mdx}&my=${mdy}&r=${mv[0]}&u=${mv[1]}&f=${mv[2]}`;
  mdx = 0; mdy = 0;
  const t0 = performance.now();
  const res = await fetch('/frame?' + q);
  const blob = await res.blob();
  v.src = URL.createObjectURL(blob);
  document.getElementById('stats').textContent =
    `frame ${res.headers.get('x-frame')} ${(performance.now()-t0).toFixed(0)} ms`;
  busy = false;
}
setInterval(loop, 60);
</script>"""


def _allowed(p: Path, roots: list[Path]) -> bool:
    return any(p == r or r in p.parents for r in roots)


def resources(s) -> dict:
    """The scene-tree panel's data (ResourceWindow.cpp:15-120)."""
    import numpy as np

    from clraytracer_tpu_torch.scene.types import scene_summary

    bvh = s.bvh
    inv = s.instances.inverse_transform.cpu().numpy()
    mstart = s.instances.material_start.cpu().numpy()
    mats = s.materials
    alb_tex, spec_tex = mats.albedo_tex.cpu().numpy(), mats.specular_tex.cpu().numpy()
    shin, rough = mats.shininess.cpu().numpy(), mats.roughness.cpu().numpy()
    tw, th = s.atlas.width.cpu().numpy(), s.atlas.height.cpu().numpy()
    toff = s.atlas.offset.cpu().numpy()
    proc = {h for h, _, _ in s.procedural_tex}
    return {
        "summary": scene_summary(s),
        "meshes": [
            {"index": k, "root": int(bvh.roots[k]), "tri_start": int(bvh.mesh_tri_start[k]),
             "tris": int(bvh.mesh_tri_count[k])}
            for k in range(len(bvh.roots))
        ],
        "instances": [
            {"index": k, "mesh": int(s.instances.mesh_index[k]),
             "material_start": int(mstart[k]),
             # world position: the translation row of the forward transform
             "position": [round(float(p), 3) for p in np.linalg.inv(inv[k])[3, :3]]}
            for k in range(int(s.instances.count))
        ],
        "textures": [
            {"index": k, "w": int(tw[k]), "h": int(th[k]), "offset": int(toff[k]),
             "procedural": k in proc}
            for k in range(int(s.atlas.num_textures))
        ],
        "materials": [
            {"index": k, "shininess": round(float(shin[k]), 3),
             "roughness": round(float(rough[k]), 3), "albedo_tex": int(alb_tex[k]),
             "specular_tex": int(spec_tex[k])}
            for k in range(int(mats.count))
        ],
    }


def thumbnail(s, i: int, side: int = 32) -> bytes:
    """Texture ``i`` from the texel pool (procedural ones are baked there
    too), sampled to ``side`` x ``side``, as PNG bytes."""
    import numpy as np

    from clraytracer_tpu_torch.render import png_bytes

    w, h = int(s.atlas.width[i]), int(s.atlas.height[i])
    off = int(s.atlas.offset[i])
    tex = s.atlas.texels[off : off + w * h, :3].cpu().numpy()
    img = (np.clip(tex.reshape(h, w, 3), 0, 1) * 255).astype(np.uint8)
    ys = (np.arange(side) * h) // side
    xs = (np.arange(side) * w) // side
    return png_bytes(img[ys][:, xs])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="clraytracer_tpu_torch.tools.live_viewer")
    ap.add_argument("--scene", default="two")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--tracer", default="best")
    ap.add_argument("--shadows", action="store_true",
                    help="sun shadow rays (beyond the reference)")
    ap.add_argument("--refraction", action="store_true",
                    help="Snell refraction through transmissive materials")
    ap.add_argument("--gi", action="store_true",
                    help="Monte-Carlo diffuse GI bounce continuations")
    ap.add_argument("--camera-pos", type=float, nargs=3, default=[0.13, 0.21, 10.0])
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    import torch

    from clraytracer_tpu_torch.cli import ASSETS_ENV, build_scene
    from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
    from clraytracer_tpu_torch.device import resolve_device
    from clraytracer_tpu_torch.engine import Engine
    from clraytracer_tpu_torch.ops.shade import refresh_packed
    from clraytracer_tpu_torch.render import frame_png
    from clraytracer_tpu_torch.scene.types import scene_summary

    dev = resolve_device(args.device)
    config = RenderConfig(width=args.width, height=args.height,
                          enable_shadows=args.shadows,
                          enable_refraction=args.refraction, enable_gi=args.gi)
    engine = Engine(
        scene=build_scene(args.scene, device=dev),
        config=config,
        camera_config=CameraConfig(position=tuple(args.camera_pos)),
        tracer=args.tracer,
        device=dev,
    )
    lock = threading.Lock()
    # the asset browser lists and opens files under these roots only
    roots = [Path.cwd().resolve()]
    assets = Path(os.environ.get(ASSETS_ENV, "reference/CLRayTracer/Assets"))
    if assets.is_dir():
        roots.append(assets.resolve())

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, ctype: str, extra=()):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj) -> None:
            self._send(json.dumps(obj).encode(), "application/json")

        def do_GET(self):  # noqa: N802 (http.server API)
            path = urlparse(self.path).path
            q = {k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()}
            if path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif path == "/frame":
                with lock:
                    engine.camera = engine.camera.updated(
                        (float(q.get("mx", 0)), float(q.get("my", 0))),
                        (float(q.get("r", 0)), float(q.get("u", 0)), float(q.get("f", 0))),
                        dt=0.1,
                    )
                    engine.tick()
                    img = engine.render().cpu().numpy()
                    engine.end_frame()
                    n = engine.frame_index
                self._send(frame_png(img), "image/png",
                           [("X-Frame", str(n)), ("Cache-Control", "no-store")])
            elif path == "/pick":
                with lock:
                    hit = engine.pick(float(q["x"]), float(q["y"]))
                self._json({
                    "hit": bool(hit.hit),
                    "instance": int(hit.instance),
                    "triangle": int(hit.index),
                    "distance": float(hit.distance),
                    "color": [round(float(c), 3) for c in hit.color],
                })
            elif path == "/sun":
                with lock:
                    engine.sun_angle = float(q["v"])
                self._json({})
            elif path == "/materials":
                with lock:
                    alb = engine.scene.materials.albedo.cpu().numpy()
                self._json(["#%02x%02x%02x" % tuple(int(round(float(c) * 255)) for c in row)
                            for row in alb])
            elif path == "/resources":
                with lock:
                    out = resources(engine.scene)
                self._json(out)
            elif path == "/thumb":
                with lock:
                    body = thumbnail(engine.scene, int(q["i"]))
                self._send(body, "image/png", [("Cache-Control", "max-age=5")])
            elif path == "/files":
                p = Path(q.get("dir", "") or str(roots[0])).resolve()
                if not _allowed(p, roots) or not p.is_dir():
                    p = roots[0]
                exts = {".obj", ".clm", ".npz"}
                dirs = sorted(x for x in p.iterdir() if x.is_dir() and not x.name.startswith("."))
                files = sorted(x for x in p.iterdir()
                               if x.is_file() and x.suffix.lower() in exts)
                up = p.parent if _allowed(p, roots) and p not in roots else None
                self._json({
                    "dir": str(p),
                    "up": str(up) if up else None,
                    "dirs": [{"name": x.name, "path": str(x)} for x in dirs],
                    "files": [{"name": x.name, "path": str(x)} for x in files],
                })
            elif path == "/open":
                # hot-swap the running scene (GUI.cpp:77-136): a named scene
                # or a file under the allowed roots
                spec = q["path"]
                p = Path(spec)
                if p.exists():
                    if not _allowed(p.resolve(), roots):
                        self.send_error(403)
                        return
                    spec = str(p.resolve())
                try:
                    new_scene = build_scene(spec, device=dev)
                except SystemExit as e:
                    self._json({"error": str(e)})
                    return
                with lock:
                    engine.scene = new_scene
                self._json({"loaded": spec, **scene_summary(new_scene)})
            elif path == "/material":
                # live material edit (ResourceManager.cpp:102-128): the albedo
                # row, then the packed rows refreshed
                i = int(q["i"])
                c = q["c"].lstrip("#")
                rgb = [int(c[k : k + 2], 16) / 255.0 for k in (0, 2, 4)]
                with lock:
                    mats = engine.scene.materials
                    alb = mats.albedo.clone()
                    alb[i] = torch.tensor(rgb, dtype=alb.dtype, device=alb.device)
                    engine.scene = refresh_packed(dataclasses.replace(
                        engine.scene, materials=dataclasses.replace(mats, albedo=alb)))
                self._json({})
            else:
                self.send_error(404)

    srv = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"live viewer on http://localhost:{args.port}/  "
          f"(scene={args.scene}, tracer={args.tracer}, device={dev})", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
