"""Browser-canvas segmentation-mask editor on the port (counterpart of
fenerf_tpu/apps/paint_ui.py, the painter rebuilt headless).

Reference: Painter/run_UI.py + Painter/ui/* — a PyQt5 editor with the
19-class CelebA palette, brush / rectangle / fill tools and undo, whose
masks feed GAN inversion (edit mask -> re-invert -> re-render). The same
workflow is served to any local browser from a stdlib HTTP server: the
canvas runs in JS; load / save and the semantic batch ops (remove /
switch / scale / simplify, utils/mask_tools.py) run server-side on the
label map. Host-only: numpy, scipy and the standard library.

Usage:
  python -m fenerf_tpu_torch.apps.paint_ui --mask data/examples/mask.png \
      [--port 8799] [--out edited.png] [--edit_log sess.editlog.npz]
then open http://localhost:8799, edit, press Save. The saved file is a
uint8 label PNG for apps/invert.py --seg_path; --edit_log records one mask
snapshot per completed edit, which apps/edit_log_video.py replays.
"""
from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from fenerf_tpu_torch.utils import mask_tools
from fenerf_tpu_torch.utils.image import CELEBA_PALETTE, save_png

# 19 CelebAMask-HQ classes (Painter/ui/util.py number_object)
CLASS_NAMES = [
    "background", "skin", "nose", "eye_glasses", "left_eye", "right_eye",
    "left_brow", "right_brow", "left_ear", "right_ear", "mouth", "upper_lip",
    "lower_lip", "hair", "hat", "earring", "necklace", "neck", "cloth",
]

_PAGE = """<!doctype html>
<html><head><title>FENeRF mask painter</title><style>
body { font-family: sans-serif; margin: 16px; background: #222; color: #eee }
#palette button { width: 110px; margin: 2px; border: 2px solid #444 }
#palette button.active { border: 2px solid #fff }
canvas { border: 1px solid #888; image-rendering: pixelated; cursor: crosshair }
#tools button, #ops button, #ops input { margin: 2px }
</style></head><body>
<h3>FENeRF mask painter</h3>
<div id="tools">
 tool: <button onclick="tool='brush'">brush</button>
 <button onclick="tool='rect'">rect</button>
 <button onclick="tool='fill'">fill</button>
 size <input id="size" type="number" value="6" min="1" max="64" style="width:50px">
 <button onclick="undo()">undo</button>
 <button onclick="save()">save</button>
 <span id="status"></span>
</div>
<div id="palette"></div>
<canvas id="c" width="512" height="512"></canvas>
<div id="ops">
 server ops:
 <input id="opargs" placeholder="e.g. switch:4,5 / remove:3 / scale:13,1.2 / simplify">
 <button onclick="serverOp()">apply</button>
</div>
<script>
const PALETTE = __PALETTE__;
const NAMES = __NAMES__;
let W, H, labels, hist = [], cls = 1, tool = 'brush';
const canvas = document.getElementById('c'), ctx = canvas.getContext('2d');
const pal = document.getElementById('palette');
NAMES.forEach((n, i) => {
  const b = document.createElement('button');
  b.textContent = i + ' ' + n;
  b.style.background = 'rgb(' + PALETTE[i] + ')';
  b.onclick = () => { cls = i; document.querySelectorAll('#palette button')
    .forEach(x => x.classList.remove('active')); b.classList.add('active'); };
  pal.appendChild(b);
});
function draw() {
  const img = ctx.createImageData(W, H);
  for (let i = 0; i < W * H; i++) {
    const c = PALETTE[labels[i] % PALETTE.length];
    img.data[4*i] = c[0]; img.data[4*i+1] = c[1];
    img.data[4*i+2] = c[2]; img.data[4*i+3] = 255;
  }
  createImageBitmap(img).then(bm => {
    ctx.imageSmoothingEnabled = false;
    ctx.clearRect(0, 0, canvas.width, canvas.height);
    ctx.drawImage(bm, 0, 0, canvas.width, canvas.height);
  });
}
function load() {
  fetch('labels').then(r => r.json()).then(d => {
    W = d.w; H = d.h; labels = new Uint8Array(d.labels); draw();
  });
}
function push() { hist.push(labels.slice()); if (hist.length > 40) hist.shift(); }
function undo() { if (hist.length) { labels = hist.pop(); draw(); } }
function pos(e) {
  const r = canvas.getBoundingClientRect();
  return [Math.floor((e.clientX - r.left) / r.width * W),
          Math.floor((e.clientY - r.top) / r.height * H)];
}
function paint(x, y) {
  const s = +document.getElementById('size').value;
  for (let dy = -s; dy <= s; dy++) for (let dx = -s; dx <= s; dx++)
    if (dx*dx + dy*dy <= s*s) {
      const xx = x+dx, yy = y+dy;
      if (xx >= 0 && yy >= 0 && xx < W && yy < H) labels[yy*W+xx] = cls;
    }
  draw();
}
function fill(x, y) {
  const from = labels[y*W+x]; if (from === cls) return;
  const st = [[x, y]];
  while (st.length) {
    const [a, b] = st.pop();
    if (a < 0 || b < 0 || a >= W || b >= H || labels[b*W+a] !== from) continue;
    labels[b*W+a] = cls;
    st.push([a+1,b],[a-1,b],[a,b+1],[a,b-1]);
  }
  draw();
}
let down = false, rect0 = null;
canvas.onmousedown = e => {
  const [x, y] = pos(e); push(); down = true;
  if (tool === 'brush') paint(x, y);
  else if (tool === 'fill') { fill(x, y); down = false; }
  else rect0 = [x, y];
};
canvas.onmousemove = e => {
  if (!down || tool !== 'brush') return;
  const [x, y] = pos(e); paint(x, y);
};
canvas.onmouseup = e => {
  if (tool === 'rect' && rect0) {
    const [x, y] = pos(e);
    const [x0, y0] = rect0;
    for (let b = Math.min(y0,y); b <= Math.max(y0,y); b++)
      for (let a = Math.min(x0,x); a <= Math.max(x0,x); a++)
        labels[b*W+a] = cls;
    draw(); rect0 = null;
  }
  if (down || tool === 'fill') logEdit();
  down = false;
};
function logEdit() {
  fetch('log', {method: 'POST',
                body: JSON.stringify({labels: Array.from(labels)})});
}
function save() {
  fetch('save', {method: 'POST', body: JSON.stringify(
    {labels: Array.from(labels)})}).then(r => r.text()).then(t =>
    document.getElementById('status').textContent = t);
}
function serverOp() {
  push();
  fetch('op', {method: 'POST', body: JSON.stringify(
    {op: document.getElementById('opargs').value,
     labels: Array.from(labels)})}).then(r => r.json()).then(d => {
    labels = new Uint8Array(d.labels); draw(); logEdit();
    document.getElementById('status').textContent = d.msg;
  });
}
load();
</script></body></html>
"""


def apply_op(mask: np.ndarray, spec: str) -> np.ndarray:
    """'switch:4,5' | 'remove:3' | 'scale:13,1.2' | 'simplify'
    -> mask_tools ops (the edit_mask grammar with commas); painting a region
    (add_semantic) is the client-side brush."""
    name, _, args = spec.strip().partition(":")
    vals = [float(v) for v in args.split(",") if v] if args else []
    if name == "switch":
        return mask_tools.switch_semantic(mask, int(vals[0]), int(vals[1]))
    if name == "remove":
        return mask_tools.remove_semantic(mask, int(vals[0]))
    if name == "scale":
        return mask_tools.scale_semantic(mask, int(vals[0]), vals[1])
    if name == "simplify":
        return mask_tools.simplify_mask(mask)
    raise ValueError(f"unknown op {spec!r}")


def make_handler(state: dict):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _labels(self, m: np.ndarray, **extra):
            self._send(json.dumps({"labels": m.reshape(-1).tolist(),
                                   **extra}).encode(), "application/json")

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                page = (_PAGE
                        .replace("__PALETTE__",
                                 json.dumps(CELEBA_PALETTE.tolist()))
                        .replace("__NAMES__", json.dumps(CLASS_NAMES)))
                self._send(page.encode(), "text/html")
            elif self.path == "/labels":
                m = state["mask"]
                self._labels(m, w=m.shape[1], h=m.shape[0])
            else:
                self._send(b"not found", "text/plain", 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(n) or b"{}")
            m = state["mask"]
            if "labels" in data:
                m = np.asarray(data["labels"], np.uint8).reshape(m.shape)
            if self.path == "/save":
                state["mask"] = m
                save_png(state["out"], m)
                if state.get("log_path"):
                    state["log"].append(m.copy())
                    np.savez_compressed(
                        state["log_path"], frames=np.stack(state["log"]))
                self._send(f"saved {state['out']}".encode(), "text/plain")
            elif self.path == "/log":
                # the session log: one mask snapshot per completed edit
                # (the reference painter logs stroke events and replays
                # them, Painter/converter_log_to_video.py; snapshots replay
                # the same without a Qt event model)
                state["mask"] = m
                if state.get("log_path") is not None:
                    state["log"].append(m.copy())
                self._send(b"ok", "text/plain")
            elif self.path == "/op":
                try:
                    m = apply_op(m, data["op"])
                    state["mask"] = m
                    self._labels(m, msg=f"applied {data['op']}")
                except Exception as e:  # shown on the page's status line
                    self._labels(m, msg=f"error: {e}")
            else:
                self._send(b"not found", "text/plain", 404)

    return Handler


def make_server(mask_path: str, out_path: str, port: int = 8799,
                log_path: str | None = None):
    """-> (a ThreadingHTTPServer on 127.0.0.1:port, not yet serving; its
    state dict). port 0 takes a free one (server.server_address[1])."""
    from fenerf_tpu_torch.data.native_loader import read_image

    mask = read_image(mask_path, "L")
    state = {"mask": mask, "out": out_path, "log_path": log_path,
             "log": [mask.copy()]}
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    return server, state


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mask", required=True, help="uint8 label PNG to edit")
    p.add_argument("--out", default=None,
                   help="save path (default: <mask>_edit.png)")
    p.add_argument("--port", type=int, default=8799)
    p.add_argument("--edit_log", default=None,
                   help="record the edit session to this .npz (replayable "
                        "to video via apps.edit_log_video)")
    args = p.parse_args(argv)
    out = args.out or args.mask.rsplit(".", 1)[0] + "_edit.png"
    server, _ = make_server(args.mask, out, args.port, args.edit_log)
    print(f"painting {args.mask} -> {out}")
    print(f"open http://localhost:{server.server_address[1]}  "
          "(Ctrl-C to stop)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
