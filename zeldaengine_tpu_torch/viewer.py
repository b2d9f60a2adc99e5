"""Live HTTP viewer — the interactive window/present/input/editor surface.

The reference is an interactive windowed app: GLFW window + swapchain
present (InitWindow ZeldaEngine.cpp:1587-1742, vkQueuePresentKHR :2030)
with live mouse orbit/drag/scroll and keyboard callbacks (:1766-1937),
plus the ImGui editor drawn every frame (UpdateImGuiWidgets :4324-4581:
menu bar, Outliner tree, Details panel, Python-IDE pane) reserving the
right/bottom 20% of the framebuffer (:4343-4344). An offscreen renderer has
no window system; the native equivalent of "present" is streaming the
pipelined u8 frames to a browser, and the editor panels are HTML driven
by the same editor protocol the headless livelink speaks:

  GET  /            viewer page: viewport + Outliner/Details/menu/IDE
                    panels occupying the right/bottom bars (hidden in
                    game mode, exactly the reference's 'G' toggle)
  GET  /stream      multipart/x-mixed-replace MJPEG of the frame loop
  GET  /frame.jpg   latest frame (single shot)
  GET  /stats       FrameStats JSON
  POST /input       {"type": "key"|"orbit"|"zoom"|"resize", ...} mapped
                    onto the same Engine methods the GLFW callbacks call
                    (KeyboardCallback :1771: F focus, R reset anim,
                    G game mode, M stage roll, L light roll, 0-9 debug
                    views; RMB orbit drag :1845; scroll zoom :1910)
  POST /editor      editor-protocol commands (livelink.editor):
                    GetOutliner/GetDetails/SetDetails/GetStats/SaveWorld/
                    ReloadWorld/NewWorld/CompileShaders/RunScript

Run: ``python -m zeldaengine_tpu_torch.viewer [--port 8090] [--world
World.json] [--device cpu]`` (the engine runs on the card unless
``--device cpu``; port 0 binds a free port, which ``EngineViewer.port``
reports).

A failed tick stops the render loop: ``/frame.jpg``, ``/stream`` and
``/stats`` then answer 500 with the error, and ``stop()`` (and so
``main``) raises it.
"""

from __future__ import annotations

import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

LOG = logging.getLogger("zelda.viewer")

_PAGE = """<!doctype html>
<html><head><title>zeldaengine_tpu_torch</title><style>
 body { margin:0; background:#111; color:#9a9; font:12px monospace;
        display:grid; height:100vh; overflow:hidden;
        grid-template-columns: 1fr 20%; grid-template-rows: 1fr 20%; }
 body.game { grid-template-columns: 1fr 0; grid-template-rows: 1fr 0; }
 #vp { grid-area:1/1/2/2; position:relative; overflow:auto; }
 #hud { position:absolute; top:4px; left:6px; z-index:2; }
 img { display:block; margin:0 auto; max-width:100%; }
 #right { grid-area:1/2/3/3; background:#181c18; overflow-y:auto;
          padding:4px; border-left:1px solid #2a2; }
 #bottom { grid-area:2/1/3/2; background:#141814; overflow-y:auto;
           padding:4px; border-top:1px solid #2a2; }
 body.game #right, body.game #bottom { display:none; }
 h4 { margin:6px 0 2px; color:#cfc; }
 button { background:#232; color:#9f9; border:1px solid #2a2;
          margin:1px; cursor:pointer; font:inherit; }
 .row { cursor:pointer; padding:1px 3px; }
 .row:hover, .row.sel { background:#253425; }
 #details input { width:95%; background:#121; color:#cfc;
                  border:1px solid #243; font:inherit; }
 #details td { padding:1px 3px; }
 textarea { width:98%; height:60px; background:#121; color:#cfc;
            border:1px solid #243; font:inherit; }
 pre { color:#8c8; margin:2px; white-space:pre-wrap; }
</style></head><body class="__GAMECLASS__">
<div id="vp">
 <div id="hud">zeldaengine_tpu_torch &mdash; drag: orbit &middot; wheel: zoom
  &middot; keys: F R G M L 0-9 (G toggles editor)</div>
 <img id="v" src="/stream" draggable="false">
</div>
<div id="right">
 <h4>File</h4>
 <button onclick="cmd({Command:'NewWorld'}).then(refreshOutliner)">New</button>
 <button onclick="cmd({Command:'SaveWorld'})">Save</button>
 <button onclick="cmd({Command:'ReloadWorld'}).then(refreshOutliner)">Reload</button>
 <button onclick="cmd({Command:'CompileShaders'})">Compile Shaders</button>
 <h4>Outliner</h4><div id="outliner">loading&hellip;</div>
 <h4>Details <span id="target"></span></h4>
 <div id="details"></div>
</div>
<div id="bottom">
 <span id="stats"></span>
 <h4>Python IDE</h4>
 <textarea id="src">print(engine.stats.fps)</textarea>
 <button onclick="runScript()">Run</button>
 <pre id="out"></pre>
</div>
<script>
const post = (o) => fetch('/input', {method:'POST', body:JSON.stringify(o)});
const cmd = (o) => fetch('/editor', {method:'POST', body:JSON.stringify(o)})
                    .then(r => r.json());
let drag = false, lx = 0, ly = 0;
const img = document.getElementById('v');
img.addEventListener('mousedown', e => { drag = true; lx = e.clientX; ly = e.clientY; e.preventDefault(); });
window.addEventListener('mouseup', () => drag = false);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  post({type:'orbit', dx: e.clientX - lx, dy: e.clientY - ly});
  lx = e.clientX; ly = e.clientY;
});
window.addEventListener('wheel', e => post({type:'zoom', d: e.deltaY > 0 ? -1 : 1}));
window.addEventListener('keydown', e => {
  if (e.target.tagName === 'TEXTAREA' || e.target.tagName === 'INPUT') return;
  if (e.key.toUpperCase() === 'G') document.body.classList.toggle('game');
  post({type:'key', key: e.key});
});

let selected = null;
async function refreshOutliner() {
  const o = await cmd({Command:'GetOutliner'});
  const rows = [['Camera', 'Camera'], ['Engine', 'Engine']];
  for (let i = 0; i < o.Lights.Directional; i++)
    rows.push(['DirectionalLight/' + i, '&#9728; DirectionalLight ' + i]);
  for (let i = 0; i < o.Lights.Point; i++)
    rows.push(['PointLight/' + i, '&#9679; PointLight ' + i]);
  for (let i = 0; i < o.Lights.Spot; i++)
    rows.push(['SpotLight/' + i, '&#9678; SpotLight ' + i]);
  for (const ob of o.Objects)
    rows.push(['Object/' + ob.Index,
               '&#9632; ' + ob.ProfabName + ' &times;' + ob.InstanceCount]);
  document.getElementById('outliner').innerHTML = rows.map(
    ([t, label]) => `<div class="row${t===selected?' sel':''}"
      onclick="select('${t}')">${label}</div>`).join('')
    + `<div>tris: ${o.SceneTriangles} inst: ${o.SceneInstances}</div>`;
}
async function select(target) {
  selected = target;
  document.getElementById('target').textContent = '— ' + target;
  const d = await cmd({Command:'GetDetails', Target:target});
  const vals = d.Values || {};
  document.getElementById('details').innerHTML = '<table>'
    + Object.entries(vals).map(([k, v]) =>
      `<tr><td>${k}</td><td><input data-k="${k}"
        value='${JSON.stringify(v)}'></td></tr>`).join('')
    + '</table><button onclick="applyDetails()">Apply</button>';
  refreshOutliner();
}
async function applyDetails() {
  const values = {};
  for (const inp of document.querySelectorAll('#details input')) {
    try { values[inp.dataset.k] = JSON.parse(inp.value); } catch (e) {}
  }
  await cmd({Command:'SetDetails', Target:selected, Values:values});
  select(selected);
}
async function runScript() {
  const r = await cmd({Command:'RunScript',
                       Source:document.getElementById('src').value});
  document.getElementById('out').textContent =
    r.Output !== undefined ? r.Output : JSON.stringify(r);
}
async function pollStats() {
  try {
    const s = await (await fetch('/stats')).json();
    document.getElementById('stats').textContent =
      `frame ${s.frame_index} | ${s.frame_ms.toFixed(1)} ms | ` +
      `${s.fps.toFixed(1)} fps | ${s.triangles} tris | ` +
      `${s.reloads} reloads`;
  } catch (e) {}
  setTimeout(pollStats, 1000);
}
refreshOutliner(); pollStats();
</script></body></html>"""


class EngineViewer:
    """Owns the render loop: ticks the Engine, encodes each presented
    frame to JPEG, and serves it to any number of stream clients. The
    exception that stopped the render loop, if any, is ``error``."""

    def __init__(self, engine, port: int = 8090, max_fps: float = 60.0,
                 quality: int = 85, host: str = "127.0.0.1"):
        from zeldaengine_tpu_torch.livelink.editor import EditorHandler

        self.engine = engine
        self.editor = EditorHandler(engine)
        # Loopback by default, like the livelink TCP server: /editor
        # dispatches the full editor protocol including RunScript
        # (arbitrary exec), which must not be reachable from the network
        # without the user explicitly opting in (--host 0.0.0.0).
        self.host = host
        self.port = port
        self.max_fps = max_fps
        self.quality = quality
        self._frame: bytes | None = None
        self._frame_seq = 0
        self._cond = threading.Condition()
        self._raw = None  # latest un-encoded frame (encoder thread input)
        self._raw_cond = threading.Condition()
        self.error: BaseException | None = None
        self._running = False
        self._render_thread: threading.Thread | None = None
        self._encode_thread: threading.Thread | None = None
        self._httpd: ThreadingHTTPServer | None = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._running = True
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send_error_json(self) -> bool:
                """Answer 500 with the render loop's failure, if any."""
                err = viewer.error
                if err is None:
                    return False
                body = json.dumps({"error": f"{type(err).__name__}: {err}"})
                body = body.encode()
                self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return True

            def do_GET(self):
                if self.path == "/":
                    game = "game" if viewer.engine.game_mode else ""
                    body = _PAGE.replace("__GAMECLASS__", game).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/frame"):
                    frame = viewer.wait_frame()
                    if self._send_error_json():
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(frame)))
                    self.end_headers()
                    self.wfile.write(frame)
                elif self.path == "/stats":
                    import dataclasses

                    if self._send_error_json():
                        return

                    body = json.dumps(
                        dataclasses.asdict(viewer.engine.stats)
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream":
                    if self._send_error_json():
                        return
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=zeldaframe",
                    )
                    self.end_headers()
                    seq = -1
                    try:
                        while viewer._running:
                            frame, seq = viewer.wait_frame_seq(seq)
                            if viewer.error is not None:
                                break  # the render loop has stopped
                            if frame is None:
                                continue
                            self.wfile.write(b"--zeldaframe\r\n")
                            self.wfile.write(b"Content-Type: image/jpeg\r\n")
                            self.wfile.write(
                                f"Content-Length: {len(frame)}\r\n\r\n"
                                .encode()
                            )
                            self.wfile.write(frame)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_error(404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                if self.path == "/editor":
                    # The ImGui editor surface as HTTP: same handler the
                    # livelink TCP protocol dispatches to.
                    try:
                        msg = json.loads(self.rfile.read(n) or b"{}")
                        body = json.dumps(viewer.editor.handle(msg)).encode()
                        self.send_response(200)
                    except Exception as e:  # noqa: BLE001
                        body = json.dumps({"Status": "error",
                                           "Error": str(e)}).encode()
                        self.send_response(400)
                elif self.path == "/input":
                    try:
                        msg = json.loads(self.rfile.read(n) or b"{}")
                        viewer.handle_input(msg)
                        body = b'{"ok": true}'
                        self.send_response(200)
                    except Exception as e:  # noqa: BLE001 — never kill the loop
                        body = json.dumps({"ok": False,
                                           "error": str(e)}).encode()
                        self.send_response(400)
                else:
                    self.send_error(404)
                    return
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        self._render_thread = threading.Thread(target=self._render_loop,
                                               daemon=True)
        self._render_thread.start()
        self._encode_thread = threading.Thread(target=self._encode_loop,
                                               daemon=True)
        self._encode_thread.start()
        LOG.info("[VIEWER] serving on http://localhost:%d/", self.port)

    def stop(self) -> None:
        """Shut the server and loops down; raise the render loop's
        failure, if any."""
        self._running = False
        with self._cond:
            self._cond.notify_all()
        if self._httpd is not None:
            self._httpd.shutdown()
        with self._raw_cond:
            self._raw_cond.notify_all()
        if self._render_thread is not None:
            self._render_thread.join(timeout=5.0)
        if self._encode_thread is not None:
            self._encode_thread.join(timeout=5.0)
        if self.error is not None:
            raise RuntimeError("viewer: the render loop stopped on a failed "
                               "tick") from self.error

    # ----------------------------------------------------------------- frames

    def _render_loop(self) -> None:
        # JPEG encoding happens on its own thread, so that the encode does
        # not gate the tick cadence; the encoder keeps only the LATEST
        # frame, dropping encodes under load rather than queueing latency.
        # A failed tick (a failed present fetch among them) ends the loop:
        # nothing serves an old frame as if it were live.
        while self._running:
            t0 = time.time()
            try:
                img = self.engine.tick()
            except Exception as e:  # noqa: BLE001 - kept and re-raised
                LOG.exception("[VIEWER] tick failed; the render loop stops")
                with self._cond:
                    self.error = e
                    self._cond.notify_all()
                return
            with self._raw_cond:
                self._raw = img
                self._raw_cond.notify_all()
            budget = 1.0 / self.max_fps - (time.time() - t0)
            if budget > 0:
                time.sleep(budget)

    def _encode_loop(self) -> None:
        from PIL import Image

        while self._running:
            with self._raw_cond:
                if self._raw is None:
                    self._raw_cond.wait(1.0)
                img, self._raw = self._raw, None
            if img is None:
                continue
            buf = io.BytesIO()
            Image.fromarray(np.asarray(img)).save(
                buf, format="JPEG", quality=self.quality
            )
            with self._cond:
                self._frame = buf.getvalue()
                self._frame_seq += 1
                self._cond.notify_all()

    def wait_frame(self, timeout: float = 30.0) -> bytes:
        with self._cond:
            if self._frame is None and self.error is None:
                self._cond.wait(timeout)
            return self._frame or b""

    def wait_frame_seq(self, last_seq: int, timeout: float = 30.0):
        with self._cond:
            if self._frame_seq == last_seq and self.error is None:
                self._cond.wait(timeout)
            return self._frame, self._frame_seq

    # ------------------------------------------------------------------ input

    def handle_input(self, msg: dict) -> None:
        """Map browser events onto the Engine's input surface (the GLFW
        KeyboardCallback/mouse handlers, ZeldaEngine.cpp:1766-1937)."""
        e = self.engine
        kind = msg.get("type")
        if kind == "key":
            k = str(msg.get("key", ""))
            if k in "0123456789":
                e.set_debug_view(int(k))
            elif k.upper() == "F":
                e.focus()
            elif k.upper() == "R":
                e.reset_animation()
            elif k.upper() == "G":
                e.toggle_game_mode()
            elif k.upper() == "M":
                e.toggle_stage_roll()
            elif k.upper() == "L":
                e.toggle_light_roll()
        elif kind == "orbit":
            # Reference sensitivity: CameraArm yaw/pitch per pixel (:1858)
            e.orbit(float(msg.get("dx", 0)) * 0.25,
                    float(msg.get("dy", 0)) * 0.25)
        elif kind == "zoom":
            e.zoom(float(msg.get("d", 0)))
        elif kind == "resize":
            e.resize(int(msg["width"]), int(msg["height"]))
        else:
            raise ValueError(f"unknown input type: {kind!r}")


def main(argv=None) -> None:
    import argparse

    from zeldaengine_tpu_torch.config import EngineConfig
    from zeldaengine_tpu_torch.engine import Engine

    ap = argparse.ArgumentParser(
        description="zeldaengine_tpu_torch live viewer")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--host", type=str, default="127.0.0.1",
                    help="bind address (default loopback; the /editor "
                         "endpoint can run scripts — only expose it "
                         "deliberately)")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--world", type=str, default=None)
    ap.add_argument("--livelink-port", type=int, default=8080)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         "(plain PyTorch versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    config = EngineConfig(width=args.width, height=args.height)
    world = None
    if args.world:
        from zeldaengine_tpu_torch.scene.world import World

        world = World(file_path=args.world).load()
    engine = Engine(config=config, world=world,
                    livelink_port=args.livelink_port, device=args.device)
    engine.start()
    viewer = EngineViewer(engine, port=args.port, host=args.host)
    viewer.start()
    print(f"viewer: http://localhost:{viewer.port}/")
    try:
        while viewer.error is None:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        try:
            viewer.stop()  # raises the render loop's failure
        finally:
            engine.stop()


if __name__ == "__main__":
    main()
