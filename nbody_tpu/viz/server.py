"""Live HTTP viewer — the interactive-rate replacement for the reference's
GLFW window (``simulation_visualization.cpp:172-223``, ``main.cpp:118-133``).

The reference's UX is *watching the run evolve live*; headless accelerator
hosts have no display, so the idiomatic equivalent is a tiny in-process HTTP server
streaming the device-rendered frames to any browser:

- ``/``          a minimal page with a live ``<img>`` + run controls
- ``/stream``    ``multipart/x-mixed-replace`` PNG stream (the MJPEG
                 pattern; browsers render PNG parts natively, so the
                 existing zlib PNG encoders are reused — no JPEG dep)
- ``/frame.png`` the latest frame (one-shot)
- ``/stop`` ``/pause`` ``/resume``  run control (POST or GET): the
                 reference's close-the-window-to-stop semantics
                 (``glfwWindowShouldClose``, ``main.cpp:118``) without
                 killing the process.
                 ``Simulation.run`` polls ``control_state()`` at chunk
                 boundaries and checkpoints before stopping.
- ``/view``      camera control (zoom/pan — beyond the reference's fixed
                 unrotated camera): ``?op=in|out|reset|left|right|up|down``
                 relative steps, or absolute ``?zoom=F&cx=F&cy=F`` (cx/cy
                 are fractions of the config's max_view).  ``Simulation``
                 polls ``view_state()`` with the frame cadence and feeds
                 the rasterizer's TRACED camera scalars — view changes
                 recompile nothing and apply from the next chunk.

``LiveViewer`` implements the same ``submit(idx, frame)`` / ``close()``
interface as ``FrameStreamer``, so it plugs straight into
``Simulation.run(frame_streamer=...)`` and the CLI (``--viz-serve PORT``).
Encoding happens on the caller's thread (cheap: 800x600 PNG at low
compression); delivery fans out on the server's per-client threads.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_INDEX_HTML = b"""<!doctype html>
<html><head><title>nbody_tpu live</title>
<style>body{background:#111;color:#9e9;font-family:monospace;text-align:center}
img{image-rendering:pixelated;border:1px solid #333;margin-top:1em}
button{background:#222;color:#9e9;border:1px solid #474;margin:0 .3em;
padding:.3em 1em;font-family:monospace;cursor:pointer}
#st{color:#ee9}</style>
<script>
function ctl(p){fetch('/'+p,{method:'POST'}).then(r=>r.text())
  .then(t=>{document.getElementById('st').textContent=t;});}
function view(op){fetch('/view?op='+op,{method:'POST'}).then(r=>r.text())
  .then(t=>{document.getElementById('vw').textContent=t;});}
</script></head><body>
<h3>nbody_tpu &mdash; live simulation view</h3>
<img src="/stream" alt="live frames">
<p>green &rarr; red = light &rarr; heavy (the reference's mass lerp)</p>
<p><button onclick="ctl('pause')">pause</button>
<button onclick="ctl('resume')">resume</button>
<button onclick="ctl('stop')">stop</button> <span id="st"></span></p>
<p>
<button onclick="view('in')">zoom +</button>
<button onclick="view('out')">zoom &minus;</button>
<button onclick="view('left')">&larr;</button>
<button onclick="view('right')">&rarr;</button>
<button onclick="view('up')">&uarr;</button>
<button onclick="view('down')">&darr;</button>
<button onclick="view('reset')">reset view</button>
<span id="vw"></span></p>
<p style="color:#666">stop ends the run cleanly at the next chunk
boundary (checkpointing first when configured)</p>
</body></html>
"""

_BOUNDARY = b"nbodyframe"


def _encode(rgb: np.ndarray) -> bytes:
    # Native zlib encoder when built (make -C native); Python fallback
    # is built into encode_png.
    from .native_png import encode_png
    return encode_png(rgb, compress_level=1)


class LiveViewer:
    """Threaded live-view server; drop-in frame_streamer."""

    def __init__(self, port: int = 8000, host: str = "127.0.0.1"):
        self._cond = threading.Condition()
        self._seq = 0
        self._png: Optional[bytes] = None
        self._closed = False
        self._control = "run"   # "run" | "pause" | "stop"
        # Camera: zoom factor and view-center offsets as FRACTIONS of the
        # config's max_view (the renderer owns the world scale).
        self._view = (1.0, 0.0, 0.0)
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _reply_text(self, text: str):
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                cmd, _, query = self.path.lstrip("/").partition("?")
                if cmd in ("stop", "pause", "resume"):
                    viewer._set_control(
                        {"stop": "stop", "pause": "pause",
                         "resume": "run"}[cmd])
                    self._reply_text(f"{cmd} requested (applies at the "
                                     f"next chunk boundary)")
                elif cmd == "view":
                    try:
                        z, cx, cy = viewer._set_view(query)
                    except ValueError as e:
                        self.send_error(400, str(e))
                        return
                    self._reply_text(
                        f"zoom {z:g}x center ({cx:+.2f}, {cy:+.2f})")
                else:
                    self.send_error(404)

            def do_GET(self):
                head = self.path.lstrip("/").partition("?")[0]
                if head in ("stop", "pause", "resume", "view"):
                    return self.do_POST()   # curl-friendly
                self._do_get()

            def _do_get(self):
                if self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length",
                                     str(len(_INDEX_HTML)))
                    self.end_headers()
                    self.wfile.write(_INDEX_HTML)
                elif self.path == "/frame.png":
                    png = viewer._wait_frame(after=-1)
                    if png is None:
                        self.send_error(404, "no frame yet")
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.end_headers()
                    self.wfile.write(png)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; "
                        f"boundary={_BOUNDARY.decode()}")
                    self.end_headers()
                    seen = -1
                    while True:
                        png = viewer._wait_frame(after=seen)
                        if png is None:      # closed
                            return
                        seen = viewer._seq
                        try:
                            self.wfile.write(
                                b"--" + _BOUNDARY + b"\r\n"
                                b"Content-Type: image/png\r\n"
                                b"Content-Length: "
                                + str(len(png)).encode() + b"\r\n\r\n"
                                + png + b"\r\n")
                        except (BrokenPipeError, ConnectionError):
                            return
                else:
                    self.send_error(404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self.frames_written = 0

    def _wait_frame(self, after: int, timeout: float = 30.0):
        """Block until a frame newer than ``after`` exists (or closed)."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._closed or (self._png is not None
                                         and self._seq > after),
                timeout=timeout)
            if self._png is not None and self._seq > after:
                return self._png
            return None

    # -- run control -------------------------------------------------------
    def _set_control(self, state: str) -> None:
        with self._cond:
            # stop is sticky: a later pause/resume cannot cancel it.
            if self._control != "stop":
                self._control = state
            self._cond.notify_all()

    def control_state(self) -> str:
        """Current run-control request: "run", "pause", or "stop".
        ``Simulation.run`` polls this at chunk boundaries."""
        with self._cond:
            return self._control

    # -- camera --------------------------------------------------------------
    _PAN_STEP = 0.25          # of the current (zoomed) view half-width
    _ZOOM_STEP = 1.25

    def _set_view(self, query: str):
        """Apply a /view request: relative ``op=...`` or absolute
        ``zoom=&cx=&cy=`` (unknown keys rejected).  Returns the new view."""
        from urllib.parse import parse_qsl
        params = dict(parse_qsl(query))
        with self._cond:
            z, cx, cy = self._view
            if "op" in params:
                op = params["op"]
                step = self._PAN_STEP / z
                if op == "in":
                    z *= self._ZOOM_STEP
                elif op == "out":
                    z /= self._ZOOM_STEP
                elif op == "left":
                    cx -= step
                elif op == "right":
                    cx += step
                elif op == "up":
                    cy += step
                elif op == "down":
                    cy -= step
                elif op == "reset":
                    z, cx, cy = 1.0, 0.0, 0.0
                else:
                    raise ValueError(f"unknown view op {op!r}")
            else:
                try:
                    z = float(params.get("zoom", z))
                    cx = float(params.get("cx", cx))
                    cy = float(params.get("cy", cy))
                except (TypeError, ValueError):
                    raise ValueError("zoom/cx/cy must be numbers")
            if not (1e-3 <= z <= 1e3):
                raise ValueError("zoom out of range [1e-3, 1e3]")
            self._view = (z, cx, cy)
            return self._view

    def view_state(self):
        """Current camera request ``(zoom, cx, cy)``; cx/cy are fractions
        of the config's max_view.  ``Simulation`` polls this with the
        frame cadence and feeds the rasterizer's traced camera scalars."""
        with self._cond:
            return self._view

    def request_stop(self) -> None:
        """Programmatic stop (same path as the browser button)."""
        self._set_control("stop")

    # -- frame_streamer interface -----------------------------------------
    def submit(self, idx: int, frame) -> None:
        png = _encode(np.asarray(frame))
        with self._cond:
            self._png = png
            self._seq += 1
            self._cond.notify_all()
        self.frames_written += 1

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
