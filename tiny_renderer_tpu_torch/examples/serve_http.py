"""Minimal HTTP frame server on the Scene API (``examples/serve_http.py``).

    GET /render?pipeline=shadow&camera=0.9&light=-0.6   -> image/png
    GET /healthz                                        -> {"ok": true, ...}

Angles are the reference's orbit parameterization (src/app.rs:200-207:
camera at (sin a, 0, cos a), light at (sin b, 0, cos b)).  One Scene per
pipeline is built lazily and reused; a lock serializes the device work
(one renderer process per GPU).  The overflow flag is surfaced in
/healthz.

Run:  python -m tiny_renderer_tpu_torch.examples.serve_http [asset_dir] [port] [--size N]
          [--backend cuda|cpu] [--raster kernel|dense]
      (without asset_dir, the procedural stand-in of the flagship model;
      --backend is the device, --raster the raster backend: dense is the JAX
      example's --backend jnp)
Try:  curl -o frame.png 'http://localhost:8000/render?pipeline=shadow&camera=0.9'
"""

from __future__ import annotations

import argparse
import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class FrameService:
    """A lazily built Scene per pipeline and a device lock."""

    def __init__(self, asset_dir, size=400, device="cuda", backend="kernel"):
        from .. import RenderConfig, load_model
        from ..app import flagship_model

        self.model = load_model(asset_dir, verbose=False) if asset_dir else flagship_model()
        self.config = RenderConfig(width=size, height=size)
        self.device = device
        self.backend = backend
        self._scenes = {}
        self._lock = threading.Lock()
        self._renders = 0
        self._overflowed = False

    def _scene(self, pipeline):
        from .. import Scene

        scene = self._scenes.get(pipeline)
        if scene is None:
            # Raises ValueError on unknown pipeline names (the reference's
            # message), which the handler maps to HTTP 400.
            scene = Scene(self.model, pipeline, self.config, device=self.device, backend=self.backend)
            self._scenes[pipeline] = scene
        return scene

    def render_png(self, pipeline, camera_angle, light_angle):
        from ..utils.png import png_bytes

        with self._lock:
            scene = self._scene(pipeline)
            scene.set_camera(
                [math.sin(camera_angle), 0.0, math.cos(camera_angle)],
                [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
            )
            scene.set_light_direction([math.sin(light_angle), 0.0, math.cos(light_angle)])
            scene.render()
            frame = scene.get_frame_buffer()
            self._renders += 1
            self._overflowed |= bool(scene.overflowed)
        return png_bytes(frame)

    def health(self):
        with self._lock:  # a snapshot: handler threads mutate _scenes
            return {
                "ok": not self._overflowed,
                "renders": self._renders,
                "overflowed": self._overflowed,
                "pipelines_warm": sorted(self._scenes),
                "size": [self.config.height, self.config.width],
            }


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            if os.environ.get("SERVE_HTTP_VERBOSE"):
                super().log_message(fmt, *args)

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                body = json.dumps(service.health()).encode()
                return self._send(200, body, "application/json")
            if url.path != "/render":
                return self._send(404, b"not found\n", "text/plain")
            q = parse_qs(url.query)
            try:
                pipeline = q.get("pipeline", ["shadow"])[0]
                camera = float(q.get("camera", ["0.0"])[0])
                light = float(q.get("light", ["-0.6"])[0])
                png = service.render_png(pipeline, camera, light)
            except (ValueError, KeyError) as e:
                return self._send(400, f"error: {e}\n".encode(), "text/plain")
            self._send(200, png, "image/png")

    return Handler


def serve(asset_dir, port=8000, size=400, device="cuda", backend="kernel"):
    """(server, service): a ThreadingHTTPServer on 127.0.0.1:`port` (0
    picks a free port) that the caller runs with serve_forever; `backend`
    is the raster backend of every Scene (frame.BACKENDS)."""
    service = FrameService(asset_dir, size=size, device=device, backend=backend)
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(service))
    return server, service


def main(argv=None):
    from ..pipelines.frame import BACKENDS

    ap = argparse.ArgumentParser(description="serve rendered frames over HTTP")
    ap.add_argument("asset_dir", nargs="?", help="asset directory (default: procedural stand-in)")
    ap.add_argument("port", nargs="?", type=int, default=8000)
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--backend", default="cuda", choices=("cuda", "cpu"), help="the device")
    ap.add_argument("--raster", default="kernel", choices=BACKENDS,
                    help="the raster backend (dense: the JAX example's --backend jnp)")
    args = ap.parse_args(argv)
    server, _ = serve(args.asset_dir, port=args.port, size=args.size, device=args.backend,
                      backend=args.raster)
    print(f"serving {args.asset_dir or 'the procedural stand-in'} on "
          f"http://127.0.0.1:{server.server_address[1]} ({args.size}x{args.size}, "
          f"device={args.backend}, raster={args.raster})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
