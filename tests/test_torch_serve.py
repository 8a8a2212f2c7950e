"""Torch port: the HTTP frame server example over a real loopback socket,
on the CPU with the procedural stand-in of the flagship model at 96x96.
The PNG payload must equal png_bytes of a direct Scene render byte for
byte."""

import json
import math
import struct
import threading
import urllib.error
import urllib.request

import pytest
import torch

from tiny_renderer_tpu_torch import RenderConfig, Scene
from tiny_renderer_tpu_torch.examples.serve_http import serve
from tiny_renderer_tpu_torch.utils.png import png_bytes


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    srv, service = serve(None, port=0, size=96, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:  # 4xx still carry a body
        return e.code, e.headers.get("Content-Type"), e.read()


def direct_png(service, pipeline, camera, light):
    scene = Scene(service.model, pipeline, RenderConfig(width=96, height=96), device="cpu")
    scene.set_camera([math.sin(camera), 0.0, math.cos(camera)], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    scene.set_light_direction([math.sin(light), 0.0, math.cos(light)])
    scene.render()
    return png_bytes(scene.get_frame_buffer())


@pytest.mark.parametrize("pipeline", ["shadow", "phong"])
def test_render_serves_scene_pixels(server, pipeline):
    base, service = server
    status, ctype, body = _get(f"{base}/render?pipeline={pipeline}&camera=0.9")
    assert status == 200 and ctype == "image/png"
    assert struct.unpack(">II", body[16:24]) == (96, 96)
    assert body == direct_png(service, pipeline, 0.9, -0.6)


def test_render_validates_input(server):
    base, _ = server
    status, _, body = _get(f"{base}/render?pipeline=nope")
    assert status == 400 and b"not supported" in body
    status, _, body = _get(f"{base}/render?pipeline=phong&camera=abc")
    assert status == 400 and b"error" in body
    assert _get(f"{base}/render?pipeline=phong&light=0.1.2")[0] == 400
    assert _get(f"{base}/other")[0] == 404


def test_healthz_reports_state(server):
    base, _ = server
    assert _get(f"{base}/render?pipeline=default")[0] == 200
    status, ctype, body = _get(f"{base}/healthz")
    assert status == 200 and ctype == "application/json"
    h = json.loads(body)
    assert h["ok"] is True and h["overflowed"] is False
    assert h["renders"] >= 1 and "default" in h["pipelines_warm"]
    assert h["size"] == [96, 96]


def test_concurrent_requests_deterministic(server):
    """The device lock serializes renders: concurrent identical requests
    return identical bytes, those of a direct render."""
    base, service = server
    results = [None] * 4

    def fetch(i):
        results[i] = _get(f"{base}/render?pipeline=default&camera=1.7&light=0.3")

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(r[0] == 200 for r in results)
    assert {r[2] for r in results} == {direct_png(service, "default", 1.7, 0.3)}
