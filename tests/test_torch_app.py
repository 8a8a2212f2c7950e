"""Torch port: the entry points above the frame path, on the CPU at small
sizes — the CLI (app.main, python -m tiny_renderer_tpu_torch), apply_knobs
against the JAX package's, run_sequence, the interactive loop against the
JAX InputState, the X11 viewer over a wire-protocol server, the per-stage
profile and the timing utilities, the custom-pipeline example, and the
default pipeline of Scene and the CLI (the same as the JAX package's)."""

import ctypes.util
import json
import math
import re
import struct
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from test_interactive import DT, FakeClock, FakeViewer
from test_torch_frame import VIEW, _tiny_assets
from tiny_renderer_tpu import RenderConfig as JRenderConfig
from tiny_renderer_tpu import app as japp
from tiny_renderer_tpu.scene import Scene as JScene
from tiny_renderer_tpu_torch import Model, RenderConfig, Scene, load_model
from tiny_renderer_tpu_torch import app as tapp
from tiny_renderer_tpu_torch.examples import custom_pipeline as example
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines.profile import STAGES, print_stage_breakdown, stage_breakdown
from tiny_renderer_tpu_torch.utils import timing
from tiny_renderer_tpu_torch.utils.png import downsample_box, png_bytes
from tiny_renderer_tpu_torch.utils.timing import TRACE_FILE, FpsCounter, StageTimer, profile_trace

ROOT = Path(__file__).resolve().parent.parent
SIZE = ["--size", "128", "64"]
CPU = ["--backend", "cpu", "--no-fps"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return str(_tiny_assets(tmp_path_factory.mktemp("assets")))


def sphere():
    return Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))


def scene_frame(model, pipeline, cfg, camera=0.0, light=0.0):
    """The Scene's frame at orbit angles (src/app.rs:200-207)."""
    scene = Scene(model, pipeline, cfg, device="cpu")
    look_from, look_at, up, light_dir = tapp._angles_to_vectors(camera, light)
    scene.set_camera(look_from, look_at, up)
    scene.set_light_direction(light_dir)
    scene.render()
    return scene


def test_main_writes_frame_and_debug_views(assets, tmp_path):
    out = {k: tmp_path / f"{k}.png" for k in ("save", "z", "shadow")}
    rc = tapp.main(["-p", assets, "-s", "shadow", *SIZE, "--frames", "2", *CPU,
                    "--save", str(out["save"]), "--dump-z", str(out["z"]),
                    "--dump-shadow", str(out["shadow"])])
    assert rc == 0
    scene = scene_frame(load_model(assets, verbose=False), "shadow", RenderConfig(width=128, height=64))
    assert out["save"].read_bytes() == png_bytes(scene.get_frame_buffer())
    assert out["z"].read_bytes() == png_bytes(scene.get_z_buffer())
    assert out["shadow"].read_bytes() == png_bytes(scene.get_shadow_buffer())


def test_main_save_seq_equals_per_frame_renders(assets, tmp_path):
    seq = tmp_path / "seq"
    rc = tapp.main(["-p", assets, "-s", "phong", *SIZE, "--frames", "3", *CPU,
                    "--camera-angle", "0.2", "--light-angle", "-0.1", "--save-seq", str(seq)])
    assert rc == 0
    files = sorted(seq.iterdir())
    assert [f.name for f in files] == [f"frame_{i:04d}.png" for i in range(3)]
    model, cfg = load_model(assets, verbose=False), RenderConfig(width=128, height=64)
    for i, f in enumerate(files):
        cam = np.float32(0.2 + cfg.camera_speed / 60.0 * i)
        lig = np.float32(-0.1 - cfg.light_speed / 60.0 * i)
        want = scene_frame(model, "phong", cfg, float(cam), float(lig)).get_frame_buffer()
        assert f.read_bytes() == png_bytes(want), f.name


def test_run_sequence_returns_the_last_frame(tmp_path):
    model, cfg = sphere(), RenderConfig(width=128, height=64)
    scene = Scene(model, "default", cfg, device="cpu")
    args = types.SimpleNamespace(frames=2, camera_angle=0.5, light_angle=0.0,
                                 save_seq=str(tmp_path / "s"))
    last = tapp.run_sequence(scene, args)
    cam, lig = np.float32(0.5 + cfg.camera_speed / 60.0), np.float32(-cfg.light_speed / 60.0)
    np.testing.assert_array_equal(
        last, scene_frame(model, "default", cfg, float(cam), float(lig)).get_frame_buffer())


def test_main_ssaa_resolves_the_supersampled_frame(assets, tmp_path):
    png = tmp_path / "ssaa.png"
    assert tapp.main(["-p", assets, "-s", "default", "--size", "64", "32", "--frames", "1",
                      *CPU, "--ssaa", "2", "--save", str(png)]) == 0
    data = png.read_bytes()
    assert struct.unpack(">II", data[16:24]) == (64, 32)
    big = scene_frame(load_model(assets, verbose=False), "default", RenderConfig(width=128, height=64))
    assert data == png_bytes(downsample_box(big.get_frame_buffer(), 2))
    assert tapp.main(["-p", assets, "--ssaa", "2", "--interactive", *CPU]) == 2


def test_main_knobs_and_projection_distance(assets, tmp_path):
    pngs = {}
    for name, extra in (("default", []), ("knobs", ["--knob", "strip_mask=true", "--knob",
                                                    "strip_planes=1", "--knob", "strip_len=32"]),
                        ("pd3", ["--projection-distance", "3"])):
        pngs[name] = tmp_path / f"{name}.png"
        assert tapp.main(["-p", assets, "-s", "shadow", *SIZE, "--frames", "1", *CPU,
                          "--save", str(pngs[name]), *extra]) == 0
    assert pngs["knobs"].read_bytes() == pngs["default"].read_bytes()
    assert pngs["pd3"].read_bytes() != pngs["default"].read_bytes()
    assert tapp.main(["-p", assets, *SIZE, *CPU, "--projection-distance", "0"]) == 2


@pytest.mark.parametrize("knob", ["nope=1", "strip_mask=maybe", "strip_len", "tile_w=100",
                                  "strip_len=x"])
def test_main_bad_knob_exits_2(assets, knob, capsys):
    assert tapp.main(["-p", assets, *SIZE, *CPU, "--knob", knob]) == 2
    assert "error:" in capsys.readouterr().err


def test_main_bad_pipeline_and_unknown_arguments(assets, capsys):
    with pytest.raises(SystemExit) as err:
        tapp.main(["-p", assets, "-s", "nope", *CPU])
    assert err.value.code == 2
    capsys.readouterr()
    assert tapp.main(["-p", assets, *SIZE, "--frames", "1", *CPU, "--compile-cache", "/x",
                      "--no-compile-cache"]) == 0
    assert ("ignoring unrecognized arguments: --compile-cache /x --no-compile-cache"
            in capsys.readouterr().err)


KNOB_ARGS = [
    [],
    ["strip_mask=true", "strip_len=32"],
    ["fuse_passes=1", "tex_tile=16", "shadow_tile=8"],
    ["max_incidences=4096"],
    ["max_incidences=none", "occlusion_step=0.05", "idx_int16=off"],
]


@pytest.mark.parametrize("knobs", KNOB_ARGS, ids=lambda k: ",".join(k) or "none")
def test_apply_knobs_matches_jax(knobs):
    got = tapp.apply_knobs(RenderConfig(width=128, height=64), knobs)
    want = japp.apply_knobs(JRenderConfig(width=128, height=64), knobs)
    assert got.__dict__ == want.__dict__


def test_python_m_runs(assets, tmp_path):
    png = tmp_path / "m.png"
    proc = subprocess.run(
        [sys.executable, "-m", "tiny_renderer_tpu_torch", "-p", assets, "-s", "phong",
         "--size", "64", "32", "--frames", "1", *CPU, "--save", str(png)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "cooking up a scene with 'phong' shader pipeline" in proc.stdout
    assert png.read_bytes().startswith(b"\x89PNG")


# Hold 'd' for frames 1-3 and 'q' for 4-5 (each integrates the previous
# frame's dt), then Escape.
SCRIPT = {0: [("press", "d")], 3: [("release", "d"), ("press", "q")],
          5: [("release", "q"), ("press", "escape")]}


def jax_input_angles(script, n_frames, cfg):
    """The angles each frame renders at, replayed through the JAX
    package's InputState."""
    state = japp.InputState(0.0, 0.0, cfg.camera_speed, cfg.light_speed)
    angles, dt = [], 0.0
    for i in range(n_frames):
        state.integrate(dt)
        angles.append((state.camera, state.light))
        for kind, key in script.get(i, []):
            (state.on_press if kind == "press" else state.on_release)(key)
        dt = DT
    return angles


@pytest.mark.parametrize("serial", [False, True], ids=["pipelined", "serial"])
def test_run_interactive_matches_jax_input_state(serial, monkeypatch):
    model, cfg = sphere(), RenderConfig(width=64, height=64)
    scene = Scene(model, "phong", cfg, device="cpu")
    cams = []
    orig = scene.set_camera
    monkeypatch.setattr(scene, "set_camera", lambda f, a, u: (cams.append(np.array(f)), orig(f, a, u)))
    viewer = FakeViewer(SCRIPT)
    args = types.SimpleNamespace(camera_angle=0.0, light_angle=0.0, no_fps=True, serial_present=serial)
    frame = tapp.run_interactive(scene, args, viewer=viewer, clock=FakeClock())
    angles = jax_input_angles(SCRIPT, 6, cfg)
    assert viewer.frames_shown == len(cams) == 6 and not viewer.alive
    for got, (cam, _) in zip(cams, angles):
        np.testing.assert_allclose(got, [math.sin(cam), 0.0, math.cos(cam)], rtol=1e-6)
    want = scene_frame(model, "phong", cfg, *angles[-1]).get_frame_buffer()
    np.testing.assert_array_equal(frame, want)
    if serial:
        np.testing.assert_array_equal(viewer.shown[-1], want)
    else:  # frame N-1 shown while N renders: the startup frame twice
        np.testing.assert_array_equal(viewer.shown[1], viewer.shown[0])
        assert not np.array_equal(viewer.shown[-1], want)


def test_interactive_falls_back_to_headless_without_display(monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    scene = Scene(sphere(), "default", RenderConfig(width=64, height=64), device="cpu")
    args = types.SimpleNamespace(camera_angle=0.0, light_angle=0.0, no_fps=True, frames=1,
                                 orbit=False, timing=False)
    assert tapp.run_interactive(scene, args).shape == (64, 64, 3)
    assert "falling back to headless" in capsys.readouterr().out


def test_x11_viewer_drives_the_loop_over_the_wire():
    """The port's X11Viewer through the real libX11 against the
    wire-protocol X server: held 'd' orbits the camera, Escape exits, and
    the last blit that crossed the socket is a rendered frame."""
    if not ctypes.util.find_library("X11"):
        pytest.skip("libX11 not installed")
    from test_x11_wire import _fb_as_rgb, _install_nonfatal_x_error_handler, _ScriptedWire
    from x11_wire_server import MiniXServer

    from tiny_renderer_tpu_torch.viewer_x11 import X11Viewer

    _install_nonfatal_x_error_handler()
    scene = Scene(sphere(), "phong", RenderConfig(width=64, height=64), device="cpu")
    with MiniXServer() as srv:
        monkeypatch = pytest.MonkeyPatch()
        monkeypatch.setenv("DISPLAY", srv.display)
        try:
            viewer = _ScriptedWire(X11Viewer(width=64, height=64), srv, {
                0: [(0x0064, True)], 2: [(0x0064, False), (0xFF1B, True), (0xFF1B, False)]})
            cams = []
            orig = scene.set_camera
            scene.set_camera = lambda f, a, u: (cams.append(np.array(f)), orig(f, a, u))
            t = [0.0]

            def clock():
                t[0] += DT
                return t[0]

            args = types.SimpleNamespace(camera_angle=0.0, light_angle=0.0, no_fps=True)
            frame = tapp.run_interactive(scene, args, viewer=viewer, clock=clock)
        finally:
            monkeypatch.undo()
        assert frame.shape == (64, 64, 3) and len(cams) >= 3
        assert not np.allclose(cams[0], cams[-1]), "camera never orbited"
        wid = next(iter(srv.windows))
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not (wid in srv.framebuffers and _fb_as_rgb(srv, wid).any()):
            time.sleep(0.02)
        assert _fb_as_rgb(srv, wid).any(), "blitted frame is all-black"
        assert srv.unknown_opcodes == [] and srv.errors == []


@pytest.mark.parametrize("pipeline", ["shadow", "default"])
def test_stage_breakdown_on_cpu(pipeline):
    scene = Scene(sphere(), pipeline, RenderConfig(width=128, height=64), device="cpu")
    deltas, cumulative = stage_breakdown(scene, iters=2)
    assert list(cumulative) == list(STAGES) and list(deltas) == [*STAGES, "uniforms", "fetch"]
    for t in (*cumulative.values(), deltas["uniforms"], deltas["fetch"]):
        assert t["device"] is None and t["host"] >= 0.0
    assert sum(deltas[s]["host"] for s in STAGES) == pytest.approx(cumulative["full"]["host"])
    lines = []
    print_stage_breakdown(scene, iters=2, out=lines.append)
    assert len(lines) == 7 and "host clock" in lines[0] and "CUDA" not in lines[0]


def test_timing_utilities(tmp_path):
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("add", sync=torch.ones(3)):
            torch.ones(64).sum()
    assert timer.counts == {"add": 2} and timer.totals["add"] >= 0.0
    assert timer.summary().startswith("add: ")
    printed = []
    fps = FpsCounter(out=printed.append)
    fps._begin -= 2.0
    fps.tick()
    assert printed == ["FPS --- 1"]
    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(8).mul(2)
    trace = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())
    assert trace["traceEvents"]


def test_main_timing_and_profile(assets, tmp_path, capsys):
    rc = tapp.main(["-p", assets, "-s", "default", *SIZE, "--frames", "2", *CPU, "--timing",
                    "--profile", str(tmp_path / "prof")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "frame time on cpu" in out and "per-stage time of 'default'" in out
    # The tracer's report (its spans: one scene.render a frame), then off.
    assert "traced run" in out and out.index("traced run") < out.index("per-stage time")
    assert re.search(r"scene\.render +2 spans", out) and not timing.tracing()
    events = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())["traceEvents"]
    assert {"scene.render", "scene.stage"} <= {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_default_pipeline_matches_jax():
    """Scene(model) and the CLI without -s render 'default' in both packages."""
    model = sphere()
    cfg = RenderConfig(width=128, height=64)
    port = Scene(model, config=cfg, device="cpu")
    ref = JScene(model, config=JRenderConfig(width=128, height=64), backend="pallas_interpret")
    assert port.pipeline_name == ref.pipeline_name == "default"
    for s in (port, ref):
        s.set_light_direction(VIEW[0])
        s.render()
    got, want = port.get_frame_buffer(), ref.get_frame_buffer()
    assert (got > 0).any(-1).mean() > 0.05
    assert (got != want).any(-1).mean() < 0.005
    assert tapp.build_arg_parser().parse_args([]).pipeline == "default"
    assert japp.build_arg_parser().parse_args([]).pipeline == "default"


def test_example_and_cli_see_registered_pipelines(assets, tmp_path):
    out = tmp_path / "toon.png"
    try:
        example.main([assets, str(out), "--size", "64", "64", "--backend", "cpu"])
        assert out.read_bytes().startswith(b"\x89PNG")
        assert (tmp_path / "toon-glow.png").read_bytes().startswith(b"\x89PNG")
        assert tapp.build_arg_parser().parse_args(["-s", "glow"]).pipeline == "glow"
        png = tmp_path / "cli.png"
        assert tapp.main(["-p", assets, "-s", "toon", "--size", "64", "64", "--frames", "1", *CPU,
                          "--save", str(png)]) == 0
        want = scene_frame(load_model(assets, verbose=False), "toon", RenderConfig(width=64, height=64))
        assert png.read_bytes() == png_bytes(want.get_frame_buffer())
    finally:
        tframe.unregister_pipeline("toon")
        tframe.unregister_pipeline("glow")
