"""App / CLI of the torch port (the counterpart of ``tiny_renderer_tpu.app``).

The reference's entry point (src/main.rs: ``-p <asset dir>``, ``-s
<pipeline>``, 800x800) and frame loop (src/app.rs: a/d orbit the camera,
q/e the light, at 3.0 rad/s scaled by the frame time; FPS print):

  python -m tiny_renderer_tpu_torch -s shadow --frames 10 --orbit --save out.png
  python -m tiny_renderer_tpu_torch -s occlusion --interactive

Headless by default: ``--frames N`` renders N frames (``--orbit`` animates
them); ``--save`` writes the last as PNG, ``--save-seq DIR`` renders the
orbit as one burst and writes every frame, ``--dump-z``/``--dump-shadow``
write the debug buffer views.  ``--interactive`` opens a window (X11, else
matplotlib) when a display exists, else falls back to headless.
``--timing`` turns the tracer of utils/timing.py on for the run and prints
what it recorded (the frames' device stage ms, host spans, counters), the
frame times and a per-stage breakdown (pipelines/profile.py); ``--profile
DIR`` writes a torch.profiler trace, which holds the program's spans.

``-s`` takes the seven built-in pipelines and any registered with
``register_pipeline`` before ``build_arg_parser``.  ``--backend cuda`` (the
default) renders on the GPU through the CUDA raster kernel; ``--backend
cpu`` on the CPU through its plain torch twin.  ``--raster dense`` (the
JAX app's ``--backend jnp``) replaces the binned tile raster with the dense
one, every triangle at every pixel, on either device; ``--knob
row_bands=N`` rasters in N tile-row bands.  Without ``-p`` the app
loads ``assets/diablo`` when that directory exists, else a procedural
stand-in of the same size (flagship_model).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

from .assets.model import Model, load_model
from .config import RenderConfig
from .models.procedural import make_textures, make_uv_sphere
from .pipelines.frame import BACKENDS, PIPELINES
from .scene import Scene
from .utils import timing
from .utils.png import downsample_box, write_png
from .utils.timing import FpsCounter, profile_trace

DEFAULT_ASSET_ROOTS = ("assets",)


def flagship_model(verbose: bool = False) -> Model:
    """The flagship scene: diablo when an asset root holds it, else a UV
    sphere of diablo's size (5,096 triangles vs 5,022) with 1024^2 maps."""
    for root in DEFAULT_ASSET_ROOTS:
        path = os.path.join(root, "diablo")
        if os.path.isdir(path):
            return load_model(path, verbose=verbose)
    tex = make_textures(1024)
    return Model(
        mesh=make_uv_sphere(radius=0.45, stacks=50, slices=52),
        texture=tex["texture"],
        normal_map=tex["normal_map"],
        normal_map_tangent=tex["normal_map_tangent"],
        specular_map=tex["specular_map"],
    )


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tiny_renderer_tpu_torch",
        description="tiny renderer on PyTorch + CUDA",
    )
    ap.add_argument("-p", dest="asset_path", default=None,
                    help="asset directory (model.obj + 4 TGA maps); default: "
                         "assets/diablo if present, else a procedural stand-in")
    # The live registry: pipelines registered before this call are choices.
    ap.add_argument("-s", dest="pipeline", default="default",
                    choices=tuple(PIPELINES), help="shader pipeline name")
    ap.add_argument("--size", nargs=2, type=int, default=[800, 800],
                    metavar=("W", "H"), help="frame size (default 800 800)")
    ap.add_argument("--frames", type=int, default=60,
                    help="number of frames to render in headless mode")
    ap.add_argument("--orbit", action="store_true",
                    help="animate camera+light orbit in headless mode")
    ap.add_argument("--camera-angle", type=float, default=0.0,
                    help="initial camera orbit angle (radians)")
    ap.add_argument("--light-angle", type=float, default=0.0,
                    help="initial light orbit angle (radians)")
    ap.add_argument("--save", metavar="PNG", help="write the final frame to PNG")
    ap.add_argument("--save-seq", metavar="DIR",
                    help="render the whole orbit animation as one burst and "
                         "write frame_%%04d.png into DIR")
    ap.add_argument("--dump-z", metavar="PNG", help="write the z-buffer debug view")
    ap.add_argument("--dump-shadow", metavar="PNG", help="write the shadow-buffer debug view")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "cpu"),
                    help="the device: cuda, the CUDA raster kernel on the GPU "
                         "(default); cpu, its plain torch twin on the CPU")
    ap.add_argument("--raster", default="kernel", choices=BACKENDS,
                    help="the raster backend (the JAX app's --backend): kernel, "
                         "the binned tile raster (default); dense, every "
                         "triangle at every pixel (the JAX package's jnp), "
                         "on --backend's device")
    ap.add_argument("--depth", type=float, default=255.0,
                    help="z-buffer depth range (reference: 255, shader.rs:214)")
    ap.add_argument("--projection-distance", type=float, default=5.0,
                    help="perspective projection distance c (w' = 1 - z/c; "
                         "reference: 5, shader.rs:204)")
    ap.add_argument("--interactive", action="store_true",
                    help="open an interactive viewer (requires a display)")
    ap.add_argument("--no-fps", action="store_true", help="disable the FPS printout")
    ap.add_argument("--serial-present", action="store_true",
                    help="interactive: present each frame after it renders "
                         "(the reference's contract, src/app.rs:213-218) "
                         "instead of copying frame N-1 to the host while "
                         "frame N renders (one frame of display latency)")
    ap.add_argument("--timing", action="store_true",
                    help="trace the run (device stage ms, host spans, "
                         "counters) and print it, a per-frame wall-time "
                         "summary and a per-stage breakdown at exit")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run to DIR")
    ap.add_argument("--ssaa", type=int, default=1, metavar="N",
                    help="supersampled antialiasing: render at N x the "
                         "requested size and box-average down (headless "
                         "--save/--save-seq; debug dumps stay at render "
                         "resolution).  Output is not parity-comparable")
    ap.add_argument("--knob", action="append", default=[], metavar="NAME=VALUE",
                    help="override a RenderConfig field (repeatable), e.g. "
                         "--knob tex_tile=16 --knob fuse_passes=true; bools "
                         "accept true/false.  Every raster knob renders the "
                         "same pixels")
    return ap


def apply_knobs(config, knob_args):
    """Apply --knob NAME=VALUE overrides to a RenderConfig.

    Values are coerced to the field's declared type (bool accepts
    true/false/1/0).  Unknown names and malformed values raise ValueError
    listing the valid fields: a mistyped knob that silently changed nothing
    would invalidate an experiment."""
    fields = {f.name: f for f in dataclasses.fields(type(config))}
    updates = {}
    for spec in knob_args:
        name, sep, raw = spec.partition("=")
        if not sep or name not in fields:
            valid = ", ".join(sorted(fields))
            raise ValueError(
                f"--knob {spec!r}: expected NAME=VALUE with NAME one of: {valid}"
            )
        ftype = fields[name].type
        if isinstance(ftype, str) and ftype.endswith("| None"):
            # Optional fields (e.g. max_incidences: int | None).
            if raw.strip().lower() in ("none", "null"):
                updates[name] = None
                continue
            ftype = ftype.replace("| None", "").strip()
        if ftype in ("bool", bool):
            low = raw.strip().lower()
            if low in ("true", "1", "yes", "on"):
                val = True
            elif low in ("false", "0", "no", "off"):
                val = False
            else:
                raise ValueError(f"--knob {spec!r}: not a bool: {raw!r}")
        elif ftype in ("int", int):
            val = int(raw)
        elif ftype in ("float", float):
            val = float(raw)
        else:
            val = raw
        updates[name] = val
    return dataclasses.replace(config, **updates) if updates else config


def _angles_to_vectors(camera_angle: float, light_angle: float):
    """Camera and light on the unit XZ circle (src/app.rs:200-207)."""
    look_from = np.array([math.sin(camera_angle), 0.0, math.cos(camera_angle)], np.float32)
    light = np.array([math.sin(light_angle), 0.0, math.cos(light_angle)], np.float32)
    return look_from, np.zeros(3, np.float32), np.array([0.0, 1.0, 0.0], np.float32), light


def print_trace(out=print):
    """--timing: print what the tracer recorded (timing.report) and turn it
    off, so that the stage breakdown after it runs untraced."""
    if timing.tracing():
        out("traced run (utils/timing.py):")
        out(timing.report(timing.snapshot()))
        timing.disable()


def run_headless(scene: Scene, args) -> np.ndarray:
    cfg = scene.config
    fps = FpsCounter(enabled=not args.no_fps)
    camera_angle = args.camera_angle
    light_angle = args.light_angle
    frame_time = 0.0
    times = []
    for _ in range(max(1, args.frames)):
        t0 = time.monotonic()
        if args.orbit:
            camera_angle += cfg.camera_speed * frame_time
            light_angle -= cfg.light_speed * frame_time
        look_from, look_at, up, light = _angles_to_vectors(camera_angle, light_angle)
        scene.set_camera(look_from, look_at, up)
        scene.set_light_direction(light)
        scene.render()
        # Headless: frames stay on the device; only the final one is fetched.
        scene.synchronize()
        fps.tick()
        frame_time = time.monotonic() - t0
        times.append(frame_time)
    if args.timing and times:
        steady = times[1:] or times  # drop the first frame (kernel build)
        print(
            f"frame time on {scene.device}: mean {1e3 * sum(steady) / len(steady):.2f} ms, "
            f"min {1e3 * min(steady):.2f} ms over {len(steady)} frames "
            f"(first frame incl. kernel build: {1e3 * times[0]:.0f} ms)"
        )
        print_trace()
        from .pipelines.profile import print_stage_breakdown

        print_stage_breakdown(scene)
    return scene.get_frame_buffer()


class InputState:
    """The reference's per-frame input integration (src/app.rs:55-80,
    :173-199): a/d orbit the camera, q/e orbit the light, at speeds scaled
    by the PREVIOUS frame's dt; Escape exits (the reference fires on key
    release, app.rs:74; press is accepted too for backends that deliver no
    releases).  Held keys are tracked by press/release pairs instead of the
    reference's key auto-repeat: the same steady-state behaviour without
    depending on the OS repeat rate."""

    def __init__(self, camera_angle, light_angle, camera_speed, light_speed):
        self.camera = camera_angle
        self.light = light_angle
        self._camera_speed = camera_speed
        self._light_speed = light_speed
        self.keys: set = set()
        self.exit = False

    def on_press(self, key):
        if key == "escape":
            self.exit = True
        else:
            self.keys.add(key)

    def on_release(self, key):
        if key == "escape":
            self.exit = True
        self.keys.discard(key)

    def integrate(self, dt):
        """Reference keymap (src/app.rs:63-77, :173-199)."""
        if "d" in self.keys:
            self.camera += self._camera_speed * dt
        if "a" in self.keys:
            self.camera -= self._camera_speed * dt
        if "e" in self.keys:
            self.light += self._light_speed * dt
        if "q" in self.keys:
            self.light -= self._light_speed * dt


class MatplotlibViewer:
    """Window backend for the interactive loop (show-image equivalent,
    reference Cargo.toml:12 + src/app.rs:148-153).  Raises on construction
    when no GUI backend is available."""

    def __init__(self):
        import matplotlib

        matplotlib.use("TkAgg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self.fig, self._ax = plt.subplots(figsize=(6, 6))
        self._ax.set_axis_off()
        self._im = None
        plt.ion()
        plt.show()

    def connect(self, on_press, on_release):
        self.fig.canvas.mpl_connect("key_press_event", lambda event: on_press(event.key))
        self.fig.canvas.mpl_connect("key_release_event", lambda event: on_release(event.key))

    def show(self, frame):
        if self._im is None:
            self._im = self._ax.imshow(frame)
        else:
            self._im.set_data(frame)
        self.fig.canvas.draw_idle()
        self.fig.canvas.flush_events()

    @property
    def alive(self) -> bool:
        return self._plt.fignum_exists(self.fig.number)

    def close(self):
        self._plt.ioff()
        self._plt.close(self.fig)


def _start_fetch(frame):
    """Begin the device-to-host copy of a (H, W, 3) u8 frame: on a GPU into
    pinned host memory behind an event, so the copy runs while the host
    queues the next frame."""
    if not frame.is_cuda:
        return frame, None
    host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
    host.copy_(frame, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _finish_fetch(pending):
    """The fetched frame, presentation-flipped (row 0 = top)."""
    host, done = pending
    if done is not None:
        done.synchronize()
    return host.numpy()[::-1]


def run_interactive(scene: Scene, args, viewer=None, clock=time.monotonic) -> np.ndarray:
    """The reference's windowed frame loop (src/app.rs:155-247).

    `viewer`/`clock` are injectable so tests drive the real loop with
    scripted key events and a deterministic clock.  By default a window is
    opened when a display exists (X11, else matplotlib); without one the
    app renders headless.
    """
    if viewer is None:
        if not os.environ.get("DISPLAY"):
            print("no display available; falling back to headless")
            return run_headless(scene, args)
        # The dedicated native window first (show-image parity,
        # src/app.rs:148-153); matplotlib is the fallback viewer.
        try:
            from .viewer_x11 import X11Viewer

            viewer = X11Viewer(scene.config.width, scene.config.height)
        except (OSError, RuntimeError) as e:
            print(f"X11 viewer unavailable ({e}); trying matplotlib")
            try:
                viewer = MatplotlibViewer()
            except Exception as e2:  # any GUI toolkit failure: no window
                print(f"interactive viewer unavailable ({e2}); falling back to headless")
                return run_headless(scene, args)

    cfg = scene.config
    state = InputState(args.camera_angle, args.light_angle, cfg.camera_speed, cfg.light_speed)
    viewer.connect(state.on_press, state.on_release)
    fps = FpsCounter(enabled=not args.no_fps)
    serial = getattr(args, "serial_present", False)
    frame_time = 0.0
    frame = None
    pending = None  # the copy of the last rendered frame, under way
    while not state.exit and viewer.alive:
        t0 = clock()
        state.integrate(frame_time)
        look_from, look_at, up, light = _angles_to_vectors(state.camera, state.light)
        scene.set_camera(look_from, look_at, up)
        scene.set_light_direction(light)
        out = scene.render()  # frame N queued on the device
        if serial:
            # The reference's contract: present frame N itself.
            frame = _finish_fetch(_start_fetch(out["frame"]))
            viewer.show(frame)
        else:
            if pending is None:
                pending = _start_fetch(out["frame"])  # startup: present the first frame
            # Pipelined presentation: show frame N-1, whose copy ran while
            # frame N was queued; one frame of display latency.
            frame = _finish_fetch(pending)
            viewer.show(frame)
            pending = _start_fetch(out["frame"])
        fps.tick()
        frame_time = clock() - t0
    # The final frame, rendered from the input state at exit, is still in
    # flight: fetch it, so --save and the return value match the reference.
    if pending is not None:
        frame = _finish_fetch(pending)
    viewer.close()
    return frame


def run_sequence(scene: Scene, args, ssaa: int = 1) -> np.ndarray:
    """Render the orbit animation as ONE burst and write its PNG frames."""
    cfg = scene.config
    n = max(1, args.frames)
    # A fixed 60 fps step (the interactive loop scales by real frame time).
    dt = 1.0 / 60.0
    cams = (args.camera_angle + cfg.camera_speed * dt * np.arange(n)).astype(np.float32)
    ligs = (args.light_angle - cfg.light_speed * dt * np.arange(n)).astype(np.float32)
    frames = scene.render_sequence(cams, ligs)
    os.makedirs(args.save_seq, exist_ok=True)
    for i in range(n):
        write_png(os.path.join(args.save_seq, f"frame_{i:04d}.png"), downsample_box(frames[i], ssaa))
    print(f"wrote {n} frames to {args.save_seq}")
    # The final frame before the SSAA resolve; main() resolves it for --save.
    return frames[-1]


def main(argv=None) -> int:
    # The reference silently ignores unrecognized argv tokens
    # (src/main.rs:16-26); they are ignored here too, but said.
    args, unknown = build_arg_parser().parse_known_args(argv)
    if unknown:
        print(f"ignoring unrecognized arguments: {' '.join(unknown)}", file=sys.stderr)
    width, height = args.size

    model = load_model(args.asset_path) if args.asset_path else flagship_model()
    print(f"cooking up a scene with '{args.pipeline}' shader pipeline")
    if args.projection_distance == 0.0:
        print("error: --projection-distance must be nonzero", file=sys.stderr)
        return 2
    ssaa = max(1, args.ssaa)
    if ssaa > 1 and args.interactive:
        print("error: --ssaa is headless-only (--save/--save-seq)", file=sys.stderr)
        return 2
    config = RenderConfig(
        width=width,
        height=height,
        depth=args.depth,
        projection_coef=-1.0 / args.projection_distance,
    )
    try:
        config = apply_knobs(config, args.knob)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if ssaa > 1:
        # Scaled after the knobs, so --knob width/height compose with --ssaa.
        config = dataclasses.replace(config, width=config.width * ssaa, height=config.height * ssaa)
    scene = Scene(model, args.pipeline, config, device=args.backend, backend=args.raster)

    if args.timing:
        timing.enable()
    try:
        with profile_trace(args.profile):
            if args.save_seq:
                frame = run_sequence(scene, args, ssaa=ssaa)
            elif args.interactive:
                frame = run_interactive(scene, args)
            else:
                frame = run_headless(scene, args)
        if args.timing:
            print_trace()
    finally:
        if args.timing:
            timing.disable()

    if args.save and frame is not None:
        write_png(args.save, downsample_box(frame, ssaa))
        print(f"wrote {args.save}")
    if args.dump_z:
        write_png(args.dump_z, scene.get_z_buffer())
        print(f"wrote {args.dump_z}")
    if args.dump_shadow:
        write_png(args.dump_shadow, scene.get_shadow_buffer())
        print(f"wrote {args.dump_shadow}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
