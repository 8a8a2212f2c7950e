"""Headless CLI of the torch port (the counterpart of ``tiny_renderer_tpu.app``).

Renders N frames of a pipeline, optionally orbiting the camera and light
(src/app.rs:173-207), and writes the last frame as PNG:

  python -m tiny_renderer_tpu_torch.app -s shadow --frames 10 --save out.png

``-s`` takes any of the seven pipelines (default, phong, normal_map,
specular, darboux, shadow, occlusion).

``--backend cuda`` (the default) renders on the GPU through the CUDA raster
kernel; ``--backend cpu`` renders on the CPU through its plain torch twin.
Without ``-p`` the app loads ``assets/diablo`` when that directory exists,
else a procedural stand-in of the same size (flagship_model).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np

from .assets.model import Model, load_model
from .config import RenderConfig
from .models.procedural import make_textures, make_uv_sphere
from .pipelines.frame import PIPELINES
from .scene import Scene
from .utils.png import write_png

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
        description="tiny renderer on PyTorch + CUDA (headless)",
    )
    ap.add_argument("-p", dest="asset_path", default=None,
                    help="asset directory (model.obj + 4 TGA maps); default: "
                         "assets/diablo if present, else a procedural stand-in")
    ap.add_argument("-s", dest="pipeline", default="shadow",
                    choices=tuple(PIPELINES), help="shader pipeline name")
    ap.add_argument("--size", nargs=2, type=int, default=[800, 800],
                    metavar=("W", "H"), help="frame size (default 800 800)")
    ap.add_argument("--frames", type=int, default=60, help="number of frames to render")
    ap.add_argument("--orbit", action="store_true", help="animate camera+light orbit")
    ap.add_argument("--save", metavar="PNG", help="write the final frame to PNG")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the CUDA raster kernel on the GPU (default); "
                         "cpu: its plain torch twin on the CPU")
    return ap


def _angles_to_vectors(camera_angle: float, light_angle: float):
    """Camera and light on the unit XZ circle (src/app.rs:200-207)."""
    look_from = np.array([math.sin(camera_angle), 0.0, math.cos(camera_angle)], np.float32)
    light = np.array([math.sin(light_angle), 0.0, math.cos(light_angle)], np.float32)
    return look_from, np.zeros(3, np.float32), np.array([0.0, 1.0, 0.0], np.float32), light


def run_headless(scene: Scene, frames: int, orbit: bool) -> np.ndarray:
    cfg = scene.config
    camera_angle = light_angle = frame_time = 0.0
    times = []
    for _ in range(max(1, frames)):
        t0 = time.perf_counter()
        if orbit:
            camera_angle += cfg.camera_speed * frame_time
            light_angle -= cfg.light_speed * frame_time
        look_from, look_at, up, light = _angles_to_vectors(camera_angle, light_angle)
        scene.set_camera(look_from, look_at, up)
        scene.set_light_direction(light)
        scene.render()
        scene.synchronize()
        frame_time = time.perf_counter() - t0
        times.append(frame_time)
    steady = times[1:] or times
    print(
        f"{len(times)} frames on {scene.device}: mean {1e3 * sum(steady) / len(steady):.3f} ms "
        f"after the first ({1e3 * times[0]:.1f} ms, kernel build included)"
    )
    return scene.get_frame_buffer()


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    width, height = args.size
    model = load_model(args.asset_path) if args.asset_path else flagship_model()
    print(f"cooking up a scene with '{args.pipeline}' shader pipeline")
    scene = Scene(model, args.pipeline, RenderConfig(width=width, height=height),
                  device=args.backend)
    frame = run_headless(scene, args.frames, args.orbit)
    if args.save:
        write_png(args.save, np.ascontiguousarray(frame))
        print(f"wrote {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
