"""Drive one run of a cell, optionally with the program's timed path broken
underneath, and print the result line.

    python benchmark/tests/drive_run.py <cell> [--root DIR] [--fault NAME] [--trace]
        [--device cpu|cuda:0] [--size small|mid|cell] [--seed N] [--seconds S]

Used by the benchmark's tests: each run gets a fresh process, so that the
harness's check of the loaded modules sees only what the run loaded.  It
skips run.py's look for a GPU and runs everything else: set-up, the loop's
window, the traced parts, the comparison with the reference.  --size small
(the default) is a size a CPU test run can hold; mid keeps the cell's mesh
at 200 x 200; cell runs the cell as configured (on the GPU)."""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Sizes a test run can hold: the configurations' own pipeline and shapes,
# at 96 x 96 with a 12 x 16 sphere (small) or at 200 x 200 with the cell's
# own mesh (mid), with 64^2 maps and 8-frame bursts.
SIZES = {"small": ({"width": 96, "height": 96}, {"stacks": 12, "slices": 16}),
         "mid": ({"width": 200, "height": 200}, {})}


def _faults(name):
    """Break the program's timed path underneath with fault `name`."""
    import numpy as np
    import torch
    from tiny_renderer_tpu_torch import Scene

    seq, fetch, cam = Scene.render_sequence, Scene.get_frame_buffer, Scene.set_camera

    def altered(frames):
        frames = np.array(frames)
        frames[..., 5:21, :, :] = 255 - frames[..., 5:21, :, :]  # a 16-row strip of every frame
        return frames

    def half(self, c, l):
        frames = np.array(seq(self, c, l))
        frames[len(c) // 2:] = 0
        return frames

    def first_camera_only(self, *args):
        if not getattr(self, "_posed", False):
            cam(self, *args)
            self._posed = True

    if name == "no_shadow_compare":
        # the shadow-map compare skipped: every fragment lit
        from tiny_renderer_tpu_torch.pipelines import shaders

        shaders._shadow_fetch = lambda buf, sx, sy, width, tile=0: torch.full_like(sx, -3.0e38)
        return
    patches = {
        # a step that returns its state unchanged: every frame at the first pose
        "stale_burst": ("render_sequence", lambda self, c, l: seq(self, np.full_like(c, c[0]), np.full_like(l, l[0]))),
        "stale_frame": ("set_camera", first_camera_only),
        # half of the batch left out
        "half_burst": ("render_sequence", half),
        # an answer altered where it is produced
        "altered_burst": ("render_sequence", lambda self, c, l: altered(seq(self, c, l))),
        "altered_frame": ("get_frame_buffer", lambda self: altered(fetch(self))),
    }
    attr, fn = patches[name]
    setattr(Scene, attr, fn)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--fault")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--size", choices=("small", "mid", "cell"), default="small")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(2)
    from benchmark import harness

    cell = harness.find_cell(args.cell, args.root)
    if args.size != "cell":
        frame, mesh = SIZES[args.size]
        cell.config.update(frame)
        cell.config["mesh"].update(mesh)
        cell.config["maps"]["size"] = 64
        t = cell.traffic
        for k in ("warmup_steps", "span_frames", "traced_calls", "traced_frames"):
            if k in t:
                t[k] = min(t[k], 2)
        t["warmup_seconds"] = 0.0
        if "frames_per_call" in t:
            t["frames_per_call"] = 8
    if args.fault:
        _faults(args.fault)
    result = harness.run(cell, args.seed, args.seconds, args.trace, args.device, T0, log=lambda m: None)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
