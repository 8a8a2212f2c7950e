"""Sharded rendering (``examples/sharded_render.py``).

Renders one shadow frame with the screen rows sharded over a mesh of
devices (parallel.sharding); the frame equals the single-device render bit
for bit.  The shards run one after another in this process, each on its
own device of the mesh; the mesh here repeats one device --shards times
(five shards on one GPU by default), so it runs on a machine with one card.

Run:  python -m tiny_renderer_tpu_torch.examples.sharded_render [asset_dir] [--out PNG]
        [--size N] [--shards N] [--device cuda|cpu] [--backend kernel|dense]
        [--replicate-pass1 | --pipelined]

  Without asset_dir, the procedural stand-in of the flagship model.
  --size N renders NxN (default 800); N must be a multiple of --shards
  (default 5), and on the kernel backend each shard's N/shards rows a
  multiple of the 32-row tile: 800 = 5 x 160.  --backend dense --shards 8
  gives 8 x 100 rows.  --replicate-pass1: every shard rasterizes the whole
  light view instead of gathering the shadow map (same pixels).
  --pipelined: a 3-frame orbit through render_sequence_pipelined on a
  ("stage", "rows") mesh of 2 x shards, writing <out>-N.png per frame.

On a CUDA device the sharded frame is a set of replayed CUDA graphs (the
first call captures them); the example then renders N_TIMED more frames
(sequences with --pipelined) and prints the ms per frame.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

N_PIPELINED = 3
N_TIMED = 10  # frames (sequences) timed after the first on a CUDA device
LIGHT = [0.35, 0.0, 0.94]
LOOK_FROM = [0.25, 0.0, 0.97]


def _size(value, shards):
    """--size's value, or exit with a message."""
    if value is None:
        sys.exit("--size needs a value, e.g. --size 400")
    try:
        size = int(value)
    except ValueError:
        sys.exit(f"--size must be an integer, got {value!r}")
    if size <= 0 or size % shards != 0:
        sys.exit(f"--size must be a positive multiple of the mesh's row axis ({shards}), got {size}")
    return size


def _print_time(render, dev, frames):
    """On a CUDA device: the host-clock ms per frame of N_TIMED more calls
    of render() (each `frames` frames, replayed), closed by a synchronize."""
    if dev.type != "cuda":
        return
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        render()
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / (N_TIMED * frames)
    print(f"{ms:.3f} ms per frame ({N_TIMED * frames} frames replayed on {torch.cuda.get_device_name(dev)})")


def main(argv=None):
    ap = argparse.ArgumentParser(description="render a row-sharded shadow frame")
    ap.add_argument("asset_dir", nargs="?", help="asset directory (default: procedural stand-in)")
    ap.add_argument("--out", default="sharded.png", help="output PNG (default sharded.png)")
    ap.add_argument("--size", nargs="?", const=None, default="800", help="frame size N (NxN)")
    ap.add_argument("--shards", type=int, default=5, help="row shards (default 5)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="kernel", choices=("kernel", "dense"))
    ap.add_argument("--replicate-pass1", action="store_true",
                    help="full-height light pass on every shard instead of the gathered map")
    ap.add_argument("--pipelined", action="store_true",
                    help="a 3-frame orbit through the two-pass pipeline-parallel path")
    args = ap.parse_args(argv)
    if args.shards < 1:
        sys.exit(f"--shards must be positive, got {args.shards}")
    size = _size(args.size, args.shards)
    if args.replicate_pass1 and args.pipelined:
        sys.exit(
            "--replicate-pass1 and --pipelined are mutually exclusive "
            "(replicate_pass1 is a pass-1 strategy; the pipelined path "
            "splits the passes across mesh stages instead)"
        )

    from .. import RenderConfig, load_model
    from ..app import flagship_model
    from ..convert import scene_arrays, to_tensor
    from ..ops.vertex import expand_geometry
    from ..parallel import make_pp_mesh, make_row_mesh, render_frame_sharded, render_sequence_pipelined
    from ..utils.png import write_png

    model = load_model(args.asset_dir, verbose=False) if args.asset_dir else flagship_model()
    dev = torch.device(args.device)
    m = model.mesh
    geom, tex = scene_arrays(
        {"positions": m.positions, "tex_coords": m.tex_coords, "normals": m.normals,
         "pos_idx": m.pos_idx, "tex_idx": m.tex_idx, "normal_idx": m.normal_idx},
        {"texture": model.texture, "normal_map": model.normal_map,
         "normal_map_tangent": model.normal_map_tangent, "specular_map": model.specular_map},
        dev,
    )
    geom = expand_geometry(geom)
    look_at = torch.zeros(3, dtype=torch.float32, device=dev)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    cfg = RenderConfig(width=size, height=size, replicate_pass1=args.replicate_pass1)

    try:
        if args.pipelined:
            mesh = make_pp_mesh([dev] * (2 * args.shards))
            print(f"pp mesh: {mesh.shape} over {2 * args.shards} shards on {dev}")
            angles = np.linspace(0.0, 0.9, N_PIPELINED, dtype=np.float32)
            lights = to_tensor(np.stack([[np.sin(a + 0.35), 0.0, np.cos(a + 0.35)] for a in angles])
                               .astype(np.float32), dev)
            froms = to_tensor(np.stack([[np.sin(a + 0.25), 0.0, np.cos(a + 0.25)] for a in angles])
                              .astype(np.float32), dev)

            def render():
                return render_sequence_pipelined(geom, tex, lights, froms, look_at, up,
                                                 pipeline="shadow", config=cfg, mesh=mesh,
                                                 backend=args.backend)

            result = render()
            _print_time(render, dev, N_PIPELINED)
            base, ext = os.path.splitext(args.out)
            for i in range(N_PIPELINED):
                write_png(f"{base}-{i}{ext}", result["frame"][i].cpu().numpy()[::-1])  # presentation flip
                print(f"wrote {base}-{i}{ext}")
            print(f"overflow={result['overflow'].cpu().tolist()}")
            return
        mesh = make_row_mesh([dev] * args.shards)
        print(f"mesh: {mesh.shape} over {args.shards} shards on {dev}")
        light, look_from = to_tensor(np.float32(LIGHT), dev), to_tensor(np.float32(LOOK_FROM), dev)

        def render():
            return render_frame_sharded(geom, tex, light, look_from, look_at, up, pipeline="shadow",
                                        config=cfg, mesh=mesh, backend=args.backend)

        result = render()
        _print_time(render, dev, 1)
    except ValueError as e:  # a shard height the tile grid cannot take
        sys.exit(str(e))
    frame = result["frame"].cpu().numpy()[::-1]  # presentation flip
    write_png(args.out, frame)
    print(f"wrote {args.out} ({frame.shape[1]}x{frame.shape[0]}, "
          f"overflow={bool(result['overflow'])})")


if __name__ == "__main__":
    main()
