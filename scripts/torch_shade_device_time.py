#!/usr/bin/env python3
"""Device time of the torch port's strip shade alone, on one NVIDIA GPU.

    PYTHONPATH=<tree> python3 scripts/torch_shade_device_time.py [--calls 10]

Imports `tiny_renderer_tpu_torch` from the tree PYTHONPATH names, so two
trees of the port (two commits) run the same measurement: builds the
flagship stand-in's Scene at 800x800 (default config) for each pipeline,
computes the strip shade's inputs with the frame path's own steps (uniforms,
vertex stage, light pass, camera raster with the strip and plane outputs
the config asks for), and calls `frame._shade_strips` alone, eagerly: three
warm-up calls, then `--calls` calls under torch.profiler, each after a
device synchronize.  Every GPU event of that trace (kernels, copies, fills)
belongs to the shade, so their summed duration per call is the shade's
device time, host gaps excluded.  Prints one JSON line: the tree's path,
the card's name and power limit, and per pipeline the device ms per call,
the GPU events per call and the covered strips.  Fails without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

PIPELINES = ("default", "phong", "normal_map", "specular", "darboux", "shadow", "occlusion")
VIEW = ([0.3, 0.0, 0.95], [0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])


def shade_inputs(scene, view):
    """(args, kwargs) of frame._shade_strips for the scene's frame at `view`."""
    from tiny_renderer_tpu_torch.ops.mathlib import F32_MIN
    from tiny_renderer_tpu_torch.ops.vertex import triangle_setup
    from tiny_renderer_tpu_torch.pipelines import frame

    cfg, pipeline = scene.config, scene.pipeline_name
    spec = frame.PIPELINES[pipeline]
    geom, textures = scene._geom, scene._textures
    u1, uniforms = frame._uniforms(spec, cfg, *view)
    setup = triangle_setup(geom, uniforms, cfg, needs=spec.needs)
    if spec.two_pass:
        setup1 = triangle_setup(geom, u1, cfg, matrix_key="shadow_matrix", cull=False)
        shadow_z = frame._light_pass(setup1, cfg, "kernel")[0]
    else:
        shadow_z = torch.full((cfg.height, cfg.width), F32_MIN, device=view[0].device)
    kspec = frame._planes_spec(pipeline, textures, cfg) or ()
    _, idx, varys, strips, _ = frame._rasterize(setup, cfg, "kernel", spec=kspec, emit_z=False,
                                                emit_strips=frame._strip_mask_len(cfg))
    args = (setup, idx, pipeline, uniforms, frame._with_packed_plane(textures, pipeline, cfg), cfg,
            frame._shadow_for_shade(shadow_z, spec, cfg))
    return args, dict(strip_mask=strips, planes=varys, planes_spec=kspec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--pipelines", nargs="+", default=list(PIPELINES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_shade_device_time: no GPU; this measurement needs one")
    import tiny_renderer_tpu_torch as port
    from tiny_renderer_tpu_torch import RenderConfig, Scene
    from tiny_renderer_tpu_torch.app import flagship_model
    from tiny_renderer_tpu_torch.pipelines import frame

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    model = flagship_model()
    rng = np.random.default_rng(7)  # chip_smoke.py's maps for the normal-mapped pipelines
    maps = {n: rng.integers(0, 256, model.texture.shape, dtype=np.uint8)
            for n in ("normal_map", "normal_map_tangent", "specular_map")}
    pmodel = dataclasses.replace(model, **maps)
    view = [torch.tensor(np.float32(v), device=dev) for v in VIEW]
    out = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))), "device": smi}
    for pipeline in args.pipelines:
        scene = Scene(pmodel, pipeline, RenderConfig(), device=dev)
        sargs, skw = shade_inputs(scene, view)
        covered = int((sargs[1] >= 0).reshape(-1, scene.config.strip_len).any(-1).sum())
        for _ in range(3):
            frame._shade_strips(*sargs, **skw)
        torch.cuda.synchronize(dev)
        with tempfile.TemporaryDirectory() as tmp:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(args.calls):
                    frame._shade_strips(*sargs, **skw)
                    torch.cuda.synchronize(dev)
            prof.export_chrome_trace(f"{tmp}/trace.json")
            with open(f"{tmp}/trace.json") as f:
                events = json.load(f)["traceEvents"]
        gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if not gpu:
            raise SystemExit(f"torch_shade_device_time: the trace of {pipeline} holds no GPU event")
        out[pipeline] = {"device_ms": sum(e["dur"] for e in gpu) / 1e3 / args.calls,
                         "gpu_events": len(gpu) / args.calls, "covered_strips": covered,
                         "strips": scene.config.width * scene.config.height // scene.config.strip_len}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
