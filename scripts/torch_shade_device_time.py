#!/usr/bin/env python3
"""Device time of the torch port's strip shade alone, on one NVIDIA GPU.

    PYTHONPATH=<tree> python3 scripts/torch_shade_device_time.py [--calls 10]
        [--pipelines shadow occlusion] [--chunk-ends 1 1/8,1/4,1/2,1 ...]

Imports `tiny_renderer_tpu_torch` from the tree PYTHONPATH names, so two
trees of the port (two commits) run the same measurement.  For each
pipeline it builds a Scene at 800x800 (default config) of three models,
one per coverage: "none" (the flagship stand-in moved 5 units up, no
triangle on screen), "stock" (the flagship stand-in) and "all" (a wall of
make_grid() that covers every strip), computes the strip shade's inputs
with the frame path's own steps (uniforms, vertex stage, light pass,
camera raster with the strip and plane outputs the config asks for), and
times `frame._shade_strips` alone:
- "eager" (stock coverage only): called eagerly, which runs every chunk of
  slots; three warm-up calls, then `--calls` calls under torch.profiler,
  each after a device synchronize;
- "graph" (each coverage): captured once as a CUDA graph
  (pipelines.graphs.CapturedGraph), where the chunks past the covered
  count are conditional nodes the device skips; `--calls` replays under
  torch.profiler.  Its frame is checked byte-equal to the eager call's.
Every GPU event of a trace (kernels, copies, fills) belongs to the shade, so
their summed duration per call is the shade's device time, host gaps
excluded.  `--chunk-ends` times the graph under other chunk rules
(frame.SHADE_CHUNK_ENDS; "1" is one chunk of every slot, the shade before
the chunks), each in turn.  Prints one JSON line: the tree's path, the
card's name and power limit, and per pipeline the device ms, GPU events and
kernels per call, the covered strips and the graph's capture seconds and
MB.  Fails without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from fractions import Fraction

import numpy as np
import torch

PIPELINES = ("default", "phong", "normal_map", "specular", "darboux", "shadow", "occlusion")
VIEW = ([0.3, 0.0, 0.95], [0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
COVERAGES = ("none", "stock", "all")


def coverage_models(model):
    """{coverage: Model} with the model's maps: "none" moves its mesh 5
    units up (off screen and off the light's map), "stock" is the model,
    "all" is a make_grid() wall that covers every strip at VIEW."""
    from tiny_renderer_tpu_torch.models.procedural import make_grid

    up = dataclasses.replace(model.mesh, positions=model.mesh.positions + np.float32([0.0, 5.0, 0.0]))
    return {"none": dataclasses.replace(model, mesh=up), "stock": model,
            "all": dataclasses.replace(model, mesh=make_grid())}


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


def device_time(run, calls, dev):
    """(device ms, GPU events, GPU kernels) per call of run() over `calls`
    calls under torch.profiler, each closed by a synchronize."""
    torch.cuda.synchronize(dev)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
                torch.cuda.synchronize(dev)
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not gpu:
        raise SystemExit("torch_shade_device_time: the trace holds no GPU event")
    return (sum(e["dur"] for e in gpu) / 1e3 / calls, len(gpu) / calls,
            sum(e["cat"] == "kernel" for e in gpu) / calls)


def measure(pmodel, pipelines, calls, dev, rules=(None,)):
    """{pipeline: {coverage: readings}} of the shade at the three coverages;
    `rules`: chunk rules (tuples of SHADE_CHUNK_ENDS, None for the
    module's) whose graphs are timed in turn."""
    from tiny_renderer_tpu_torch import RenderConfig, Scene
    from tiny_renderer_tpu_torch.pipelines import frame
    from tiny_renderer_tpu_torch.pipelines.graphs import CapturedGraph

    view = [torch.tensor(np.float32(v), device=dev) for v in VIEW]
    models = coverage_models(pmodel)
    default_rule = frame.SHADE_CHUNK_ENDS
    out = {}
    for pipeline in pipelines:
        res = out[pipeline] = {}
        for cov in COVERAGES:
            scene = Scene(models[cov], pipeline, RenderConfig(), device=dev)
            cfg = scene.config
            sargs, skw = shade_inputs(scene, view)
            covered = int((sargs[1] >= 0).reshape(-1, cfg.strip_len).any(-1).sum())
            n_strips = -(-cfg.width * cfg.height // cfg.strip_len)
            r = res[cov] = {"covered_strips": covered, "strips": n_strips,
                            "slots": -(-n_strips // cfg.strip_batch) * cfg.strip_batch}
            eager = frame._shade_strips(*sargs, **skw)
            if cov == "stock":
                for _ in range(2):
                    frame._shade_strips(*sargs, **skw)
                ms, ev, kn = device_time(lambda: frame._shade_strips(*sargs, **skw), calls, dev)
                r["eager"] = {"device_ms": ms, "gpu_events": ev, "kernels": kn}
            for rule in rules:
                frame.SHADE_CHUNK_ENDS = default_rule if rule is None else rule
                try:
                    graph = CapturedGraph(lambda: frame._shade_strips(*sargs, **skw), (), "the strip shade",
                                          device=dev)
                    graph()
                    torch.cuda.synchronize(dev)
                    if not torch.equal(graph.outputs, eager):
                        raise SystemExit(f"torch_shade_device_time: {pipeline} {cov}: the replayed shade "
                                         "differs from the eager shade")
                    ms, ev, kn = device_time(graph, calls, dev)
                    bounds = frame.shade_chunks(r["slots"], cfg.strip_batch)
                finally:
                    frame.SHADE_CHUNK_ENDS = default_rule
                name = "graph" if rule is None else "graph " + ",".join(str(Fraction(f)) for f in rule)
                r[name] = {"device_ms": ms, "gpu_events": ev, "kernels": kn,
                           "chunks": len(bounds), "chunks_run": sum(s < covered for s, _ in bounds),
                           "capture_s": graph.capture_s, "pool_mb": graph.pool_bytes / 2**20}
                del graph
    return out


def parse_rule(text):
    """"1/8,1/4,1/2,1" -> (0.125, 0.25, 0.5, 1.0)."""
    return tuple(float(Fraction(x)) for x in text.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--pipelines", nargs="+", default=list(PIPELINES))
    ap.add_argument("--chunk-ends", nargs="*", default=[], type=parse_rule,
                    help="other chunk rules to time the graph under, e.g. 1 1/8,1/4,1/2,1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_shade_device_time: no GPU; this measurement needs one")
    import tiny_renderer_tpu_torch as port
    from tiny_renderer_tpu_torch.app import flagship_model

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    model = flagship_model()
    rng = np.random.default_rng(7)  # chip_smoke.py's maps for the normal-mapped pipelines
    maps = {n: rng.integers(0, 256, model.texture.shape, dtype=np.uint8)
            for n in ("normal_map", "normal_map_tangent", "specular_map")}
    pmodel = dataclasses.replace(model, **maps)
    out = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))), "device": smi}
    out.update(measure(pmodel, args.pipelines, args.calls, dev, rules=(None, *args.chunk_ends)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
