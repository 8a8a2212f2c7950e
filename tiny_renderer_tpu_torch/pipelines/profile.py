"""Per-stage time breakdown of a frame (``tiny_renderer_tpu.pipelines.profile``).

A frame is hundreds of eager launches, so neither the host clock nor one
kernel's time attributes it.  This module runs CUMULATIVE PREFIXES of
render_frame — vertex (the uniforms included) | + binning | + raster | the
full frame with needs_z=False (the burst posture) — each taking the same
branches render_frame takes for the scene's pipeline, config and raster
backend (the binning prefix bins the row bands the raster bins), and
reports the differences between consecutive prefixes as stage costs, with
the uniforms alone (the matrix stack, part of the vertex stage) and the
device-to-host frame fetch timed on their own.  The dense backend has no
binning stage: its prefixes are vertex | + raster | full.

Protocol: each prefix runs once to warm up, then `iters` times over
slightly different camera/light angles.  On a GPU the run is timed twice:
between two CUDA events (the device's span from the first launch to the
last) and by the host clock up to a device synchronize; a host-bound frame
shows the two close together.  On a GPU each prefix is then also captured
as a CUDA graph (pipelines.graphs, the counterpart of the JAX module's
_scan_prefix_fn: the prefix as one compiled program) and its replays over
the same angles are timed the same two ways: the stage costs of the path
that Scene, the bursts and the bench run.  On the CPU only the host clock
of the eager prefixes exists.  Prefixes are separate runs, so the deltas
are attributions, not a schedule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import mathlib as ml
from ..ops.binning import bin_triangles
from ..ops.vertex import triangle_setup
from ..utils.timing import StageTimer
from .graphs import CapturedGraph
from .frame import (
    PIPELINES,
    _band_plan,
    _check_config,
    _fused_raster,
    _planes_spec,
    _rasterize,
    _strip_mask_len,
    _use_fused_raster,
    render_frame,
)
from .shaders import kernel_varying_spec

STAGES = ("vertex", "bin", "raster", "full")
STAGE_LABELS = {
    "vertex": "vertex setup",
    "bin": "+ binning",
    "raster": "+ raster",
    "full": "+ shade (full frame)",
}


def stages(backend="kernel"):
    """The prefixes profiled on a raster backend: no binning on "dense"."""
    return STAGES if backend == "kernel" else tuple(s for s in STAGES if s != "bin")


def _prefix_fn(pipeline, config, stage, backend="kernel"):
    """fn(geom, textures, light_direction, look_from, look_at, up) running
    render_frame up to `stage` (one of stages(backend), or "uniforms": the
    matrix stack alone) with render_frame's branch choices."""
    spec = PIPELINES[pipeline]

    def fn(geom, textures, light_direction, look_from, look_at, up):
        if stage == "uniforms":
            if spec.two_pass:
                ml.shadow_pass_1_prepare(config, light_direction, look_at, up)
                return ml.shadow_pass_2_prepare(config, light_direction, look_from, look_at, up)
            return ml.default_prepare(config, light_direction, look_from, look_at, up)
        if stage == "full":
            return render_frame(geom, textures, light_direction, look_from, look_at, up,
                                pipeline=pipeline, config=config, needs_z=False,
                                backend=backend)["frame"]
        setup1 = None
        if spec.two_pass:
            u1 = ml.shadow_pass_1_prepare(config, light_direction, look_at, up)
            setup1 = triangle_setup(geom, u1, config, matrix_key="shadow_matrix", cull=False)
            uniforms = ml.shadow_pass_2_prepare(config, light_direction, look_from, look_at, up)
        else:
            uniforms = ml.default_prepare(config, light_direction, look_from, look_at, up)
        setup = triangle_setup(geom, uniforms, config, needs=spec.needs)
        # The camera pass bins and rasters the spec render_frame gives it:
        # no varying lanes for the strip shade (the planes spec under
        # strip_planes), the kernel spec for the full-screen shade, none on
        # the dense backend.
        compact = backend == "kernel" and config.compact_shade
        pspec = _planes_spec(pipeline, textures, config) if compact else None
        if compact:
            kspec = pspec or ()
        elif backend == "kernel":
            kspec = kernel_varying_spec(pipeline, textures, tile=config.tex_tile)
        else:
            kspec = ()
        if stage == "vertex":
            return setup["rx"]
        if stage == "bin":
            light = ((setup1, ()),) if setup1 is not None else ()
            for s, sp in light + ((setup, kspec),):
                for t0, _, band in _band_plan(s, config):
                    out = bin_triangles(s, band, sp, row_tile_offset=t0)[0]
            return out
        if _use_fused_raster(spec, config, backend, setup, pspec, needs_z=False):
            return _fused_raster(setup1, setup, config)[1]
        if setup1 is not None:
            _rasterize(setup1, config, backend, emit_idx=False)
        return _rasterize(setup, config, backend, spec=kspec, emit_z=False,
                          emit_strips=_strip_mask_len(config) if compact else 0)[1]

    return fn


def _views(n, device):
    """n (light_direction, look_from, look_at, up) tuples on `device`, the
    camera and light stepping 1e-4 rad per frame around a fixed pose."""
    look_at = torch.zeros(3, dtype=torch.float32, device=device)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=device)
    out = []
    for i in range(n):
        ca, la = np.float32(0.35 + 1e-4 * i), np.float32(-0.6 + 1e-4 * i)
        light = torch.tensor([np.sin(la), 0.0, np.cos(la)], dtype=torch.float32, device=device)
        look_from = torch.tensor([np.sin(ca), 0.0, np.cos(ca)], dtype=torch.float32, device=device)
        out.append((light, look_from, look_at, up))
    return out


def stage_breakdown(scene, iters: int = 12):
    """Per-stage ms of a Scene's pipeline, config, raster backend and device.

    Returns (deltas, cumulative): dicts of stage (stages(scene.backend)) ->
    {"host": ms, "device": ms, "graph_host": ms, "graph_device": ms}, per
    frame: the eager prefix by the host clock and by CUDA events, and its
    replayed CUDA graph the same two ways (every value but "host" None on
    the CPU).  deltas attribute each stage's share; deltas["uniforms"] is
    the part of the vertex stage spent in the matrix stack,
    deltas["fetch"] the device-to-host copy of one frame
    (Scene.get_frame_buffer, no graph)."""
    geom, textures = scene._geom, scene._textures
    pipeline, config, backend = scene.pipeline_name, scene.config, scene.backend
    _check_config(config, pipeline, backend)
    cuda = scene.device.type == "cuda"
    anchor = geom["pos_tri"]  # StageTimer synchronizes this tensor's device
    views = _views(iters, scene.device)
    timer = StageTimer()

    def clock(name, run, n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2)) if cuda else (None, None)
        scene.synchronize()
        with timer.stage(name, sync=anchor):
            if cuda:
                start.record()
            run()
            if cuda:
                end.record()
        return {"host": timer.totals[name] * 1e3 / n,
                "device": start.elapsed_time(end) / n if cuda else None}

    def eager(name, fn):
        fn(geom, textures, *views[0])  # warm-up
        t = clock(name, lambda: [fn(geom, textures, *v) for v in views], iters)
        t["graph_host"] = t["graph_device"] = None
        return t

    def replayed(name, fn, t):
        graph = CapturedGraph(lambda *v: fn(geom, textures, *v), views[0],
                              f"the {name} prefix of pipeline {pipeline!r}",
                              hold=(*geom.values(), *textures.values()))
        g = clock(f"{name} graph", lambda: [graph(*v) for v in views], iters)
        t["graph_host"], t["graph_device"] = g["host"], g["device"]

    fns = {stage: _prefix_fn(pipeline, config, stage, backend) for stage in stages(backend)}
    fns["uniforms"] = _prefix_fn(pipeline, config, "uniforms")
    # Every eager prefix first: a capture empties the allocator's cache,
    # which an eager run timed after it would pay to refill.
    times = {name: eager(name, fn) for name, fn in fns.items()}
    if cuda:
        for name, fn in fns.items():
            replayed(name, fn, times[name])
    uniforms = times.pop("uniforms")
    cumulative = times
    scene.render()
    n_fetch = max(2, iters // 2)
    fetch = clock("fetch", lambda: [scene.get_frame_buffer() for _ in range(n_fetch)], n_fetch)
    fetch["graph_host"] = fetch["graph_device"] = None

    deltas, prev = {}, dict.fromkeys(uniforms, 0.0)
    for stage in cumulative:
        deltas[stage] = {k: None if v is None else v - prev[k] for k, v in cumulative[stage].items()}
        prev = cumulative[stage]
    deltas["uniforms"] = uniforms
    deltas["fetch"] = fetch
    return deltas, cumulative


def print_stage_breakdown(scene, iters: int = 6, out=print):
    """Print stage_breakdown: on a GPU CUDA-event and host-clock ms per
    stage, eager and replayed as a CUDA graph; host-clock ms on the CPU.
    Returns the deltas."""
    deltas, cumulative = stage_breakdown(scene, iters)
    cuda = deltas["full"]["device"] is not None
    cfg = scene.config
    out(f"per-stage time of '{scene.pipeline_name}' at {cfg.width}x{cfg.height} on {scene.device} "
        f"({scene.backend} raster), "
        f"{iters} frames per prefix (cumulative-prefix deltas, ms per frame; "
        + ("CUDA events | host clock, eager || replayed CUDA graph):" if cuda else "host clock):"))

    def fmt(t):
        if not cuda:
            return f"{t['host']:8.3f}"
        graph = ("        - |        -" if t["graph_device"] is None
                 else f"{t['graph_device']:8.3f} | {t['graph_host']:8.3f}")
        return f"{t['device']:8.3f} | {t['host']:8.3f} || {graph}"

    for stage in stages(scene.backend):
        out(f"  {STAGE_LABELS[stage]:22s} {fmt(deltas[stage])} ms"
            f"   (prefix total {fmt(cumulative[stage])} ms)")
        if stage == "vertex":
            out(f"    {'of which uniforms':20s} {fmt(deltas['uniforms'])} ms")
    out(f"  {'frame fetch (blit)':22s} {fmt(deltas['fetch'])} ms")
    return deltas
