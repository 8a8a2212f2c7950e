#!/usr/bin/env python3
"""Drive the torch port's frame paths (all seven pipelines) on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases (each prints a line; any failure raises, so the exit code is not 0):

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the raster kernels (csrc/raster.cu) with nvcc for sm_90a,
             their probe build and the graphs' IF nodes (csrc/graph_if.cu)
             beside them, all three at once, and print ptxas's
             registers/spills for every instantiation.
2b. vertex — csrc/vertex.cu (the vertex layer's prepare and setup kernels):
             each prepare's uniforms and every triangle_setup field
             bit-equal to the plain torch versions on the card over 64
             orbit, random and near-degenerate poses, every pipeline's
             needs and glow's attr:*; Scene.render of every pipeline and a
             60-frame burst byte-equal to the plain layer's eager frames;
             vertex launches per replay; kernels a frame and the layer's
             time against the plain layer's (vertex_phase).
2c. occlusion — csrc/occlusion.cu (the occlusion probe, one thread a
             fragment): the kernel bit-equal to shaders.occlusion_reference
             on the card under orbit, random and degenerate lights (its
             frame constants), on adversarial fragments (NaN, +-inf, far off
             the plane, exact halves; 1, 16 and 33 samples, the swizzled
             plane on and off) and on the 800x800 frame's chunk fragments;
             Scene.render and a 60-frame render_sequence byte-equal to the
             plain probe's eager frames under the default config and
             compact_shade=False; in the profiler one occlusion kernel ran
             a replayed frame, and kernels a frame; occlusion launches
             recorded a replayed frame (one a chunk body in the graph) and
             none for shadow; the kernel's device ms alone and in a graph
             beside its bound (occlusion_phase, runnable alone).
2d. darboux — csrc/darboux.cu (the darboux strip chunk body, one thread a
             fragment): frames byte-equal to the torch chunk body's on the
             card at the 800x800 cell's orbit poses under tex_tile 16 and 0,
             strip_pack_words on and off, the int16 idx plane and bodies of
             fill slots; row slabs at a first row > 0; degenerate normals
             (NaN, singular bases); seeded synthetic chunks (NaN/inf setup
             columns, uncovered lanes, fill slots); Scene.render and a
             60-frame render_sequence byte-equal to the torch body's eager
             frames, launches recorded a replayed frame (one a chunk body,
             none under compact_shade=False); in the profiler one darboux
             kernel ran a replayed frame, kernels a frame and
             darboux_launches; the kernel's device ms and the strip shade
             replayed with it and with the torch body, beside its bound
             (darboux_phase, runnable alone).
3. kernel  — every kernel mode against its plain torch twin on seeded random
             soups, the depth tie case, the flagship scene's two passes and
             five adversarial screen-space scenes (large and huge triangles,
             one-pixel triangles and slivers on rect, sub-tile and bin-tile
             borders, a hot bin tile of 2,000 triangles, exact z ties across
             borders, -0.0 against +0.0 depths), bit-identical (float
             outputs compared as bits): K1 phase 1 (z, idx, z+idx), the
             gathered record layout, the int16 index target, the strip plane
             (SL 8, 16, and 64 and 24 across sub-tile borders), phase 2
             with shadow's kernel spec (tex_tile 0 and 16) and with a spec
             of const and interp planes, K2 (both passes in one launch), and
             the all-on knob config's two launches on its 16x128 tiles
             (gathered + int16 + strips + planes in one camera launch).
             On the random soups and the flagship also phase 2 under the
             other pipelines' specs: normal_map's, specular's and darboux's
             kernel specs (texel index over 2 or 3 packed maps, darboux's
             3-component local_z) at tex_tile 0 and 16, darboux's 15-plane
             reference spec with its four consts (maps of mixed dims), and
             occlusion's zfrag-only spec, and the two-pass custom
             pipeline fog's spec (texel index + zfrag) at tex_tile 0 and 16.
             On each scene's two passes, the rect masks the kernel computes
             (its probe build) equal raster_cuda.cull_masks, the torch
             model of the cull that the work counts below come from.
4. slice   — Scene.render plus a 16-frame 800x800 shadow burst of the
             flagship scene through the public API, each a replayed CUDA
             graph: two kernel launches per frame (and per capture's eager
             warm-up frame), no black frame, no overflow, frames
             bit-identical to the same frames rendered eagerly with the
             twin as raster, and a frame within the 0.5% tie budget of the
             same frame rendered on the CPU.
5. pipelines — for each of the six other pipelines (default, phong,
             normal_map, specular, darboux, occlusion) at 800x800, default
             config, on the flagship scene with seeded random normal,
             tangent-normal and specular maps: Scene.render with z and an
             8-frame burst (replayed graphs), one K1 launch per frame (two
             for occlusion), no black frame, no overflow, render and burst
             bit-identical to the eager frames with the twin raster, and
             the frame within the 0.5% tie budget of the same frame on the
             CPU.
6. knobs   — the same shadow burst (first 4 angles) under each raster knob config
             (fuse_passes, strip_mask + strip_planes, idx_int16,
             csr_indirect=False + strip_mask, compact_shade=False,
             shadow_tile=8 + fuse_passes, all on): frames bit-identical to
             the default burst, with the launches each config implies;
             compact_shade=False also through Scene.render (z, frame, shadow
             equal to the default Scene.render).  Then 4 frames of each
             other pipeline under compact_shade=False (darboux through its
             const gather), strip_mask + strip_planes (all but darboux) and
             fuse_passes (occlusion): each equal to that pipeline's default
             burst, with the launches each config implies; and darboux
             with 512^2 normal maps, whose full-screen shade (the 15-plane
             reference spec) must equal its strip shade (per-map samplers).
7. graph   — the frame and the burst as replayed CUDA graphs
             (pipelines/graphs.py) for the seven pipelines under every knob
             config above and the custom toon, fog (default, fuse_passes,
             strip_mask + strip_planes) and glow: Scene.render byte-equal
             to the eager render_frame at three poses with the eager launch
             counts per replay; a 64-frame replayed burst's checksums and
             overflow flags equal to the eager burst's, with its launches
             (occlusion under occlusion_dedup also equal to its default
             burst's);
             torch.cuda.set_sync_debug_mode("error") silent around a replay
             and a burst; a pipeline re-registered with another shade
             renders the new shade through a new Scene and burst.  Prints
             the capture seconds and the memory reserved per graph, ms per
             frame of eager against replayed bursts and host loops per
             pipeline, and under torch.profiler over replayed shadow bursts
             (captured before the trace) the device's idle share and each
             mode's K1/K2 device ms per launch inside the graph.
8. shade   — the strip shade's covered-count chunks as IF nodes of the
             replayed graphs (frame.shade_chunks, graphs.device_if, built
             from csrc/graph_if.cu), at three coverages: the flagship moved
             off screen (no covered strip), the stock pose, and a wall that
             covers every strip.  For the seven pipelines, occlusion under
             occlusion_dedup (the same kernel on the card) and shadow
             under strip_mask + strip_planes + nopack: the replayed
             Scene.render byte-equal to the eager render_frame and a
             4-frame replayed burst's frames to the eager burst's; the
             sharded SHARD_CONFIGS replayed, byte-equal to the eager
             sharded frame and to render_frame.  torch.profiler over
             replayed shadow frames: GPU kernels per frame at each coverage
             and the chunk bodies run (none at count 0, the chunk rule's
             number elsewhere).  The replayed shade alone (device ms,
             scripts/torch_shade_device_time.py) at each coverage, beside
             one chunk of every slot and the earlier all-slots time; capture
             seconds and MB per graph.
9. parallel — the scale-out path (parallel.sharding).  On the random soups
             and the flagship, every kernel mode on a band of 5 tile rows
             at row tile offsets 1, 3 and the last band, binned for that
             band (K1 z, idx, z+idx, int16, strips SL 8 and 16, phase 2
             under shadow's spec, gathered records; K2): bit-identical to
             its twin and to the same rows of the full-frame launch.  The
             flagship shadow frame at 800x800 on 5 row shards of one card
             (make_row_mesh([cuda:0] * 5)) under the default config,
             fuse_passes, replicate_pass1, shard_triangles, needs_z=False
             and strips + planes, replayed as segment graphs (captured at
             the first call, one per segment between collectives): frame,
             z, shadow and overflow bit-identical to the eager sharded
             frame (the same segments run eagerly) and to render_frame at
             two poses, the second capturing nothing, with 5 K1 launches
             per pass per replay (5 K2 under fuse_passes) and
             set_sync_debug_mode("error") silent around a replay.
             render_batch_sharded (phong, 4 frames, 2 x 5 mesh) and
             render_sequence_pipelined (shadow, 3 frames, 2 stages x 5
             rows), replayed, at two sets of poses: every frame equal to
             the eager path's and to its single-device render, launches
             per frame as eager, sync debug mode silent.  The dense
             backend: coverage equal to the kernel's on both passes,
             winners apart on < 0.2% of pixels, the frame within 0.5% of
             the kernel frame, and on 8 shards of 100 rows bit-identical
             to the dense frame.  The sharded example in process with its
             defaults: PNG bytes equal to render_frame's.  Times: capture
             seconds and memory reserved per segment graph; the shadow
             frame on one device and on 5 shards, eager and replayed (in
             turns), and the dense frame (host clock); the batch and
             pipelined ms per frame, eager and replayed; under
             torch.profiler over replayed sharded frames, K1's and K2's
             device ms inside the graphs; the banded K1 and K2 launches
             of one sharded frame (paced, twin, device ms) beside their
             bound and the card's name and power limit.
10. fuzz    — seeded random knob compositions (tests/test_fuzz_configs.py's
             _random_config draw, copied) on random scenes of 100
             triangles at 800x800, one draw per pipeline and two that take
             K2, each with the drawn span caps (binding: overflow flagged)
             and with loose ones (no overflow allowed): the eager frame and
             a 2-frame burst bit-identical to the same with the twins as
             K1 and K2, the replayed frame (make_frame_fn) and burst
             byte-equal to the eager ones at two poses, with the eager
             launches per replay.
11. timing  — kernel and twin ms per launch per mode at the flagship shapes
             (CUDA events around launches paced by the host, as the times
             before the redesign were taken, and the kernel's device time
             with the launch queue held full), beside those earlier times
             (PR2_MS); the cull's work per block; burst
             ms per frame of each knob config beside the default, and of
             each of the seven pipelines at the default config (host clock
             after warm-up, configs in turns); phase 2 under darboux's
             4-plane and 15-plane specs (paced, twin and device times)
             beside its bound;
             beside the card's name and power limit.
12. entry  — the entry points above the frame path, each at 800x800 on the
             flagship scene.  Registry: custom pipelines registered with
             register_pipeline — toon (one pass, uv + intensity), fog
             (two_pass, uv + zfrag, reads the shadow buffer) and glow (the
             user vertex attribute attr:glow) — each through Scene.render
             and an 8-frame burst bit-identical to the twin raster, with 1
             K1 launch per frame (2 for fog), within 0.5% of the CPU frame;
             fog under fuse_passes (1 K2 launch per frame) and under
             strip_mask + strip_planes equal to its default burst; a zeroed
             attr:glow changes the frame.  CLI in process (app.main): a
             shadow orbit with --timing, --save, --dump-z, --dump-shadow;
             toon with --save-seq; shadow with --knob fuse_passes=true;
             every PNG equal to a Scene or render_sequence frame
             at the same angles.  Interactive: run_interactive with a
             scripted viewer and a fake clock ('d' held 5 frames, 'q' 3,
             then Escape), pipelined and serial, the final frame equal to a
             Scene.render at the integrated angles.  Serving: the HTTP frame
             server on a loopback port, /render bytes of shadow and toon
             equal to png_bytes of a direct render, 400 on a bad pipeline or
             angle, /healthz ok.  Prints the stage breakdown of shadow and
             default (CUDA-event and host ms per stage), ms per served
             request and interactive ms per frame.
13. capacity — the capacity scale.  The flagship stand-in written to a
             temporary directory (model.obj and four 1024^2 TGAs, the
             texture RLE-coded), loaded by load_model on the native path
             (assets/native.py, g++-built; the NumPy parsers patched to
             fail) and equal to the NumPy load, then subdivided twice by
             subdivide_mesh: 81,536 triangles.  K1 z, idx and z+idx on
             both passes (int32 index target) and on the 4 tile-row bands
             of row_bands=4, bit-identical to the twins and to the full
             frame's rows.  Phong and shadow at 800x800 through Scene.render
             and a 2-frame burst under row_bands 0, 4 and 25 (shadow also
             under fuse_passes with 0 and 4): the one-band render equal to
             the twin raster, every banded render bit-identical to it, R
             K1 launches per pass and no K2 under bands, no overflow.  The
             flagship through Scene(backend="dense") and app.main --raster
             dense: no kernel launch, coverage equal to the kernel frame's,
             within the 0.5% tie budget, the PNG equal to the Scene's.
             Times: K1 per frame at capacity and under row_bands=4 (paced,
             twin, device) beside their bounds, each pass's device ms, and
             the capacity frames (burst ms/frame and Scene.render latency)
             in turns with the flagship's shadow frame.
14. trace  — the tracer (utils/timing.py) on the benchmark cell's 800x800
             shadow scene: 8 Scene.render frames and a 60-frame
             render_sequence byte-equal with the tracer off and on; the
             drained frames numbered in turn, none dropped, each credited
             to its call, every stamped covered count equal to the eager
             strip shade's at the same pose; torch.profiler counts 7 mark
             kernels a frame (8 a burst frame) and shows the program's
             spans as host ranges.
14b. sequence — render_sequence's frames returned through pinned host
             memory, a frame's copy on the copy stream behind the next
             replay, on the two burst cells' 800x800 shadow and occlusion
             scenes: three back-to-back 60-frame calls, every array held,
             each byte-equal to the burst's kept frames fetched by .cpu(),
             the first unchanged under the later calls; the counter
             sequence.overlapped 59 a call with the tracer on, the frames
             byte-equal with it off and on.  Prints ms a frame of the
             closed loop against one pageable .cpu() after the burst, in
             turns (sequence_phase, runnable alone).
15. profile — the CLI with --profile (torch.profiler): the trace's GPU
             kernels and the device's idle share over 4 shadow frames, and
             the shadow frame by the stage profile before and after the
             profiler ran (the last phase).

Each phase prints its seconds and the most device memory reserved in it.  Launch counts are set to 0 just before each
path is driven and read just after (the kernels line's launches_by_pipeline
includes the custom pipelines toon, fog and glow, the sharded paths and the
capacity scene).  Prints a JSON line of kernel results
(time paced by the host as "ms", device time as "device_ms", launches in
all the paths driven and by pipeline, the pipelines whose paths launched
it, error, and the bound: the larger of the work's fp32 operations over 67 TFLOP/s and its bytes
over 3.35 TB/s, counted from this run's binned inputs, with phase 1's
operations only at the pixels inside each candidate's bbox), then, last, the
device JSON line.  The scene is diablo when assets/diablo exists, else a UV
sphere of the same size (5,096 triangles, 1024^2 maps) made from fixed
parameters.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

N_FRAMES = 16
N_KNOB_FRAMES = 4
N_PIPE_FRAMES = 8
PIPELINE_ORDER = ("default", "phong", "normal_map", "specular", "darboux", "shadow", "occlusion")
NEW_PIPELINES = tuple(p for p in PIPELINE_ORDER if p != "shadow")
# Custom pipelines of the entry phase and their K1 launches per frame.
CUSTOM_LAUNCHES = {"toon": {"raster": 1}, "fog": {"raster": 2}, "glow": {"raster": 1}}
FOG_SPEC = (("uv", 2, "interp"), ("zfrag", 1, "zfrag"))
# Interactive script: after the frame shown at each index, these key events.
# 'd' is held while frames 1-5 integrate, 'q' while frames 6-8 do.
KEY_SCRIPT = {0: [("press", "d")], 5: [("release", "d"), ("press", "q")],
              8: [("release", "q"), ("press", "escape")]}
DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
VIEW = ([0.3, 0.0, 0.95], [0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
VIEW2 = ([-0.45, 0.0, 0.89], [0.38, 0.15, 0.91], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])  # another light and camera
MODES = {"z": dict(emit_z=True, emit_idx=False), "idx": dict(emit_z=False, emit_idx=True),
         "z+idx": dict(emit_z=True, emit_idx=True)}
# A varying spec with every plane mode: interp (uv), const (row0, du), zfrag.
CONST_SPEC = (("uv", 2, "interp"), ("row0", 3, "const"), ("du", 2, "const"), ("zfrag", 1, "zfrag"))
# Raster knob configs of the knob phase and the launches each makes per
# frame of a burst (every other count 0).
KNOBS = {
    "fuse": (dict(fuse_passes=True), {"fused": 1}),
    "mask+planes": (dict(strip_mask=True, strip_planes=True),
                    {"raster": 2, "strips": 1, "planes": 1}),
    "i16": (dict(idx_int16=True), {"raster": 2, "int16": 1}),
    "nocsr+mask": (dict(csr_indirect=False, strip_mask=True),
                   {"raster": 2, "gathered": 2, "strips": 1}),
    "fullplane": (dict(compact_shade=False), {"raster": 2, "planes": 1}),
    "sswz8+fuse": (dict(shadow_tile=8, fuse_passes=True), {"fused": 1}),
    "all-on": (dict(fuse_passes=True, strip_mask=True, strip_planes=True, idx_int16=True,
                    csr_indirect=False, tile_h=16, tex_tile=16, shadow_tile=16),
               {"raster": 2, "gathered": 2, "int16": 1, "strips": 1, "planes": 1}),
}


def pipeline_launches(name):
    """K1 launches per frame of a pipeline's default burst: the camera pass,
    and the light pass first for the two-pass pipelines."""
    return {"raster": 2 if name in ("shadow", "occlusion") else 1}


def pipeline_knobs(name):
    """The knob configs the knob phase drives for one of the other
    pipelines and the launches each makes per frame (every other count 0):
    the full-screen shade, the strip plane + varying planes for the strip
    shade (not darboux, whose per-triangle consts keep the attribute
    gather), and K2 for occlusion."""
    cam = pipeline_launches(name)
    knobs = {"fullplane": (dict(compact_shade=False), {**cam, "planes": 1})}
    if name != "darboux":
        knobs["mask+planes"] = (dict(strip_mask=True, strip_planes=True),
                                {**cam, "strips": 1, "planes": 1})
    if name == "occlusion":
        knobs["fuse"] = (dict(fuse_passes=True), {"fused": 1})
    return knobs


# The parallel phase: 800 rows over 5 shards of 160 rows (5 tile rows of
# 32), a band of that many tile rows at each offset of BAND_OFFSETS ("last":
# the frame's last band), and the sharded configs with the launches each
# makes per frame (every other count 0).
ROW_SHARDS = 5
BAND_TILE_ROWS = 5
BAND_OFFSETS = (1, 3, "last")
SHARD_CONFIGS = {
    "default": ({}, True, {"raster": 10, "offset": 8}),
    "fuse_passes": (dict(fuse_passes=True), False, {"fused": 5, "fused_offset": 4}),
    "replicate_pass1": (dict(replicate_pass1=True), True, {"raster": 10, "offset": 4}),
    "shard_triangles": (dict(shard_triangles=True), True, {"raster": 10, "offset": 8}),
    "needs_z=False": ({}, False, {"raster": 10, "offset": 8}),
    "strips+planes": (dict(strip_mask=True, strip_planes=True), True,
                      {"raster": 10, "offset": 8, "strips": 5, "planes": 5}),
}
N_BATCH_FRAMES = 4
N_PP_FRAMES = 3
N_SHARD_TRACED = 4  # replayed sharded frames under the profiler
DENSE_SHARDS = 8  # 8 x 100 rows: the dense backend has no tile grid

PEAK_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
OPS_PER_CANDIDATE = 26  # phase 1 flops per (pixel, candidate) test, csrc/raster.cu
OPS_PHASE2_BASE = 16  # edge functions + exact-division barycentrics per covered pixel
# Phase 2 flops per covered pixel and plane; texidx: two interpolations,
# two scales, the fold (4 per coordinate), then the row-major index (2) or
# the tile swizzle (14).
OPS_PER_PLANE = {"interp": 5, "zfrag": 5, "const": 0, "texidx": 20}
OPS_ROW_MAJOR, OPS_SWIZZLE = 2, 14
# Kernel ms per launch before the walk's redesign (CUDA events around
# launches paced by the host), for comparison.
PR2_LABEL = "PR 2's chip run 4 on NVIDIA H100 80GB HBM3 at 700 W"
PR2_MS = {"light/z": 0.2834, "camera/idx": 0.1425, "camera/z+idx": 0.1426, "gathered": 0.1412,
          "int16": 0.1428, "strips": 0.1456, "planes": 0.1803, "fused": 0.4284}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def shade_fog(frag, uniforms, textures, config):
    """The two-pass custom shade: texture dimmed where the shadow compare
    fails and by depth (zfrag), with the shadow buffer fetched as the
    built-in shadow shade fetches it."""
    from tiny_renderer_tpu_torch.ops import mathlib as ml
    from tiny_renderer_tpu_torch.pipelines import shaders

    sm = ml.mat4_mul(uniforms["shadow_matrix"], uniforms["i_vpmv"])
    p = torch.stack([frag["x"].to(torch.float32), frag["y"].to(torch.float32), frag["zfrag"]], dim=-1)
    sc = ml.mat4_transform_point(sm, p)
    sval = shaders._shadow_fetch(frag["shadow_buffer"], sc[..., 0], sc[..., 1], config.width,
                                 tile=shaders.plane_tile_effective(config, frag["shadow_buffer"].shape))
    lit = torch.where(sc[..., 2] + ml.f32(config.shadow_bias) < sval, ml.f32(0.3), 1.0)
    t = lit * (frag["zfrag"] / ml.f32(config.depth)).clamp(0.0, 1.0)
    color = shaders.sample_frag(textures, frag, ("texture",))["texture"]
    return ml.color_blend(color, torch.zeros(3, dtype=torch.uint8, device=color.device), t)


class ScriptedViewer:
    """A window for run_interactive: records the frames shown and fires
    KEY_SCRIPT's key events after each."""

    def __init__(self, script):
        self.script, self.shown, self.alive = script, 0, True
        self.last = None

    def connect(self, on_press, on_release):
        self._on = {"press": on_press, "release": on_release}

    def show(self, frame):
        self.last = np.array(frame)
        for kind, key in self.script.get(self.shown, []):
            self._on[kind](key)
        self.shown += 1

    def close(self):
        self.alive = False


def fake_clock(dt):
    """A clock that advances dt per call: every frame_time of the
    interactive loop (two calls per frame) is then exactly dt."""
    t = [0.0]

    def clock():
        t[0] += dt
        return t[0]

    return clock


def http_get(url):
    """(status, body) of a GET; error statuses return their body."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def soup(n, seed):
    """Seeded triangle soup in the unit box, geometry-dict layout, with
    varied uv (some outside [0, 1]) so every varying plane varies."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.9, 0.9, (n, 1, 3)).astype(np.float32)
    verts = (centers + rng.uniform(-0.06, 0.06, (n, 3, 3)).astype(np.float32)).reshape(-1, 3)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return {"positions": verts, "tex_coords": rng.uniform(-0.1, 1.1, (3 * n, 2)).astype(np.float32),
            "normals": np.tile(np.float32([0, 0, 1]), (3 * n, 1)),
            "pos_idx": idx, "tex_idx": idx, "normal_idx": idx}


def signed_zero(binned):
    """The binned pass with every record's depth lanes 9-11 set to -0.0 or
    +0.0: in pair k = tri // 2, the first triangle gets -0.0 and the second
    +0.0 when k is even, the other way round when k is odd."""
    records, tris, starts = binned
    tri = records[:, 12].long()
    neg = (tri % 2 == 0) == (tri // 2 % 2 == 0)
    records = records.clone()
    records[:, 9:12] = torch.where(neg, -0.0, 0.0)[:, None]
    return records, tris, starts


def block_work(setup, binned, g):
    """Per kernel block (tile-major, the tile's sub-tiles row-major): the
    candidates its walk stages (its bin tile's list), those that pass its
    sub-tile cull, the pixel tests it makes (32 per 4x8 rect the cull
    leaves; raster_cuda.cull_masks, the torch model of the cull, which the
    kernel phase holds to the kernel's masks), and the (pixel, candidate)
    pairs inside the candidates' inclusive screen bboxes.  No pixel outside the
    bbox can pass the exact integer inside test, so the last are the phase 1
    tests the outputs need."""
    from tiny_renderer_tpu_torch.ops.raster_cuda import SUBTILE, cull_masks

    records, tris, starts = binned
    tile, masks = cull_masks(records, tris, starts, **g)
    dev, nb = starts.device, masks.shape[1]
    (sub_h, sub_w), nbx = SUBTILE, g["tile_w"] // SUBTILE[1]
    b = torch.arange(nb, device=dev)
    key = (tile[:, None] * nb + b).reshape(-1)

    def per_block(v):
        out = torch.zeros((starts.numel() - 1) * nb, dtype=torch.int64, device=dev)
        return out.index_add_(0, key, v.reshape(-1).long())

    slot = torch.arange(int(starts[0]), int(starts[-1]), device=dev)
    tri = (tris[slot] if tris is not None else records[slot, 12]).long()

    def span(lo, hi, origin, size):
        return (torch.minimum(hi[tri][:, None], origin + size - 1)
                - torch.maximum(lo[tri][:, None], origin) + 1).clamp(min=0)

    x0 = (tile % g["tiles_x"] * g["tile_w"])[:, None] + b % nbx * sub_w
    y0 = (tile // g["tiles_x"] * g["tile_h"])[:, None] + b // nbx * sub_h
    inbox = span(setup["x0"], setup["x1"], x0, sub_w) * span(setup["y0"], setup["y1"], y0, sub_h)
    return {"candidates": torch.diff(starts).long().repeat_interleave(nb),
            "survivors": per_block(masks.any(-1)), "tests": 32 * per_block(masks.sum(-1)),
            "bbox": per_block(inbox)}


def bound(passes, out_bytes, planes=(), covered=0):
    """(bound_ms, bound_by, flops, bytes) of a raster launch: phase 1 flops over the
    (pixel, candidate) pairs inside the candidates' bboxes, phase 2 flops per
    covered pixel, against the bytes of the record rows read (13 lanes, plus
    the plane lanes), the id list, the tile offsets and the outputs.  The
    rows read are those the launch's CSR slice references: a band's, or a
    pass's after the cull, not every row of the array."""
    from tiny_renderer_tpu_torch.ops.raster_cuda import PLANE_LANES

    ops, nbytes = 0, out_bytes
    for records, tris, starts, tests in passes:
        n_inc = int(starts[-1] - starts[0])
        ops += tests * OPS_PER_CANDIDATE
        rows = torch.unique(tris[int(starts[0]):int(starts[-1])]).numel() if tris is not None else n_inc
        lanes = max([13] + [lane + PLANE_LANES[m] for m, lane, *_ in planes])
        nbytes += rows * lanes * 4 + starts.numel() * 4 + (n_inc * 4 if tris is not None else 0)
    for mode, _lane, _p, _w, _h, swz in planes:
        extra = (OPS_SWIZZLE if swz else OPS_ROW_MAJOR) if mode == "texidx" else 0
        ops += covered * (OPS_PER_PLANE[mode] + extra)
    ops += covered * OPS_PHASE2_BASE if planes else 0
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def time_launches(fn, n, hold=False):
    """ms per call of fn over n calls, by CUDA events after warm-up: the
    calls as the host paces them, or with hold, the device's work alone
    (the device sleeps while the calls are queued, twice the time the host
    took to queue them at up to 2 GHz, so the queue stays full)."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2 * queued * 2e9))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_ms(fn, n):
    """Best host-clock ms of n calls of fn, each ended by a synchronize."""
    best = float("inf")
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


# The vertex phase: the prepare and setup kernels of csrc/vertex.cu against
# their plain torch versions on the card, the frames they give against the
# eager frames of the plain vertex layer, their launches and their time.
VERTEX_CELL = "diablo-shadow.orbit-burst"
VERTEX_SEED = 2_147_500_018
VERTEX_ORBIT = 32  # orbit poses (the burst's angle track, sin and cos on the card)
VERTEX_RANDOM = 24  # poses of random unit-scale vectors
# Near-degenerate (light, look_from, look_at, up): look_from along up, at
# look_at, a hair off either, a zero up or light, tiny and huge vectors.
VERTEX_DEGENERATE = (
    ([0.3, 0.2, 0.9], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ([0.3, 0.2, 0.9], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ([0.3, 0.2, 0.9], [1e-30, 1.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ([0.3, 0.2, 0.9], [0.0, 1e-7, 1e-7], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ([0.3, 0.2, 0.9], [0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
    ([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ([1e-20, 0.0, 0.0], [1e-3, 1e-3, 1.0], [0.0, 0.0, 0.0], [0.0, 1e-30, 0.0]),
    ([0.3, 0.2, 0.9], [3e4, -2e4, 1e4], [0.1, 0.1, 0.1], [0.0, 1.0, 0.0]),
)
VERTEX_CONFIGS = ((800, 800), (256, 128))
VERTEX_FRAME_POSES = 2  # Scene.render poses a pipeline
VERTEX_TIMED = 200  # replays of the vertex layer's graphs timed by CUDA events
VERTEX_KERNELS = re.compile(r"prepare_kernel|setup_kernel")


def plain_vertex():
    """The vertex layer's plain torch versions (mathlib.prepare_reference,
    vertex.setup_reference) on CUDA tensors too, inside the returned
    context: for eager frames, since a graph captured inside it would be
    cached with the plain layer."""
    from tiny_renderer_tpu_torch.ops import mathlib as ml
    from tiny_renderer_tpu_torch.ops import vertex, vertex_cuda

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        vertex_cuda, "prepare",
        lambda config, *vecs, inverses=False: ml.prepare_reference(config, *vecs, inverses=inverses)))
    stack.enter_context(mock.patch.object(
        vertex_cuda, "setup",
        lambda tris, uniforms, config, exact_max, **kw: vertex.setup_reference(tris, uniforms, config, **kw)))
    return stack


def same_bits(a, b):
    """(equal, NaN payloads that differ) of two tensors: floats compared as
    bits, NaN against NaN by class."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False, 0
    if a.dtype != torch.float32:
        return torch.equal(a, b), 0
    diff = a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)
    both_nan = torch.isnan(a) & torch.isnan(b)
    return not bool((diff & ~both_nan).any()), int((diff & both_nan).sum())


def vertex_phase(dev, smi):
    """Phase 2b: csrc/vertex.cu on the card.  Builds it (ptxas registers
    printed).  Over VERTEX_ORBIT orbit poses, VERTEX_RANDOM random ones and
    the near-degenerate ones, at both VERTEX_CONFIGS: each prepare's
    uniforms (default_prepare, the light pass's, the camera pass's)
    bit-equal to mathlib.prepare_reference on the same CUDA tensors, and
    every triangle_setup field bit-equal to the plain layer's for each
    built-in pipeline's needs and for glow's attr:*, on the benchmark's
    sphere, a soup through the gather path and the soup scaled past the
    exactness envelope (coord_overflow set).  Every launch's
    cudaGetLastError() is 0 (the wrapper raises otherwise) and a
    synchronize after each pose is clean.  Then the seven pipelines and
    glow through Scene.render (replayed) byte-equal to render_frame with
    the plain layer at VERTEX_FRAME_POSES poses, and a replayed 60-frame
    shadow burst (frames, checksums, overflow) byte-equal to the plain
    layer's eager burst, with 2 prepare and 2 setup launches a replayed
    two-pass frame (1 and 1 one-pass) and raster_cuda.LAUNCHES as before.
    torch.profiler over a replayed burst: kernels a frame, the vertex
    kernels among them and their device time.  The vertex layer alone
    (both prepares and setups of the shadow frame) captured as a graph,
    the kernels against the plain layer, device ms a replay by CUDA events
    (the launch queue held full).
    Returns the numbers for the kernel table."""
    from benchmark import harness, tracing
    from benchmark.orbit import Orbit
    from tiny_renderer_tpu_torch import RenderConfig, Scene
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.examples import custom_pipeline as example
    from tiny_renderer_tpu_torch.ops import mathlib as ml
    from tiny_renderer_tpu_torch.ops import raster_cuda, vertex_cuda
    from tiny_renderer_tpu_torch.ops.vertex import triangle_setup
    from tiny_renderer_tpu_torch.pipelines import frame as tframe
    from tiny_renderer_tpu_torch.pipelines.graphs import CapturedGraph

    lib, seconds, log = raster_cuda.build(force=True, source=vertex_cuda.SOURCE)
    phase("vertex", f"nvcc {' '.join(raster_cuda.NVCC_FLAGS)} -> {lib.name} in {seconds:.3f} s")
    registers = [line.strip() for line in log.splitlines()
                 if "Compiling entry" in line or "registers" in line or "spill" in line]
    for line in registers:
        phase("vertex", line)

    cell = harness.find_cell(VERTEX_CELL)
    sc = harness.build_scene(cell.config, VERTEX_SEED, dev)[0]
    example.register()
    rng = np.random.default_rng(VERTEX_SEED)
    orbit = Orbit(VERTEX_SEED, cell.traffic["camera_step_rad"], cell.traffic["light_step_rad"])
    cams, ligs = (to_tensor(a, dev) for a in orbit.angles(0, VERTEX_ORBIT))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    origin, up_y = to_tensor(np.zeros(3, np.float32), dev), to_tensor(np.float32([0.0, 1.0, 0.0]), dev)
    poses = [(torch.stack([torch.sin(li), zero, torch.cos(li)]), torch.stack([torch.sin(c), zero, torch.cos(c)]),
              origin, up_y) for c, li in zip(cams, ligs)]
    poses += [tuple(to_tensor(v, dev) for v in rng.normal(size=(4, 3)).astype(np.float32))
              for _ in range(VERTEX_RANDOM)]
    poses += [tuple(to_tensor(np.float32(v), dev) for v in pose) for pose in VERTEX_DEGENERATE]

    big = soup(3000, 1)
    big["positions"] = big["positions"] * np.float32(400.0)
    geoms = {"sphere": sc._geom, "soup": {k: to_tensor(v, dev) for k, v in soup(3000, 0).items()},
             "soup x400": {k: to_tensor(v, dev) for k, v in big.items()},
             "sphere+glow": {**sc._geom, "attr:glow": to_tensor(example.glow_attribute(sc.model), dev)}}
    needs = {name: tframe.PIPELINES[name].needs for name in (*PIPELINE_ORDER, "glow")}

    n_prep = n_setup = nan_payloads = overflowed = 0
    vertex_cuda.reset_launches()
    for w, h in VERTEX_CONFIGS:
        cfg = RenderConfig(width=w, height=h).resolve("shadow")
        for pi, (light, look_from, look_at, up) in enumerate(poses):
            label = f"{w}x{h} pose {pi}"
            kernel = {"default": ml.default_prepare(cfg, light, look_from, look_at, up),
                      "light": ml.shadow_pass_1_prepare(cfg, light, look_at, up),
                      "camera": ml.shadow_pass_2_prepare(cfg, light, look_from, look_at, up)}
            plain = {"default": ml.prepare_reference(cfg, light, look_from, look_at, up),
                     "light": ml.prepare_reference(cfg, light, light, look_at, up),
                     "camera": ml.prepare_reference(cfg, light, look_from, look_at, up, inverses=True)}
            plain["light"]["shadow_matrix"] = plain["light"]["vpmv"]
            for which, u in kernel.items():
                check(set(u) == set(plain[which]), f"{label} {which}: keys {sorted(u)}")
                for k, t in u.items():
                    ok, nans = same_bits(t, plain[which][k])
                    check(ok, f"{label} {which} prepare: {k} differs from the plain torch version")
                    nan_payloads += nans
                n_prep += 1
            torch.cuda.synchronize()
            kernel["camera"]["shadow_matrix"] = kernel["light"]["vpmv"]
            for gname, geom in geoms.items():
                variants = [("light", dict(matrix_key="shadow_matrix", cull=False))]
                variants += [("camera", dict(needs=n)) for n in sorted(set(needs.values()))]
                for which, kw in variants:
                    if gname == "sphere+glow" and which == "light":
                        continue
                    got = triangle_setup(geom, kernel[which], cfg, **kw)
                    with plain_vertex():
                        want = triangle_setup(geom, kernel[which], cfg, **kw)
                    check(set(got) == set(want), f"{label} {gname} {kw}: keys {sorted(set(got) ^ set(want))}")
                    for k in want:
                        ok, nans = same_bits(got[k], want[k])
                        check(ok, f"{label} {gname} {which} {kw}: setup field {k} differs from the plain version")
                        nan_payloads += nans
                    overflowed += bool(want["coord_overflow"])
                    n_setup += 1
            torch.cuda.synchronize()
    check(vertex_cuda.LAUNCHES == {"prepare": n_prep, "setup": n_setup},
          f"vertex launches {vertex_cuda.LAUNCHES} for {n_prep} prepares and {n_setup} setups")
    check(overflowed > 0, "no setup set coord_overflow: the envelope went unchecked")
    phase("vertex", f"{len(poses)} poses x {len(VERTEX_CONFIGS)} sizes: {n_prep} prepares and {n_setup} setups "
          f"({len(geoms)} geometries, needs {sorted(set(needs.values()))} and glow's attr:glow; "
          f"{overflowed} with coord_overflow) bit-equal to the plain torch versions on the card "
          f"(NaN payloads that differ: {nan_payloads}); every launch's cudaGetLastError() 0, "
          f"synchronize clean")

    # Frames: replayed Scene.render against render_frame with the plain layer.
    frame_poses = [(np.float32([math.sin(li), 0.0, math.cos(li)]), np.float32([math.sin(c), 0.0, math.cos(c)]))
                   for c, li in zip(*orbit.angles(7, VERTEX_FRAME_POSES))]
    for name in (*PIPELINE_ORDER, "glow"):
        attrs = {"glow": example.glow_attribute(sc.model)} if name == "glow" else None
        s = Scene(sc.model, name, RenderConfig(), device=dev, vertex_attrs=attrs)
        one = not tframe.PIPELINES[name].two_pass
        for light, look_from in frame_poses:
            s.set_light_direction(light)
            s.set_camera(look_from, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
            s.render()  # the first call captures
            vertex_cuda.reset_launches()
            got = s.render()
            check(vertex_cuda.LAUNCHES == ({"prepare": 1, "setup": 1} if one else {"prepare": 2, "setup": 2}),
                  f"{name}: vertex launches a replayed frame {vertex_cuda.LAUNCHES}")
            view = [to_tensor(np.float32(v), dev) for v in (light, look_from, [0, 0, 0], [0, 1, 0])]
            with plain_vertex():
                want = tframe.render_frame(s._geom, s._textures, *view, pipeline=name, config=s.config)
            for k in ("frame", "z", "shadow", "overflow"):
                check(torch.equal(got[k], want[k]), f"{name}: replayed {k} differs from the plain layer's frame")
    torch.cuda.synchronize()

    # The benchmark's burst: replayed against the plain layer's eager burst.
    n = cell.traffic["frames_per_call"]
    bc, bl = (to_tensor(a, dev) for a in orbit.angles(100, n))
    config = sc.config.resolve(sc.pipeline_name)
    kw = dict(pipeline=sc.pipeline_name, config=config, keep_frames=True)
    tframe.render_burst(sc._geom, sc._textures, bc, bl, **kw)  # captures
    raster_before = dict(raster_cuda.LAUNCHES)
    vertex_cuda.reset_launches()
    got = tframe.render_burst(sc._geom, sc._textures, bc, bl, **kw)
    check(vertex_cuda.LAUNCHES == {"prepare": 2 * n, "setup": 2 * n},
          f"vertex launches of a replayed {n}-frame burst: {vertex_cuda.LAUNCHES}")
    raster_n = {k: v - raster_before[k] for k, v in raster_cuda.LAUNCHES.items()}
    with plain_vertex():
        want = tframe._render_burst_eager(sc._geom, sc._textures, bc, bl, **kw)
    for k in ("frames", "checksums", "overflow"):
        check(torch.equal(got[k], want[k]), f"the replayed {n}-frame burst's {k} differ from the plain layer's")
    check(not bool(got["overflow"].any()), "the burst overflowed")

    # The profiler over a replayed burst: kernels a frame, the vertex ones.
    trace = tracing.summarize(tracing.profile(
        lambda: tframe.render_burst(sc._geom, sc._textures, bc, bl, **kw), dev)[0], frames=n)
    vk = [(name, s) for name, s in trace.kernels if VERTEX_KERNELS.search(name)]
    by_kernel = collections.defaultdict(list)
    for name, s in vk:
        by_kernel["prepare" if "prepare" in name else "setup"].append(s * 1e3)
    kernels_a_frame = len(trace.kernels) / n
    check(len(vk) == 4 * n, f"{len(vk)} vertex kernels in the profiled {n}-frame burst, not {4 * n}")

    # The vertex layer alone, replayed: the kernels against the plain layer.
    spec = tframe.PIPELINES["shadow"]
    view = [to_tensor(np.float32(v), dev) for v in VIEW]

    def layer(*v):
        u1, u = tframe._uniforms(spec, config, *v)
        s1 = triangle_setup(sc._geom, u1, config, matrix_key="shadow_matrix", cull=False)
        s2 = triangle_setup(sc._geom, u, config, needs=spec.needs)
        return s1["rx"], s2["rx"]

    g_kernel = CapturedGraph(layer, view, "the vertex layer")
    with plain_vertex():
        g_plain = CapturedGraph(layer, view, "the plain vertex layer")
        plain_trace = tracing.summarize(tracing.profile(lambda: layer(*view), dev)[0], frames=1)
    check(g_kernel.vertex_launches == {"prepare": 2, "setup": 2} and not any(g_plain.vertex_launches.values()),
          f"vertex launches recorded: {g_kernel.vertex_launches}, plain {g_plain.vertex_launches}")
    ms = {}
    for label, g in (("plain", g_plain), ("kernel", g_kernel), ("kernel2", g_kernel), ("plain2", g_plain)):
        ms[label] = time_launches(lambda g=g: g.graph.replay(), VERTEX_TIMED, hold=True)
    ms_kernel, ms_plain = min(ms["kernel"], ms["kernel2"]), min(ms["plain"], ms["plain2"])
    T = sc._geom["pos_tri"].shape[0]
    # Bytes a frame: each pass reads positions and uvs (the camera pass the
    # normals too) and writes 17 ints, 9 floats (+3 intensities) and valid.
    nbytes = T * (36 + 24 + 17 * 4 + 9 * 4 + 1) + T * (36 + 24 + 36 + 17 * 4 + 12 * 4 + 1)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    result = {
        "prepare_device_ms": float(np.mean(by_kernel["prepare"])), "setup_device_ms": float(np.mean(by_kernel["setup"])),
        "layer_graph_ms": ms_kernel, "plain_graph_ms": ms_plain, "plain_kernels": len(plain_trace.kernels),
        "kernels_per_frame": kernels_a_frame, "vertex_kernels_per_frame": len(vk) / n, "bound_ms": bound_ms,
        "bytes": nbytes, "registers": registers, "raster_launches_a_burst": raster_n,
    }
    phase("vertex", f"Scene.render of {len(PIPELINE_ORDER)} pipelines and glow at {VERTEX_FRAME_POSES} poses and a "
          f"replayed {n}-frame shadow burst byte-equal to the plain layer's eager frames; vertex launches a "
          f"replayed frame 2 + 2 (two-pass), 1 + 1 (one-pass); raster launches of the burst {raster_n}")
    phase("vertex", f"profiled replayed burst: {kernels_a_frame:.2f} kernels a frame, {len(vk) / n:.0f} of them "
          f"vertex kernels; device ms a launch: prepare {result['prepare_device_ms']:.4f}, setup "
          f"{result['setup_device_ms']:.4f} (light {min(by_kernel['setup']):.4f}..camera "
          f"{max(by_kernel['setup']):.4f})")
    phase("vertex", f"the vertex layer replayed alone (2 prepares + 2 setups, {T} triangles): {ms_kernel:.4f} ms a "
          f"replay against the plain layer's {ms_plain:.4f} ms ({len(plain_trace.kernels)} kernels eagerly); "
          f"bound {bound_ms * 1e3:.3f} us ({nbytes} B at 3.35 TB/s), {bound_ms / ms_kernel:.2%} of it  [{smi}]")
    print(json.dumps({"vertex": result}), flush=True)
    return result


OCCLUSION_CELL = "diablo-occlusion.orbit-burst"
OCCLUSION_SEED = 2_147_533_209
OCCLUSION_LIGHTS = 48  # orbit poses under which the kernel is held to the plain version
OCCLUSION_RANDOM = 32  # random light directions, likewise
OCCLUSION_LIGHT_FRAGMENTS = 512  # fragments a light
# Light directions in model space (i_m the identity), likewise: aligned
# with +z, opposite, a hair off, zero, non-finite, huge.
OCCLUSION_DEGENERATE = ([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1e-8, 0.0, 1.0], [0.0, 1e-9, -1.0], [0.0, 0.0, 0.0],
                        [math.nan, 0.0, 1.0], [math.inf, 0.0, 0.0], [3e30, 3e30, 3e30], [1e-30, 0.0, 0.0])
OCCLUSION_SAMPLES = (1, 16, 33)
OCCLUSION_TILES = (0, 16)
OCCLUSION_FRAGMENTS = 200_000  # adversarial fragments a case
# Fragment values beside the seeded ones: off the plane, non-finite, and
# coordinates on exact halves.
OCCLUSION_SPECIAL = (math.nan, math.inf, -math.inf, 1e30, -1e30, 4e9, -0.0, 0.5, 1.5, 2.5, -0.5, -2.5,
                     399.5, 799.5, 800.5, 1e-30)
OCCLUSION_CONFIGS = {"default": {}, "compact_shade=False": dict(compact_shade=False)}
OCCLUSION_POSES = 3  # Scene.render poses a config
OCCLUSION_TIMED = 200
OCCLUSION_KERNEL = re.compile(r"occlusion_kernel")


def plain_occlusion():
    """The probe's plain torch version (shaders.occlusion_reference) on
    CUDA tensors too, inside the returned context: for eager frames, since
    a graph captured inside it would be cached with the plain probe."""
    from tiny_renderer_tpu_torch.ops import occlusion_cuda
    from tiny_renderer_tpu_torch.pipelines import shaders

    return mock.patch.object(
        occlusion_cuda, "coefficient",
        lambda xf, yf, zfrag, plane, uniforms, directions, config, tile=0:
            shaders.occlusion_reference(xf, yf, zfrag, plane, uniforms, config))


def occlusion_fragments(rng, n, width, height, dev):
    """n seeded fragments over and around a width x height screen, a fifth
    of each coordinate set to OCCLUSION_SPECIAL values and a tenth of them
    on exact halves."""
    xf = rng.uniform(-80, width + 80, n).astype(np.float32)
    yf = rng.uniform(-80, height + 80, n).astype(np.float32)
    zf = rng.uniform(-10, 265, n).astype(np.float32)
    for a in (xf, yf, zf):
        at = rng.choice(n, size=n // 5, replace=False)
        a[at] = rng.choice(np.float32(OCCLUSION_SPECIAL), size=at.size)
    halves = np.arange(n // 10, dtype=np.float32) % np.float32(width) - np.float32(0.5)
    xf[:halves.size] = halves
    yf[:halves.size] = halves[::-1] % np.float32(height)
    return [torch.from_numpy(a).to(dev) for a in (xf, yf, zf)]


def occlusion_phase(dev, smi):
    """Phase 2c: csrc/occlusion.cu on the card.  Builds it (ptxas registers
    and spills printed).  The kernel bit-equal to
    shaders.occlusion_reference on the same CUDA tensors (NaN against NaN):
    under the uniforms of OCCLUSION_LIGHTS orbit poses of the cell, random
    lights and degenerate ones, on a ramp plane (each texel its own index,
    so a sample index moved by the frame constants the kernel's blocks
    compute, rotation_between's acosf/sinf/cosf included, moves the
    result); on adversarial fragments at 800x800, for 1, 16 and 33
    samples, the swizzled plane on and off, the frame's uniforms and
    identity ones; and on the chunk fragments of the cell's 800x800 frame.
    (The kernel ignores occlusion_dedup, whose dedup_gather the CPU tests
    hold to JAX.)  Then under each of OCCLUSION_CONFIGS: Scene.render
    (replayed) byte-equal to render_frame with the plain probe at
    OCCLUSION_POSES poses, and a 60-frame render_sequence byte-equal to the
    plain probe's eager burst; torch.profiler over a replayed
    render_sequence: one occlusion kernel ran a frame (the stand-in covers
    fewer strips than the first chunk holds), and kernels a frame.
    occlusion_cuda.LAUNCHES counts the launches the graph records, one a
    chunk body whether its IF node runs it or not: checked at that, and at
    none for shadow frames.  The kernel's device ms alone (the launch queue
    held full) and in a replayed graph beside the plain probe's graph and
    the bound (benchmark/roofline_probe.py at the frame's covered pixels).
    Returns the numbers for the kernel table."""
    from benchmark import harness, roofline_probe, tracing
    from benchmark.orbit import Orbit
    from tiny_renderer_tpu_torch import Scene
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.ops import mathlib as ml
    from tiny_renderer_tpu_torch.ops import occlusion_cuda, raster_cuda
    from tiny_renderer_tpu_torch.pipelines import frame as tframe
    from tiny_renderer_tpu_torch.pipelines import shaders
    from tiny_renderer_tpu_torch.pipelines.graphs import CapturedGraph

    lib, seconds, log = raster_cuda.build(force=True, source=occlusion_cuda.SOURCE)
    phase("occlusion", f"nvcc {' '.join(raster_cuda.NVCC_FLAGS)} -> {lib.name} in {seconds:.3f} s")
    registers = [line.strip() for line in log.splitlines()
                 if "Compiling entry" in line or "registers" in line or "spill" in line]
    for line in registers:
        phase("occlusion", line)

    cell = harness.find_cell(OCCLUSION_CELL)
    sc = harness.build_scene(cell.config, OCCLUSION_SEED, dev)[0]
    config = sc.config.resolve("occlusion")
    spec = tframe.PIPELINES["occlusion"]
    rng = np.random.default_rng(OCCLUSION_SEED)
    orbit = Orbit(OCCLUSION_SEED, cell.traffic["camera_step_rad"], cell.traffic["light_step_rad"])
    origin, up_y = [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]

    def view(light, look_from):
        return [to_tensor(np.float32(v), dev) for v in (light, look_from, origin, up_y)]

    def orbit_views(first, count):
        return [view([math.sin(li), 0.0, math.cos(li)], [math.sin(c), 0.0, math.cos(c)])
                for c, li in zip(*orbit.angles(first, count))]

    # The frame constants, through the kernel: under each light, fragments
    # on the screen over a ramp plane against the plain version.
    w, h = config.width, config.height
    uniform_sets = [tframe._uniforms(spec, config, *v)[1] for v in orbit_views(0, OCCLUSION_LIGHTS)]
    uniform_sets += [tframe._uniforms(spec, config, *view(rng.normal(size=3), [0.2, 0.1, 0.98]))[1]
                     for _ in range(OCCLUSION_RANDOM)]
    base = uniform_sets[0]
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    uniform_sets += [dict(base, i_m=eye, t_light_direction=to_tensor(np.float32(v), dev))
                     for v in OCCLUSION_DEGENERATE]
    ramp = torch.arange(h * w, dtype=torch.float32, device=dev).reshape(h, w)
    differ, nan_payloads, moved = [], 0, 0
    for i, u in enumerate(uniform_sets):
        xf, yf, zf = (torch.from_numpy(rng.uniform(0, hi, OCCLUSION_LIGHT_FRAGMENTS).astype(np.float32)).to(dev)
                      for hi in (w, h, 255))
        got = shaders.occlusion_coefficient(xf, yf, zf, ramp, u, config)
        want = shaders.occlusion_reference(xf, yf, zf, ramp, u, config)
        ok, nans = same_bits(got, want)
        nan_payloads += nans
        moved += bool((want < 1).any())
        if not ok:
            at = int(((got.view(torch.int32) != want.view(torch.int32))
                      & ~(torch.isnan(got) & torch.isnan(want))).nonzero()[0, 0])
            differ.append((i, at, float(got[at]), float(want[at])))
    torch.cuda.synchronize()
    phase("occlusion", f"{len(uniform_sets)} lights ({OCCLUSION_LIGHTS} orbit, {OCCLUSION_RANDOM} random, "
          f"{len(OCCLUSION_DEGENERATE)} degenerate), {OCCLUSION_LIGHT_FRAGMENTS} fragments each on a ramp plane: "
          f"{len(differ)} differ from the plain version, {moved} occlude some fragment (NaN payloads that differ: "
          f"{nan_payloads}){'; first (light, fragment, kernel, plain) ' + str(differ[0]) if differ else ''}")
    check(not differ, "under some light the kernel differs from the plain version")
    check(moved >= OCCLUSION_LIGHTS, "too few lights occlude a fragment of the ramp plane")

    # The kernel against the plain version on adversarial fragments.
    rendered = tframe.render_frame(sc._geom, sc._textures, *orbit_views(0, 1)[0], pipeline="occlusion",
                                   config=config)
    planes = {"frame's": rendered["shadow"], "seeded": torch.from_numpy(
        np.where(rng.random((h, w)) < 0.2, np.float32(ml.F32_MIN),
                 rng.uniform(-5, 260, (h, w)).astype(np.float32))).to(dev)}
    identity = {"i_vpmv": eye, "shadow_matrix": eye, "i_m": eye,
                "t_light_direction": to_tensor(np.float32([0.0, 0.0, 1.0]), dev)}
    cases = 0
    for n in OCCLUSION_SAMPLES:
        for tile in OCCLUSION_TILES:
            for uname, u, step in (("frame", base, 0.02), ("identity", identity, 3.0)):
                cfg = dataclasses.replace(config, occlusion_samples=n, shadow_tile=tile, occlusion_step=step)
                for pname, p in planes.items():
                    p = shaders.swizzle_plane(p, tile) if tile else p
                    xf, yf, zf = occlusion_fragments(rng, OCCLUSION_FRAGMENTS, w, h, dev)
                    got = shaders.occlusion_coefficient(xf, yf, zf, p, u, cfg)
                    want = shaders.occlusion_reference(xf, yf, zf, p, u, cfg)
                    ok, nans = same_bits(got, want)
                    label = f"n {n}, tile {tile}, {uname} uniforms, {pname} plane"
                    if not ok:
                        bad = (got.view(torch.int32) != want.view(torch.int32)) & ~(
                            torch.isnan(got) & torch.isnan(want))
                        at = int(bad.nonzero()[0, 0])
                        phase("occlusion", f"{label}: {int(bad.sum())} of {got.numel()} differ; first at {at}: "
                              f"x {float(xf[at])!r} y {float(yf[at])!r} z {float(zf[at])!r} -> "
                              f"{float(got[at])!r} against {float(want[at])!r}")
                    check(ok, f"{label}: the kernel differs from the plain version")
                    check(bool((want < 1).any()) or n == 1, f"{label}: no fragment occluded")
                    nan_payloads += nans
                    cases += 1
    torch.cuda.synchronize()
    phase("occlusion", f"{cases} adversarial cases of {OCCLUSION_FRAGMENTS} fragments ({w}x{h}; samples "
          f"{OCCLUSION_SAMPLES}, tiles {OCCLUSION_TILES}, the frame's and identity uniforms, the "
          f"frame's and a seeded plane) bit-equal to the plain version on the card (NaN payloads that differ: "
          f"{nan_payloads})")

    # The chunk fragments of the cell's frame: the kernel's outputs recorded
    # as the eager frame ran, against the plain version on the same inputs.
    calls = []
    launch = occlusion_cuda.coefficient

    def recorded(*a, **k):
        occ = launch(*a, **k)
        calls.append((a, k, occ))
        return occ

    with mock.patch.object(occlusion_cuda, "coefficient", recorded):
        tframe.render_frame(sc._geom, sc._textures, *orbit_views(0, 1)[0], pipeline="occlusion", config=config)
    for (xf, yf, zf, p, u, _dirs, cfg), _, occ in calls:
        ok, _ = same_bits(occ, shaders.occlusion_reference(xf, yf, zf, p, u, cfg))
        check(ok, f"the frame's chunk of {xf.numel()} fragments: the kernel differs from the plain version")
    chunk_args = calls[0]
    pixels = int((rendered["z"] > ml.F32_MIN).sum())
    phase("occlusion", f"the {w}x{h} frame's {len(calls)} chunk bodies ({[c[0][0].numel() for c in calls]} "
          f"fragments) bit-equal to the plain version; {pixels} covered pixels")
    del calls

    # Frames and bursts against the plain probe's eager ones.
    n_seq = cell.traffic["frames_per_call"]
    cams, ligs = orbit.angles(200, n_seq)
    bodies, ran = {}, {}
    for cname, knobs in OCCLUSION_CONFIGS.items():
        s = Scene(sc.model, "occlusion", dataclasses.replace(sc.config, **knobs), device=dev)
        rc = s.config.resolve("occlusion")
        n_strips = -(-rc.width * rc.height // rc.strip_len)
        slots = -(-n_strips // rc.strip_batch) * rc.strip_batch
        per_frame = len(tframe.shade_chunks(slots, rc.strip_batch)) if rc.compact_shade else 1
        bodies[cname] = per_frame
        for v, (c, li) in zip(orbit_views(100, OCCLUSION_POSES), zip(*orbit.angles(100, OCCLUSION_POSES))):
            s.set_light_direction([math.sin(li), 0.0, math.cos(li)])
            s.set_camera([math.sin(c), 0.0, math.cos(c)], origin, up_y)
            s.render()  # the first call captures
            occlusion_cuda.reset_launches()
            got = s.render()
            check(occlusion_cuda.LAUNCHES == {"coefficient": per_frame},
                  f"{cname}: occlusion launches recorded a replayed frame {occlusion_cuda.LAUNCHES}, not {per_frame}")
            with plain_occlusion():
                want = tframe.render_frame(s._geom, s._textures, *v, pipeline="occlusion", config=rc)
            for k in ("frame", "z", "shadow", "overflow"):
                check(torch.equal(got[k], want[k]), f"{cname}: replayed {k} differs from the plain probe's frame")
        s.render_sequence(cams, ligs)  # captures the burst frame
        occlusion_cuda.reset_launches()
        seq = s.render_sequence(cams, ligs)
        check(occlusion_cuda.LAUNCHES == {"coefficient": per_frame * n_seq},
              f"{cname}: occlusion launches recorded in a {n_seq}-frame render_sequence {occlusion_cuda.LAUNCHES}")
        with plain_occlusion():
            want = tframe._render_burst_eager(s._geom, s._textures, to_tensor(cams, dev), to_tensor(ligs, dev),
                                              pipeline="occlusion", config=rc, keep_frames=True)
        check(np.array_equal(seq, want["frames"].cpu().numpy()[:, ::-1]),
              f"{cname}: the {n_seq}-frame render_sequence differs from the plain probe's eager burst")
        check(not bool(want["overflow"].any()), f"{cname}: the burst overflowed")
        # The launches that ran: the profiler over a replayed render_sequence.
        trace = tracing.summarize(tracing.profile(lambda: s.render_sequence(cams, ligs), dev)[0], frames=n_seq)
        ran_ms = [t * 1e3 for name, t in trace.kernels if OCCLUSION_KERNEL.search(name)]
        ran[cname] = len(ran_ms) / n_seq
        check(len(ran_ms) == n_seq, f"{cname}: {len(ran_ms)} occlusion kernels ran in a profiled replayed "
              f"{n_seq}-frame render_sequence, not one a frame")
        if cname == "default":
            ok_ms, kernels_a_frame = ran_ms, len(trace.kernels) / n_seq
    shadow = Scene(sc.model, "shadow", sc.config, device=dev)
    shadow.render()
    shadow.render_sequence(cams[:4], ligs[:4])
    occlusion_cuda.reset_launches()
    shadow.render()
    shadow.render_sequence(cams[:4], ligs[:4])
    torch.cuda.synchronize()
    check(occlusion_cuda.LAUNCHES == {"coefficient": 0},
          f"shadow frames launched the occlusion kernel: {occlusion_cuda.LAUNCHES}")
    phase("occlusion", f"Scene.render at {OCCLUSION_POSES} poses and a {n_seq}-frame render_sequence under "
          f"{list(OCCLUSION_CONFIGS)} byte-equal to the plain probe's eager frames; occlusion kernels that ran a "
          f"replayed frame (profiler) {ran}; launches recorded a replayed frame {bodies} (one a chunk body in the "
          f"graph, run or skipped), 0 for shadow frames")

    # The kernel's time: alone with the launch queue held full, and as a
    # replayed graph beside the plain probe's graph.
    (xf, yf, zf, p, u, dirs, cfg), k, _ = chunk_args
    tile = k.get("tile", 0)

    def probe(x):
        return shaders.occlusion_coefficient(x, yf, zf, p, u, cfg)

    alone = time_launches(lambda: occlusion_cuda.coefficient(xf, yf, zf, p, u, dirs, cfg, tile=tile),
                          OCCLUSION_TIMED, hold=True)
    g_kernel = CapturedGraph(probe, [xf], "the occlusion kernel")
    with plain_occlusion():
        g_plain = CapturedGraph(probe, [xf], "the plain occlusion probe")
    check(g_kernel.occlusion_launches == {"coefficient": 1} and not any(g_plain.occlusion_launches.values()),
          f"occlusion launches recorded: {g_kernel.occlusion_launches}, plain {g_plain.occlusion_launches}")
    ms = {}
    for label, g in (("plain", g_plain), ("kernel", g_kernel), ("kernel2", g_kernel), ("plain2", g_plain)):
        ms[label] = time_launches(lambda g=g: g.graph.replay(), OCCLUSION_TIMED, hold=True)
    ms_kernel, ms_plain = min(ms["kernel"], ms["kernel2"]), min(ms["plain"], ms["plain2"])
    bound_ms = roofline_probe.least_seconds(w, h, pixels) * 1e3
    result = {
        "device_ms": alone, "graph_ms": ms_kernel, "in_burst_ms": float(np.mean(ok_ms)), "plain_graph_ms": ms_plain,
        "fragments": xf.numel(), "pixels": pixels, "bound_ms": bound_ms, "bytes": roofline_probe.probe_bytes(w, h, pixels),
        "kernels_per_frame": kernels_a_frame, "launches_ran_a_frame": ran, "launches_recorded_a_frame": bodies, "registers": registers,
        "build_s": seconds,
    }
    phase("occlusion", f"profiled replayed {n_seq}-frame render_sequence: {kernels_a_frame:.2f} kernels a frame, "
          f"{len(ok_ms) / n_seq:.0f} occlusion kernel a frame ran, {result['in_burst_ms']:.4f} ms each")
    phase("occlusion", f"the kernel on the frame's first chunk ({xf.numel()} fragments): {alone:.4f} ms a launch "
          f"(queue held full), {ms_kernel:.4f} ms a replayed graph, against the plain probe's graph "
          f"{ms_plain:.4f} ms; bound {bound_ms * 1e3:.3f} us ({result['bytes']} B at 3.35 TB/s, {pixels} covered "
          f"pixels), {bound_ms / alone:.2%} of it alone, {bound_ms / result['in_burst_ms']:.2%} in the burst  [{smi}]")
    print(json.dumps({"occlusion": result}), flush=True)
    return result


DARBOUX_CELL = "diablo-darboux.orbit-burst"
DARBOUX_SEED = 2_147_524_024
DARBOUX_POSES = 4  # orbit poses of the 800x800 frame a config
# The eager frames' configs: the layouts the body reads and writes (the
# row-major packed plane, u8 triples, the int16 idx plane) and eager chunk
# bodies made mostly of fill slots (strip_batch 8: 3 bodies, run in full).
DARBOUX_CONFIGS = {"default": {}, "tex_tile 0": dict(auto_tune=False), "strip_pack_words=False":
                   dict(strip_pack_words=False), "idx_int16": dict(idx_int16=True), "strip_batch=8": dict(strip_batch=8)}
DARBOUX_SLABS = ((160, 320), (96, 704))  # (rows, first row) of row slabs of the 800x800 frame
# Synthetic chunks: seeded setup columns over T triangles, a share of them
# set to DARBOUX_SPECIAL values, singular bases, uncovered lanes.
DARBOUX_TRIANGLES = 5096
DARBOUX_SPECIAL = (math.nan, math.inf, -math.inf, 0.0, -0.0, 1e30, -1e30, 1e-30, 0.5, 1.0, -1.0)
DARBOUX_POSES_REPLAYED = 3  # Scene.render poses
DARBOUX_TIMED = 200
DARBOUX_KERNEL = re.compile(r"darboux_kernel")


def plain_darboux():
    """The torch chunk body on CUDA tensors too, inside the returned
    context: the built-in spec without its fused body.  For eager frames,
    since a graph captured inside it would be cached with the torch body."""
    from tiny_renderer_tpu_torch.pipelines import frame as tframe

    spec = tframe.PIPELINES["darboux"]
    return mock.patch.dict(tframe.PIPELINES, {"darboux": dataclasses.replace(spec, fused_body=None)})


def darboux_setup(rng, n, dev):
    """Seeded setup columns of n triangles with NaN, +-inf, zeros and huge
    values among them, zero-area triangles, bases whose rows coincide or
    whose normal lies along a row (singular), as triangle_setup's dict."""
    def floats(*shape, scale=1.0):
        a = rng.normal(0.0, scale, shape).astype(np.float32)
        at = rng.random(shape) < 0.04
        a[at] = rng.choice(np.float32(DARBOUX_SPECIAL), size=int(at.sum()))
        return a

    out = {k: rng.integers(-3000, 3000, n).astype(np.int32) for k in ("a1", "b1", "c1", "a2", "b2", "c2")}
    out["cz"] = rng.integers(-40_000, 40_000, n).astype(np.int32)
    out["cz"][::17] = 0
    out["uv"] = np.abs(floats(n, 3, 2, scale=0.7))
    out["t_norm"], out["row0n"], out["row1n"] = floats(n, 3, 3), floats(n, 3), floats(n, 3)
    out["row1n"][::5] = out["row0n"][::5]
    out["t_norm"][1::7] = out["row0n"][1::7, None, :]
    out["du"], out["dv"] = floats(n, 2, scale=0.02), floats(n, 2, scale=0.02)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in out.items()}


def darboux_phase(dev, smi):
    """Phase 2d: csrc/darboux.cu on the card.  Builds it (ptxas registers
    and spills printed).  The kernel's frames byte-equal to the torch chunk
    body's (plain_darboux) on the same CUDA tensors, eagerly: the cell's
    800x800 frame at DARBOUX_POSES orbit poses under each of
    DARBOUX_CONFIGS (tex_tile 16 and 0, strip_pack_words on and off, the
    int16 idx plane, bodies of fill slots); row slabs at a first row > 0
    (parallel.sharding's y_offset); the frame with degenerate normals (zero,
    or along an edge: NaN and singular bases); and seeded synthetic chunks
    through _shade_strips (NaN/inf setup columns, zero-area triangles,
    singular bases, uncovered lanes, fill slots) at tex_tile 16 and 0, both
    writebacks, y_offset 0 and 96.  Then Scene.render (replayed) byte-equal
    to the torch body's eager frame at DARBOUX_POSES_REPLAYED poses and a
    60-frame render_sequence byte-equal to the torch body's eager burst,
    with the launches recorded a replayed frame (one a chunk body in the
    graph) and none under compact_shade=False (the full-screen torch
    shade); torch.profiler over a replayed render_sequence: one darboux
    kernel ran a frame, kernels a frame, and the snapshot's
    darboux_launches.  The kernel's device ms on the frame's first chunk
    (the launch queue held full), and the strip shade alone replayed with
    the kernel and with the torch body, beside the bound
    (benchmark/roofline_darboux.py at the frame's covered pixels).  Returns
    the numbers for the kernel table."""
    from benchmark import harness, roofline_darboux, tracing
    from benchmark.orbit import Orbit
    from tiny_renderer_tpu_torch import Scene
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.ops import darboux_cuda, raster_cuda
    from tiny_renderer_tpu_torch.ops import mathlib as ml
    from tiny_renderer_tpu_torch.ops.vertex import triangle_setup
    from tiny_renderer_tpu_torch.pipelines import frame as tframe
    from tiny_renderer_tpu_torch.pipelines.graphs import CapturedGraph
    from tiny_renderer_tpu_torch.utils import timing

    lib, seconds, log = raster_cuda.build(force=True, source=darboux_cuda.SOURCE)
    phase("darboux", f"nvcc {' '.join(raster_cuda.NVCC_FLAGS)} -> {lib.name} in {seconds:.3f} s")
    registers = [line.strip() for line in log.splitlines()
                 if "Compiling entry" in line or "registers" in line or "spill" in line]
    for line in registers:
        phase("darboux", line)

    cell = harness.find_cell(DARBOUX_CELL)
    sc = harness.build_scene(cell.config, DARBOUX_SEED, dev)[0]
    config = sc.config.resolve("darboux")
    spec = tframe.PIPELINES["darboux"]
    rng = np.random.default_rng(DARBOUX_SEED)
    orbit = Orbit(DARBOUX_SEED, cell.traffic["camera_step_rad"], cell.traffic["light_step_rad"])
    origin, up_y = [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]

    def view(light, look_from):
        return [to_tensor(np.float32(v), dev) for v in (light, look_from, origin, up_y)]

    def orbit_views(first, count):
        return [view([math.sin(li), 0.0, math.cos(li)], [math.sin(c), 0.0, math.cos(c)])
                for c, li in zip(*orbit.angles(first, count))]

    def both(label, fn):
        """fn() with the kernel and with the torch body, byte for byte;
        returns the kernel's output and its launches."""
        darboux_cuda.reset_launches()
        got = fn()
        launches = darboux_cuda.LAUNCHES["body"]
        with plain_darboux():
            want = fn()
        torch.cuda.synchronize()
        check(darboux_cuda.LAUNCHES["body"] == launches and launches > 0,
              f"{label}: {launches} kernel launches, {darboux_cuda.LAUNCHES['body'] - launches} under the torch body")
        bad = (got != want).reshape(-1, got.shape[-1]).any(-1)
        if bool(bad.any()):
            at = int(bad.nonzero()[0, 0])
            phase("darboux", f"{label}: {int(bad.sum())} of {bad.numel()} pixels differ; first at {at}: "
                  f"{got.reshape(-1, got.shape[-1])[at].tolist()} against {want.reshape(-1, want.shape[-1])[at].tolist()}")
        check(not bool(bad.any()), f"{label}: the kernel differs from the torch body")
        return got, launches

    # The 800x800 frame at orbit poses under each config.
    w, h = config.width, config.height
    cases, black = 0, {}
    for i, (cname, knobs) in enumerate(DARBOUX_CONFIGS.items()):
        rc = dataclasses.replace(sc.config, **knobs).resolve("darboux")
        for v in orbit_views(50 * i, DARBOUX_POSES):
            both(f"{cname} frame", lambda: tframe.render_frame(sc._geom, sc._textures, *v, pipeline="darboux",
                                                               config=rc, needs_z=False)["frame"])
            cases += 1
    # Row slabs.
    v = orbit_views(7, 1)[0]
    _, u = tframe._uniforms(spec, config, *v)
    setup = triangle_setup(sc._geom, u, config, needs=spec.needs)
    for rows, y0 in DARBOUX_SLABS:
        both(f"the slab of rows {y0}..{y0 + rows}", lambda: tframe._camera_pass_and_shade(
            setup, u, "darboux", sc._textures, config, "kernel", None, False, rows=rows, y0=y0)[0])
        cases += 1
    # Degenerate normals: zero on a third of the triangles (NaN), along the
    # first edge on another third (a singular basis).
    geom = dict(sc._geom)
    normal, pos = geom["normal_tri"].clone(), geom["pos_tri"]
    third = torch.arange(normal.shape[0], device=dev) % 3
    normal[third == 0] = 0.0
    normal[third == 1] = (pos[:, 1] - pos[:, 0])[third == 1][:, None, :]
    geom["normal_tri"] = normal
    for v in orbit_views(300, DARBOUX_POSES):
        out, _ = both("degenerate normals", lambda: tframe.render_frame(
            geom, sc._textures, *v, pipeline="darboux", config=config)["frame"])
        covered = tframe.render_frame(geom, sc._textures, *v, pipeline="darboux", config=config)["z"] > ml.F32_MIN
        black["degenerate"] = black.get("degenerate", 0) + int((covered & (out == 0).all(-1)).sum())
        cases += 1
    # Synthetic chunks through _shade_strips.
    syn = darboux_setup(rng, DARBOUX_TRIANGLES, dev)
    idx = torch.from_numpy(rng.integers(-1, DARBOUX_TRIANGLES, (h, w)).astype(np.int32)).to(dev)
    idx[torch.from_numpy(rng.random((h, w)) < 0.3).to(dev)] = -1
    light = {"t_light_direction": u["t_light_direction"]}
    for tile_knobs in ({}, dict(auto_tune=False)):
        for pack in (True, False):
            rc = dataclasses.replace(sc.config, strip_pack_words=pack, **tile_knobs).resolve("darboux")
            textures = tframe._with_packed_plane(sc._textures, "darboux", rc)
            for y0 in (0, 96):
                out, n = both(f"synthetic chunks, tex_tile {rc.tex_tile}, pack {pack}, y_offset {y0}",
                              lambda: tframe._shade_strips(syn, idx, "darboux", light, textures, rc, None,
                                                           y_offset=y0))
                black["synthetic"] = black.get("synthetic", 0) + int(((idx >= 0) & (out == 0).all(-1)).sum())
                cases += 1
    phase("darboux", f"{cases} cases byte-equal to the torch body on the card: the {w}x{h} frame at "
          f"{DARBOUX_POSES} poses under {list(DARBOUX_CONFIGS)}, row slabs {DARBOUX_SLABS}, degenerate normals, "
          f"synthetic chunks (NaN/inf columns, singular bases, uncovered lanes, fill slots; tex_tile 16 and 0, "
          f"both writebacks, y_offset 0 and 96); covered pixels black (NaN or a dark blend) {black}")

    # Replayed frames and bursts against the torch body's eager ones.
    n_seq = cell.traffic["frames_per_call"]
    cams, ligs = orbit.angles(200, n_seq)
    n_strips = -(-w * h // config.strip_len)
    slots = -(-n_strips // config.strip_batch) * config.strip_batch
    per_frame = len(tframe.shade_chunks(slots, config.strip_batch))
    for cname, knobs, bodies in (("default", {}, per_frame), ("compact_shade=False", dict(compact_shade=False), 0)):
        s = Scene(sc.model, "darboux", dataclasses.replace(sc.config, **knobs), device=dev)
        rc = s.config.resolve("darboux")
        for v, (c, li) in zip(orbit_views(100, DARBOUX_POSES_REPLAYED),
                              zip(*orbit.angles(100, DARBOUX_POSES_REPLAYED))):
            s.set_light_direction([math.sin(li), 0.0, math.cos(li)])
            s.set_camera([math.sin(c), 0.0, math.cos(c)], origin, up_y)
            s.render()  # the first call captures
            darboux_cuda.reset_launches()
            got = s.render()
            check(darboux_cuda.LAUNCHES == {"body": bodies},
                  f"{cname}: darboux launches recorded a replayed frame {darboux_cuda.LAUNCHES}, not {bodies}")
            with plain_darboux():
                want = tframe.render_frame(s._geom, s._textures, *v, pipeline="darboux", config=rc)
            for k in ("frame", "z", "shadow", "overflow"):
                check(torch.equal(got[k], want[k]), f"{cname}: replayed {k} differs from the torch body's frame")
        s.render_sequence(cams, ligs)  # captures the burst frame
        darboux_cuda.reset_launches()
        seq = s.render_sequence(cams, ligs)
        check(darboux_cuda.LAUNCHES == {"body": bodies * n_seq},
              f"{cname}: darboux launches recorded in a {n_seq}-frame render_sequence {darboux_cuda.LAUNCHES}")
        with plain_darboux():
            want = tframe._render_burst_eager(s._geom, s._textures, to_tensor(cams, dev), to_tensor(ligs, dev),
                                              pipeline="darboux", config=rc, keep_frames=True)
        check(np.array_equal(seq, want["frames"].cpu().numpy()[:, ::-1]),
              f"{cname}: the {n_seq}-frame render_sequence differs from the torch body's eager burst")
        check(not bool(want["overflow"].any()), f"{cname}: the burst overflowed")
        if cname == "default":
            darboux_cuda.reset_launches()
            trace = tracing.summarize(tracing.profile(lambda: s.render_sequence(cams, ligs), dev)[0], frames=n_seq)
            launches = timing.snapshot()["darboux_launches"]
            ran_ms = [t * 1e3 for name, t in trace.kernels if DARBOUX_KERNEL.search(name)]
            kernels_a_frame = len(trace.kernels) / n_seq
            check(len(ran_ms) == n_seq, f"{len(ran_ms)} darboux kernels ran in a profiled replayed {n_seq}-frame "
                  f"render_sequence, not one a frame")
            check(launches == {"body": per_frame * n_seq}, f"darboux_launches {launches}")
    phase("darboux", f"Scene.render at {DARBOUX_POSES_REPLAYED} poses and a {n_seq}-frame render_sequence "
          f"byte-equal to the torch body's eager frames (default and compact_shade=False); launches recorded a "
          f"replayed frame {per_frame} (one a chunk body in the graph, run or skipped), 0 under "
          f"compact_shade=False; profiled replayed burst: {kernels_a_frame:.2f} kernels a frame, "
          f"{len(ran_ms) / n_seq:.0f} darboux kernel a frame ran, {float(np.mean(ran_ms)):.4f} ms each; "
          f"darboux_launches {launches}")

    # The kernel's time: alone on the frame's first chunk with the launch
    # queue held full, and the strip shade replayed with the kernel and with
    # the torch body.
    calls = []
    launch = darboux_cuda.chunk_body

    def recorded(*a, **k):
        calls.append((a, k))
        launch(*a, **k)

    v = orbit_views(0, 1)[0]
    with mock.patch.object(darboux_cuda, "chunk_body", recorded):
        tframe.render_frame(sc._geom, sc._textures, *v, pipeline="darboux", config=config)
    (a, k), *_ = calls
    setup1, strips = a[0], a[1]
    frame_idx = strips.reshape(-1)[:w * h].reshape(h, w)
    pixels = int((frame_idx >= 0).sum())
    alone = time_launches(lambda: darboux_cuda.chunk_body(*a, **k), DARBOUX_TIMED, hold=True)
    textures = tframe._with_packed_plane(sc._textures, "darboux", config)
    light = {"t_light_direction": a[6]}

    def shade(idx):
        return tframe._shade_strips(setup1, idx, "darboux", light, textures, config, None)

    g_kernel = CapturedGraph(shade, [frame_idx], "the darboux strip shade")
    with plain_darboux():
        g_plain = CapturedGraph(shade, [frame_idx], "the torch darboux strip shade")
    check(g_kernel.darboux_launches == {"body": per_frame} and not any(g_plain.darboux_launches.values()),
          f"darboux launches recorded: {g_kernel.darboux_launches}, torch body {g_plain.darboux_launches}")
    check(torch.equal(g_kernel(frame_idx).clone(), g_plain(frame_idx)), "the replayed strip shades differ")
    ms = {}
    for label, g in (("plain", g_plain), ("kernel", g_kernel), ("kernel2", g_kernel), ("plain2", g_plain)):
        ms[label] = time_launches(lambda g=g: g.graph.replay(), DARBOUX_TIMED, hold=True)
    ms_kernel, ms_plain = min(ms["kernel"], ms["kernel2"]), min(ms["plain"], ms["plain2"])
    bound_ms = roofline_darboux.least_seconds(w, h, pixels) * 1e3
    result = {
        "device_ms": alone, "shade_graph_ms": ms_kernel, "plain_shade_graph_ms": ms_plain,
        "in_burst_ms": float(np.mean(ran_ms)), "slots": a[2].numel(), "pixels": pixels, "bound_ms": bound_ms,
        "bytes": roofline_darboux.darboux_bytes(pixels), "flops": roofline_darboux.darboux_flops(pixels),
        "kernels_per_frame": kernels_a_frame, "launches_recorded_a_frame": per_frame, "cases": cases,
        "registers": registers, "build_s": seconds,
    }
    phase("darboux", f"the kernel on the frame's first chunk ({a[2].numel()} slots of {config.strip_len}): "
          f"{alone:.4f} ms a launch (queue held full), {result['in_burst_ms']:.4f} ms in the burst; the strip "
          f"shade replayed {ms_kernel:.4f} ms against the torch body's {ms_plain:.4f} ms; bound "
          f"{bound_ms * 1e3:.3f} us ({result['bytes']} B at 3.35 TB/s, {pixels} covered pixels), "
          f"{bound_ms / alone:.3%} of it alone, {bound_ms / result['in_burst_ms']:.3%} in the burst  [{smi}]")
    print(json.dumps({"darboux": result}), flush=True)
    return result


def entry_phase(dev, model, config, smi, record, twin, pcams, pligs, shadow_scene, default_scene):
    """Phase 12: the entry points above the frame path (register_pipeline,
    the CLI, the interactive loop, the frame server), every scene starting
    from `config`; launches are reported through record(pipeline, counts)
    and twin is the pair of patches that swap the kernels for their twins."""
    from tiny_renderer_tpu_torch import Scene, app, register_pipeline, unregister_pipeline
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.examples import custom_pipeline as example
    from tiny_renderer_tpu_torch.examples.serve_http import serve
    from tiny_renderer_tpu_torch.ops import raster_cuda
    from tiny_renderer_tpu_torch.pipelines.frame import _render_burst_eager, make_burst_fn, render_frame
    from tiny_renderer_tpu_torch.pipelines.profile import print_stage_breakdown
    from tiny_renderer_tpu_torch.utils.png import png_bytes

    cpu_view = [to_tensor(np.float32(v), "cpu") for v in VIEW]
    view = [to_tensor(np.float32(v), dev) for v in VIEW]
    # (a) Registry: the custom pipelines through Scene and a burst.
    glow = example.glow_attribute(model)
    custom_runs = {}  # name -> (burst fn, scene, burst frames, Scene.render frame)
    for name, per_frame in CUSTOM_LAUNCHES.items():
        csc = Scene(model, name, config, device=dev,
                    vertex_attrs={"glow": glow} if name == "glow" else None)
        csc.set_light_direction(VIEW[0])
        csc.set_camera(*VIEW[1:])
        cburst = make_burst_fn(name, csc.config, keep_frames=True)
        raster_cuda.reset_launches()
        r1 = csc.render()
        torch.cuda.synchronize()
        got_render = dict(raster_cuda.LAUNCHES)
        raster_cuda.reset_launches()
        cout = cburst(csc._geom, csc._textures, pcams, pligs)
        torch.cuda.synchronize()
        got_burst = dict(raster_cuda.LAUNCHES)
        want = {k: 2 * per_frame.get(k, 0) for k in got_render}  # warm-up + replay
        check(got_render == want, f"{name}: Scene.render launches {got_render}, expected {want}")
        want = {k: (N_PIPE_FRAMES + 1) * per_frame.get(k, 0) for k in got_render}
        check(got_burst == want, f"{name}: burst launches {got_burst}, expected {want}")
        record(name, got_render)
        record(name, got_burst)
        cframes = cout["frames"]
        clit = (cframes > 0).any(-1).flatten(1).float().mean(1)
        check(bool((clit > 0).all()), f"{name}: a burst frame is all black: lit share {clit.tolist()}")
        check(not bool(cout["overflow"].any()) and not csc.overflowed, f"{name}: a frame overflowed")
        with twin[0], twin[1]:
            tout = _render_burst_eager(csc._geom, csc._textures, pcams, pligs, pipeline=name,
                                       config=csc.config, keep_frames=True)
            trender = render_frame(csc._geom, csc._textures, *view, pipeline=name, config=csc.config)
        check(raster_cuda.LAUNCHES == got_burst, f"{name}: the twin burst launched a kernel")
        check(torch.equal(tout["frames"], cframes), f"{name}: burst frames differ from the twin-raster burst")
        for k in ("frame", "z", "shadow"):
            check(torch.equal(trender[k], r1[k]), f"{name}: Scene.render {k} differs from the twin raster")
        ccpu = render_frame({k: v.cpu() for k, v in csc._geom.items()},
                            {k: v.cpu() for k, v in csc._textures.items()}, *cpu_view,
                            pipeline=name, config=csc.config)
        cdiff = float((ccpu["frame"] != r1["frame"].cpu()).any(-1).float().mean())
        check(cdiff < 0.005, f"{name}: GPU frame differs from the CPU frame on {cdiff:.4%} of pixels")
        custom_runs[name] = (cburst, csc, cframes, r1["frame"])
        phase("entry", f"{name}: Scene.render {got_render['raster']} + burst {got_burst['raster']} K1 "
              f"launches ({per_frame['raster']} per frame, a warm-up frame per capture), lit share "
              f"{min(clit.tolist()):.4f}-{max(clit.tolist()):.4f}, replayed render and {N_PIPE_FRAMES}-frame "
              f"burst bit-identical to the eager frames with the twin raster; vs the CPU frame {cdiff:.6%} "
              "of pixels differ")
    for label, knobs, per_frame in (("fuse_passes", dict(fuse_passes=True), {"fused": 1}),
                                    ("strip_mask + strip_planes", dict(strip_mask=True, strip_planes=True),
                                     {"raster": 2, "strips": 1, "planes": 1})):
        fsc = Scene(model, "fog", dataclasses.replace(config, **knobs), device=dev)
        raster_cuda.reset_launches()
        fout = make_burst_fn("fog", fsc.config, keep_frames=True)(
            fsc._geom, fsc._textures, pcams[:N_KNOB_FRAMES], pligs[:N_KNOB_FRAMES])
        torch.cuda.synchronize()
        got = dict(raster_cuda.LAUNCHES)
        record("fog", got)
        want = {k: (N_KNOB_FRAMES + 1) * per_frame.get(k, 0) for k in got}  # + the capture's warm-up
        check(got == want, f"fog {label}: launches {got}, expected {want}")
        check(torch.equal(fout["frames"], custom_runs["fog"][2][:N_KNOB_FRAMES]),
              f"fog {label}: burst frames differ from fog's default burst")
        phase("entry", f"fog {label}: {N_KNOB_FRAMES} frames bit-identical to fog's default burst, "
              f"launches {got}")
    cold = Scene(model, "glow", config, device=dev, vertex_attrs={"glow": np.zeros_like(glow)})
    cold.set_light_direction(VIEW[0])
    cold.set_camera(*VIEW[1:])
    check(not torch.equal(cold.render()["frame"], custom_runs["glow"][3]),
          "glow: a zeroed attr:glow renders the same frame")
    phase("entry", "glow: a zeroed attr:glow changes the frame")

    # (b) The CLI in process.  Each app.main builds its Scene through
    # Recording, so the state the CLI rendered can be rendered again.
    class Recording(Scene):
        made = []

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            Recording.made.append(self)

    def again(sc, pipeline=None, config=None):
        """A fresh Scene rendered at the state sc last rendered."""
        ref = Scene(sc.model, pipeline or sc.pipeline_name, config or sc.config, device=dev)
        ref.set_camera(sc._look_from, sc._look_at, sc._up)
        ref.set_light_direction(sc._light_direction)
        ref.render()
        return ref

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    cli = ["--size", str(config.width), str(config.height), "--backend", dev.type]
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(app, "Scene", Recording):
        out = {k: f"{tmp}/{k}.png" for k in ("save", "z", "shadow", "fuse")}
        raster_cuda.reset_launches()
        rc = app.main([*cli, "-s", "shadow", "--frames", "10", "--orbit", "--timing", "--no-fps",
                       "--save", out["save"], "--dump-z", out["z"], "--dump-shadow", out["shadow"]])
        torch.cuda.synchronize()
        got = dict(raster_cuda.LAUNCHES)
        record("shadow", got)
        check(rc == 0, f"app.main shadow --orbit --timing returned {rc}")
        check(got["raster"] >= 20, f"app.main shadow: launches {got}")
        sc = Recording.made[-1]
        ref = again(sc)
        check(read(out["save"]) == png_bytes(ref.get_frame_buffer()), "--save differs from Scene")
        check(read(out["z"]) == png_bytes(ref.get_z_buffer()), "--dump-z differs from Scene")
        check(read(out["shadow"]) == png_bytes(ref.get_shadow_buffer()), "--dump-shadow differs from Scene")
        phase("entry", f"app.main -s shadow --frames 10 --orbit --timing --save --dump-z --dump-shadow: "
              f"rc 0, launches {got}, the three PNGs equal to a Scene at the final angles")

        raster_cuda.reset_launches()
        rc = app.main([*cli, "-s", "toon", "--frames", "8", "--no-fps", "--save-seq", f"{tmp}/seq"])
        torch.cuda.synchronize()
        got = dict(raster_cuda.LAUNCHES)
        record("toon", got)
        # One burst of 8 frames, and its capture's warm-up frame.
        check(rc == 0 and got["raster"] == 9, f"app.main toon --save-seq: rc {rc}, launches {got}")
        sc = Recording.made[-1]
        step = np.arange(8) / 60.0
        seq = Scene(sc.model, "toon", sc.config, device=dev).render_sequence(
            (sc.config.camera_speed * step).astype(np.float32), (-sc.config.light_speed * step).astype(np.float32))
        for i in range(8):
            check(read(f"{tmp}/seq/frame_{i:04d}.png") == png_bytes(seq[i]),
                  f"--save-seq frame {i} differs from render_sequence")
        phase("entry", f"app.main -s toon --frames 8 --save-seq: rc 0, launches {got}, 8 PNGs equal to "
              "render_sequence")

        raster_cuda.reset_launches()
        rc = app.main([*cli, "-s", "shadow", "--frames", "4", "--knob", "fuse_passes=true", "--no-fps",
                       "--save", out["fuse"]])
        torch.cuda.synchronize()
        got = dict(raster_cuda.LAUNCHES)
        record("shadow", got)
        sc = Recording.made[-1]
        check(rc == 0 and sc.config.fuse_passes, f"app.main --knob fuse_passes=true: rc {rc}")
        # Scene.render asks for the camera z, which K2 does not emit: K1, 2
        # per frame of 4 and of the capture's warm-up.
        check(got["raster"] == 10 and got["fused"] == 0, f"app.main --knob fuse_passes=true: launches {got}")
        ref = again(sc, config=config)
        check(read(out["fuse"]) == png_bytes(ref.get_frame_buffer()),
              "--knob fuse_passes=true differs from the default config's Scene")
        phase("entry", f"app.main -s shadow --frames 4 --knob fuse_passes=true: rc 0, launches {got} "
              "(Scene.render wants z), PNG equal to the default config's Scene")
    Recording.made.clear()

    # (c) Interactive, scripted keys and a fake clock.
    isc = Scene(model, "shadow", config, device=dev)
    state = app.InputState(0.0, 0.0, isc.config.camera_speed, isc.config.light_speed)
    dt, prev_dt = 1.0 / 60.0, 0.0
    for i in range(max(KEY_SCRIPT) + 1):  # the loop's integration, replayed
        state.integrate(prev_dt)
        for kind, key in KEY_SCRIPT.get(i, []):
            (state.on_press if kind == "press" else state.on_release)(key)
        prev_dt = dt
    want = again(types.SimpleNamespace(model=model, pipeline_name="shadow", config=isc.config, **dict(zip(
        ("_look_from", "_look_at", "_up", "_light_direction"), app._angles_to_vectors(state.camera, state.light)))))
    inter_ms = {}
    isc.render()  # its graph's capture, before the timed loops
    for label, serial in (("pipelined", False), ("serial", True)):
        viewer = ScriptedViewer(KEY_SCRIPT)
        args = types.SimpleNamespace(camera_angle=0.0, light_angle=0.0, no_fps=True, serial_present=serial)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = app.run_interactive(isc, args, viewer=viewer, clock=fake_clock(dt))
        inter_ms[label] = (time.perf_counter() - t0) * 1e3 / viewer.shown
        check(viewer.shown == max(KEY_SCRIPT) + 1 and not viewer.alive, f"interactive {label}: "
              f"{viewer.shown} frames shown")
        check(np.array_equal(final, want.get_frame_buffer()),
              f"interactive {label}: the final frame differs from Scene.render at the integrated angles")
    phase("entry", f"run_interactive ('d' 5 frames, 'q' 3, Escape): final frame equal to Scene.render at "
          f"camera {state.camera:.4f}, light {state.light:.4f}; ms per frame (host clock, "
          f"{max(KEY_SCRIPT) + 1} frames incl. presentation): pipelined {inter_ms['pipelined']:.3f}, "
          f"serial {inter_ms['serial']:.3f}  [{smi}]")

    # (d) Serving over a loopback port.
    server, service = serve(None, port=0, size=config.width, device=dev)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        for name in ("shadow", "toon"):
            status, body = http_get(f"{base}/render?pipeline={name}&camera=0.9&light=-0.6")
            direct = Scene(service.model, name, service.config, device=dev)
            direct.set_camera(*app._angles_to_vectors(0.9, -0.6)[:3])
            direct.set_light_direction(app._angles_to_vectors(0.9, -0.6)[3])
            check(status == 200 and body == png_bytes(direct.get_frame_buffer()),
                  f"/render {name}: status {status}, bytes differ from a direct render")
        for query in ("pipeline=nope", "pipeline=shadow&camera=abc"):
            status, _ = http_get(f"{base}/render?{query}")
            check(status == 400, f"/render?{query}: status {status}, expected 400")
        n_req = 8
        t0 = time.perf_counter()
        for i in range(n_req):
            status, _ = http_get(f"{base}/render?pipeline=shadow&camera={0.1 * i}")
            check(status == 200, f"/render shadow: status {status}")
        served_ms = (time.perf_counter() - t0) * 1e3 / n_req
        status, body = http_get(f"{base}/healthz")
        health = json.loads(body)
        check(status == 200 and health["ok"] and health["renders"] == 2 + n_req,
              f"/healthz: {status} {health}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "the server thread did not stop")
    phase("entry", f"serve(None, port=0, size={config.width}): /render shadow and toon bytes equal to png_bytes of a "
          f"direct render, 400 on a bad pipeline and angle, /healthz {health}; {served_ms:.3f} ms per "
          f"served {config.width}x{config.width} shadow request (host clock, {n_req} sequential requests, PNG encode "
          f"included)  [{smi}]")

    for sc in (shadow_scene, default_scene):
        print_stage_breakdown(sc, iters=24, out=lambda line: phase("entry", f"{line}  [{smi}]"))
    for name in CUSTOM_LAUNCHES:
        unregister_pipeline(name)


def traced(run, dev):
    """run() under torch.profiler, summarized by benchmark/tracing.py: the
    kernels ((name, s) each) inside the host's window around run(), and the
    device's busy time (the union of its intervals) and the window, in s."""
    from benchmark import tracing

    events, _ = tracing.profile(run, dev)
    return tracing.summarize(events) or tracing.Trace(window_s=0.0, busy_s=0.0, kernels=[], device_ops=[],
                                                      idle_gaps=[])


# The tracer phase: the benchmark's cell, its interactive frames and one
# burst of its mix, and the profiler's count of mark kernels a frame.
TRACE_CELL = "diablo-shadow.orbit-burst"
TRACE_SEED = 2_147_500_431
TRACE_FRAMES = 8
TRACE_MARKS = {"scene.render": 7, "scene.render_sequence": 8}


def trace_phase(dev, smi):
    """Phase 14: the tracer's stage stamps on the card at the benchmark
    cell's 800^2 shadow frame (benchmark/configs, the seed's scene): TRACE_FRAMES frames
    of Scene.render + get_frame_buffer along the mix's orbit and one
    render_sequence of the mix's frames_per_call, first with the tracer
    off, then on.  The frames byte-equal; the drained frames numbered in
    turn, none dropped, each under the call that issued it with its marks'
    labels; each frame's stamped covered count equal to the count the strip
    shade gives eagerly (render_frame and the eager burst) at the same pose;
    torch.profiler over a traced frame and a traced burst counts
    TRACE_MARKS mark kernels a frame and holds the program's spans as host
    ranges."""
    from benchmark import harness, tracing
    from benchmark.orbit import Orbit, host_vectors
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.pipelines.frame import _render_burst_eager, render_frame
    from tiny_renderer_tpu_torch.utils import timing

    cell = harness.find_cell(TRACE_CELL)
    n_burst = cell.traffic["frames_per_call"]
    sc = harness.build_scene(cell.config, TRACE_SEED, dev)[0]
    config = sc.config.resolve(sc.pipeline_name)
    orbit = Orbit(TRACE_SEED, cell.traffic["camera_step_rad"], cell.traffic["light_step_rad"])
    cams, ligs = orbit.angles(0, n_burst)
    poses = [host_vectors(float(c), float(li)) for c, li in zip(cams[:TRACE_FRAMES], ligs[:TRACE_FRAMES])]

    def calls():
        frames = []
        for light, look_from in poses:
            sc.set_camera(look_from, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
            sc.set_light_direction(light)
            sc.render()
            frames.append(sc.get_frame_buffer())
        return frames, sc.render_sequence(cams, ligs)

    def eager_counts(run):
        """The strip shade's covered counts of run()'s eager frames, in turn."""
        got = []
        with mock.patch.object(timing, "shade_count", lambda covered, starts: got.append(int(covered))):
            run()
        return got

    check(not timing.tracing(), "the tracer is on before the trace phase")
    timing.snapshot()
    off, seq_off = calls()
    timing.enable()
    before = max([r.last for r in timing._RINGS.values()], default=0)
    on, seq_on = calls()  # captures the traced frame and burst graphs
    timing.snapshot()
    on, seq_on = calls()  # replays them
    snap = timing.snapshot()
    check(all(np.array_equal(a, b) for a, b in zip(off, on)) and np.array_equal(seq_off, seq_on),
          "frames differ with the tracer on")
    frames = snap["frames"]
    first = frames[0]["frame"] if frames else 0
    check(len(frames) == TRACE_FRAMES + n_burst and snap["dropped"] == {"spans": 0, "frames": 0}
          and [fr["frame"] for fr in frames] == list(range(first, first + len(frames))) and first > before,
          f"drained frames {[fr['frame'] for fr in frames]} (from {before}), dropped {snap['dropped']}")
    roots = {sp["id"]: sp["name"] for sp in snap["spans"] if sp["parent"] is None}
    issuers = [roots.get(fr["call"]) for fr in frames]
    check(issuers == ["scene.render"] * TRACE_FRAMES + ["scene.render_sequence"] * n_burst,
          f"frames credited to {collections.Counter(issuers)}")
    check(all(len(fr["labels"]) == TRACE_MARKS[who] and fr["stamps_ns"] == sorted(fr["stamps_ns"])
              for fr, who in zip(frames, issuers)), "labels or stamps out of order")
    views = [torch.from_numpy(np.stack([light, look_from, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]]).astype(np.float32))
             .to(dev) for light, look_from in poses]
    want = eager_counts(lambda: [render_frame(sc._geom, sc._textures, *v, pipeline=sc.pipeline_name,
                                              config=config, backend=sc.backend) for v in views])
    want += eager_counts(lambda: _render_burst_eager(
        sc._geom, sc._textures, to_tensor(cams, dev), to_tensor(ligs, dev), pipeline=sc.pipeline_name,
        config=config, keep_frames=True, backend=sc.backend))
    got = [fr["covered"] for fr in frames]
    check(got == want, f"stamped covered counts {got} against the eager shade's {want}")

    def profiled(run, n):
        trace = tracing.profile(run, dev)[0]
        marks = sum("mark_kernel" in e.get("name", "") for e in trace if e.get("cat") == "kernel")
        ranges = {e["name"] for e in trace if e.get("cat") == "user_annotation"}
        return marks / n, ranges

    per_frame, ranges = profiled(lambda: [sc.render(), sc.get_frame_buffer()], 1)
    per_burst, burst_ranges = profiled(lambda: sc.render_sequence(cams, ligs), n_burst)
    timing.snapshot()
    timing.disable()
    timing.snapshot()
    check((per_frame, per_burst) == (TRACE_MARKS["scene.render"], TRACE_MARKS["scene.render_sequence"]),
          f"mark kernels a frame in the profiler's trace: {per_frame} (frame), {per_burst} (burst)")
    check(ranges >= {"scene.render", "scene.stage", "graph.replay", "frame.clone", "scene.fetch"}
          and burst_ranges >= {"scene.render_sequence", "sequence.issue", "sequence.copy", "graph.replay"},
          f"the program's spans in the profiler's trace: {sorted(ranges | burst_ranges)}")
    stages = {k: float(np.median([fr["stages"][k] for fr in frames[TRACE_FRAMES:]]))
              for k in ("vertex", "binning", "raster", "shade")}
    phase("trace", f"{TRACE_CELL} (seed {TRACE_SEED}): {TRACE_FRAMES} Scene.render frames and a {n_burst}-frame "
          f"render_sequence byte-equal with the tracer off and on; frames {first}..{first + len(frames) - 1} "
          f"drained in turn, 0 dropped; covered counts {min(got)}..{max(got)} equal to the eager shade's "
          f"(chunks {sorted(collections.Counter(fr['chunks'] for fr in frames).items())}); profiler: "
          f"{per_frame:.0f} mark kernels a frame, {per_burst:.0f} a burst frame, the spans as host ranges; "
          f"burst stages (median device ms) " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"  [{smi}]")


# The sequence phase: the burst cells' scenes, SEQ_CALLS back-to-back
# render_sequence calls of their mix's frames_per_call each.
SEQ_CELLS = ("diablo-shadow.orbit-burst", "diablo-occlusion.orbit-burst")
SEQ_SEED = 2_147_511_913
SEQ_CALLS = 3
SEQ_ROUNDS = 4  # timed rounds of SEQ_CALLS calls, the two returns in turns


def sequence_phase(dev, smi):
    """Phase 14b: render_sequence's frames returned through pinned host
    memory, each frame's copy on the copy stream behind the next replay, on
    the two burst cells' 800^2 scenes (shadow and occlusion; benchmark/configs,
    the seed's scene).  SEQ_CALLS back-to-back calls along the mix's orbit,
    every array held: each byte-equal to render_burst(..., keep_frames=True)
    ["frames"].cpu().numpy()[:, ::-1] at the same angles; the first call's
    array unchanged after the later calls (a pinned block in use is never
    given out again); the counter sequence.overlapped N - 1 a call with the
    tracer on, and the frames byte-equal with it off and on.  Prints ms a
    frame of the closed loop (the previous array held, as the benchmark's
    loop holds it) against the one pageable .cpu() after the burst, in
    turns, and whether a dropped array's pinned block was given out again."""
    from benchmark import harness
    from benchmark.orbit import Orbit
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.pipelines.frame import make_burst_fn
    from tiny_renderer_tpu_torch.utils import timing

    check(not timing.tracing(), "the tracer is on before the sequence phase")
    for name in SEQ_CELLS:
        cell = harness.find_cell(name)
        n = cell.traffic["frames_per_call"]
        sc = harness.build_scene(cell.config, SEQ_SEED, dev)[0]
        orbit = Orbit(SEQ_SEED, cell.traffic["camera_step_rad"], cell.traffic["light_step_rad"])
        angles = [orbit.angles(k * n, n) for k in range(SEQ_CALLS)]
        burst = make_burst_fn(sc.pipeline_name, sc.config, keep_frames=True, backend=sc.backend)

        def pageable(cams, ligs):
            """The return before pinned staging: one .cpu() after the burst."""
            out = burst(sc._geom, sc._textures, to_tensor(cams, dev), to_tensor(ligs, dev))
            check(not bool(out["overflow"].any()), f"{name}: a burst frame overflowed")
            return out["frames"].cpu().numpy()[:, ::-1]

        timing.snapshot()
        held = [sc.render_sequence(*a) for a in angles]
        first = held[0].copy()
        want = [pageable(*a) for a in angles]
        check(all(np.array_equal(h, w) for h, w in zip(held, want)),
              f"{name}: render_sequence's frames differ from the burst's kept frames")
        check(np.array_equal(held[0], first), f"{name}: the first call's frames changed under later calls")
        addresses = {h.ctypes.data for h in held}
        check(len(addresses) == SEQ_CALLS, f"{name}: held calls share pinned blocks")
        dropped = held.pop().ctypes.data
        again = sc.render_sequence(*angles[-1])
        reused = again.ctypes.data == dropped
        check(np.array_equal(again, want[-1]), f"{name}: a call into a reused block differs")
        del again
        timing.enable()
        traced = [sc.render_sequence(*a) for a in angles]  # the first captures the traced graph
        counters = timing.snapshot()["counters"]
        timing.disable()
        timing.snapshot()
        check(all(np.array_equal(t, w) for t, w in zip(traced, want)), f"{name}: frames differ with the tracer on")
        check(counters.get("sequence.overlapped") == SEQ_CALLS * (n - 1)
              and counters.get("sequence.frames") == SEQ_CALLS * n,
              f"{name}: counters {counters.get('sequence.overlapped')} overlapped, "
              f"{counters.get('sequence.frames')} frames over {SEQ_CALLS} calls")
        del held, traced, want

        ms = {"pinned": [], "pageable": []}
        for r in range(SEQ_ROUNDS):
            for how in (("pinned", "pageable") if r % 2 == 0 else ("pageable", "pinned")):
                call = sc.render_sequence if how == "pinned" else pageable
                out = call(*angles[0])  # the loop holds the previous array while it calls again
                t = time.perf_counter()
                for a in angles:
                    out = call(*a)
                ms[how].append(1e3 * (time.perf_counter() - t) / (SEQ_CALLS * n))
                del out
        phase("sequence", f"{name} (seed {SEQ_SEED}): {SEQ_CALLS} render_sequence calls of {n} frames byte-equal "
              f"to the kept burst frames, the first unchanged under the later ones, with the tracer off and on; "
              f"sequence.overlapped {counters['sequence.overlapped'] // SEQ_CALLS} a call; a dropped array's "
              f"pinned block given out again: {reused}; ms a frame, closed loop (median of {SEQ_ROUNDS} rounds): "
              f"pinned {statistics.median(ms['pinned']):.4f} {[round(v, 4) for v in ms['pinned']]}, pageable "
              f"{statistics.median(ms['pageable']):.4f} {[round(v, 4) for v in ms['pageable']]}  [{smi}]")

# The kernels of csrc/raster.cu as the trace names them: K1's instantiations
# raster_kernel<with_idx, with_planes> and K2.
K1_TRACE = re.compile(r"raster_kernel<(true|false), (true|false)>")
K2_TRACE = re.compile(r"raster_fused_kernel")
# Shadow configs whose replayed burst (or, for "camera z+idx", replayed
# Scene.render) gives one mode's in-graph time: (knobs, the instantiation
# (idx, planes) or "fused").
GRAPH_MODES = {
    "light z": ({}, ("false", "false")),
    "camera idx": ({}, ("true", "false")),
    "camera z+idx": ({}, ("true", "false")),
    "gathered": (dict(csr_indirect=False), ("true", "false")),
    "int16": (dict(idx_int16=True), ("true", "false")),
    "strips": (dict(strip_mask=True), ("true", "false")),
    "planes": (dict(strip_planes=True), ("true", "true")),
    "fused": (dict(fuse_passes=True), "fused"),
    # darboux's 4-plane kernel spec (texel index over its maps + local_z),
    # a replayed darboux burst under compact_shade=False.
    "planes darboux": (dict(compact_shade=False), ("true", "true"), "darboux"),
}
N_GRAPH_FRAMES = 64
N_GRAPH_TIMED = 16


def graph_phase(dev, model, pmodel, smi, record):
    """Phase 7: the frame and the burst as replayed CUDA graphs, for the
    seven pipelines under their knob configs and the custom toon, fog and
    glow.  Each Scene.render (a replayed graph) byte-equal to the eager
    render_frame at three poses, with the eager launch counts; a
    64-frame replayed burst's checksums and overflow flags equal to the
    eager burst's, with its launch counts; sync debug mode "error" silent
    around a replay and a burst; a re-registered pipeline renders its new
    shade.  Times: eager against replayed bursts and host loops per
    pipeline, the device's idle share under the profiler over a replayed
    burst, each mode's K1/K2 device ms inside a replayed graph, capture
    seconds and memory reserved per graph.  Returns {mode: in-graph ms per
    launch}."""
    from tiny_renderer_tpu_torch import RenderConfig, Scene, app, register_pipeline, unregister_pipeline
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.examples import custom_pipeline as example
    from tiny_renderer_tpu_torch.ops import raster_cuda
    from tiny_renderer_tpu_torch.pipelines import frame as tframe
    from tiny_renderer_tpu_torch.pipelines import graphs
    from tiny_renderer_tpu_torch.pipelines.frame import _render_burst_eager, make_burst_fn, render_frame

    poses = [app._angles_to_vectors(c, li) for c, li in ((0.2, -0.5), (0.9, 0.4), (-1.3, 2.2))]
    cams = torch.tensor(0.37 + 0.05 * np.arange(N_GRAPH_FRAMES), dtype=torch.float32, device=dev)
    ligs = torch.tensor(-0.6 + 0.03 * np.arange(N_GRAPH_FRAMES), dtype=torch.float32, device=dev)
    glow = example.glow_attribute(model)
    runs = [("shadow", "default", {}, {"raster": 2})]
    runs += [("shadow", k, knobs, per) for k, (knobs, per) in KNOBS.items()]
    for p in NEW_PIPELINES:
        runs.append((p, "default", {}, pipeline_launches(p)))
        runs += [(p, k, knobs, per) for k, (knobs, per) in pipeline_knobs(p).items()]
    runs.append(("occlusion", "dedup", dict(occlusion_dedup=True), pipeline_launches("occlusion")))
    runs += [("toon", "default", {}, {"raster": 1}), ("fog", "default", {}, {"raster": 2}),
             ("fog", "fuse", dict(fuse_passes=True), {"fused": 1}),
             ("fog", "mask+planes", dict(strip_mask=True, strip_planes=True),
              {"raster": 2, "strips": 1, "planes": 1}),
             ("glow", "default", {}, {"raster": 1})]

    def counted(fn):
        raster_cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, dict(raster_cuda.LAUNCHES)

    def views(pose):
        return [to_tensor(np.float32(v), dev) for v in (pose[3], *pose[:3])]

    captures, scenes, sums = [], {}, {}
    for pipeline, label, knobs, per_frame in runs:
        name = f"{pipeline} {label}"
        sc = Scene(pmodel if pipeline in NEW_PIPELINES else model, pipeline, RenderConfig(**knobs), device=dev,
                   vertex_attrs={"glow": glow} if pipeline == "glow" else None)
        before = tframe._GRAPHS.graphs()
        for i, pose in enumerate(poses):
            sc.set_camera(*pose[:3])
            sc.set_light_direction(pose[3])
            got, g_counts = counted(sc.render)
            want, e_counts = counted(lambda: render_frame(sc._geom, sc._textures, *views(pose),
                                                          pipeline=pipeline, config=sc.config))
            for k in ("frame", "z", "shadow", "overflow"):
                check(torch.equal(got[k], want[k]), f"graph {name} pose {i}: replayed {k} differs from eager")
            if i:  # the first call also ran the capture's warm-up frame
                check(g_counts == e_counts and g_counts["raster"] + g_counts["fused"] > 0,
                      f"graph {name}: launches per replay {g_counts}, eager {e_counts}")
        record(pipeline, g_counts)
        burst = make_burst_fn(pipeline, sc.config)
        burst(sc._geom, sc._textures, cams[:1], ligs[:1])  # the capture
        bg, bg_counts = counted(lambda: burst(sc._geom, sc._textures, cams, ligs))
        be, be_counts = counted(lambda: _render_burst_eager(sc._geom, sc._textures, cams, ligs,
                                                            pipeline=pipeline, config=sc.config))
        want = {k: N_GRAPH_FRAMES * per_frame.get(k, 0) for k in bg_counts}
        check(bg_counts == be_counts == want, f"graph {name}: burst launches {bg_counts}, eager {be_counts}, "
              f"expected {want}")
        record(pipeline, bg_counts)
        check(torch.equal(bg["checksums"], be["checksums"]) and torch.equal(bg["overflow"], be["overflow"]),
              f"graph {name}: the replayed burst's checksums differ from the eager burst's")
        check(not bool(bg["overflow"].any()), f"graph {name}: overflow")
        sums[pipeline, label] = bg["checksums"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            sc.render()
            burst(sc._geom, sc._textures, cams, ligs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize(dev)
        new = [g for g in tframe._GRAPHS.graphs() if not any(g is b for b in before)]
        captures += [(name, g.capture_s, g.pool_bytes) for g in new]
        scenes[pipeline, label] = (sc, burst)
        phase("graph", f"{name}: Scene.render replayed at 3 poses byte-equal to eager render_frame "
              f"(launches per replay {({k: v for k, v in g_counts.items() if v})} = eager); "
              f"{N_GRAPH_FRAMES}-frame replayed burst checksums equal to the eager burst's, launches "
              f"{({k: v for k, v in bg_counts.items() if v})} = eager; sync debug mode 'error' silent; "
              "graphs captured (s, MB reserved): " + ", ".join(f"{c:.3f} s {b / 2**20:.1f}" for _, c, b in
                                                               captures[len(captures) - len(new):]))
    check(torch.equal(sums["occlusion", "dedup"], sums["occlusion", "default"]),
          "graph occlusion dedup: the burst's checksums differ from occlusion's default burst")
    phase("graph", f"occlusion_dedup: the {N_GRAPH_FRAMES}-frame replayed burst's checksums equal to the "
          "default occlusion burst's")
    caps = [c for _, c, _ in captures]
    mbs = [b / 2**20 for _, _, b in captures]
    phase("graph", f"{len(runs)} configs, {len(captures)} graphs captured: capture (warm-up + capture) "
          f"{min(caps):.3f}-{max(caps):.3f} s (median {float(np.median(caps)):.3f}), memory reserved per graph "
          f"{min(mbs):.1f}-{max(mbs):.1f} MB (median {float(np.median(mbs)):.1f}; the largest: "
          + ", ".join(f"{n} {b / 2**20:.1f}" for n, _, b in sorted(captures, key=lambda x: -x[2])[:3])
          + f"); at most {graphs.GRAPH_CACHE_SIZE} graphs alive  [{smi}]")

    # A re-registered pipeline renders its new shade (the gen key).
    def negative(frag, uniforms, textures, config):
        return 255 - example.shade_toon(frag, uniforms, textures, config)

    spec = example.TOON_SPEC
    register_pipeline("regen", example.shade_toon, varying_spec=spec, maps=("texture",),
                      needs=("vertex_intensity",), overwrite=True)
    try:
        old = Scene(model, "regen", RenderConfig(), device=dev)
        a = old.render()["frame"]
        register_pipeline("regen", negative, varying_spec=spec, maps=("texture",),
                          needs=("vertex_intensity",), overwrite=True)
        sc = Scene(model, "regen", RenderConfig(), device=dev)
        b = sc.render()
        e = render_frame(sc._geom, sc._textures, *views((old._look_from, old._look_at, old._up,
                                                         old._light_direction)), pipeline="regen", config=sc.config)
        covered = b["z"] > -3e38
        check(torch.equal(b["frame"], e["frame"]) and bool(covered.any())
              and torch.equal(b["frame"][covered], 255 - a[covered]),
              "re-registered pipeline: the new Scene does not render the new shade")
        bb = make_burst_fn("regen", sc.config)(sc._geom, sc._textures, cams[:4], ligs[:4])
        eb = _render_burst_eager(sc._geom, sc._textures, cams[:4], ligs[:4], pipeline="regen", config=sc.config)
        check(torch.equal(bb["checksums"], eb["checksums"]), "re-registered pipeline: the burst's checksums")
    finally:
        unregister_pipeline("regen")
    phase("graph", "a pipeline re-registered with another shade: a new Scene and burst replay graphs of the "
          "new shade (its generation in the key), equal to the eager frames")

    # Times: eager against replayed, bursts and host loops, pipelines in turns.
    def burst_ms(fn, sc):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn(sc._geom, sc._textures, cams[:N_GRAPH_TIMED], ligs[:N_GRAPH_TIMED])
        out["checksums"].cpu()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t) * 1e3 / N_GRAPH_TIMED

    def loop_ms(render, sc):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for i in range(N_GRAPH_TIMED):
            a, b = 0.37 + 0.05 * i, -0.6 + 0.03 * i
            sc.set_camera(*app._angles_to_vectors(a, b)[:3])
            sc.set_light_direction(app._angles_to_vectors(a, b)[3])
            render(sc)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t) * 1e3 / N_GRAPH_TIMED

    def eager_render(sc):
        vecs = [to_tensor(v, dev) for v in (sc._light_direction, sc._look_from, sc._look_at, sc._up)]
        return render_frame(sc._geom, sc._textures, *vecs, pipeline=sc.pipeline_name, config=sc.config)

    kinds = {
        "burst eager": lambda sc, fn: burst_ms(lambda *a: _render_burst_eager(
            *a, pipeline=sc.pipeline_name, config=sc.config), sc),
        "burst replayed": lambda sc, fn: burst_ms(fn, sc),
        "loop eager": lambda sc, fn: loop_ms(eager_render, sc),
        "loop replayed": lambda sc, fn: loop_ms(Scene.render, sc),
    }
    best = {(p, k): float("inf") for p in PIPELINE_ORDER for k in kinds}
    for rnd in range(2):
        for p in (PIPELINE_ORDER if rnd == 0 else PIPELINE_ORDER[::-1]):
            for k in (list(kinds) if rnd == 0 else list(kinds)[::-1]):
                best[p, k] = min(best[p, k], kinds[k](*scenes[p, "default"]))
    phase("graph", f"ms/frame at 800x800, default config (host clock + synchronize, best of 2 in turns; bursts of "
          f"{N_GRAPH_TIMED} closed by the checksums' fetch, host loops of {N_GRAPH_TIMED} Scene.render-style "
          "frames with new camera and light each): " + "; ".join(
              f"{p} " + " / ".join(f"{k} {best[p, k]:.3f}" for k in kinds) for p in PIPELINE_ORDER)
          + f"  [{smi}]")

    # The profiler over replayed bursts: idle share, and each mode's kernel
    # time inside the graph.
    graph_ms, shadow_sc = {}, scenes["shadow", "default"][0]
    for mode, (knobs, inst, *other) in GRAPH_MODES.items():
        # Each graph is captured and replayed once before the trace: the
        # trace holds replays of a graph already on the device.
        pipeline = other[0] if other else "shadow"
        if mode == "camera z+idx":
            run, n = shadow_sc.render, 4
        else:
            sc = shadow_sc if not knobs else Scene(pmodel if other else model, pipeline, RenderConfig(**knobs),
                                                   device=dev)
            fn = make_burst_fn(pipeline, sc.config)
            run = (lambda fn=fn, sc=sc: fn(sc._geom, sc._textures, cams[:N_GRAPH_TIMED], ligs[:N_GRAPH_TIMED]))
            n = N_GRAPH_TIMED
        run()
        profiled = traced(run, dev)
        if inst == "fused":
            durs = [1e3 * sec for name, sec in profiled.kernels if K2_TRACE.search(name)]
        else:
            durs = [1e3 * sec for name, sec in profiled.kernels
                    if (m := K1_TRACE.search(name)) and m.groups() == inst]
        graph_ms[mode] = float(np.mean(durs)) if durs else None
        phase("graph", f"profiler over {n} replayed {pipeline} {'Scene.render' if mode == 'camera z+idx' else 'burst'}"
              f" frames ({knobs or 'default config'}): {len(profiled.kernels)} GPU kernels, "
              f"device busy {1e3 * profiled.busy_s:.3f} ms of a {1e3 * profiled.window_s:.3f} ms window "
              f"({1 - profiled.busy_s / profiled.window_s if profiled.window_s else float('nan'):.1%} idle); "
              f"{mode}: {len(durs)} launches, "
              + (f"{graph_ms[mode]:.4f} ms per launch inside the graph" if durs else "not in the trace")
              + f"  [{smi}]")
    return graph_ms


# The shade phase: the strip shade as it ran before its chunks (every slot
# in one batch), alone, in device ms (scripts/torch_shade_device_time.py
# on an NVIDIA H100 80GB HBM3 at 700 W), beside this run's chunked shade.
ALL_SLOTS_SHADE_MS = {"shadow": 1.119, "occlusion": 4.455}
SHADE_RUNS = [(p, "default", {}) for p in PIPELINE_ORDER] + [
    ("occlusion", "dedup", dict(occlusion_dedup=True)),
    ("shadow", "mask+planes+nopack", dict(strip_mask=True, strip_planes=True, strip_pack_words=False))]
N_SHADE_FRAMES = 4  # burst frames per coverage, camera angles near 0 (the wall covers every strip)
N_SHADE_TRACED = 8  # replayed Scene.render frames under the profiler per coverage
IF_TRACE = re.compile(r"set_conditional_kernel")


def shade_phase(dev, pmodel, smi, record):
    """Phase 8: the strip shade's covered-count chunks, IF nodes of the
    replayed graphs (frame.shade_chunks, graphs.device_if), at three
    coverages: no triangle on screen, the stock pose, and a wall covering
    every strip (scripts/torch_shade_device_time.py's coverage_models).
    Every pipeline's replayed Scene.render byte-equal to the eager
    render_frame and its replayed burst's frames to the eager burst's (and
    occlusion under occlusion_dedup, which on the card runs the same
    occlusion kernel, and shadow under strip_mask + strip_planes + nopack), and
    SHARD_CONFIGS' replayed sharded frames to the eager sharded frame and
    to render_frame.  torch.profiler over replayed shadow frames: GPU
    kernels per frame at each coverage and the chunk bodies they ran (the
    count-0 frame none).  The replayed shade's device ms against covered
    strips beside the earlier all-slots shade, and capture s and MB per graph."""
    from tiny_renderer_tpu_torch import RenderConfig, Scene
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.ops import raster_cuda
    from tiny_renderer_tpu_torch.ops.mathlib import F32_MIN
    from tiny_renderer_tpu_torch.parallel import make_row_mesh, render_frame_sharded, sharding
    from tiny_renderer_tpu_torch.pipelines import frame as tframe
    from tiny_renderer_tpu_torch.pipelines.frame import _render_burst_eager, make_burst_fn, render_frame

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_shade_device_time as shade_time

    models = shade_time.coverage_models(pmodel)
    view = [to_tensor(np.float32(v), dev) for v in VIEW]
    cams = torch.tensor(0.10 + 0.05 * np.arange(N_SHADE_FRAMES), dtype=torch.float32, device=dev)
    ligs = torch.tensor(-0.2 + 0.1 * np.arange(N_SHADE_FRAMES), dtype=torch.float32, device=dev)
    keys = ("frame", "z", "shadow", "overflow")

    def covered_strips(z, cfg):
        return int((z > F32_MIN).reshape(-1, cfg.strip_len).any(-1).sum())

    def coverage_ok(cov, n, cfg):
        strips = cfg.width * cfg.height // cfg.strip_len
        return n == 0 if cov == "none" else n == strips if cov == "all" else 0 < n < strips // 4

    captures, scenes = [], {}
    for pipeline, label, knobs in SHADE_RUNS:
        t0, notes, before = time.perf_counter(), [], tframe._GRAPHS.graphs()
        for cov in shade_time.COVERAGES:
            sc = Scene(models[cov], pipeline, RenderConfig(**knobs), device=dev)
            sc.set_light_direction(VIEW[0])
            sc.set_camera(*VIEW[1:])
            raster_cuda.reset_launches()
            got = sc.render()
            torch.cuda.synchronize(dev)
            record(pipeline, raster_cuda.LAUNCHES)
            want = render_frame(sc._geom, sc._textures, *view, pipeline=pipeline, config=sc.config)
            for k in keys:
                check(torch.equal(got[k], want[k]), f"shade {pipeline} {label} {cov}: replayed {k} differs from eager")
            n = covered_strips(want["z"], sc.config)
            check(coverage_ok(cov, n, sc.config) and not bool(want["overflow"]),
                  f"shade {pipeline} {label} {cov}: {n} covered strips, overflow {bool(want['overflow'])}")
            raster_cuda.reset_launches()
            bg = make_burst_fn(pipeline, sc.config, keep_frames=True)(sc._geom, sc._textures, cams, ligs)
            torch.cuda.synchronize(dev)
            record(pipeline, raster_cuda.LAUNCHES)
            be = _render_burst_eager(sc._geom, sc._textures, cams, ligs, pipeline=pipeline, config=sc.config,
                                     keep_frames=True)
            check(torch.equal(bg["frames"], be["frames"]) and torch.equal(bg["checksums"], be["checksums"])
                  and torch.equal(bg["overflow"], be["overflow"]),
                  f"shade {pipeline} {label} {cov}: the replayed burst differs from the eager burst")
            lit = (bg["frames"] > 0).any(-1).flatten(1).float().mean(1)
            check(bool((lit == 0).all()) if cov == "none" else bool((lit > 0).all()),
                  f"shade {pipeline} {label} {cov}: burst lit shares {lit.tolist()}")
            notes.append(f"{cov} {n}")
            scenes[pipeline, label, cov] = sc
        new = [g for g in tframe._GRAPHS.graphs() if not any(g is b for b in before)]
        captures += [(f"{pipeline} {label}", g.capture_s, g.pool_bytes) for g in new]
        phase("shade", f"{pipeline} {label}: Scene.render and a {N_SHADE_FRAMES}-frame burst replayed, byte-equal "
              f"to eager render_frame and the eager burst at covered strips {', '.join(notes)}; graphs captured "
              "(s, MB reserved): " + ", ".join(f"{c:.3f} s {b / 2**20:.1f}" for _, c, b in
                                               captures[len(captures) - len(new):])
              + f"  [{time.perf_counter() - t0:.1f} s]")
    caps = [c for _, c, _ in captures]
    mbs = [b / 2**20 for _, _, b in captures]
    phase("shade", f"{len(captures)} graphs captured: capture (warm-up + capture) {min(caps):.3f}-{max(caps):.3f} s "
          f"(median {float(np.median(caps)):.3f}), memory reserved per graph {min(mbs):.1f}-{max(mbs):.1f} MB "
          f"(median {float(np.median(mbs)):.1f}; the largest: " + ", ".join(
              f"{n} {b / 2**20:.1f}" for n, _, b in sorted(captures, key=lambda x: -x[2])[:3]) + f")  [{smi}]")

    # The sharded frames at the three coverages.
    t1 = time.perf_counter()
    mesh = make_row_mesh([dev] * ROW_SHARDS)
    for name, (knobs, needs_z, per_frame) in SHARD_CONFIGS.items():
        c = dataclasses.replace(RenderConfig(), **knobs).resolve("shadow")
        for cov in shade_time.COVERAGES:
            g, t = scenes["shadow", "default", cov]._geom, scenes["shadow", "default", cov]._textures
            single = render_frame(g, t, *view, pipeline="shadow", config=c, needs_z=needs_z)
            eager = sharding._frame_sharded(g, t, tuple(view), pipeline="shadow", config=c, mesh=mesh,
                                            backend="kernel", needs_z=needs_z, eager=True)
            raster_cuda.reset_launches()
            for _ in range(2):  # the capture, then a replay alone
                got = render_frame_sharded(g, t, *view, pipeline="shadow", config=c, mesh=mesh, needs_z=needs_z)
            torch.cuda.synchronize(dev)
            record("shadow, row-sharded", raster_cuda.LAUNCHES)
            for k in keys:
                for other, what in ((eager, "eager sharded"), (single, "render_frame")):
                    check((got[k] is None) == (other[k] is None) and (got[k] is None or torch.equal(got[k], other[k])),
                          f"shade sharded {name} {cov}: replayed {k} differs from the {what} frame")
    phase("shade", f"render_frame_sharded on {ROW_SHARDS} row shards of {dev} under {', '.join(SHARD_CONFIGS)}, "
          f"replayed at the three coverages: frame, z, shadow, overflow byte-equal to the eager sharded frame and "
          f"to render_frame  [{time.perf_counter() - t1:.1f} s]")

    # Kernels per replayed shadow frame at each coverage: the chunk bodies
    # past the covered count launch nothing.  (That the count-0 frame runs
    # no body at all is checked on the shade alone below: a body's kernels
    # vary a little with its chunk's size, the shade alone's count does
    # not.)
    def kernels(run, n):
        ks = [name for name, _ in traced(lambda: [run() for _ in range(n)], dev).kernels]
        return len(ks) / n, sum(bool(IF_TRACE.search(k)) for k in ks) / n

    rows = []
    for cov in shade_time.COVERAGES:
        sc = scenes["shadow", "default", cov]
        sc.render()
        per, ifs = kernels(sc.render, N_SHADE_TRACED)
        n = covered_strips(sc.render()["z"], sc.config)
        slots = -(-(sc.config.width * sc.config.height // sc.config.strip_len) // sc.config.strip_batch) \
            * sc.config.strip_batch
        bounds = tframe.shade_chunks(slots, sc.config.strip_batch)
        rows.append((cov, n, per, ifs, sum(start < n for start, _ in bounds)))
    per_frame = [r[2] for r in rows]
    check(per_frame[0] < per_frame[1] < per_frame[2] and all(ifs == len(bounds) for *_, ifs, _ in rows)
          and [r[4] for r in rows] == [0, 1, len(bounds)],
          f"shade profile: kernels per replayed frame {per_frame}, IF-node setters {[r[3] for r in rows]}, "
          f"chunk bodies by the rule {[r[4] for r in rows]}, chunks {bounds}")
    phase("shade", f"torch.profiler over {N_SHADE_TRACED} replayed shadow Scene.render frames per coverage: "
          + "; ".join(f"{cov} ({n} covered strips, {ran} chunk bodies by the rule) {per:.0f} GPU kernels a frame "
                      f"({ifs:.0f} IF-node setters)" for cov, n, per, ifs, ran in rows)
          + f"; chunks {bounds}  [{smi}]")

    # The replayed shade alone against covered strips; at count 0 each
    # chunk adds only its predicate and its IF node's setter.
    t2 = time.perf_counter()
    res = shade_time.measure(pmodel, list(ALL_SLOTS_SHADE_MS), 10, dev, rules=(None, (1.0,)))
    for pipeline, by_cov in res.items():
        none = by_cov["none"]
        check(none["graph"]["kernels"] - none["graph 1"]["kernels"] == 2 * (none["graph"]["chunks"] - 1),
              f"shade {pipeline} alone at count 0: {none['graph']['kernels']} kernels under the chunk rule, "
              f"{none['graph 1']['kernels']} under one chunk: a body ran")
        phase("shade", f"{pipeline} shade alone (scripts/torch_shade_device_time.py; device ms per call, GPU "
              f"kernels; the earlier shade over every slot {ALL_SLOTS_SHADE_MS[pipeline]:.3f} ms): " + "; ".join(
                  f"{cov} ({r['covered_strips']} of {r['strips']} strips) chunked {r['graph']['device_ms']:.4f} ms "
                  f"{r['graph']['kernels']:.0f} kernels {r['graph']['chunks_run']} of {r['graph']['chunks']} chunks, "
                  f"one chunk of every slot {r['graph 1']['device_ms']:.4f} ms {r['graph 1']['kernels']:.0f} kernels"
                  + (f", eager (every chunk) {r['eager']['device_ms']:.4f} ms" if "eager" in r else "")
                  for cov, r in by_cov.items()) + f"  [{smi}]")
    phase("shade", f"shade times took {time.perf_counter() - t2:.1f} s")


def profile_phase(dev, config, smi, shadow_scene):
    """Phase 15: the CLI's --profile trace (torch.profiler), the device's busy
    and idle share in it, and the shadow frame by the stage profile before
    and after the profiler ran in this process.  Last, so that no other
    measurement follows the profiler in the process."""
    from tiny_renderer_tpu_torch import app
    from tiny_renderer_tpu_torch.pipelines.profile import stage_breakdown
    from tiny_renderer_tpu_torch.utils.timing import TRACE_FILE

    before = stage_breakdown(shadow_scene, iters=24)[1]["full"]
    with tempfile.TemporaryDirectory() as tmp:
        rc = app.main(["--size", str(config.width), str(config.height), "--backend", dev.type,
                       "-s", "shadow", "--frames", "4", "--no-fps", "--profile", tmp])
        check(rc == 0, f"app.main --profile returned {rc}")
        with open(f"{tmp}/{TRACE_FILE}") as f:
            events = json.load(f)["traceEvents"]
    # Device work in the trace: kernels, copies and fills (busy: the union
    # of their intervals); idle is the rest of their span.
    from benchmark import tracing

    gpu = [e for e in events if e.get("cat") in tracing.DEVICE_CATS]
    kernels = sum(e["cat"] == "kernel" for e in gpu)
    check(kernels > 0, "the --profile trace holds no GPU kernel")
    busy = sum(b - a for a, b in tracing.union([(e["ts"], e["ts"] + e["dur"]) for e in gpu])) / 1e3
    span = (max(e["ts"] + e["dur"] for e in gpu) - min(e["ts"] for e in gpu)) / 1e3
    after = stage_breakdown(shadow_scene, iters=24)[1]["full"]
    phase("profile", f"app.main -s shadow --frames 4 --profile: rc 0; trace {len(events)} events, {kernels} "
          f"GPU kernels and {len(gpu) - kernels} copies/fills, device busy {busy:.3f} ms of a {span:.3f} ms "
          f"span ({1 - busy / span:.1%} idle; 4 frames of Scene.render, the first capturing its graph, "
          f"profiler on); shadow frame by the stage profile (24 frames, CUDA events | host ms per frame, "
          f"eager || replayed graph) {before['device']:.3f} | {before['host']:.3f} || "
          f"{before['graph_device']:.3f} | {before['graph_host']:.3f} before the profiler ran in this process, "
          f"{after['device']:.3f} | {after['host']:.3f} || {after['graph_device']:.3f} | "
          f"{after['graph_host']:.3f} after  [{smi}]")


MESH_FIELDS = ("positions", "tex_coords", "normals", "pos_idx", "tex_idx", "normal_idx")
MAP_NAMES = ("texture", "normal_map", "normal_map_tangent", "specular_map")


def write_obj(path, mesh):
    """The mesh as OBJ text with PTN faces (1-based v/vt/vn); floats
    written with 9 significant digits, so f32 values round-trip."""
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.positions.tolist()]
    lines += [f"vt {u:.9g} {v:.9g}" for u, v in mesh.tex_coords.tolist()]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.normals.tolist()]
    faces = np.stack([mesh.pos_idx, mesh.tex_idx, mesh.normal_idx], -1) + 1  # (T, 3 corners, 3)
    lines += ["f " + " ".join("/".join(map(str, c)) for c in f) for f in faces.tolist()]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_tga(path, rgb, rle=False):
    """A 24-bit bottom-left-origin TGA: raw (type 2), or RLE (type 10) with
    one packet per 128 pixels, a run packet where they are all equal."""
    h, w, _ = rgb.shape
    data = np.ascontiguousarray(rgb[::-1, :, ::-1]).reshape(-1, 3)  # bottom row first, BGR
    if rle:
        check(len(data) % 128 == 0, "write_tga: RLE needs a multiple of 128 pixels")
        chunks = data.reshape(-1, 128, 3)
        run = (chunks == chunks[:, :1]).all(axis=(1, 2))
        packets = [bytes([0xFF]) + c[0].tobytes() if r else bytes([0x7F]) + c.tobytes()
                   for c, r in zip(chunks, run.tolist())]
        body = b"".join(packets)
    else:
        body = data.tobytes()
    header = bytes([0, 0, 10 if rle else 2]) + bytes(9) + w.to_bytes(2, "little") + h.to_bytes(2, "little") \
        + bytes([24, 0])
    with open(path, "wb") as fh:
        fh.write(header + body)


def capacity_phase(dev, model, base, smi, record, passes, compare, grid, flagship):
    """Phase 13: the capacity scale.  The flagship stand-in is written to a
    temporary directory (model.obj and four TGAs, the texture RLE-coded),
    loaded by load_model on the native path and subdivided twice (81,536
    triangles).  K1 idx-only, depth-only and z+idx at capacity (int32 index
    target) and on the 4 bands of row_bands=4 against their twins; phong
    and shadow at 800x800 through Scene and the burst under row_bands 0, 4
    and 25 (and shadow under fuse_passes), each equal bit for bit to the
    one-band frame with R K1 launches per pass and no K2 under bands; the
    flagship through Scene(backend="dense") and --raster dense.  Times: K1
    per frame at capacity and under row_bands=4 (paced, twin, device) with
    their bounds, and the capacity frames (burst ms/frame, Scene.render
    latency) in turns with the flagship's.  Returns (ms, bounds) of the two
    new kernel rows."""
    from tiny_renderer_tpu_torch import Scene, app
    from tiny_renderer_tpu_torch.assets import model as model_mod
    from tiny_renderer_tpu_torch.assets import native
    from tiny_renderer_tpu_torch.assets.mesh_tools import subdivide_mesh
    from tiny_renderer_tpu_torch.ops import raster_cuda
    from tiny_renderer_tpu_torch.ops.binning import bin_triangles
    from tiny_renderer_tpu_torch.ops.mathlib import F32_MIN
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.pipelines.frame import _band_plan, _idx_dtype, make_burst_fn, render_frame
    from tiny_renderer_tpu_torch.utils.png import png_bytes

    t0 = time.perf_counter()
    cfg = base.resolve("shadow")
    W, H = cfg.width, cfg.height
    view = [to_tensor(np.float32(v), dev) for v in VIEW]

    # -- (a) the native loader, and the capacity scene --
    try:
        lib, build_s = native.build(force=True)
    except (OSError, RuntimeError) as e:
        raise AssertionError(f"the native asset loader does not build: {e}") from e
    check(native.native_available(), "native_available() is False after a successful build")
    with tempfile.TemporaryDirectory() as tmp:
        write_obj(f"{tmp}/model.obj", model.mesh)
        for name in MAP_NAMES:
            write_tga(f"{tmp}/{name}.tga", getattr(model, name), rle=name == "texture")
        fail = mock.Mock(side_effect=AssertionError("load_model ran a NumPy parser"))
        tl = time.perf_counter()
        with mock.patch.object(model_mod, "read_obj", fail), mock.patch.object(model_mod, "read_tga", fail):
            loaded = model_mod.load_model(tmp, verbose=False)
        native_s = time.perf_counter() - tl
        tl = time.perf_counter()
        with mock.patch.object(native, "read_obj_native", return_value=None), \
                mock.patch.object(native, "read_tga_native", return_value=None):
            ref = model_mod.load_model(tmp, verbose=False)
        numpy_s = time.perf_counter() - tl
    for f in MESH_FIELDS:
        a, b, c = getattr(loaded.mesh, f), getattr(ref.mesh, f), getattr(model.mesh, f)
        check(a.dtype == b.dtype == c.dtype and np.array_equal(a, b) and np.array_equal(a, c),
              f"native load: mesh {f} differs from the NumPy load or the written mesh")
    for name in MAP_NAMES:
        check(np.array_equal(getattr(loaded, name), getattr(ref, name))
              and np.array_equal(getattr(loaded, name), getattr(model, name)),
              f"native load: {name} differs from the NumPy load or the written map")
    mesh = subdivide_mesh(loaded.mesh, 2)
    check(mesh.num_triangles == 16 * model.num_triangles, f"capacity mesh {mesh.num_triangles}")
    big = dataclasses.replace(loaded, mesh=mesh)
    phase("capacity", f"native loader: g++ {' '.join(native.CXX_FLAGS)} -> {lib.name} in {build_s:.3f} s; "
          f"load_model took the native path (the NumPy parsers patched to fail) in {native_s:.3f} s, the NumPy "
          f"path {numpy_s:.3f} s, bytes and dtypes equal, equal to the written scene (model.obj of "
          f"{model.num_triangles} triangles, four 1024^2 TGAs, texture RLE); subdivide_mesh(levels=2): "
          f"{mesh.num_triangles} triangles  [{time.perf_counter() - t0:.1f} s]")

    # -- (b) K1 at capacity and on the bands of row_bands=4, against the twins --
    t1 = time.perf_counter()
    geom_np = {f: getattr(mesh, f) for f in MESH_FIELDS}
    cap = passes(geom_np)
    setups = cap["setup"]
    check(_idx_dtype(setups["camera"], dataclasses.replace(cfg, idx_int16=True, tile_h=16)) == "int32",
          "capacity: idx_int16 must fall back to the int32 target at T >= 32768")
    n_cmp = 0
    full = {}
    for pname in ("light", "camera"):
        for mode, kw in MODES.items():
            got = raster_cuda.rasterize(*cap[pname], **grid, **kw)
            torch.cuda.synchronize()
            compare("capacity", f"capacity/{pname}/{mode}", got,
                    raster_cuda.rasterize_reference(*cap[pname], **grid, **kw))
            check(got[1] is None or got[1].dtype == torch.int32, "capacity: idx not int32")
            full[pname, mode] = got
            n_cmp += 1
    cfg4 = dataclasses.replace(cfg, row_bands=4)
    plan4 = _band_plan(setups["camera"], cfg4)
    check(sum(bt for _, bt, _ in plan4) == cfg.tiles_y and len(plan4) == min(4, cfg.tiles_y),
          f"row_bands=4 plan {plan4}")
    bands = {}
    for pname, mode in (("light", "z"), ("camera", "idx"), ("camera", "z+idx")):
        kw = MODES[mode]
        for t, bt, band in plan4:
            b = bin_triangles(setups[pname], band, row_tile_offset=t)
            check(not bool(b[3]), f"capacity band {t}: overflow")
            bg = {**grid, "tiles_y": bt}
            got = raster_cuda.rasterize(*b[:3], **bg, row_tile_offset=t, **kw)
            torch.cuda.synchronize()
            label = f"capacity/{pname}/{mode}@row tile {t}"
            compare("capacity_banded", label, got,
                    raster_cuda.rasterize_reference(*b[:3], **bg, row_tile_offset=t, **kw))
            r = slice(t * cfg.tile_h, (t + bt) * cfg.tile_h)
            compare("capacity_banded", label + " vs the full frame", got,
                    [None if x is None else x[r] for x in full[pname, mode]])
            bands[pname, t] = (b[:3], bg)
            n_cmp += 2
    n_inc = {p: int(cap[p][2][-1]) for p in ("light", "camera")}
    per_tile = {p: torch.diff(cap[p][2]).reshape(cfg.tiles_y, cfg.tiles_x) for p in n_inc}
    # (incidences, cap) of the fullest band of each band count, over both passes.
    fullest = {rb: max((int(per_tile[p][t:t + bt].sum()), band.max_incidences) for p in per_tile
                       for t, bt, band in _band_plan(setups[p], dataclasses.replace(cfg, row_bands=rb)))
               for rb in (4, 25)}
    phase("capacity", f"{n_cmp} kernel/twin comparisons at {mesh.num_triangles} triangles bit-identical "
          f"(tolerance: exact): K1 z, idx, z+idx on both passes ({n_inc['light']} light and {n_inc['camera']} "
          f"camera incidences, at most {max(int(v.max()) for v in per_tile.values())} per tile, cap "
          f"{cfg.max_incidences or 'max(4T, 4096)'}; int32 index target), and on the {len(plan4)} bands of "
          f"row_bands=4 at row tile offsets {[t for t, _, _ in plan4]}, each also equal to the full frame's "
          "rows; the fullest band holds " + ", ".join(f"{n} incidences against its cap of {c} (row_bands={rb})"
                                                     for rb, (n, c) in fullest.items())
          + f"  [{time.perf_counter() - t1:.1f} s]")

    # -- (c) phong and shadow through Scene and the burst, with and without bands --
    t2 = time.perf_counter()
    cams = torch.tensor([0.37, 0.42], dtype=torch.float32, device=dev)
    ligs = torch.tensor([-0.6, -0.57], dtype=torch.float32, device=dev)
    twin = (mock.patch.object(raster_cuda, "rasterize", raster_cuda.rasterize_reference),
            mock.patch.object(raster_cuda, "rasterize_fused", raster_cuda.rasterize_fused_reference))
    runs = {}
    for pipeline in ("phong", "shadow"):
        n_pass = 2 if pipeline == "shadow" else 1
        one = None
        for rb, knobs in ((0, {}), (4, {}), (25, {}), (0, dict(fuse_passes=True)),
                          (4, dict(fuse_passes=True))):
            if knobs and pipeline != "shadow":
                continue
            sc = Scene(big, pipeline, dataclasses.replace(base, row_bands=rb, **knobs), device=dev)
            sc.set_light_direction(VIEW[0])
            sc.set_camera(*VIEW[1:])
            R = len(_band_plan(setups["camera"], sc.config))
            burst = make_burst_fn(pipeline, sc.config, keep_frames=True)
            raster_cuda.reset_launches()
            r = sc.render()
            torch.cuda.synchronize()
            got_render = dict(raster_cuda.LAUNCHES)
            raster_cuda.reset_launches()
            bo = burst(sc._geom, sc._textures, cams, ligs)
            torch.cuda.synchronize()
            got_burst = dict(raster_cuda.LAUNCHES)
            label = f"{pipeline} row_bands={rb}" + (" fuse_passes" if knobs else "")
            # Per frame; each first call adds its capture's warm-up frame.
            want = {"raster": n_pass * R, "offset": n_pass * (R - 1)}
            check(got_render == {m: 2 * want.get(m, 0) for m in got_render},
                  f"capacity {label}: Scene.render launches {got_render}, expected 2 x {want}")
            want = {"fused": 1} if knobs and R == 1 else want
            check(got_burst == {m: 3 * want.get(m, 0) for m in got_burst},
                  f"capacity {label}: burst launches {got_burst}, expected 3 x {want}")
            path = f"{pipeline}, capacity"
            for counts in (got_render, got_burst):
                record(path, counts)
                record(path, {"capacity_bands" if R > 1 else "capacity": counts["raster"]})
            check(not bool(r["overflow"]) and not bool(bo["overflow"].any()), f"capacity {label}: overflow")
            check(bool((bo["frames"] > 0).any(-1).flatten(1).float().mean(1).gt(0).all()),
                  f"capacity {label}: a black frame")
            check(bool(torch.isfinite(r["z"][r["z"] > F32_MIN]).all()), f"capacity {label}: non-finite z")
            if one is None:
                one = (r, bo)
                with twin[0], twin[1]:
                    tr = render_frame(sc._geom, sc._textures, *view, pipeline=pipeline, config=sc.config)
                for k in ("frame", "z", "shadow"):
                    check(torch.equal(tr[k], r[k]), f"capacity {label}: Scene.render {k} differs from the twin")
            else:
                for k in ("frame", "z", "shadow", "overflow"):
                    check(torch.equal(r[k], one[0][k]), f"capacity {label}: Scene.render {k} differs "
                          "from the one-band frame")
                check(torch.equal(bo["frames"], one[1]["frames"]), f"capacity {label}: burst differs from "
                      "the one-band burst")
            runs[label] = (sc, burst)
            phase("capacity", f"{label} at {W}x{H}, {mesh.num_triangles} triangles: Scene.render launches "
                  f"{ {m: v for m, v in got_render.items() if v} }, 2-frame burst "
                  f"{ {m: v for m, v in got_burst.items() if v} }; "
                  + ("equal to the twin raster" if one[0] is r else "frame, z, shadow, overflow and burst "
                     "bit-identical to the one-band render"))
    # K1 inside the replayed capacity bursts (torch.profiler, one 2-frame burst each).
    for label in ("shadow row_bands=0", "shadow row_bands=4"):
        sc, burst = runs[label]
        profiled = traced(lambda: burst(sc._geom, sc._textures, cams, ligs), dev)
        durs = [1e3 * sec for name, sec in profiled.kernels if K1_TRACE.search(name)]
        phase("capacity", f"{label}: K1 inside the replayed burst (torch.profiler over {len(cams)} frames) "
              f"{sum(durs) / len(cams):.4f} ms a frame in {len(durs) / len(cams):.0f} launches  [{smi}]")
    phase("capacity", f"scenes took {time.perf_counter() - t2:.1f} s")

    # -- (d) the dense backend through Scene and --raster dense --
    t3 = time.perf_counter()
    dsc = Scene(model, "shadow", base, device=dev, backend="dense")
    dsc.set_light_direction(VIEW[0])
    dsc.set_camera(*VIEW[1:])
    raster_cuda.reset_launches()
    d = dsc.render()
    torch.cuda.synchronize()
    check(not any(raster_cuda.LAUNCHES.values()), f"Scene(backend='dense') launched {raster_cuda.LAUNCHES}")
    flagship.set_light_direction(VIEW[0])
    flagship.set_camera(*VIEW[1:])
    k = flagship.render()
    for key in ("z", "shadow"):
        check(torch.equal(d[key] > F32_MIN, k[key] > F32_MIN), f"dense Scene: {key} coverage differs")
    fdiff = float((d["frame"] != k["frame"]).any(-1).float().mean())
    check(fdiff < 0.005, f"dense Scene frame differs from the kernel frame on {fdiff:.4%} of pixels")
    with tempfile.TemporaryDirectory() as tmp:
        raster_cuda.reset_launches()
        rc = app.main(["--size", str(W), str(H), "--backend", dev.type, "-s", "shadow", "--frames", "1",
                       "--raster", "dense", "--no-fps", "--save", f"{tmp}/dense.png"])
        torch.cuda.synchronize()
        check(rc == 0 and not any(raster_cuda.LAUNCHES.values()),
              f"app.main --raster dense: rc {rc}, launches {raster_cuda.LAUNCHES}")
        with open(f"{tmp}/dense.png", "rb") as fh:
            cli_png = fh.read()
    pose = app._angles_to_vectors(0.0, 0.0)
    for sc in (dsc, flagship):
        sc.set_camera(*pose[:3])
        sc.set_light_direction(pose[3])
        sc.render()
    check(cli_png == png_bytes(dsc.get_frame_buffer()), "--raster dense PNG differs from Scene(backend='dense')")
    cdiff = float((dsc.get_frame_buffer() != flagship.get_frame_buffer()).any(-1).mean())
    check(cdiff < 0.005, f"--raster dense frame differs from the kernel frame on {cdiff:.4%} of pixels")
    check(np.array_equal(dsc.get_z_buffer() > 0, flagship.get_z_buffer() > 0), "--raster dense: z coverage")
    phase("capacity", f"dense backend on the flagship: Scene(backend='dense') at {W}x{H}, 0 kernel launches, "
          f"coverage equal to the kernel's (z and shadow), frame {fdiff:.6%} of pixels apart (budget 0.5%); "
          f"app.main --raster dense PNG equal to Scene(backend='dense'), {cdiff:.6%} apart from the kernel "
          f"frame  [{time.perf_counter() - t3:.1f} s]")

    # -- (e) times --
    t4 = time.perf_counter()
    work = {p: block_work(setups[p], cap[p], grid)["bbox"].reshape(cfg.num_tiles, -1).sum(1)
            for p in ("light", "camera")}
    tests = {p: int(w.sum()) for p, w in work.items()}

    def k1_frame(fn):
        def run():
            fn(*cap["light"], **grid, emit_idx=False)
            fn(*cap["camera"], **grid, emit_z=False)
        return run

    def k1_bands(fn):
        def run():
            for t, _, _ in plan4:
                fn(*bands["light", t][0], **bands["light", t][1], row_tile_offset=t, emit_idx=False)
            for t, _, _ in plan4:
                fn(*bands["camera", t][0], **bands["camera", t][1], row_tile_offset=t, emit_z=False)
        return run

    ms = {
        "capacity": (time_launches(k1_frame(raster_cuda.rasterize), 40),
                     time_launches(k1_frame(raster_cuda.rasterize_reference), 2),
                     time_launches(k1_frame(raster_cuda.rasterize), 40, hold=True)),
        "capacity_banded": (time_launches(k1_bands(raster_cuda.rasterize), 40),
                            time_launches(k1_bands(raster_cuda.rasterize_reference), 2),
                            time_launches(k1_bands(raster_cuda.rasterize), 40, hold=True)),
    }
    per_pass = {(p, m): time_launches(lambda p=p, kw=MODES[m]: raster_cuda.rasterize(*cap[p], **grid, **kw), 100,
                                      hold=True)
                for p, m in (("light", "z"), ("camera", "idx"))}
    # The same two passes in the 25 one-tile-row bands of row_bands=25.
    plan25 = _band_plan(setups["camera"], dataclasses.replace(cfg, row_bands=25))
    b25 = [(p, t, bin_triangles(setups[p], band, row_tile_offset=t)[:3], {**grid, "tiles_y": bt})
           for p in ("light", "camera") for t, bt, band in plan25]

    def k1_bands25():
        for p, t, b, bg in b25:
            raster_cuda.rasterize(*b, **bg, row_tile_offset=t, **(dict(emit_idx=False) if p == "light"
                                                                   else dict(emit_z=False)))

    ms25 = time_launches(k1_bands25, 20, hold=True)
    px = cfg.padded_height * cfg.padded_width
    tx = cfg.tiles_x
    band_passes = [(*bands[p, t][0], int(work[p][t * tx:(t + bt) * tx].sum()))
                   for p in ("light", "camera") for t, bt, _ in plan4]
    bounds = {"capacity": bound([(*cap["light"], tests["light"]), (*cap["camera"], tests["camera"])], 2 * px * 4),
              "capacity_banded": bound(band_passes, 2 * px * 4)}
    pass_bounds = {"light": bound([(*cap["light"], tests["light"])], px * 4),
                   "camera": bound([(*cap["camera"], tests["camera"])], px * 4)}
    for key, label in (("capacity", "K1 at capacity, light pass depth-only + camera pass idx-only (2 launches)"),
                       ("capacity_banded", f"K1 under row_bands=4, the {2 * len(plan4)} banded launches of the "
                                           "same two passes")):
        paced, twin_ms, dms = ms[key]
        phase("capacity", f"{label}: {paced:.4f} ms paced by the host, {dms:.4f} ms on the device with the "
              f"launch queue held full, twin {twin_ms:.4f} ms; bound {bounds[key][0]:.6f} ms by "
              f"{bounds[key][1]} ({bounds[key][2]} flops, {bounds[key][3]} bytes; {bounds[key][0] / dms:.2%} "
              f"of it)  [{smi}]")
    phase("capacity", "per launch at capacity (device, queue held full): " + ", ".join(
        f"{p} pass {m} {per_pass[p, m]:.4f} ms (bound {pass_bounds[p][0]:.6f} ms by {pass_bounds[p][1]}, "
        f"{pass_bounds[p][0] / per_pass[p, m]:.2%})" for p, m in per_pass)
        + f"; {tests['light']} light and {tests['camera']} camera bbox pixel tests; the two passes in the "
        f"{len(b25)} launches of row_bands=25: {ms25:.4f} ms on the device  [{smi}]")

    # The frames in turns with the flagship's shadow frame: burst ms/frame
    # (best of 2 bursts of 4 frames) and Scene.render latency (best of 3),
    # each after a garbage collection.
    cams4 = torch.tensor(0.37 + 0.05 * np.arange(4), dtype=torch.float32, device=dev)
    ligs4 = torch.tensor(-0.6 + 0.03 * np.arange(4), dtype=torch.float32, device=dev)
    order = {"flagship shadow": (flagship, make_burst_fn("shadow", flagship.config)), **runs}

    def frame_times(sc, fn):
        best = float("inf")
        gc.collect()
        for _ in range(2):
            torch.cuda.synchronize()
            tb = time.perf_counter()
            fn(sc._geom, sc._textures, cams4, ligs4)
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - tb) * 1e3 / 4)
        gc.collect()
        return best, host_ms(sc.render, 3)

    for sc, fn in order.values():  # warm-up
        fn(sc._geom, sc._textures, cams4[:1], ligs4[:1])
    times = {k: [float("inf"), float("inf")] for k in order}
    for rnd in range(3):
        for key in (list(order) if rnd % 2 == 0 else list(order)[::-1]):
            b, r = frame_times(*order[key])
            times[key] = [min(times[key][0], b), min(times[key][1], r)]
    phase("capacity", f"frames at {W}x{H} (host clock + synchronize; burst ms/frame best of 3x2 bursts of 4 "
          "frames, Scene.render ms best of 3x3; in turns forward, backward, forward): " + ", ".join(
              f"{k} {b:.3f} / {r:.3f}" for k, (b, r) in times.items()) + f"  [{smi}]")
    phase("capacity", f"times took {time.perf_counter() - t4:.1f} s")
    return ms, bounds


def parallel_phase(dev, model, base, smi, record, passes, compare, cases, spec16):
    """Phase 9: the scale-out path (parallel.sharding) at 800x800.  First
    every kernel mode on a band of tile rows at a nonzero row offset, bit
    for bit against its twin and against the same rows of the full-frame
    launch; then the sharded frames of the flagship shadow scene on 5 row
    shards of one card against the single-device frame, the batch and the
    pipelined paths, the dense backend, and the sharded example.  Returns
    the banded launches' (paced, twin, device) ms per sharded frame and
    their bounds.  base: the config every scene starts from (800x800)."""
    from tiny_renderer_tpu_torch import Scene
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.examples import sharded_render
    from tiny_renderer_tpu_torch.ops import raster_cuda
    from tiny_renderer_tpu_torch.ops.binning import bin_triangles
    from tiny_renderer_tpu_torch.ops.mathlib import F32_MIN
    from tiny_renderer_tpu_torch.ops.raster_dense import rasterize_dense
    from tiny_renderer_tpu_torch.parallel import (
        make_pp_mesh, make_row_mesh, render_batch_sharded, render_frame_sharded,
        render_sequence_pipelined, sharding)
    from tiny_renderer_tpu_torch.pipelines.frame import render_frame, render_frame_jit
    from tiny_renderer_tpu_torch.utils.png import png_bytes

    t0 = time.perf_counter()
    cfg = base.resolve("shadow")
    n_cmp = [0]

    def cmp(*args):
        compare(*args)
        n_cmp[0] += 1

    k, th = BAND_TILE_ROWS, cfg.tile_h
    grid = dict(tile_h=th, tile_w=cfg.tile_w, tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x)
    band_grid = {**grid, "tiles_y": k}
    band_cfg = dataclasses.replace(cfg, height=k * th)
    band_gath = dataclasses.replace(band_cfg, csr_indirect=False)
    gath_cfg = dataclasses.replace(cfg, csr_indirect=False)
    modes = {**{m: (MODES[m], ()) for m in MODES},
             "int16": (dict(emit_z=False, idx_dtype="int16"), ()),
             "strips8": (dict(emit_z=False, emit_strips=8), ()),
             "strips16": (dict(emit_z=False, emit_strips=16), ()),
             "planes": (dict(emit_z=False, spec=spec16), spec16)}
    offsets = [cfg.tiles_y - k if o == "last" else o for o in BAND_OFFSETS]

    def rows(out, off):
        """The band's rows of full-frame outputs (varys: planes first)."""
        r = slice(off * th, (off + k) * th)
        return [None if t is None else (t[:, r] if t.ndim == 3 else t[r]) for t in out]

    for cname in ("soup0", "soup1", "soup2", "flagship"):
        geom_np = cases[cname][0]
        setups = passes(geom_np)["setup"]
        for pname, setup in setups.items():
            full = {}
            for mname, (kw, spec) in modes.items():
                full[mname] = raster_cuda.rasterize(*bin_triangles(setup, cfg, spec)[:3], **grid, **kw)
            full["gathered"] = raster_cuda.rasterize(*bin_triangles(setup, gath_cfg)[:3], **grid)
            for off in offsets:
                for mname, (kw, spec) in modes.items():
                    b = bin_triangles(setup, band_cfg, spec, row_tile_offset=off)[:3]
                    got = raster_cuda.rasterize(*b, **band_grid, row_tile_offset=off, **kw)
                    torch.cuda.synchronize()
                    label = f"{cname}/{pname}/{mname}@row tile {off}"
                    cmp("banded", label, got,
                        raster_cuda.rasterize_reference(*b, **band_grid, row_tile_offset=off, **kw))
                    cmp("banded", label + " vs the full frame", got, rows(full[mname], off))
                b = bin_triangles(setup, band_gath, row_tile_offset=off)[:3]
                got = raster_cuda.rasterize(*b, **band_grid, row_tile_offset=off)
                torch.cuda.synchronize()
                label = f"{cname}/{pname}/gathered@row tile {off}"
                cmp("banded", label, got,
                    raster_cuda.rasterize_reference(*b, **band_grid, row_tile_offset=off))
                cmp("banded", label + " vs the full frame", got, rows(full["gathered"], off))
        full = raster_cuda.rasterize_fused(*bin_triangles(setups["light"], cfg)[:3],
                                           *bin_triangles(setups["camera"], cfg)[:3], **grid)
        for off in offsets:
            b = [bin_triangles(setups[p], band_cfg, row_tile_offset=off)[:3] for p in ("light", "camera")]
            got = raster_cuda.rasterize_fused(*b[0], *b[1], **band_grid, row_tile_offset=off)
            torch.cuda.synchronize()
            label = f"{cname}/fused@row tile {off}"
            cmp("banded_fused", label, got, raster_cuda.rasterize_fused_reference(
                *b[0], *b[1], **band_grid, row_tile_offset=off))
            cmp("banded_fused", label + " vs the full frame", got, rows(full, off))
    phase("parallel", f"{n_cmp[0]} comparisons of kernels on a band of {k} tile rows at row "
          f"tile offsets {offsets} (K1 z, idx, z+idx, int16, strips 8 and 16, phase 2 under shadow's "
          "spec, gathered; K2) with their twins and with the full frame's rows: bit-identical "
          f"(tolerance: exact)  [{time.perf_counter() - t0:.1f} s]")

    # -- the sharded frame at full width, 5 row shards on one card --
    # Each path at two poses: the first call captures its segments (one
    # eager warm-up frame, then a replay: twice the launches of a frame),
    # the second replays them and captures nothing.  The eager side runs
    # the same segments eagerly (sharding._*(..., eager=True)).
    scene = Scene(model, "shadow", base, device=dev)
    g, t = scene._geom, scene._textures
    view = [to_tensor(np.float32(v), dev) for v in VIEW]
    view2 = [to_tensor(np.float32(v), dev) for v in VIEW2]
    mesh = make_row_mesh([dev] * ROW_SHARDS)
    check(mesh.shape == {"batch": 1, "rows": ROW_SHARDS}, f"mesh {mesh.shape}")

    def graphs_alive():
        return [gr for prog in sharding._PROGRAMS.graphs() for gr in prog.graphs.values()]

    def counted(fn):
        raster_cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(raster_cuda.LAUNCHES)

    def same(got, want, keys, label):
        for key in keys:
            check((got[key] is None) == (want[key] is None) and (
                got[key] is None or torch.equal(got[key], want[key])), f"{label}: {key} differs")

    def silent(fn):
        """fn() with the sync debug mode at "error": a host sync raises."""
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

    singles, captures = {}, []
    keys = ("frame", "z", "shadow", "overflow")
    for name, (knobs, needs_z, per_frame) in SHARD_CONFIGS.items():
        tc = time.perf_counter()
        c = dataclasses.replace(base, **knobs).resolve("shadow")
        before = graphs_alive()
        for i, v in enumerate((view, view2)):
            single = render_frame(g, t, *v, pipeline="shadow", config=c, needs_z=needs_z)
            eager, e_counts = counted(lambda: sharding._frame_sharded(
                g, t, tuple(v), pipeline="shadow", config=c, mesh=mesh, backend="kernel",
                needs_z=needs_z, eager=True))
            n_graphs = len(graphs_alive())
            got, counts = counted(lambda: render_frame_sharded(g, t, *v, pipeline="shadow", config=c,
                                                               mesh=mesh, needs_z=needs_z))
            want = {m: per_frame.get(m, 0) for m in counts}
            check(e_counts == want, f"sharded {name} eager: launches {e_counts}, expected {want}")
            if i == 0:
                check(counts == {m: 2 * k for m, k in want.items()},
                      f"sharded {name}: first call (warm-up + replay) launches {counts}, expected 2 x {want}")
            else:
                check(counts == want, f"sharded {name}: launches per replay {counts}, expected {want}")
                check(len(graphs_alive()) == n_graphs, f"sharded {name}: the second pose captured a graph")
            record("shadow, row-sharded", counts)
            same(got, eager, keys, f"sharded {name} pose {i}: replayed vs eager sharded")
            same(got, single, keys, f"sharded {name} pose {i}: replayed vs render_frame")
            check(not bool(got["overflow"]) and bool((got["frame"] > 0).any()), f"sharded {name}: frame")
            if i == 0:
                singles[name] = (c, needs_z, single)
        silent(lambda: render_frame_sharded(g, t, *view, pipeline="shadow", config=c, mesh=mesh,
                                            needs_z=needs_z))
        new = [gr for gr in graphs_alive() if not any(gr is b for b in before)]
        captures += [(name, gr.capture_s, gr.pool_bytes) for gr in new]
        phase("parallel", f"render_frame_sharded {name} on {ROW_SHARDS} row shards of {dev}, replayed "
              f"({len(new)} segment graphs): frame, z, shadow, overflow bit-identical to the eager sharded "
              f"frame and to render_frame at 2 poses; launches per replay {({k: v for k, v in counts.items() if v})}"
              " = SHARD_CONFIGS; the second pose captured nothing; sync debug mode 'error' silent; graphs "
              "(capture s, MB reserved): " + ", ".join(f"{cs:.3f} s {b / 2**20:.1f}" for _, cs, b in
                                                       captures[len(captures) - len(new):])
              + f"  [{time.perf_counter() - tc:.1f} s]")

    # Batch and pipelined, each at two sets of poses.
    t1 = time.perf_counter()
    poses = []
    for a0 in (0.2, 1.1):
        ang = np.linspace(a0, a0 + 0.8, N_BATCH_FRAMES, dtype=np.float32)
        poses.append((to_tensor(np.stack([[np.sin(a), 0, np.cos(a)] for a in ang]).astype(np.float32), dev),
                      to_tensor(np.stack([[np.sin(a + 0.2), 0, np.cos(a + 0.2)] for a in ang])
                                .astype(np.float32), dev)))
    phong = Scene(model, "phong", base, device=dev)
    bmesh = make_row_mesh([dev] * (2 * ROW_SHARDS), batch=2)
    pmesh = make_pp_mesh([dev] * (2 * ROW_SHARDS))
    batch_frame = {"raster": ROW_SHARDS, "offset": ROW_SHARDS - 1}
    pp_frame = {"raster": 2 * ROW_SHARDS, "offset": 2 * (ROW_SHARDS - 1)}

    def batch(lights, froms, eager=False):
        return sharding._batch_sharded(phong._geom, phong._textures, lights, froms, view[2], view[3],
                                       pipeline="phong", config=phong.config, mesh=bmesh, backend="kernel",
                                       needs_z=True, eager=eager)

    def pipelined(lights, froms, eager=False):
        return sharding._sequence_pipelined(g, t, lights[:N_PP_FRAMES], froms[:N_PP_FRAMES], view[2],
                                            view[3], pipeline="shadow", config=scene.config, mesh=pmesh,
                                            backend="kernel", eager=eager)

    before = graphs_alive()
    for i, (lights, froms) in enumerate(poses):
        for label, fn, n, per, public in (
                ("batch", batch, N_BATCH_FRAMES, batch_frame, lambda: render_batch_sharded(
                    phong._geom, phong._textures, lights, froms, view[2], view[3], pipeline="phong",
                    config=phong.config, mesh=bmesh)),
                ("pipelined", pipelined, N_PP_FRAMES, pp_frame, lambda: render_sequence_pipelined(
                    g, t, lights[:N_PP_FRAMES], froms[:N_PP_FRAMES], view[2], view[3], pipeline="shadow",
                    config=scene.config, mesh=pmesh))):
            eager, e_counts = counted(lambda: fn(lights, froms, eager=True))
            n_graphs = len(graphs_alive())
            got, counts = counted(public)
            # The first call adds its captures' warm-up: one frame's launches.
            frames_run = n + (1 if i == 0 else 0)
            check(e_counts == {m: n * per.get(m, 0) for m in e_counts}, f"{label} eager: launches {e_counts}")
            check(counts == {m: frames_run * per.get(m, 0) for m in counts},
                  f"{label} replayed (call {i}): launches {counts}, expected {frames_run} x {per}")
            if i:
                check(len(graphs_alive()) == n_graphs, f"{label}: the second call captured a graph")
            record("phong, batch-sharded" if label == "batch" else "shadow, pipelined", counts)
            same(got, eager, [k for k in ("frame", "z", "overflow") if k in got], f"{label} call {i}: "
                 "replayed vs eager")
            check(not bool(got["overflow"].any()), f"{label}: overflow")
            for b in range(n):
                if label == "batch":
                    one = render_frame(phong._geom, phong._textures, lights[b], froms[b], view[2], view[3],
                                       pipeline="phong", config=phong.config)
                    check(torch.equal(got["z"][b], one["z"]), f"batch frame {b}: z differs")
                else:
                    one = render_frame(g, t, lights[b], froms[b], view[2], view[3], pipeline="shadow",
                                       config=scene.config, needs_z=False)
                check(torch.equal(got["frame"][b], one["frame"]),
                      f"{label} frame {b} (call {i}) differs from its single-device render")
    silent(lambda: render_batch_sharded(phong._geom, phong._textures, *poses[0], view[2], view[3],
                                        pipeline="phong", config=phong.config, mesh=bmesh))
    silent(lambda: render_sequence_pipelined(g, t, poses[0][0][:N_PP_FRAMES], poses[0][1][:N_PP_FRAMES],
                                             view[2], view[3], pipeline="shadow", config=scene.config,
                                             mesh=pmesh))
    new = [gr for gr in graphs_alive() if not any(gr is b for b in before)]
    captures += [("batch/pipelined", gr.capture_s, gr.pool_bytes) for gr in new]
    phase("parallel", f"render_batch_sharded phong, {N_BATCH_FRAMES} frames on a (2 batch, {ROW_SHARDS} rows) "
          f"mesh (both groups on {dev}: one program), and render_sequence_pipelined shadow, {N_PP_FRAMES} frames "
          f"on a (2 stage, {ROW_SHARDS} rows) mesh, replayed ({len(new)} segment graphs), at 2 sets of poses: "
          "every frame bit-identical to the eager sharded path's and to its single-device render; launches "
          f"per frame {batch_frame} and {pp_frame} (plus one warm-up frame at the capture); the second call "
          f"captured nothing; sync debug mode 'error' silent  [{time.perf_counter() - t1:.1f} s]")
    caps = [cs for _, cs, _ in captures]
    mbs = [b / 2**20 for _, _, b in captures]
    phase("parallel", f"{len(captures)} sharded segment graphs captured: capture (warm-up + capture) "
          f"{min(caps):.3f}-{max(caps):.3f} s (median {float(np.median(caps)):.3f}), memory reserved per graph "
          f"{min(mbs):.1f}-{max(mbs):.1f} MB (median {float(np.median(mbs)):.1f})  [{smi}]")

    # -- the dense backend --
    t2 = time.perf_counter()
    flag = passes(cases["flagship"][0])
    H, W = cfg.height, cfg.width
    flips = {}
    for pname in ("light", "camera"):
        _, di = rasterize_dense(flag["setup"][pname], H, W, cfg.tri_block)
        ki = raster_cuda.rasterize(*flag[pname], **grid, emit_z=False)[1][:H, :W]
        check(torch.equal(di >= 0, ki >= 0), f"dense {pname} pass: coverage differs from the kernel's")
        flips[pname] = float((di != ki).float().mean())
        check(flips[pname] < 0.002, f"dense {pname} pass: winners differ on {flips[pname]:.4%} of pixels")
    kernel_frame = singles["default"][2]
    dense = render_frame(g, t, *view, pipeline="shadow", config=scene.config, backend="dense")
    fdiff = float((dense["frame"] != kernel_frame["frame"]).any(-1).float().mean())
    check(fdiff < 0.005, f"dense frame differs from the kernel frame on {fdiff:.4%} of pixels")
    for key in ("z", "shadow"):
        check(torch.equal(dense[key] > F32_MIN, kernel_frame[key] > F32_MIN),
              f"dense {key} coverage differs from the kernel's")
    raster_cuda.reset_launches()
    dmesh = make_row_mesh([dev] * DENSE_SHARDS)
    dsh = render_frame_sharded(g, t, *view, pipeline="shadow", config=scene.config, mesh=dmesh,
                               backend="dense")
    torch.cuda.synchronize()
    check(not any(raster_cuda.LAUNCHES.values()), f"the dense backend launched {raster_cuda.LAUNCHES}")
    for key in ("frame", "z", "shadow", "overflow"):
        check(torch.equal(dsh[key], dense[key]), f"dense sharded {key} differs from the dense frame")
    phase("parallel", f"dense backend at {W}x{H}: coverage equal to the kernel's on both passes, winners "
          f"differ on {flips['light']:.6%} (light) and {flips['camera']:.6%} (camera) of pixels (budget "
          f"0.2%); dense frame vs kernel frame {fdiff:.6%} of pixels (budget 0.5%); on {DENSE_SHARDS} "
          f"shards of {H // DENSE_SHARDS} rows bit-identical to the dense frame, 0 kernel launches  "
          f"[{time.perf_counter() - t2:.1f} s]")

    # -- the example, in process with its defaults --
    t3 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/sharded.png"
        raster_cuda.reset_launches()
        sharded_render.main(["--out", path])
        counts = dict(raster_cuda.LAUNCHES)
        record("shadow, row-sharded", counts)
        with open(path, "rb") as f:
            got = f.read()
    one = render_frame(g, t, to_tensor(np.float32(sharded_render.LIGHT), dev),
                       to_tensor(np.float32(sharded_render.LOOK_FROM), dev), view[2], view[3],
                       pipeline="shadow", config=scene.config, needs_z=False)
    check(got == png_bytes(one["frame"].cpu().numpy()[::-1]), "the example's PNG differs from render_frame's")
    # Its first frame captures (warm-up + replay), then N_TIMED replays.
    check(counts["raster"] == 2 * ROW_SHARDS * (2 + sharded_render.N_TIMED), f"example launches {counts}")
    phase("parallel", f"examples.sharded_render (defaults: 800x800, {ROW_SHARDS} shards, cuda, kernel): PNG "
          f"bytes equal to render_frame's, launches {counts}  [{time.perf_counter() - t3:.1f} s]")

    # -- times --
    # The shadow frame (no z) on one device and on 5 row shards, eager and
    # replayed, in turns (there and back), best of 5 each time; the single
    # replayed frame is render_frame_jit's (with z).  Then the batch and
    # the pipelined sequence, eager and replayed, ms per frame.
    t4 = time.perf_counter()
    c = singles["default"][0]
    frame_fns = {
        "single eager": lambda: render_frame(g, t, *view, pipeline="shadow", config=c, needs_z=False),
        "sharded eager": lambda: sharding._frame_sharded(g, t, tuple(view), pipeline="shadow", config=c,
                                                         mesh=mesh, backend="kernel", needs_z=False,
                                                         eager=True),
        "sharded replayed": lambda: render_frame_sharded(g, t, *view, pipeline="shadow", config=c,
                                                         mesh=mesh, needs_z=False),
        "single replayed": lambda: render_frame_jit(g, t, *view, pipeline="shadow", config=c),
    }
    turns = {k: [] for k in frame_fns}
    for key in list(frame_fns) + list(frame_fns)[::-1]:
        turns[key].append(host_ms(frame_fns[key], 5))
    frame_ms = {k: min(v) for k, v in turns.items()}
    frame_dense = host_ms(lambda: render_frame(g, t, *view, pipeline="shadow", config=c, needs_z=False,
                                               backend="dense"), 2)
    lights, froms = poses[0]
    seq_ms = {}
    for key, fn, n in (("batch eager", lambda: batch(lights, froms, eager=True), N_BATCH_FRAMES),
                       ("batch replayed", lambda: batch(lights, froms), N_BATCH_FRAMES),
                       ("pipelined eager", lambda: pipelined(lights, froms, eager=True), N_PP_FRAMES),
                       ("pipelined replayed", lambda: pipelined(lights, froms), N_PP_FRAMES)):
        seq_ms[key] = host_ms(fn, 3) / n
    # The raster inside the replayed sharded frame: torch.profiler over
    # replayed frames (default config: 10 K1 launches a frame, 8 at an
    # offset; fuse_passes: 5 K2, 4 at an offset).
    graph_ms = {}
    for key, knobs, pattern in (("banded", {}, K1_TRACE), ("banded_fused", dict(fuse_passes=True), K2_TRACE)):
        ck = dataclasses.replace(base, **knobs).resolve("shadow")

        def run(ck=ck):
            for _ in range(N_SHARD_TRACED):
                render_frame_sharded(g, t, *view, pipeline="shadow", config=ck, mesh=mesh, needs_z=False)

        run()
        profiled = traced(run, dev)
        durs = [1e3 * sec for name_, sec in profiled.kernels if pattern.search(name_)]
        per_frame = len(durs) / N_SHARD_TRACED
        graph_ms[key] = (sum(durs) / N_SHARD_TRACED, float(np.mean(durs)) if durs else None, per_frame)
        kernels = len(profiled.kernels)
        busy, span = 1e3 * profiled.busy_s, 1e3 * profiled.window_s
        check(per_frame == (2 * ROW_SHARDS if key == "banded" else ROW_SHARDS),
              f"{key}: {len(durs)} launches in the trace of {N_SHARD_TRACED} replayed sharded frames")
        phase("parallel", f"profiler over {N_SHARD_TRACED} replayed {ROW_SHARDS}-shard shadow frames "
              f"({knobs or 'default config'}, no z): {kernels / N_SHARD_TRACED:.0f} GPU kernels a frame, "
              f"device busy {busy:.3f} ms of a {span:.3f} ms window ({1 - busy / span if span else float('nan'):.1%} "
              f"idle); {'K1' if key == 'banded' else 'K2'}: {per_frame:.0f} launches a frame, "
              f"{graph_ms[key][0]:.4f} ms a frame, {graph_ms[key][1]:.4f} ms per launch inside the graphs  [{smi}]")
    # The banded launches of one sharded frame: each shard's light pass
    # (depth only) and camera pass (index only), or its K2 launch.
    work = {p: block_work(flag["setup"][p], flag[p], grid)["bbox"].reshape(cfg.num_tiles, -1).sum(1)
            for p in ("light", "camera")}
    tx = cfg.tiles_x
    shard_bins = []
    for d in range(ROW_SHARDS):
        off = d * k
        b = {p: bin_triangles(flag["setup"][p], band_cfg, row_tile_offset=off)[:3] for p in ("light", "camera")}
        tests = {p: int(work[p][off * tx:(off + k) * tx].sum()) for p in b}
        shard_bins.append((off, b, tests))

    def k1_frame(fn):
        def run():
            for off, b, _ in shard_bins:
                fn(*b["light"], **band_grid, row_tile_offset=off, emit_idx=False)
                fn(*b["camera"], **band_grid, row_tile_offset=off, emit_z=False)
        return run

    def k2_frame(fn):
        def run():
            for off, b, _ in shard_bins:
                fn(*b["light"], *b["camera"], **band_grid, row_tile_offset=off)
        return run

    ms = {
        "banded": (time_launches(k1_frame(raster_cuda.rasterize), 40),
                   time_launches(k1_frame(raster_cuda.rasterize_reference), 2),
                   time_launches(k1_frame(raster_cuda.rasterize), 40, hold=True)),
        "banded_fused": (time_launches(k2_frame(raster_cuda.rasterize_fused), 40),
                         time_launches(k2_frame(raster_cuda.rasterize_fused_reference), 2),
                         time_launches(k2_frame(raster_cuda.rasterize_fused), 40, hold=True)),
    }
    px = k * th * cfg.padded_width
    k1_passes = [(*b[p], tests[p]) for _, b, tests in shard_bins for p in ("light", "camera")]
    # K2 reads both passes' bins and writes the same two planes per band as
    # the K1 pair: the same work, so the same bound.
    bounds = {"banded": bound(k1_passes, ROW_SHARDS * 2 * px * 4),
              "banded_fused": bound(k1_passes, ROW_SHARDS * 2 * px * 4)}
    phase("parallel", f"shadow frame at {W}x{H}, ms (host clock + synchronize; best of 5, in turns there and "
          "back): " + "; ".join(f"{k} {frame_ms[k]:.3f} ({' / '.join(f'{v:.3f}' for v in turns[k])})"
                                for k in frame_fns)
          + f"; {ROW_SHARDS} shards replayed / eager {frame_ms['sharded replayed'] / frame_ms['sharded eager']:.3f}, "
          f"/ single replayed {frame_ms['sharded replayed'] / frame_ms['single replayed']:.2f}x; dense backend "
          f"{frame_dense:.3f} ms (best of 2)  [{smi}]")
    phase("parallel", "ms per frame (host clock + synchronize, best of 3 calls): " + "; ".join(
        f"{k} {v:.3f}" for k, v in seq_ms.items()) + f" (batch: {N_BATCH_FRAMES} phong frames on (2, "
        f"{ROW_SHARDS}); pipelined: {N_PP_FRAMES} shadow frames on (2 stage, {ROW_SHARDS}))  [{smi}]")
    for key, label in (("banded", f"K1 banded, the {2 * ROW_SHARDS} launches of one sharded frame"),
                       ("banded_fused", f"K2 banded, the {ROW_SHARDS} launches of one sharded frame")):
        paced, twin_ms, dms = ms[key]
        phase("parallel", f"{label}: {paced:.4f} ms paced by the host, {dms:.4f} ms on the device with the "
              f"launch queue held full, twin {twin_ms:.4f} ms; bound {bounds[key][0]:.6f} ms by "
              f"{bounds[key][1]} ({bounds[key][0] / dms:.2%} of it)  [{smi}]")
    phase("parallel", f"times took {time.perf_counter() - t4:.1f} s")
    return ms, bounds, graph_ms


# The fuzz phase's draws: (seed, pipeline), one per pipeline, and two
# seeds whose draws take K2 (fuse_passes, compact_shade, no strip_planes,
# one band) on the two-pass pipelines; triangles per random scene (as in
# tests/test_fuzz_configs.py).
FUZZ_DRAWS = ((11, "occlusion"), (12, "phong"), (13, "shadow"), (14, "default"), (15, "normal_map"),
              (16, "specular"), (17, "darboux"), (27, "shadow"), (30, "occlusion"))
FUZZ_TRIANGLES = 100


def random_scene(n, seed, spread=0.8):
    """tests/test_fuzz_configs.py's _random_scene: n random triangles of
    unit-sphere normals and random uv (the same draw)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-0.35, 0.35, (n, 3, 3)).astype(np.float32)
    verts = (centers + offs).reshape(-1, 3)
    normals = verts / np.maximum(np.linalg.norm(verts, axis=1, keepdims=True), 1e-6)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return {"positions": verts, "tex_coords": rng.uniform(0.02, 0.98, (3 * n, 2)).astype(np.float32),
            "normals": normals.astype(np.float32), "pos_idx": idx, "tex_idx": idx, "normal_idx": idx}


def random_config(rng, width, height):
    """tests/test_fuzz_configs.py's _random_config draw (the same choices in
    the same order): a random valid knob composition, as RenderConfig
    keywords.  A copy, since the card has no JAX and that module imports
    it."""
    tile_h = int(rng.choice([8, 16, 32]))
    strip_len = int(rng.choice([4, 8, 16, 32]))
    return dict(
        width=width, height=height, tri_block=32, tile_h=tile_h, tile_w=int(rng.choice([128, 256])),
        strip_len=strip_len, strip_batch=int(rng.choice([128, 512])),
        raster_group=int(rng.choice([4, 16])), csr_indirect=bool(rng.integers(2)),
        binning_compact=bool(rng.integers(2)), fuse_passes=bool(rng.integers(2)),
        strip_mask=bool(rng.integers(2)), strip_planes=bool(rng.integers(2)),
        compact_shade=bool(rng.integers(2)), idx_int16=bool(rng.integers(2)) and tile_h % 16 == 0,
        tex_tile=int(rng.choice([0, 8, 16])), shadow_tile=int(rng.choice([0, 8, 16])),
        max_span_y=int(rng.choice([2, 4, 8])), max_span_x=int(rng.choice([2, 4])),
        row_bands=int(rng.choice([0, 0, 2, 3])),
    )


def fuzz_phase(dev, record):
    """Phase 10: seeded random knob compositions (random_config) on random
    scenes at 800x800, one draw per pipeline and two that take K2, each
    with its span caps as drawn (at 800x800 they bind: the frames flag
    overflow, the regime of flagged, deterministic drops) and with loose
    ones (a full-screen bbox fits: no overflow allowed).  At two poses the
    eager frame (with z) equal to the same frame with the twins in place of
    K1 and K2, and the replayed frame (make_frame_fn) byte-equal to it; a
    2-frame burst at the same angles (no z: K2 where the gate allows it)
    replayed equal to the eager burst and to the twins' burst.  Launches
    per replay equal to the eager ones."""
    from tiny_renderer_tpu_torch import RenderConfig
    from tiny_renderer_tpu_torch.convert import scene_arrays, to_tensor
    from tiny_renderer_tpu_torch.models.procedural import make_textures
    from tiny_renderer_tpu_torch.ops import raster_cuda
    from tiny_renderer_tpu_torch.pipelines.frame import (
        _render_burst_eager, make_burst_fn, make_frame_fn, render_frame)

    t0 = time.perf_counter()
    tex = make_textures(64)
    twins = (mock.patch.object(raster_cuda, "rasterize", raster_cuda.rasterize_reference),
             mock.patch.object(raster_cuda, "rasterize_fused", raster_cuda.rasterize_fused_reference))

    def counted(fn):
        raster_cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(raster_cuda.LAUNCHES)

    def twin(fn):
        with twins[0], twins[1]:
            return fn()

    draws = []
    for seed, pipeline in FUZZ_DRAWS:
        rng = np.random.default_rng(seed)
        a, b = rng.uniform(-np.pi, np.pi, 2)
        knobs = random_config(rng, 800, 800)
        loose = dict(knobs, max_span_y=-(-800 // knobs["tile_h"]), max_span_x=-(-800 // knobs["tile_w"]))
        draws += [(seed, pipeline, a, b, knobs, "drawn"), (seed, pipeline, a, b, loose, "loose")]
    for seed, pipeline, a, b, knobs, caps in draws:
        td = time.perf_counter()
        g, t = scene_arrays(random_scene(FUZZ_TRIANGLES, seed), tex, dev)
        label = f"fuzz {seed} {pipeline} {knobs}"
        cfg = RenderConfig(**knobs).resolve(pipeline)
        cams = torch.tensor([b, b + 0.7], dtype=torch.float32, device=dev)
        ligs = torch.tensor([a, a - 0.4], dtype=torch.float32, device=dev)
        fn = make_frame_fn(pipeline, cfg)
        for i in range(2):
            view = [to_tensor(np.float32(v), dev) for v in (
                [np.sin(ligs[i].item()), 0.0, np.cos(ligs[i].item())],
                [np.sin(cams[i].item()), 0.0, np.cos(cams[i].item())], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])]
            eager, e_counts = counted(lambda: render_frame(g, t, *view, pipeline=pipeline, config=cfg))
            tw = twin(lambda: render_frame(g, t, *view, pipeline=pipeline, config=cfg))
            got, counts = counted(lambda: fn(g, t, *view))
            record(f"fuzz {pipeline}", counts)
            for k in ("frame", "z", "shadow", "overflow"):
                check(torch.equal(eager[k], tw[k]), f"{label} pose {i}: the eager {k} differs from the twins'")
                check(torch.equal(got[k], eager[k]), f"{label} pose {i}: the replayed {k} differs from eager")
            # The first call adds the capture's warm-up frame.
            check(counts == {m: (1 if i else 2) * n for m, n in e_counts.items()},
                  f"{label}: frame launches {counts}, eager {e_counts}")
        eb, e_counts = counted(lambda: _render_burst_eager(g, t, cams, ligs, pipeline=pipeline, config=cfg,
                                                           keep_frames=True))
        tb = twin(lambda: _render_burst_eager(g, t, cams, ligs, pipeline=pipeline, config=cfg, keep_frames=True))
        rb, b_counts = counted(lambda: make_burst_fn(pipeline, cfg, keep_frames=True)(g, t, cams, ligs))
        record(f"fuzz {pipeline}", b_counts)
        for k in ("frames", "checksums", "overflow"):
            check(torch.equal(eb[k], tb[k]), f"{label}: the eager burst's {k} differ from the twins'")
            check(torch.equal(rb[k], eb[k]), f"{label}: the replayed burst's {k} differ from the eager burst's")
        check(all(n % 2 == 0 for n in e_counts.values())
              and b_counts == {m: 3 * n // 2 for m, n in e_counts.items()},
              f"{label}: burst launches {b_counts} (warm-up + 2 replays), eager {e_counts} (2 frames)")
        check(caps == "drawn" or not bool(eb["overflow"].any()), f"{label}: overflow under loose span caps")
        on = {k: v for k, v in knobs.items() if k not in ("width", "height", "tri_block")}
        phase("fuzz", f"seed {seed} {pipeline} ({caps} span caps), {FUZZ_TRIANGLES} random triangles at "
              f"800x800, {on}: eager frame "
              f"and 2-frame burst = the twins' (K1/K2), replayed = eager at 2 poses, launches per replay "
              f"{({k: v for k, v in counts.items() if v})}, per burst frame "
              f"{({k: v // 2 for k, v in e_counts.items() if v})} = eager; overflow "
              f"{eb['overflow'].tolist()}  [{time.perf_counter() - td:.1f} s]")
    phase("fuzz", f"{len(draws)} draws took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU")
    from tiny_renderer_tpu_torch import RenderConfig, Scene, register_pipeline
    from tiny_renderer_tpu_torch.app import flagship_model
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.examples import custom_pipeline as example
    from tiny_renderer_tpu_torch.models.stress import adversarial, screen_scene
    from tiny_renderer_tpu_torch.ops import mathlib as ml
    from tiny_renderer_tpu_torch.ops import raster_cuda, raster_probe
    from tiny_renderer_tpu_torch.ops.binning import bin_triangles
    from tiny_renderer_tpu_torch.pipelines import graphs
    from tiny_renderer_tpu_torch.ops.vertex import triangle_setup
    from tiny_renderer_tpu_torch.pipelines.frame import _render_burst_eager, make_burst_fn, render_frame
    from tiny_renderer_tpu_torch.pipelines.shaders import kernel_varying_spec, num_planes

    clock = [time.perf_counter()]

    def lap(name):
        """Print the seconds since the previous phase ended and the most
        device memory the caching allocator reserved during it."""
        now = time.perf_counter()
        phase(name, f"took {now - clock[0]:.1f} s; max memory reserved "
              f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()
        clock[0] = now

    dev = torch.device(DEVICE, 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    phase("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    lap("device")

    # -- 2. build -------------------------------------------------------------
    with ThreadPoolExecutor(3) as pool:  # one nvcc each, started together
        jobs = [pool.submit(raster_cuda.build, force=True, probe=probe) for probe in (False, True)]
        jobs.append(pool.submit(raster_cuda.build, force=True, source=graphs.IF_SOURCE))
        (lib, seconds, log), (probe_lib, probe_seconds, _), (if_lib, if_seconds, _) = [j.result() for j in jobs]
    phase("build", f"nvcc {' '.join(raster_cuda.NVCC_FLAGS)} -> {lib.name} in {seconds:.3f} s, "
          f"and with -DRASTER_PROBE -> {probe_lib.name} in {probe_seconds:.3f} s; the replayed graphs' IF "
          f"nodes ({graphs.IF_SOURCE.name}) -> {if_lib.name} in {if_seconds:.3f} s")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            phase("build", line.strip())
    lap("build")

    # -- 2b. vertex -----------------------------------------------------------
    vertex_phase(dev, smi)
    lap("vertex")

    # -- 2c. occlusion --------------------------------------------------------
    occlusion_phase(dev, smi)
    lap("occlusion")

    # -- 2d. darboux ----------------------------------------------------------
    darboux_phase(dev, smi)
    lap("darboux")

    cfg = RenderConfig().resolve("shadow")  # 800x800, the default config
    grid = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w, tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x)
    tile_px = cfg.tile_h * cfg.tile_w
    view = [to_tensor(np.float32(v), dev) for v in VIEW]
    model = flagship_model()
    tex = {"texture": torch.from_numpy(np.ascontiguousarray(model.texture))}
    specs = {f"planes-tex{t}": kernel_varying_spec("shadow", tex, tile=t) for t in (0, 16)}
    specs["planes-const"] = CONST_SPEC
    # The other pipelines' kernel specs.  The flagship's maps share 1024^2
    # dims: a texel index over 2 or 3 packed maps, and darboux's local_z
    # (its consts dropped).  With the normal maps at another size darboux
    # keeps its 15-plane reference spec, consts included; kernel_varying_spec
    # reads only the maps' shapes.
    maps = {n: tex["texture"] for n in ("normal_map", "normal_map_tangent", "specular_map")}
    half = torch.empty((512, 512, 3), dtype=torch.uint8)
    pipe_specs = {f"{p}-tex{t}": kernel_varying_spec(p, {**tex, **maps}, tile=t)
                  for p in ("normal_map", "specular", "darboux") for t in (0, 16)}
    pipe_specs["darboux-mixed"] = kernel_varying_spec(
        "darboux", {**tex, **maps, "normal_map": half, "normal_map_tangent": half})
    pipe_specs["occlusion"] = kernel_varying_spec("occlusion", tex)
    check(num_planes(pipe_specs["darboux-tex16"]) == 4 and num_planes(pipe_specs["darboux-mixed"]) == 15
          and sum(m == "const" for _, _, m in pipe_specs["darboux-mixed"]) == 4,
          f"darboux kernel specs {pipe_specs['darboux-tex16']}, {pipe_specs['darboux-mixed']}")
    # The custom pipelines of the entry phase (toon and glow from the
    # example); fog's spec is a phase-2 layout no built-in has.
    example.register()
    register_pipeline("fog", shade_fog, varying_spec=FOG_SPEC, maps=("texture",), two_pass=True,
                      overwrite=True)
    th, tw = tex["texture"].shape[:2]
    for t in (0, 16):
        pipe_specs[f"fog-tex{t}"] = kernel_varying_spec("fog", tex, tile=t)
        want = f"texidx:{tw}:{th}:{t}" if t else f"texidx:{tw}:{th}"
        check(pipe_specs[f"fog-tex{t}"] == (("texidx", 1, want), ("zfrag", 1, "zfrag")),
              f"fog kernel spec {pipe_specs[f'fog-tex{t}']}")

    eye = torch.eye(4, device=dev)

    def screen_uniforms(m):
        return {"vpmv": m, "m": eye, "it_m": eye,
                "t_light_direction": torch.tensor([0.0, 0.6, 0.8], device=dev)}

    def passes(geom_np, bcfg=cfg, spec=(), kind="view"):
        """Binned light pass and camera pass of a scene, and the setup of
        each ("setup").  kind "view": at the view; "screen": a screen-space
        scene, the camera pass as given and the light pass transposed (x and
        y swapped, every winding flipped); "signed0": a screen-space scene
        through signed_zero."""
        g = {k: to_tensor(v, dev) for k, v in geom_np.items()}
        needs = ("vertex_intensity", "darboux")
        if kind == "view":
            u1 = ml.shadow_pass_1_prepare(bcfg, view[0], view[2], view[3])
            u2 = ml.shadow_pass_2_prepare(bcfg, *view)
            s1 = triangle_setup(g, u1, bcfg, matrix_key="shadow_matrix", cull=False, needs=needs)
            s2 = triangle_setup(g, u2, bcfg, needs=needs)
        else:
            s1 = triangle_setup(g, screen_uniforms(eye[[1, 0, 2, 3]]), bcfg, cull=False, needs=needs)
            s2 = triangle_setup(g, screen_uniforms(eye), bcfg, cull=False, needs=needs)
        out = {"light": bin_triangles(s1, bcfg, spec)[:3], "camera": bin_triangles(s2, bcfg, spec)[:3],
               "setup": {"light": s1, "camera": s2}}
        if kind == "signed0":
            out["light"], out["camera"] = signed_zero(out["light"]), signed_zero(out["camera"])
        return out

    # -- 3. kernels against twins ---------------------------------------------
    m = model.mesh
    flag_geom = {"positions": m.positions, "tex_coords": m.tex_coords, "normals": m.normals,
                 "pos_idx": m.pos_idx, "tex_idx": m.tex_idx, "normal_idx": m.normal_idx}
    # 300 identical camera-facing triangles (more than one shared-memory
    # chunk of records): index 0 must win every pixel.
    tie = soup(300, 0)
    tie["positions"] = np.tile(np.float32([[-0.3, -0.3, 0], [0.3, -0.3, 0], [-0.3, 0.3, 0]]), (300, 1))
    cases = {f"soup{s}": (soup(3000, s), "view") for s in range(3)}
    cases["tie"] = (tie, "view")
    cases["flagship"] = (flag_geom, "view")
    for name, tris in adversarial(cfg.width, cfg.height).items():
        cases[name] = (screen_scene(tris, 1), "signed0" if name == "signed0" else "screen")
    gathered_cfg = dataclasses.replace(cfg, csr_indirect=False)
    wide_cfg = dataclasses.replace(cfg, tile_h=8, tile_w=384)  # SL 24: no shuffle-only path
    wide_grid = dict(tile_h=wide_cfg.tile_h, tile_w=wide_cfg.tile_w, tiles_y=wide_cfg.tiles_y,
                     tiles_x=wide_cfg.tiles_x)
    # The all-on knob config's launches: gathered light pass z-only, and the
    # camera pass gathered + int16 + strips + planes, on 16x128 tiles.
    allon_cfg = RenderConfig(**KNOBS["all-on"][0]).resolve("shadow")
    allon_grid = dict(tile_h=allon_cfg.tile_h, tile_w=allon_cfg.tile_w, tiles_y=allon_cfg.tiles_y,
                      tiles_x=allon_cfg.tiles_x)
    allon_spec = kernel_varying_spec("shadow", tex, tile=allon_cfg.tex_tile)
    allon_cam = dict(emit_z=False, spec=allon_spec, emit_strips=allon_cfg.strip_len, idx_dtype="int16")
    err = {k: 0.0 for k in ("depth", "gathered", "int16", "strips", "planes", "fused", "banded",
                            "banded_fused", "capacity", "capacity_banded")}
    n_cmp, covered, n_masks = 0, {}, 0

    def compare(kind_, label, got, want):
        nonlocal n_cmp
        for a, b in zip(got, want):
            check((a is None) == (b is None), f"{label}: outputs differ in kind")
            if a is None:
                continue
            check(a.dtype == b.dtype and a.shape == b.shape, f"{label}: {a.dtype}{tuple(a.shape)} "
                  f"vs twin {b.dtype}{tuple(b.shape)}")
            same = (torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.dtype == torch.float32
                    else torch.equal(a, b))
            check(same, f"{label}: differs from the twin")
            err[kind_] = max(err[kind_], float((a.double() - b.double()).abs().max()))
        n_cmp += 1

    def k1(kind_, label, binned, g=grid, **kw):
        got = raster_cuda.rasterize(*binned, **g, **kw)
        torch.cuda.synchronize()
        compare(kind_, label, got, raster_cuda.rasterize_reference(*binned, **g, **kw))
        return got

    for cname, (geom_np, scene_kind) in cases.items():
        def passes_of(bcfg=cfg, spec=()):
            return passes(geom_np, bcfg, spec, scene_kind)

        base = passes_of()
        gath = passes_of(gathered_cfg)
        for pname in ("light", "camera"):
            got = raster_probe.kernel_masks(*base[pname], **grid)
            check(torch.equal(got, raster_probe.model_masks(*base[pname], **grid)),
                  f"{cname}/{pname}: the kernel's rect masks differ from raster_cuda.cull_masks")
            n_masks += got.numel()
            for mode, kw in MODES.items():
                out = k1("depth", f"{cname}/{pname}/{mode}", base[pname], **kw)
                if out[1] is not None:
                    covered[f"{cname}/{pname}"] = int((out[1] >= 0).sum())
            k1("gathered", f"{cname}/{pname}/gathered", gath[pname])
            k1("gathered", f"{cname}/{pname}/gathered+planes", passes_of(gathered_cfg,
               specs["planes-tex16"])[pname], emit_z=False, spec=specs["planes-tex16"])
            k1("int16", f"{cname}/{pname}/int16", base[pname], emit_z=False, idx_dtype="int16")
            for sl in (8, 16, 64):
                k1("strips", f"{cname}/{pname}/strips{sl}", base[pname], emit_z=False, emit_strips=sl)
        k1("strips", f"{cname}/camera/strips24@384", passes_of(wide_cfg)["camera"],
           wide_grid, emit_z=False, emit_strips=24)
        for sname, spec in specs.items():
            sp = passes_of(cfg, spec)
            for pname in ("light", "camera"):
                k1("planes", f"{cname}/{pname}/{sname}", sp[pname], emit_z=False, spec=spec)
        if cname.startswith("soup") or cname == "flagship":
            for sname, spec in pipe_specs.items():
                sp = passes_of(cfg, spec)
                for pname in ("light", "camera"):
                    k1("planes", f"{cname}/{pname}/{sname}", sp[pname], emit_z=False, spec=spec)
        k1("gathered", f"{cname}/light/all-on", passes_of(allon_cfg)["light"], allon_grid,
           emit_idx=False)
        k1("planes", f"{cname}/camera/all-on", passes_of(allon_cfg, allon_spec)["camera"],
           allon_grid, **allon_cam)
        for label, p in (("indirect", base), ("gathered", gath)):
            got = raster_cuda.rasterize_fused(*p["light"], *p["camera"], **grid)
            torch.cuda.synchronize()
            compare("fused", f"{cname}/fused/{label}", got,
                    raster_cuda.rasterize_fused_reference(*p["light"], *p["camera"], **grid))
        if cname == "tie":
            idx = raster_cuda.rasterize(*base["camera"], **grid)[1]
            check(bool((idx[idx >= 0] == 0).all()) and bool((idx >= 0).any()),
                  "tie case: triangle 0 must win every covered pixel")
        if cname == "signed0":
            z, idx = raster_cuda.rasterize(*base["camera"], **grid)[:2]
            won = idx >= 0
            check(bool((idx[won] % 2 == 0).all()), "signed-zero case: the first of each pair must win")
            signs = torch.signbit(z[won])
            check(bool(signs.any()) and bool((~signs).any()),
                  "signed-zero case: both signs of zero must be stored")
    phase("kernel", f"{n_cmp} kernel/twin comparisons bit-identical (tolerance: exact), "
          f"max_abs_err {err}; covered px {covered}; the kernel's rect masks equal "
          f"raster_cuda.cull_masks on all {2 * len(cases)} passes ({n_masks} (slot, block) masks)")
    lap("kernel")

    # -- 4. slice -------------------------------------------------------------
    scene = Scene(model, "shadow", RenderConfig(), device=dev)
    scene.set_light_direction(VIEW[0])
    scene.set_camera(*VIEW[1:])
    cams = torch.tensor(0.37 + 0.05 * np.arange(N_FRAMES), dtype=torch.float32, device=dev)
    ligs = torch.tensor(-0.6 + 0.03 * np.arange(N_FRAMES), dtype=torch.float32, device=dev)
    burst = make_burst_fn("shadow", scene.config, keep_frames=True)
    geom, textures = scene._geom, scene._textures

    # Launches by kernel mode and pipeline, over every path driven below.
    # "capacity"/"capacity_bands": K1 launches of the capacity scene's one-band
    # and banded renders (capacity phase).
    mode_paths = {k: {} for k in (*raster_cuda.LAUNCHES, "capacity", "capacity_bands")}

    def record(path, got):
        for k, n in got.items():
            if n:
                mode_paths[k][path] = mode_paths[k].get(path, 0) + n

    # Each first call captures a CUDA graph: one eager warm-up frame (its
    # launches count), then the replays (each counts the launches its
    # capture recorded).
    raster_cuda.reset_launches()
    out1 = scene.render()
    after_render = dict(raster_cuda.LAUNCHES)
    out = burst(geom, textures, cams, ligs)
    torch.cuda.synchronize()
    counts = dict(raster_cuda.LAUNCHES)
    launches = counts["raster"]
    check(after_render["raster"] == 2 * 2,
          f"Scene.render made {after_render['raster']} kernel launches, expected 4 (warm-up + replay)")
    check(launches - after_render["raster"] == 2 * (N_FRAMES + 1),
          f"burst made {launches - after_render['raster']} kernel launches, expected {2 * (N_FRAMES + 1)}")
    check(all(v == 0 for k, v in counts.items() if k != "raster"), f"default path launched {counts}")
    record("shadow", counts)
    frames = out["frames"]
    check(frames.shape == (N_FRAMES, cfg.height, cfg.width, 3) and frames.dtype == torch.uint8,
          f"burst frames {tuple(frames.shape)} {frames.dtype}")
    lit = (frames > 0).any(-1).flatten(1).float().mean(1)
    check(bool((lit > 0).all()), f"a burst frame is all black: lit share {lit.tolist()}")
    check(not bool(out["overflow"].any()) and not scene.overflowed, "a frame overflowed")
    check(out1["z"] is not None and out1["z"].shape == (cfg.height, cfg.width), "Scene.render z")
    check(bool(torch.isfinite(out1["z"][out1["z"] > ml.F32_MIN]).all()), "non-finite z")

    # The eager frames with the twin raster: the replayed graphs against them.
    with mock.patch.object(raster_cuda, "rasterize", raster_cuda.rasterize_reference):
        twin_out = _render_burst_eager(geom, textures, cams, ligs, pipeline="shadow", config=scene.config,
                                       keep_frames=True)
        twin_render = render_frame(geom, textures, *view, pipeline="shadow", config=scene.config)
    check(raster_cuda.LAUNCHES == counts, "the twin burst launched a kernel")
    check(torch.equal(twin_out["frames"], frames), "burst frames differ from the twin-raster burst")
    check(torch.equal(twin_out["checksums"], out["checksums"]), "burst checksums differ")
    for k in ("frame", "z", "shadow"):
        check(torch.equal(twin_render[k], out1[k]), f"Scene.render {k} differs from the twin raster")

    # The same frame on the CPU (the twin raster, torch CPU ops).
    cpu_view = [to_tensor(np.float32(v), "cpu") for v in VIEW]
    cpu_geom = {k: v.cpu() for k, v in geom.items()}
    cpu_tex = {k: v.cpu() for k, v in textures.items()}
    cpu = render_frame(cpu_geom, cpu_tex, *cpu_view, pipeline="shadow", config=scene.config)
    frame_diff = float((cpu["frame"] != out1["frame"].cpu()).any(-1).float().mean())
    shadow_diff = int(((cpu["shadow"] > ml.F32_MIN) != (out1["shadow"].cpu() > ml.F32_MIN)).sum())
    check(frame_diff < 0.005, f"GPU frame differs from the CPU frame on {frame_diff:.4%} of pixels")
    phase("slice", f"Scene.render + {N_FRAMES}-frame {cfg.width}x{cfg.height} shadow burst of "
          f"{model.num_triangles} triangles, each a replayed CUDA graph: {launches} kernel launches "
          f"({2 * (N_FRAMES + 1)} in the burst, its capture's warm-up frame included), lit share "
          f"{min(lit.tolist()):.4f}-{max(lit.tolist()):.4f}, "
          f"frames bit-identical to the eager frames with the twin raster; vs the CPU frame: {frame_diff:.6%} of pixels "
          f"differ, shadow coverage differs on {shadow_diff} px")
    lap("slice")

    # -- 5. pipelines ---------------------------------------------------------
    # The stand-in's normal and specular maps are flat: seeded random ones
    # make the normal-mapped pipelines do varied work.
    rng = np.random.default_rng(7)
    pmodel = dataclasses.replace(model, **{
        n: rng.integers(0, 256, model.texture.shape, dtype=np.uint8)
        for n in ("normal_map", "normal_map_tangent", "specular_map")})
    pcams, pligs = cams[:N_PIPE_FRAMES], ligs[:N_PIPE_FRAMES]
    twin = (mock.patch.object(raster_cuda, "rasterize", raster_cuda.rasterize_reference),
            mock.patch.object(raster_cuda, "rasterize_fused", raster_cuda.rasterize_fused_reference))
    pipe_runs = {}  # name -> (burst fn, scene, burst frames)
    for name in NEW_PIPELINES:
        per_frame = pipeline_launches(name)
        psc = Scene(pmodel, name, RenderConfig(), device=dev)
        psc.set_light_direction(VIEW[0])
        psc.set_camera(*VIEW[1:])
        pburst = make_burst_fn(name, psc.config, keep_frames=True)
        raster_cuda.reset_launches()
        r1 = psc.render()
        torch.cuda.synchronize()
        got_render = dict(raster_cuda.LAUNCHES)
        raster_cuda.reset_launches()
        pout = pburst(psc._geom, psc._textures, pcams, pligs)
        torch.cuda.synchronize()
        got_burst = dict(raster_cuda.LAUNCHES)
        want = {k: 2 * per_frame.get(k, 0) for k in got_render}  # warm-up + replay
        check(got_render == want, f"{name}: Scene.render launches {got_render}, expected {want}")
        want = {k: (N_PIPE_FRAMES + 1) * per_frame.get(k, 0) for k in got_render}
        check(got_burst == want, f"{name}: burst launches {got_burst}, expected {want}")
        record(name, got_render)
        record(name, got_burst)
        pframes = pout["frames"]
        check(pframes.shape == (N_PIPE_FRAMES, cfg.height, cfg.width, 3), f"{name}: frames {pframes.shape}")
        plit = (pframes > 0).any(-1).flatten(1).float().mean(1)
        check(bool((plit > 0).all()), f"{name}: a burst frame is all black: lit share {plit.tolist()}")
        check(not bool(pout["overflow"].any()) and not psc.overflowed, f"{name}: a frame overflowed")
        check(bool(torch.isfinite(r1["z"][r1["z"] > ml.F32_MIN]).all()), f"{name}: non-finite z")
        with twin[0], twin[1]:
            tout = _render_burst_eager(psc._geom, psc._textures, pcams, pligs, pipeline=name,
                                       config=psc.config, keep_frames=True)
            trender = render_frame(psc._geom, psc._textures, *view, pipeline=name, config=psc.config)
        check(raster_cuda.LAUNCHES == got_burst, f"{name}: the twin burst launched a kernel")
        check(torch.equal(tout["frames"], pframes), f"{name}: burst frames differ from the twin-raster burst")
        check(torch.equal(tout["checksums"], pout["checksums"]), f"{name}: burst checksums differ")
        for k in ("frame", "z", "shadow"):
            check(torch.equal(trender[k], r1[k]), f"{name}: Scene.render {k} differs from the twin raster")
        pcpu = render_frame({k: v.cpu() for k, v in psc._geom.items()},
                            {k: v.cpu() for k, v in psc._textures.items()}, *cpu_view,
                            pipeline=name, config=psc.config)
        pdiff = float((pcpu["frame"] != r1["frame"].cpu()).any(-1).float().mean())
        check(pdiff < 0.005, f"{name}: GPU frame differs from the CPU frame on {pdiff:.4%} of pixels")
        pipe_runs[name] = (pburst, psc, pframes)
        phase("pipelines", f"{name}: Scene.render {got_render['raster']} + burst {got_burst['raster']} "
              f"K1 launches ({per_frame['raster']} per frame, a warm-up frame per capture), lit share "
              f"{min(plit.tolist()):.4f}-{max(plit.tolist()):.4f}, replayed render and {N_PIPE_FRAMES}-frame "
              f"burst bit-identical to the eager frames with the twin raster; vs the CPU frame {pdiff:.6%} "
              "of pixels differ")
    lap("pipelines")

    # -- 6. knobs -------------------------------------------------------------
    knob_bursts = {}
    for name, (knobs, per_frame) in KNOBS.items():
        kscene = Scene(model, "shadow", RenderConfig(**knobs), device=dev)
        kburst = make_burst_fn("shadow", kscene.config, keep_frames=True)
        knob_bursts[name] = (kburst, kscene)
        raster_cuda.reset_launches()
        kout = kburst(kscene._geom, kscene._textures, cams[:N_KNOB_FRAMES], ligs[:N_KNOB_FRAMES])
        torch.cuda.synchronize()
        got = dict(raster_cuda.LAUNCHES)
        record("shadow", got)
        want = {k: (N_KNOB_FRAMES + 1) * per_frame.get(k, 0) for k in got}  # + the capture's warm-up
        check(got == want, f"knob {name}: launches {got}, expected {want}")
        check(torch.equal(kout["frames"], frames[:N_KNOB_FRAMES]),
              f"knob {name}: burst frames differ from the default burst")
        check(not bool(kout["overflow"].any()), f"knob {name}: a frame overflowed")
        msg = f"{name}: {N_KNOB_FRAMES} frames bit-identical to the default burst, launches {got}"
        if name == "fullplane":
            kscene.set_light_direction(VIEW[0])
            kscene.set_camera(*VIEW[1:])
            raster_cuda.reset_launches()
            kr = kscene.render()
            torch.cuda.synchronize()
            got = dict(raster_cuda.LAUNCHES)
            check(got["raster"] == 4 and got["planes"] == 2, f"fullplane Scene.render launches {got} "
                  "(warm-up + replay)")
            for k in ("frame", "z", "shadow"):
                check(torch.equal(kr[k], out1[k]), f"fullplane Scene.render {k} differs from the default")
            msg += f"; Scene.render z, frame, shadow equal to the default (launches {got})"
        phase("knobs", msg)
    for pname in NEW_PIPELINES:
        for name, (knobs, per_frame) in pipeline_knobs(pname).items():
            kscene = Scene(pmodel, pname, RenderConfig(**knobs), device=dev)
            raster_cuda.reset_launches()
            kout = make_burst_fn(pname, kscene.config, keep_frames=True)(
                kscene._geom, kscene._textures, cams[:N_KNOB_FRAMES], ligs[:N_KNOB_FRAMES])
            torch.cuda.synchronize()
            got = dict(raster_cuda.LAUNCHES)
            record(pname, got)
            want = {k: (N_KNOB_FRAMES + 1) * per_frame.get(k, 0) for k in got}
            check(got == want, f"{pname} knob {name}: launches {got}, expected {want}")
            check(torch.equal(kout["frames"], pipe_runs[pname][2][:N_KNOB_FRAMES]),
                  f"{pname} knob {name}: burst frames differ from the pipeline's default burst")
            check(not bool(kout["overflow"].any()), f"{pname} knob {name}: a frame overflowed")
            phase("knobs", f"{pname} {name}: {N_KNOB_FRAMES} frames bit-identical to {pname}'s default "
                  f"burst, launches {got}")
    # Darboux with normal maps of another size than the texture: the strip
    # shade samples map by map, the full-screen shade reads the 15-plane
    # reference spec, consts included, from the kernel.
    mmodel = dataclasses.replace(pmodel, **{n: np.ascontiguousarray(getattr(pmodel, n)[:512, :512])
                                            for n in ("normal_map", "normal_map_tangent")})
    mixed = {}
    for name, knobs, per_frame in (("default", {}, {"raster": 1}),
                                   ("fullplane", dict(compact_shade=False), {"raster": 1, "planes": 1})):
        msc = Scene(mmodel, "darboux", RenderConfig(**knobs), device=dev)
        check(num_planes(kernel_varying_spec("darboux", msc._textures)) == 15, "mixed maps: darboux spec")
        raster_cuda.reset_launches()
        mout = make_burst_fn("darboux", msc.config, keep_frames=True)(
            msc._geom, msc._textures, cams[:N_KNOB_FRAMES], ligs[:N_KNOB_FRAMES])
        torch.cuda.synchronize()
        got = dict(raster_cuda.LAUNCHES)
        record("darboux", got)
        want = {k: (N_KNOB_FRAMES + 1) * per_frame.get(k, 0) for k in got}
        check(got == want, f"darboux mixed maps {name}: launches {got}, expected {want}")
        mixed[name] = mout["frames"]
    check(torch.equal(mixed["fullplane"], mixed["default"]),
          "darboux mixed maps: the full-screen shade differs from the strip shade")
    check(bool((mixed["default"] > 0).any()), "darboux mixed maps: black frames")
    phase("knobs", f"darboux with 512^2 normal maps: {N_KNOB_FRAMES} frames of the full-screen shade "
          "(15-plane reference spec) bit-identical to the strip shade (per-map samplers)")
    lap("knobs")

    # -- 7. graph -------------------------------------------------------------
    graph_ms = graph_phase(dev, model, pmodel, smi, record)
    lap("graph")

    # -- 8. shade -------------------------------------------------------------
    shade_phase(dev, pmodel, smi, record)
    lap("shade")

    # -- 9. parallel ----------------------------------------------------------
    par_ms, par_bounds, par_graph = parallel_phase(dev, model, RenderConfig(), smi, record, passes, compare,
                                                   cases, specs["planes-tex16"])
    lap("parallel")

    # -- 10. fuzz --------------------------------------------------------------
    fuzz_phase(dev, record)
    lap("fuzz")

    # -- 11. timing -----------------------------------------------------------
    def timed(key, label, kernel, twin):
        """(kernel ms paced by the host, twin ms, kernel ms on the device)."""
        ms = (time_launches(kernel, 200), time_launches(twin, 5), time_launches(kernel, 200, hold=True))
        phase("timing", f"{label}: kernel {ms[0]:.4f} ms per launch paced by the host ({PR2_MS[key]:.4f} "
              f"in {PR2_LABEL}), {ms[2]:.4f} on the device with the launch queue held full; "
              f"twin {ms[1]:.4f} ms  [{smi}]")
        return ms

    flag = passes(flag_geom)
    flag_g = passes(flag_geom, gathered_cfg)
    spec16 = specs["planes-tex16"]
    flag_p = passes(flag_geom, cfg, spec16)
    ms = {}
    for pname, mode in (("light", "z"), ("camera", "idx"), ("camera", "z+idx")):
        b, kw = flag[pname], MODES[mode]
        ms[f"{pname}/{mode}"] = timed(
            f"{pname}/{mode}", f"{pname} pass {mode}", lambda: raster_cuda.rasterize(*b, **grid, **kw),
            lambda: raster_cuda.rasterize_reference(*b, **grid, **kw))
    cam = flag["camera"]
    per_tile = {p: torch.diff(flag[p][2]).cpu() for p in ("light", "camera")}
    work = {p: {k: v.cpu() for k, v in block_work(flag["setup"][p], flag[p], grid).items()}
            for p in ("light", "camera")}
    tests = {p: int(w["bbox"].sum()) for p, w in work.items()}
    both = {k: work["light"][k] + work["camera"][k] for k in work["light"]}
    wb = int(both["tests"].argmax())  # K2's slowest block walks both passes
    nb = both["tests"].numel() // cfg.num_tiles
    n_blocks = cfg.padded_width // raster_cuda.SUBTILE[1] * (cfg.padded_height // raster_cuda.SUBTILE[0])
    sm_ms = OPS_PER_CANDIDATE / (PEAK_FLOPS / 132) * 1e3  # one test at one SM's share of the peak
    phase("timing", "flagship binning and the kernel's work (by raster_cuda.cull_masks, whose masks "
          "equal the kernel's): " + ", ".join(
        f"{p} pass {int(c.sum())} incidences on {int((c > 0).sum())} of {c.numel()} tiles "
        f"(max {int(c.max())} per tile), {tests[p]} pixel tests inside the bboxes "
        f"({tests[p] / int(c.sum()):.2f} per incidence), the kernel makes {int(work[p]['tests'].sum())} "
        f"({int(work[p]['tests'].sum()) / int(c.sum()):.2f} per incidence; the brute-force walk made "
        f"{tile_px})" for p, c in per_tile.items())
        + f"; {n_blocks} blocks of {raster_cuda.SUBTILE[0]}x{raster_cuda.SUBTILE[1]} launched, "
        f"{int((both['survivors'] > 0).sum())} with a candidate left after their sub-tile cull; "
        f"both passes' worst block (block {wb % nb} of tile {wb // nb}): "
        f"{int(both['candidates'][wb])} candidates "
        f"staged, {int(both['survivors'][wb])} past its sub-tile cull, {int(both['bbox'][wb])} bbox pixel "
        f"tests, {int(both['tests'][wb])} pixel tests made, which need {int(both['tests'][wb]) * sm_ms:.6f} "
        f"ms at one SM's share of the fp32 peak (132 SMs)")
    modes = {
        "gathered": (flag_g["camera"], dict(emit_z=False)),
        "int16": (cam, dict(emit_z=False, idx_dtype="int16")),
        "strips": (cam, dict(emit_z=False, emit_strips=16)),
        "planes": (flag_p["camera"], dict(emit_z=False, spec=spec16)),
    }
    for name, (b, kw) in modes.items():
        ms[name] = timed(name, f"camera pass {name} {kw}", lambda: raster_cuda.rasterize(*b, **grid, **kw),
                         lambda: raster_cuda.rasterize_reference(*b, **grid, **kw))
    ms["fused"] = timed(
        "fused", "fused light + camera pass",
        lambda: raster_cuda.rasterize_fused(*flag["light"], *cam, **grid),
        lambda: raster_cuda.rasterize_fused_reference(*flag["light"], *cam, **grid))

    def burst_ms(fn, sc, n_reps):
        best = float("inf")
        for _ in range(n_reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(sc._geom, sc._textures, cams, ligs)
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3 / N_FRAMES)
        return best

    def in_turns(order):
        """Best burst ms/frame of each (burst fn, scene) of `order`: one
        warm-up burst each, then two rounds of two bursts each, forward,
        then backward."""
        for fn, sc in order.values():
            burst_ms(fn, sc, 1)
        best = {k: float("inf") for k in order}
        for rnd in range(2):
            for k in (list(order) if rnd == 0 else list(order)[::-1]):
                best[k] = min(best[k], burst_ms(*order[k], 2))
        return best

    burst_times = in_turns({"default": (burst, scene), **knob_bursts})
    with mock.patch.object(raster_cuda, "rasterize", raster_cuda.rasterize_reference):
        burst_twin = burst_ms(lambda *a: _render_burst_eager(*a, pipeline="shadow", config=scene.config),
                              scene, 1)
    phase("timing", "shadow burst ms/frame (host clock, best of 4 bursts of "
          f"{N_FRAMES}, configs in turns): " + ", ".join(f"{k} {v:.3f}" for k, v in burst_times.items())
          + f"; default eager with the twin raster {burst_twin:.3f}  [{smi}]")
    pipe_times = in_turns({p: (burst, scene) if p == "shadow" else pipe_runs[p][:2] for p in PIPELINE_ORDER})
    phase("timing", "burst ms/frame by pipeline, default config (host clock, best of 4 bursts of "
          f"{N_FRAMES}, pipelines in turns): " + ", ".join(f"{k} {v:.3f}" for k, v in pipe_times.items())
          + f"  [{smi}]")

    # -- kernel results -------------------------------------------------------
    hp, wp = cfg.padded_height, cfg.padded_width
    px = hp * wp

    def pas(b, p):
        """A pass for bound(); every layout and spec bins the same incidences."""
        return (b[0], b[1], b[2], tests[p])

    cam_cov = int((raster_cuda.rasterize(*flag_p["camera"], **grid, emit_z=False)[1] >= 0).sum())
    planes16 = raster_cuda._plane_layout(spec16)
    both = [pas(flag["light"], "light"), pas(cam, "camera")]
    cam_only = [pas(cam, "camera")]
    bounds = {
        "light z": bound([pas(flag["light"], "light")], px * 4),
        "camera idx": bound(cam_only, px * 4),
        "camera z+idx": bound(cam_only, px * 8),
        "depth": bound(both, px * 8),
        "gathered": bound([pas(flag_g["camera"], "camera")], px * 4),
        "int16": bound(cam_only, px * 2),
        "strips": bound(cam_only, px * 4 + px // 16 * 4),
        "planes": bound([pas(flag_p["camera"], "camera")], px * 4 + len(planes16) * px * 4, planes16,
                        cam_cov),
        "fused": bound(both, px * 8),
    }
    phase("timing", "bounds: " + ", ".join(
        f"{k} {v[0]:.6f} ms by {v[1]} ({v[2]} flops, {v[3]} bytes)" for k, v in bounds.items()))
    for sname in ("darboux-tex16", "darboux-mixed"):
        spec = pipe_specs[sname]
        b = passes(flag_geom, cfg, spec)["camera"]
        kw = dict(emit_z=False, spec=spec)
        paced, twin_ms, dms = (time_launches(lambda: raster_cuda.rasterize(*b, **grid, **kw), 200),
                               time_launches(lambda: raster_cuda.rasterize_reference(*b, **grid, **kw), 5),
                               time_launches(lambda: raster_cuda.rasterize(*b, **grid, **kw), 200, hold=True))
        planes = raster_cuda._plane_layout(spec)
        bd = bound([pas(b, "camera")], px * 4 + len(planes) * px * 4, planes, cam_cov)
        phase("timing", f"phase 2 under {sname} ({len(planes)} planes; camera pass, idx-only): kernel "
              f"{paced:.4f} ms per launch paced by the host, {dms:.4f} on the device with the launch queue "
              f"held full; twin {twin_ms:.4f} ms; bound {bd[0]:.6f} ms by {bd[1]} ({bd[2]} flops, "
              f"{bd[3]} bytes), {bd[0] / dms:.2%} of it (shadow's 3 planes: {ms['planes'][2]:.4f} ms on "
              f"the device)  [{smi}]")
    lap("timing")

    # -- 12. entry ------------------------------------------------------------
    entry_phase(dev, model, RenderConfig(), smi, record, twin, pcams, pligs, scene,
                pipe_runs["default"][1])
    lap("entry")

    # -- 13. capacity ---------------------------------------------------------
    cap_ms, cap_bounds = capacity_phase(dev, model, RenderConfig(), smi, record, passes, compare, grid, scene)
    lap("capacity")

    # -- 14. trace ------------------------------------------------------------
    trace_phase(dev, smi)
    lap("trace")

    # -- 14b. sequence ----------------------------------------------------------
    sequence_phase(dev, smi)
    lap("sequence")

    # -- 15. profile ----------------------------------------------------------
    profile_phase(dev, RenderConfig(), smi, scene)
    lap("profile")

    src = "tiny_renderer_tpu_torch/csrc/raster.cu"
    rp = "tiny_renderer_tpu/ops/raster_pallas.py"
    entries = [
        ("raster_depth (K1 phase 1: light pass depth-only + camera pass idx-only, ms per frame)",
         f"{rp}:167", "depth", "raster", tuple(a + b for a, b in zip(ms["light/z"], ms["camera/idx"]))),
        ("raster_depth, gathered records (K1 tris=None; camera pass idx-only)", f"{rp}:208",
         "gathered", "gathered", ms["gathered"]),
        ("raster_depth, int16 index target (K1; camera pass)", f"{rp}:231", "int16", "int16", ms["int16"]),
        ("raster_depth, strip plane emit_strips=SL (K1; camera pass, timed at SL 16; SL 8 on "
         "occlusion's path)", f"{rp}:236", "strips", "strips", ms["strips"]),
        ("raster_depth, phase 2 varying planes (K1 vary_body; camera pass, shadow kernel spec, "
         "tex_tile 16)", f"{rp}:257", "planes", "planes", ms["planes"]),
        ("raster_fused (K2: light pass depth + camera pass idx in one launch)", f"{rp}:466",
         "fused", "fused", ms["fused"]),
        (f"raster_depth at a row offset (K1 row_tile_offset > 0 on the row shards of parallel.sharding; "
         f"each shard's light pass depth-only + camera pass idx-only, ms per frame of {ROW_SHARDS} shards)",
         f"{rp}:155", "banded", "offset", par_ms["banded"]),
        (f"raster_fused at a row offset (K2 row_tile_offset > 0 on the row shards under fuse_passes, ms "
         f"per frame of {ROW_SHARDS} shards)", f"{rp}:480", "banded_fused", "fused_offset",
         par_ms["banded_fused"]),
        ("raster_depth at capacity (K1 at 81,536 triangles, int32 index target: light pass depth-only + "
         "camera pass idx-only, ms per frame)", f"{rp}:167", "capacity", "capacity", cap_ms["capacity"]),
        ("raster_depth under row_bands=4 (K1 at the row offsets of the capacity frame's tile-row bands; "
         "launches: every banded render, row_bands 4 and 25; times: the 4 light + 4 camera launches of "
         "row_bands=4, ms per frame)", f"{rp}:155", "capacity_banded", "capacity_bands",
         cap_ms["capacity_banded"]),
    ]
    bounds.update(par_bounds)
    bounds.update(cap_bounds)

    def by_pipeline(mode):
        return dict(mode_paths[mode])

    # Device ms per launch inside a replayed graph (graph phase; the depth
    # row per frame: its two launches), null where no graph phase trace
    # holds the mode.
    in_graph = {k: graph_ms.get(m) for k, m in (("gathered", "gathered"), ("int16", "int16"),
                                                  ("strips", "strips"), ("planes", "planes"),
                                                  ("fused", "fused"))}
    if graph_ms.get("light z") is not None and graph_ms.get("camera idx") is not None:
        in_graph["depth"] = graph_ms["light z"] + graph_ms["camera idx"]
    # The offset rows: ms per replayed sharded frame (its 10 K1 or 5 K2
    # launches inside the segment graphs).
    in_graph.update({k: par_graph[k][0] for k in ("banded", "banded_fused")})

    for name, _r, _k, mode, _t in entries:
        check(mode_paths[mode], f"{name}: no path launched it")

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": sum(mode_paths[mode].values()), "launches_by_pipeline": by_pipeline(mode),
        "pipelines": list(by_pipeline(mode)), "max_abs_err": err[key], "ms": t[0], "device_ms": t[2],
        "graph_device_ms": in_graph.get(key), "plain_ms": t[1], "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": None,
    } for name, replaces, key, mode, t in entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
