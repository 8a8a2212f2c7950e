#!/usr/bin/env python3
"""Drive the torch port's shadow frame path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases (each prints a line; any failure raises, so the exit code is not 0):

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the raster kernels (csrc/raster.cu) with nvcc for sm_90a
             and print ptxas's registers/spills for every instantiation.
3. kernel  — every kernel mode against its plain torch twin on seeded random
             soups, the depth tie case and the flagship scene's two passes,
             bit-identical: K1 phase 1 (z, idx, z+idx), the gathered record
             layout, the int16 index target, the strip plane (SL 16, and 64
             and 24 through the shared-memory combine), phase 2 with
             shadow's kernel spec (tex_tile 0 and 16) and with a spec of
             const and interp planes, K2 (both passes in one launch), and
             the all-on knob config's two launches on its 16x128 tiles
             (gathered + int16 + strips + planes in one camera launch).
4. slice   — Scene.render plus a 16-frame 800x800 shadow burst of the
             flagship scene through the public API: two kernel launches
             per frame, no black frame, no overflow, frames bit-identical
             to the same burst with the twin as raster, and a frame within
             the 0.5% tie budget of the same frame rendered on the CPU.
5. knobs   — the same burst (first 4 angles) under each raster knob config
             (fuse_passes, strip_mask + strip_planes, idx_int16,
             csr_indirect=False + strip_mask, compact_shade=False,
             shadow_tile=8 + fuse_passes, all on): frames bit-identical to
             the default burst, with the launches each config implies;
             compact_shade=False also through Scene.render (z, frame, shadow
             equal to the default Scene.render).
6. timing  — kernel and twin ms per launch per mode at the flagship shapes,
             and burst ms per frame of each knob config beside the default
             (CUDA events / host clock after warm-up, configs in turns),
             beside the card's name and power limit.

Launch counts are set to 0 just before each path is driven and read just
after.  Prints a JSON line of kernel results (time, launches, error, and the
bound: the larger of the work's fp32 operations over 67 TFLOP/s and its bytes
over 3.35 TB/s, counted from this run's binned inputs, with phase 1's
operations only at the pixels inside each candidate's bbox), then, last, the
device JSON line.  The scene is diablo when assets/diablo exists, else a UV
sphere of the same size (5,096 triangles, 1024^2 maps) made from fixed
parameters.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

N_FRAMES = 16
N_KNOB_FRAMES = 4
DEVICE = "cuda"
VIEW = ([0.3, 0.0, 0.95], [0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
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
PEAK_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
OPS_PER_CANDIDATE = 26  # phase 1 flops per (pixel, candidate) test, csrc/raster.cu
OPS_PHASE2_BASE = 16  # edge functions + exact-division barycentrics per covered pixel
# Phase 2 flops per covered pixel and plane; texidx: two interpolations,
# two scales, the fold (4 per coordinate), then the row-major index (2) or
# the tile swizzle (14).
OPS_PER_PLANE = {"interp": 5, "zfrag": 5, "const": 0, "texidx": 20}
OPS_ROW_MAJOR, OPS_SWIZZLE = 2, 14


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


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


def bbox_tests(setup, binned, g):
    """(tiles,) i64: per tile, the (pixel, candidate) pairs whose pixel lies
    in the candidate triangle's inclusive screen bbox.  No pixel outside it
    can pass the exact integer inside test, so these are the phase 1 tests
    the outputs need (the kernel walks every pixel of the tile)."""
    records, tris, starts = binned
    nt = starts.numel() - 1
    dev = starts.device
    tile = torch.repeat_interleave(torch.arange(nt, device=dev), torch.diff(starts).long())
    slot = torch.arange(int(starts[0]), int(starts[-1]), device=dev)
    tri = (tris[slot] if tris is not None else records[slot, 12]).long()

    def span(lo, hi, t, size):
        return (torch.minimum(hi[tri], (t + 1) * size - 1) - torch.maximum(lo[tri], t * size) + 1).clamp(min=0)

    px = (span(setup["x0"], setup["x1"], tile % g["tiles_x"], g["tile_w"])
          * span(setup["y0"], setup["y1"], tile // g["tiles_x"], g["tile_h"]))
    return torch.zeros(nt, dtype=torch.int64, device=dev).index_add_(0, tile, px.long())


def bound(passes, out_bytes, planes=(), covered=0):
    """(bound_ms, bound_by, flops, bytes) of a raster launch: phase 1 flops over the
    (pixel, candidate) pairs inside the candidates' bboxes, phase 2 flops per
    covered pixel, against the bytes of the record rows read (13 lanes, plus
    the plane lanes), the id list, the tile offsets and the outputs."""
    from tiny_renderer_tpu_torch.ops.raster_cuda import PLANE_LANES

    ops, nbytes = 0, out_bytes
    for records, tris, starts, tests in passes:
        n_inc = int(starts[-1] - starts[0])
        ops += tests * OPS_PER_CANDIDATE
        rows = records.shape[0] if tris is not None else n_inc
        lanes = max([13] + [lane + PLANE_LANES[m] for m, lane, *_ in planes])
        nbytes += rows * lanes * 4 + starts.numel() * 4 + (n_inc * 4 if tris is not None else 0)
    for mode, _lane, _p, _w, _h, swz in planes:
        extra = (OPS_SWIZZLE if swz else OPS_ROW_MAJOR) if mode == "texidx" else 0
        ops += covered * (OPS_PER_PLANE[mode] + extra)
    ops += covered * OPS_PHASE2_BASE if planes else 0
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def main() -> int:
    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU")
    from tiny_renderer_tpu_torch import RenderConfig, Scene
    from tiny_renderer_tpu_torch.app import flagship_model
    from tiny_renderer_tpu_torch.convert import to_tensor
    from tiny_renderer_tpu_torch.ops import mathlib as ml
    from tiny_renderer_tpu_torch.ops import raster_cuda
    from tiny_renderer_tpu_torch.ops.binning import bin_triangles
    from tiny_renderer_tpu_torch.ops.vertex import triangle_setup
    from tiny_renderer_tpu_torch.pipelines.frame import make_burst_fn, render_frame
    from tiny_renderer_tpu_torch.pipelines.shaders import kernel_varying_spec

    dev = torch.device(DEVICE, 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    phase("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------------
    lib, seconds, log = raster_cuda.build(force=True)
    phase("build", f"nvcc {' '.join(raster_cuda.NVCC_FLAGS)} -> {lib.name} in {seconds:.3f} s")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            phase("build", line.strip())

    cfg = RenderConfig().resolve("shadow")  # 800x800, the default config
    grid = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w, tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x)
    tile_px = cfg.tile_h * cfg.tile_w
    view = [to_tensor(np.float32(v), dev) for v in VIEW]
    model = flagship_model()
    tex = {"texture": torch.from_numpy(np.ascontiguousarray(model.texture))}
    specs = {f"planes-tex{t}": kernel_varying_spec("shadow", tex, tile=t) for t in (0, 16)}
    specs["planes-const"] = CONST_SPEC

    def passes(geom_np, bcfg=cfg, spec=()):
        """Binned light pass and camera pass of a scene at the view, and the
        setup of each ("setup")."""
        g = {k: to_tensor(v, dev) for k, v in geom_np.items()}
        u1 = ml.shadow_pass_1_prepare(bcfg, view[0], view[2], view[3])
        u2 = ml.shadow_pass_2_prepare(bcfg, *view)
        s1 = triangle_setup(g, u1, bcfg, matrix_key="shadow_matrix", cull=False,
                            needs=("vertex_intensity", "darboux"))
        s2 = triangle_setup(g, u2, bcfg, needs=("vertex_intensity", "darboux"))
        return {"light": bin_triangles(s1, bcfg, spec)[:3], "camera": bin_triangles(s2, bcfg, spec)[:3],
                "setup": {"light": s1, "camera": s2}}

    # -- 3. kernels against twins ---------------------------------------------
    m = model.mesh
    flag_geom = {"positions": m.positions, "tex_coords": m.tex_coords, "normals": m.normals,
                 "pos_idx": m.pos_idx, "tex_idx": m.tex_idx, "normal_idx": m.normal_idx}
    # 300 identical camera-facing triangles (more than one shared-memory
    # chunk of records): index 0 must win every pixel.
    tie = soup(300, 0)
    tie["positions"] = np.tile(np.float32([[-0.3, -0.3, 0], [0.3, -0.3, 0], [-0.3, 0.3, 0]]), (300, 1))
    cases = {f"soup{s}": soup(3000, s) for s in range(3)}
    cases["tie"] = tie
    cases["flagship"] = flag_geom
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
    err = {k: 0.0 for k in ("depth", "gathered", "int16", "strips", "planes", "fused")}
    n_cmp, covered = 0, {}

    def compare(kind_, label, got, want):
        nonlocal n_cmp
        for a, b in zip(got, want):
            check((a is None) == (b is None), f"{label}: outputs differ in kind")
            if a is None:
                continue
            check(a.dtype == b.dtype and a.shape == b.shape, f"{label}: {a.dtype}{tuple(a.shape)} "
                  f"vs twin {b.dtype}{tuple(b.shape)}")
            check(torch.equal(a, b), f"{label}: differs from the twin")
            err[kind_] = max(err[kind_], float((a.double() - b.double()).abs().max()))
        n_cmp += 1

    def k1(kind_, label, binned, g=grid, **kw):
        got = raster_cuda.rasterize(*binned, **g, **kw)
        torch.cuda.synchronize()
        compare(kind_, label, got, raster_cuda.rasterize_reference(*binned, **g, **kw))
        return got

    for cname, geom_np in cases.items():
        base = passes(geom_np)
        gath = passes(geom_np, gathered_cfg)
        for pname in ("light", "camera"):
            for mode, kw in MODES.items():
                out = k1("depth", f"{cname}/{pname}/{mode}", base[pname], **kw)
                if out[1] is not None:
                    covered[f"{cname}/{pname}"] = int((out[1] >= 0).sum())
            k1("gathered", f"{cname}/{pname}/gathered", gath[pname])
            k1("gathered", f"{cname}/{pname}/gathered+planes", passes(geom_np, gathered_cfg,
               specs["planes-tex16"])[pname], emit_z=False, spec=specs["planes-tex16"])
            k1("int16", f"{cname}/{pname}/int16", base[pname], emit_z=False, idx_dtype="int16")
            for sl in (16, 64):
                k1("strips", f"{cname}/{pname}/strips{sl}", base[pname], emit_z=False, emit_strips=sl)
        k1("strips", f"{cname}/camera/strips24@384", passes(geom_np, wide_cfg)["camera"],
           wide_grid, emit_z=False, emit_strips=24)
        for sname, spec in specs.items():
            sp = passes(geom_np, cfg, spec)
            for pname in ("light", "camera"):
                k1("planes", f"{cname}/{pname}/{sname}", sp[pname], emit_z=False, spec=spec)
        k1("gathered", f"{cname}/light/all-on", passes(geom_np, allon_cfg)["light"], allon_grid,
           emit_idx=False)
        k1("planes", f"{cname}/camera/all-on", passes(geom_np, allon_cfg, allon_spec)["camera"],
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
    phase("kernel", f"{n_cmp} kernel/twin comparisons bit-identical (tolerance: exact), "
          f"max_abs_err {err}; covered px {covered}")

    # -- 4. slice -------------------------------------------------------------
    scene = Scene(model, "shadow", RenderConfig(), device=dev)
    scene.set_light_direction(VIEW[0])
    scene.set_camera(*VIEW[1:])
    cams = torch.tensor(0.37 + 0.05 * np.arange(N_FRAMES), dtype=torch.float32, device=dev)
    ligs = torch.tensor(-0.6 + 0.03 * np.arange(N_FRAMES), dtype=torch.float32, device=dev)
    burst = make_burst_fn("shadow", scene.config, keep_frames=True)
    geom, textures = scene._geom, scene._textures

    raster_cuda.reset_launches()
    out1 = scene.render()
    after_render = dict(raster_cuda.LAUNCHES)
    out = burst(geom, textures, cams, ligs)
    torch.cuda.synchronize()
    counts = dict(raster_cuda.LAUNCHES)
    launches = counts["raster"]
    check(after_render["raster"] == 2, f"Scene.render made {after_render['raster']} kernel launches, expected 2")
    check(launches - after_render["raster"] == 2 * N_FRAMES,
          f"burst made {launches - after_render['raster']} kernel launches, expected {2 * N_FRAMES}")
    check(all(v == 0 for k, v in counts.items() if k != "raster"), f"default path launched {counts}")
    frames = out["frames"]
    check(frames.shape == (N_FRAMES, cfg.height, cfg.width, 3) and frames.dtype == torch.uint8,
          f"burst frames {tuple(frames.shape)} {frames.dtype}")
    lit = (frames > 0).any(-1).flatten(1).float().mean(1)
    check(bool((lit > 0).all()), f"a burst frame is all black: lit share {lit.tolist()}")
    check(not bool(out["overflow"].any()) and not scene.overflowed, "a frame overflowed")
    check(out1["z"] is not None and out1["z"].shape == (cfg.height, cfg.width), "Scene.render z")
    check(bool(torch.isfinite(out1["z"][out1["z"] > ml.F32_MIN]).all()), "non-finite z")

    with mock.patch.object(raster_cuda, "rasterize", raster_cuda.rasterize_reference):
        twin_out = burst(geom, textures, cams, ligs)
        twin_render = scene.render()
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
          f"{model.num_triangles} triangles: {launches} kernel launches "
          f"({2 * N_FRAMES} in the burst), lit share {min(lit.tolist()):.4f}-{max(lit.tolist()):.4f}, "
          f"frames bit-identical to the twin raster; vs the CPU frame: {frame_diff:.6%} of pixels "
          f"differ, shadow coverage differs on {shadow_diff} px")

    # -- 5. knobs -------------------------------------------------------------
    knob_counts, knob_bursts = {}, {}
    for name, (knobs, per_frame) in KNOBS.items():
        kscene = Scene(model, "shadow", RenderConfig(**knobs), device=dev)
        kburst = make_burst_fn("shadow", kscene.config, keep_frames=True)
        knob_bursts[name] = (kburst, kscene)
        raster_cuda.reset_launches()
        kout = kburst(kscene._geom, kscene._textures, cams[:N_KNOB_FRAMES], ligs[:N_KNOB_FRAMES])
        torch.cuda.synchronize()
        got = dict(raster_cuda.LAUNCHES)
        knob_counts[name] = got
        want = {k: N_KNOB_FRAMES * per_frame.get(k, 0) for k in got}
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
            check(got["raster"] == 2 and got["planes"] == 1, f"fullplane Scene.render launches {got}")
            for k in ("frame", "z", "shadow"):
                check(torch.equal(kr[k], out1[k]), f"fullplane Scene.render {k} differs from the default")
            msg += f"; Scene.render z, frame, shadow equal to the default (launches {got})"
        phase("knobs", msg)

    # -- 6. timing ------------------------------------------------------------
    def time_launches(fn, n):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def timed(label, kernel, twin):
        ms = (time_launches(kernel, 200), time_launches(twin, 5))
        phase("timing", f"{label}: kernel {ms[0]:.4f} ms, twin {ms[1]:.4f} ms per launch  [{smi}]")
        return ms

    flag = passes(flag_geom)
    flag_g = passes(flag_geom, gathered_cfg)
    spec16 = specs["planes-tex16"]
    flag_p = passes(flag_geom, cfg, spec16)
    ms = {}
    for pname, mode in (("light", "z"), ("camera", "idx"), ("camera", "z+idx")):
        b, kw = flag[pname], MODES[mode]
        ms[f"{pname}/{mode}"] = timed(
            f"{pname} pass {mode}", lambda: raster_cuda.rasterize(*b, **grid, **kw),
            lambda: raster_cuda.rasterize_reference(*b, **grid, **kw))
    cam = flag["camera"]
    per_tile = {p: torch.diff(flag[p][2]).cpu() for p in ("light", "camera")}
    tests = {p: bbox_tests(flag["setup"][p], flag[p], grid).cpu() for p in ("light", "camera")}
    both_tile = per_tile["light"] + per_tile["camera"]
    wt = int(both_tile.argmax())
    worst, worst_tests = int(both_tile[wt]), int(tests["light"][wt] + tests["camera"][wt])
    sm_ms = OPS_PER_CANDIDATE / (PEAK_FLOPS / 132) * 1e3  # one test at one SM's share of the peak
    phase("timing", "flagship binning: " + ", ".join(
        f"{p} pass {int(c.sum())} incidences on {int((c > 0).sum())} of {c.numel()} tiles "
        f"(max {int(c.max())} per tile), {int(tests[p].sum())} pixel tests inside the bboxes "
        f"({float(tests[p].sum()) / int(c.sum()):.2f} per incidence; the kernel makes {tile_px})"
        for p, c in per_tile.items())
        + f"; both passes' worst tile (tile {wt}) {worst} candidates: its brute-force walk needs "
        f"{worst * tile_px * sm_ms:.4f} ms at one SM's share of the fp32 peak (132 SMs), its "
        f"{worst_tests} bbox pixel tests {worst_tests * sm_ms:.6f} ms")
    modes = {
        "gathered": (flag_g["camera"], dict(emit_z=False)),
        "int16": (cam, dict(emit_z=False, idx_dtype="int16")),
        "strips": (cam, dict(emit_z=False, emit_strips=16)),
        "planes": (flag_p["camera"], dict(emit_z=False, spec=spec16)),
    }
    for name, (b, kw) in modes.items():
        ms[name] = timed(f"camera pass {name} {kw}", lambda: raster_cuda.rasterize(*b, **grid, **kw),
                         lambda: raster_cuda.rasterize_reference(*b, **grid, **kw))
    ms["fused"] = timed(
        "fused light + camera pass",
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

    order = {"default": (burst, scene), **knob_bursts}
    for fn, sc in order.values():
        burst_ms(fn, sc, 1)  # warm-up
    burst_times = {k: float("inf") for k in order}
    for rnd in range(2):  # in turns: forward, then backward
        for k in (list(order) if rnd == 0 else list(order)[::-1]):
            burst_times[k] = min(burst_times[k], burst_ms(*order[k], 2))
    with mock.patch.object(raster_cuda, "rasterize", raster_cuda.rasterize_reference):
        burst_twin = burst_ms(burst, scene, 1)
    phase("timing", "burst ms/frame (host clock, best of 4 bursts of "
          f"{N_FRAMES}, configs in turns): " + ", ".join(f"{k} {v:.3f}" for k, v in burst_times.items())
          + f"; default with the twin raster {burst_twin:.3f}  [{smi}]")

    # -- kernel results -------------------------------------------------------
    hp, wp = cfg.padded_height, cfg.padded_width
    px = hp * wp

    def pas(b, p):
        """A pass for bound(); every layout and spec bins the same incidences."""
        return (b[0], b[1], b[2], int(tests[p].sum()))

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
    src = "tiny_renderer_tpu_torch/csrc/raster.cu"
    rp = "tiny_renderer_tpu/ops/raster_pallas.py"
    entries = [
        ("raster_depth (K1 phase 1: light pass depth-only + camera pass idx-only, ms per frame)",
         f"{rp}:167", "depth", counts["raster"],
         (ms["light/z"][0] + ms["camera/idx"][0], ms["light/z"][1] + ms["camera/idx"][1])),
        ("raster_depth, gathered records (K1 tris=None; camera pass idx-only)", f"{rp}:208",
         "gathered", knob_counts["nocsr+mask"]["gathered"], ms["gathered"]),
        ("raster_depth, int16 index target (K1; camera pass)", f"{rp}:231", "int16",
         knob_counts["i16"]["int16"], ms["int16"]),
        ("raster_depth, strip plane emit_strips=16 (K1; camera pass)", f"{rp}:236", "strips",
         knob_counts["mask+planes"]["strips"], ms["strips"]),
        ("raster_depth, phase 2 varying planes (K1 vary_body; camera pass, shadow kernel spec, "
         "tex_tile 16)", f"{rp}:257", "planes", knob_counts["fullplane"]["planes"], ms["planes"]),
        ("raster_fused (K2: light pass depth + camera pass idx in one launch)", f"{rp}:466",
         "fused", knob_counts["fuse"]["fused"], ms["fused"]),
    ]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": n, "max_abs_err": err[key], "ms": t[0], "plain_ms": t[1],
        "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": None,
    } for name, replaces, key, n, t in entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
