#!/usr/bin/env python3
"""Drive the torch port's shadow frame path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases (each prints a line; any failure raises, so the exit code is not 0):

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the raster kernel (csrc/raster.cu) with nvcc for sm_90a.
3. kernel  — the CUDA kernel against its plain torch twin in all three output
             modes (z, idx, z+idx) on seeded random soups, the depth tie
             case and the flagship scene's two passes: bit-identical.
4. slice   — Scene.render plus a 16-frame 800x800 shadow burst of the
             flagship scene through the public API: two kernel launches
             per frame, no black frame, no overflow, frames bit-identical
             to the same burst with the twin as raster, and a frame within
             the 0.5% tie budget of the same frame rendered on the CPU.
5. timing  — kernel and twin ms per launch per mode at the flagship shapes,
             and burst ms per frame (CUDA events / host clock after
             warm-up), beside the card's name and power limit.

Prints a JSON line of kernel results, then, last, the device JSON line.
The scene is diablo when assets/diablo exists, else a UV sphere of the
same size (5,096 triangles, 1024^2 maps) made from fixed parameters.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

N_FRAMES = 16
DEVICE = "cuda"
VIEW = ([0.3, 0.0, 0.95], [0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
MODES = {"z": dict(emit_z=True, emit_idx=False), "idx": dict(emit_z=False, emit_idx=True),
         "z+idx": dict(emit_z=True, emit_idx=True)}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def soup(n, seed):
    """Seeded triangle soup in the unit box, geometry-dict layout."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.9, 0.9, (n, 1, 3)).astype(np.float32)
    verts = (centers + rng.uniform(-0.06, 0.06, (n, 3, 3)).astype(np.float32)).reshape(-1, 3)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return {"positions": verts, "tex_coords": np.full((3 * n, 2), 0.5, np.float32),
            "normals": np.tile(np.float32([0, 0, 1]), (3 * n, 1)),
            "pos_idx": idx, "tex_idx": idx, "normal_idx": idx}


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
        if "registers" in line or "spill" in line:
            phase("build", line.strip())

    cfg = RenderConfig().resolve("shadow")  # 800x800, the default config
    grid = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w, tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x)
    view = [to_tensor(np.float32(v), dev) for v in VIEW]

    def passes(geom_np):
        """Binned light pass and camera pass of a scene at the view."""
        g = {k: to_tensor(v, dev) for k, v in geom_np.items()}
        u1 = ml.shadow_pass_1_prepare(cfg, view[0], view[2], view[3])
        u2 = ml.shadow_pass_2_prepare(cfg, *view)
        s1 = triangle_setup(g, u1, cfg, matrix_key="shadow_matrix", cull=False)
        s2 = triangle_setup(g, u2, cfg, needs=("vertex_intensity",))
        return {"light": bin_triangles(s1, cfg)[:3], "camera": bin_triangles(s2, cfg)[:3]}

    # -- 3. kernel against twin -----------------------------------------------
    model = flagship_model()
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
    max_err, n_cmp, covered = 0.0, 0, {}
    for cname, geom_np in cases.items():
        for pname, binned in passes(geom_np).items():
            for mode, kw in MODES.items():
                kz, kidx = raster_cuda.rasterize(*binned, **grid, **kw)
                torch.cuda.synchronize()
                tz, tidx = raster_cuda.rasterize_reference(*binned, **grid, **kw)
                torch.cuda.synchronize()
                if kz is not None:
                    check(torch.equal(kz, tz), f"{cname}/{pname}/{mode}: z differs from the twin")
                    max_err = max(max_err, float((kz - tz).abs().max()))
                if kidx is not None:
                    check(torch.equal(kidx, tidx), f"{cname}/{pname}/{mode}: idx differs from the twin")
                    max_err = max(max_err, float((kidx - tidx).abs().max()))
                    covered[f"{cname}/{pname}"] = int((kidx >= 0).sum())
                n_cmp += 1
        if cname == "tie":
            idx = raster_cuda.rasterize(*passes(geom_np)["camera"], **grid)[1]
            check(bool((idx[idx >= 0] == 0).all()) and bool((idx >= 0).any()),
                  "tie case: triangle 0 must win every covered pixel")
    phase("kernel", f"{n_cmp} kernel/twin comparisons bit-identical (tolerance: exact), "
          f"max_abs_err {max_err}; covered px {covered}")

    # -- 4. slice -------------------------------------------------------------
    scene = Scene(model, "shadow", RenderConfig(), device=dev)
    scene.set_light_direction(VIEW[0])
    scene.set_camera(*VIEW[1:])
    cams = torch.tensor(0.37 + 0.05 * np.arange(N_FRAMES), dtype=torch.float32, device=dev)
    ligs = torch.tensor(-0.6 + 0.03 * np.arange(N_FRAMES), dtype=torch.float32, device=dev)
    burst = make_burst_fn("shadow", scene.config, keep_frames=True)
    geom, textures = scene._geom, scene._textures

    raster_cuda.LAUNCHES = 0
    out1 = scene.render()
    after_render = raster_cuda.LAUNCHES
    out = burst(geom, textures, cams, ligs)
    torch.cuda.synchronize()
    launches = raster_cuda.LAUNCHES
    check(after_render == 2, f"Scene.render made {after_render} kernel launches, expected 2")
    check(launches - after_render == 2 * N_FRAMES,
          f"burst made {launches - after_render} kernel launches, expected {2 * N_FRAMES}")
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
    check(raster_cuda.LAUNCHES == launches, "the twin burst launched the kernel")
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

    # -- 5. timing ------------------------------------------------------------
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

    flag = passes(flag_geom)
    ms = {}
    for pname, mode in (("light", "z"), ("camera", "idx"), ("camera", "z+idx")):
        b, kw = flag[pname], MODES[mode]
        ms[f"{pname}/{mode}"] = (
            time_launches(lambda: raster_cuda.rasterize(*b, **grid, **kw), 200),
            time_launches(lambda: raster_cuda.rasterize_reference(*b, **grid, **kw), 5),
        )
        phase("timing", f"{pname} pass {mode}: kernel {ms[f'{pname}/{mode}'][0]:.4f} ms, "
              f"twin {ms[f'{pname}/{mode}'][1]:.4f} ms per launch  [{smi}]")

    def burst_ms(n_reps=3):
        best = float("inf")
        for _ in range(n_reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            burst(geom, textures, cams, ligs)
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3 / N_FRAMES)
        return best

    burst_kernel = burst_ms()
    with mock.patch.object(raster_cuda, "rasterize", raster_cuda.rasterize_reference):
        burst_twin = burst_ms(1)
    phase("timing", f"burst: {burst_kernel:.3f} ms/frame with the kernel, {burst_twin:.3f} ms/frame "
          f"with the twin raster (host clock, best of 3 / 1 bursts of {N_FRAMES})  [{smi}]")

    frame_ms = ms["light/z"][0] + ms["camera/idx"][0]
    frame_plain = ms["light/z"][1] + ms["camera/idx"][1]
    print(json.dumps({"kernels": [{
        "name": "raster_depth (K1 phase 1: light pass depth-only + camera pass idx-only, ms per frame)",
        "route": "cuda",
        "source": "tiny_renderer_tpu_torch/csrc/raster.cu",
        "replaces": "tiny_renderer_tpu/ops/raster_pallas.py:167",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": frame_ms,
        "plain_ms": frame_plain,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
