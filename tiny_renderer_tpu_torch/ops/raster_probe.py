"""Probes of the raster kernel on a GPU, through its probe build.

    python -m tiny_renderer_tpu_torch.ops.raster_probe

The probe build is csrc/raster.cu compiled with -DRASTER_PROBE
(``raster_cuda.build(probe=True)``): the same kernels, with the PROBE_*
markers of the source switched on.  Run as a script, this checks the probe
build against the twin on the flagship stand-in's two passes at 800x800
and a bin tile of 2,000 small triangles (models.stress "hot"), bit for
bit, then prints, per pass, when each block ran and how long its staging +
sub-tile cull, rect masks and walk took (%globaltimer at the walk's block
barriers; the probe adds a barrier after each chunk's walk, so the phases
are upper bounds) for the blocks that finished last, beside the card's name
and power limit.  ``kernel_masks`` reads the rect mask the kernel computes
for each staged record in each block, which chip_smoke.py holds to
``raster_cuda.cull_masks``.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from ..app import flagship_model
from ..config import RenderConfig
from ..convert import to_tensor
from ..models.stress import adversarial, screen_scene
from . import mathlib as ml
from . import raster_cuda
from .binning import bin_triangles
from .vertex import triangle_setup

VIEW = ([0.3, 0.0, 0.95], [0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])  # chip_smoke.py's
PHASES = ("total", "stage", "rect", "walk")  # probe_times slots 0-3; 4 and 5: block start and end


@contextlib.contextmanager
def probing(times=None, masks=None):
    """Context in which raster_cuda's wrappers launch the probe build, its
    probes writing into `times` and `masks` (device tensors, csrc/raster.cu
    probe_times and probe_masks; None: off)."""
    lib = raster_cuda._library(probe=True)
    ptr = [None if t is None else t.data_ptr() for t in (times, masks)]
    raster_cuda._raise_on(lib.raster_set_probe(*ptr), lib, "raster_set_probe")
    try:
        with mock.patch.object(raster_cuda, "_library", lambda: lib):
            yield
    finally:
        torch.cuda.synchronize()
        raster_cuda._raise_on(lib.raster_set_probe(None, None), lib, "raster_set_probe")


def kernel_masks(records, tris, starts, **grid):
    """The rect mask the K1 kernel computes for each CSR slot in
    [starts[0], starts[-1]) in each SUBTILE block of the slot's tile: (S,
    blocks per tile) i64, bit r for rect r (raster_cuda.rect_offsets)."""
    subs = grid["tile_h"] // raster_cuda.SUBTILE[0] * (grid["tile_w"] // raster_cuda.SUBTILE[1])
    slots = records.shape[0] if tris is None else tris.shape[0]
    out = torch.zeros((slots, subs), dtype=torch.int32, device=records.device)
    with probing(masks=out):
        raster_cuda.rasterize(records, tris, starts, **grid, emit_idx=False)
    return out[int(starts[0]):int(starts[-1])].long()


def model_masks(records, tris, starts, **grid):
    """raster_cuda.cull_masks packed as kernel_masks packs the kernel's."""
    masks = raster_cuda.cull_masks(records, tris, starts, **grid)[1]
    bit = 1 << torch.arange(masks.shape[-1], device=masks.device)
    return (masks.long() * bit).sum(-1)


def scenes(dev):
    """The config, its grid and the binned passes: flagship light and
    camera, and the hot bin tile."""
    cfg = RenderConfig().resolve("shadow")
    view = [to_tensor(np.float32(v), dev) for v in VIEW]
    m = flagship_model().mesh
    geom = {k: to_tensor(getattr(m, k), dev)
            for k in ("positions", "tex_coords", "normals", "pos_idx", "tex_idx", "normal_idx")}
    light = triangle_setup(geom, ml.shadow_pass_1_prepare(cfg, view[0], view[2], view[3]), cfg,
                           matrix_key="shadow_matrix", cull=False)
    camera = triangle_setup(geom, ml.shadow_pass_2_prepare(cfg, *view), cfg)
    hot = screen_scene(adversarial(cfg.width, cfg.height)["hot"], 1)
    hot = triangle_setup({k: to_tensor(v, dev) for k, v in hot.items()},
                         {"vpmv": torch.eye(4, device=dev)}, cfg, cull=False)
    grid = dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w, tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x)
    return cfg, grid, {k: bin_triangles(s, cfg)[:3] for k, s in
                       (("light", light), ("camera", camera), ("hot", hot))}


def _bits(ts):
    return [t.view(torch.int32) if t.dtype == torch.float32 else t for t in ts if t is not None]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("raster_probe needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cfg, grid, passes = scenes(dev)
    sub_h, sub_w = raster_cuda.SUBTILE
    nbx = cfg.padded_width // sub_w
    blocks = cfg.padded_height // sub_h * nbx
    for name, binned in passes.items():
        times = torch.zeros((blocks, 8), dtype=torch.int64, device=dev)
        with probing(times=times):
            got = raster_cuda.rasterize(*binned, **grid)
        want = raster_cuda.rasterize_reference(*binned, **grid)
        if not all(torch.equal(a, b) for a, b in zip(_bits(got), _bits(want))):
            raise AssertionError(f"{name}: the probe build differs from the twin")
        t = times.cpu().numpy().astype(np.float64)
        start = (t[:, 4] - t[:, 4].min()) / 1e3
        end = (t[:, 5] - t[:, 4].min()) / 1e3
        us = t[:, :4] / 1e3
        busy = us[:, 3] > 0
        print(f"[{name}] bit-identical to the twin; {blocks} blocks of {sub_h}x{sub_w}, {int(busy.sum())} "
              f"walked a record; span {end.max():.2f} us; those started at up to {start[busy].max():.2f} us; "
              f"median block {np.median(us[:, 0]):.2f} us  [{smi}]", flush=True)
        for b in np.argsort(-end)[:5]:
            y, x = divmod(int(b), nbx)
            print(f"[{name}]   block ({y}, {x}) tile ({y * sub_h // cfg.tile_h}, {x * sub_w // cfg.tile_w}): "
                  f"start {start[b]:.2f}, end {end[b]:.2f} us; "
                  + ", ".join(f"{k} {v:.2f}" for k, v in zip(PHASES, us[b])) + " us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
