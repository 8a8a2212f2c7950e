"""Torch port: the binning kernel's CUDA wrapper (ops/binning_cuda.py) and its dispatch, on the CPU.

No nvcc and no card here, so the kernel itself is held to the plain version
by chip_smoke.py's binning phase.  Here: CPU tensors take the plain version
(bin_triangles_reference) through bin_triangles and a rendered frame, and
never reach the library; the wrapper refuses a column of the wrong dtype or
shape, a CPU tensor and a record wider than the kernel writes, before any
launch; the record's spec lanes are the columns the wrapper hands the
kernel; launches made under a capture count at each replay, apart from the
other kernels' counters, and the tracer's snapshot copies them as
binning_launches.  And a model of the kernel's index math in plain torch (a
counting sort: the incidences of each rectangle before a tile, the tiles'
starts as a clamped exclusive scan, the ranks of the covering triangles in
triangle order, both drop rules) equals the sort-based bin_triangles on
random soups and spheres, under incidence caps that bind, span caps that
clamp and at row tile offsets.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tiny_renderer_tpu_torch import Model, RenderConfig, Scene
from tiny_renderer_tpu_torch.assets.obj import ObjMesh
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.ops import (
    binning_cuda, darboux_cuda, occlusion_cuda, raster_cuda, shadow_cuda, vertex_cuda)
from tiny_renderer_tpu_torch.ops.binning import (
    bin_triangles, bin_triangles_reference, incidence_cap, pack_triangle_records, record_lanes, spec_columns)
from tiny_renderer_tpu_torch.ops.vertex import triangle_setup
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines.shaders import VARYING_SPECS
from tiny_renderer_tpu_torch.utils import timing

CFG = RenderConfig(width=256, height=128)
VIEW = ([0.3, 0.2, 0.95], [0.2, 0.1, 0.98])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_library(monkeypatch):
    """Any use of the kernel's library raises."""

    def refuse():
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(binning_cuda, "_library", refuse)


def soup(n, seed, spread=0.9, size=0.3):
    """n random triangles (positions around the origin, trivial uv and
    normals) as a mesh of its own."""
    rng = np.random.default_rng(seed)
    verts = (rng.uniform(-spread, spread, (n, 1, 3)) + rng.uniform(-size, size, (n, 3, 3))).astype(np.float32)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return ObjMesh(positions=verts.reshape(-1, 3), tex_coords=np.full((3 * n, 2), 0.25, np.float32),
                   normals=np.tile(np.float32([[0.0, 0.0, 1.0]]), (3 * n, 1)), pos_idx=idx, tex_idx=idx,
                   normal_idx=idx)


MESHES = {
    "sphere": lambda: make_uv_sphere(0.45, 12, 16),
    "big sphere": lambda: make_uv_sphere(1.3, 10, 12),
    "soup": lambda: soup(300, 0),
    "large triangles": lambda: soup(120, 1, spread=0.6, size=0.8),
}


def setups(mesh, pipeline="shadow", config=CFG, view=VIEW):
    """(resolved config, {pass: triangle_setup's dict}) of `mesh` under
    `pipeline` on the CPU."""
    s = Scene(Model(mesh=mesh, **make_textures(16)), pipeline, config, device="cpu")
    spec = tframe.PIPELINES[pipeline]
    v = [torch.tensor(x, dtype=torch.float32) for x in (view[0], view[1], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])]
    u1, u = tframe._uniforms(spec, s.config, *v)
    out = {"camera": triangle_setup(s._geom, u, s.config, needs=spec.needs)}
    if spec.two_pass:
        out["light"] = triangle_setup(s._geom, u1, s.config, matrix_key="shadow_matrix", cull=False)
    return s.config, out


def counting_sort(setup, config, row_tile_offset=0):
    """(tris, starts, overflowed) of a stable counting sort by tile: the
    kernel's index math (csrc/binning.cu) in plain torch, over all
    (triangle, tile) pairs at once."""
    th, tw, ntx, nty = config.tile_h, config.tile_w, config.tiles_x, config.tiles_y
    msy, msx = config.max_span_y, config.max_span_x
    T = setup["valid"].shape[0]
    cap = incidence_cap(T, config)
    tx0, tx1 = setup["x0"] // tw, setup["x1"] // tw
    ty0, ty1 = setup["y0"] // th - row_tile_offset, setup["y1"] // th - row_tile_offset
    v = setup["valid"] & (ty1 >= 0) & (ty0 <= nty - 1)
    ty0, ty1 = ty0.clamp(0, nty - 1), ty1.clamp(0, nty - 1)
    clamped = bool((v & ((tx1 - tx0 > msx - 1) | (ty1 - ty0 > msy - 1))).any())
    sy = torch.where(v, (ty1 - ty0 + 1).clamp(max=msy), 0)[:, None]
    sx = torch.where(v, (tx1 - tx0 + 1).clamp(max=msx), 0)[:, None]
    count = (sy * sx)[:, 0]
    total = int(count.sum())
    tiles = torch.arange(config.num_tiles)
    dr, dc = tiles[None] // ntx - ty0[:, None], tiles[None] % ntx - tx0[:, None]  # (T, tiles)
    in_rows = (dr >= 0) & (dr < sy)
    covers = in_rows & (dc >= 0) & (dc < sx)
    # Each rectangle's candidates before the tile: whole rows above it, then
    # a prefix of its row; where it covers the tile, its own position there.
    before = dr.clamp(min=0).minimum(sy) * sx + torch.where(in_rows, dc.clamp(min=0).minimum(sx), 0)
    rank = torch.cumsum(covers.to(torch.int64), 0) - covers.to(torch.int64)  # triangle order in a tile
    if config.binning_compact:
        # Kept: triangle-major position base + before < cap.
        lim = (cap - (torch.cumsum(count, 0) - count))[:, None]
        start = before.minimum(lim).clamp(min=0).sum(0)
        keep = covers & (before < lim)
    else:
        # Kept: tile-major slot < cap.
        start = before.sum(0)
        keep = covers & (start[None] + rank < cap)
    slot = start[None] + rank
    # The sort's id list: its sorted keys cut at cap, one a candidate.
    slots = cap if config.binning_compact else min(cap, T * msy * msx)
    tris = torch.full((slots,), T - 1, dtype=torch.int32)
    ids = torch.arange(T, dtype=torch.int32)[:, None].expand_as(keep)
    tris[slot[keep]] = ids[keep]
    starts = torch.cat([start.clamp(max=cap), torch.tensor([min(total, cap)])]).to(torch.int32)
    return tris, starts, total > cap or clamped


CAPS = {
    "default": {},
    "compact": dict(binning_compact=True),
    "cap 64": dict(max_incidences=64),
    "cap 64 compact": dict(max_incidences=64, binning_compact=True),
    "cap 8 compact": dict(max_incidences=8, binning_compact=True),
    "span 1x1": dict(max_span_y=1, max_span_x=1),
    "span 1x1 compact": dict(max_span_y=1, max_span_x=1, binning_compact=True),
    "tile 8 span 2x1 cap 96": dict(tile_h=8, max_span_y=2, max_span_x=1, max_incidences=96),
}


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_counting_sort_equals_the_sort(mesh, caps):
    """The counting-sort model equals bin_triangles on both passes: ids,
    starts and the overflow flag (and a binding cap or span cap is seen)."""
    base, passes = setups(MESHES[mesh]())
    cfg = dataclasses.replace(base, **CAPS[caps])
    flagged = []
    for setup in passes.values():
        _, tris, starts, ovf = bin_triangles(setup, cfg)
        got = counting_sort(setup, cfg)
        assert torch.equal(got[0], tris) and torch.equal(got[1], starts) and got[2] == bool(ovf)
        flagged.append(bool(ovf))
    if caps != "default" and caps != "compact" and mesh != "soup":
        assert any(flagged), "no pass hit the cap: the drop rule went unchecked"


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("mesh", ["big sphere", "large triangles"])
def test_counting_sort_at_row_offsets(mesh, compact):
    """Bands of two tile rows at every row tile offset, each under a cap
    that binds in some band: the model equals the sort."""
    base, passes = setups(MESHES[mesh](), config=RenderConfig(width=256, height=256, tile_h=16))
    band = dataclasses.replace(base, height=2 * base.tile_h, max_incidences=24, binning_compact=compact)
    flagged = []
    for setup in passes.values():
        for t0 in range(base.tiles_y - 1):
            _, tris, starts, ovf = bin_triangles(setup, band, row_tile_offset=t0)
            got = counting_sort(setup, band, t0)
            assert torch.equal(got[0], tris) and torch.equal(got[1], starts) and got[2] == bool(ovf), t0
            flagged.append(bool(ovf))
    assert any(flagged)


@pytest.mark.parametrize("pipeline", ["shadow", "darboux"])
def test_cpu_tensors_take_the_plain_path(pipeline, no_library):
    """bin_triangles and a rendered frame on the CPU run the plain version:
    equal to bin_triangles_reference, no launch counted."""
    binning_cuda.reset_launches()
    cfg, passes = setups(MESHES["sphere"](), pipeline)
    for setup in passes.values():
        for got, want in zip(bin_triangles(setup, cfg), bin_triangles_reference(setup, cfg)):
            assert torch.equal(got, want)
    s = Scene(Model(mesh=MESHES["sphere"](), **make_textures(16)), pipeline, RenderConfig(width=64, height=64),
              device="cpu")
    s.set_light_direction(VIEW[0])
    s.set_camera(VIEW[1], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    s.render()
    assert (s.get_frame_buffer() > 0).any()
    assert binning_cuda.LAUNCHES == {"bin": 0}


@pytest.mark.parametrize("pipeline", ["shadow", "darboux", "specular", "occlusion"])
def test_spec_lanes_are_the_kernel_columns(pipeline):
    """The record's lanes past BASE_LANES are spec_columns, which the
    wrapper hands the kernel after COLUMNS and zv's three (their count
    within record_lanes)."""
    cfg, passes = setups(MESHES["sphere"](), pipeline)
    spec = tuple(VARYING_SPECS[pipeline])
    setup = passes["camera"]
    rec = pack_triangle_records(setup, spec)
    cols = spec_columns(setup, spec)
    assert 13 + len(cols) <= record_lanes(spec) == rec.shape[1]
    for lane, col in enumerate(cols, start=13):
        assert torch.equal(rec[:, lane], col)
    assert not rec[:, 13 + len(cols):].any()


def test_wrapper_refuses(no_library):
    """CPU columns, a wrong dtype or shape and a record wider than the
    kernel writes raise before any launch."""
    cfg, passes = setups(MESHES["sphere"]())
    setup = passes["camera"]
    with pytest.raises(ValueError, match="CUDA device"):
        binning_cuda.bin_triangles(setup, cfg)
    with pytest.raises(ValueError, match="x0: expected"):
        binning_cuda.bin_triangles({**setup, "x0": setup["x0"].to(torch.int64)}, cfg)
    with pytest.raises(ValueError, match="cz: expected"):
        binning_cuda.bin_triangles({**setup, "cz": setup["cz"][:-1]}, cfg)
    wide = (("uv", 2, "interp"),) * 20
    with pytest.raises(ValueError, match="lanes"):
        binning_cuda.bin_triangles(setup, cfg, wide)
    assert binning_cuda.LAUNCHES == {"bin": 0}


def test_launches_count_at_each_replay():
    """A launch under a capture counts into the capture's dict of binning
    launches, none into the other kernels' or into LAUNCHES; each replay
    adds them to binning_cuda.LAUNCHES."""
    binning_cuda.reset_launches()
    others = (raster_cuda, vertex_cuda, occlusion_cuda, darboux_cuda, shadow_cuda)
    before = [dict(m.LAUNCHES) for m in others]
    with raster_cuda.recording() as raster, vertex_cuda.recording() as vertex, \
            occlusion_cuda.recording() as occlusion, darboux_cuda.recording() as darboux, \
            shadow_cuda.recording() as shadow, binning_cuda.recording() as binning:
        for _ in range(2):  # one launch a pass
            raster_cuda.launch_counts(binning_cuda.LAUNCHES)["bin"] += 1
    assert binning == {"bin": 2} and binning_cuda.LAUNCHES == {"bin": 0}
    assert not any(v for d in (raster, vertex, occlusion, darboux, shadow) for v in d.values())
    for _ in range(3):
        binning_cuda.replayed(binning)
    assert binning_cuda.LAUNCHES == {"bin": 6}
    assert [m.LAUNCHES for m in others] == before
    raster_cuda.launch_counts(binning_cuda.LAUNCHES)["bin"] += 1  # outside a capture
    assert binning_cuda.LAUNCHES == {"bin": 7}
    binning_cuda.reset_launches()


def test_snapshot_copies_the_counter():
    """timing.snapshot() shows binning_cuda.LAUNCHES as binning_launches, a
    copy the caller may keep."""
    binning_cuda.reset_launches()
    raster_cuda.launch_counts(binning_cuda.LAUNCHES)["bin"] += 2
    snap = timing.snapshot()["binning_launches"]
    assert snap == {"bin": 2} and snap is not binning_cuda.LAUNCHES
    binning_cuda.reset_launches()
    assert snap == {"bin": 2}
