"""Torch port: the raster's plain twin against the Pallas kernel.

Both consume the same binned inputs (JAX binning, eager).  The Pallas
kernel runs in interpret mode, as the JAX suite runs it on the CPU; XLA may
contract its z interpolation into FMAs (docs/DESIGN.md divergence #2), so z
is compared with a tolerance and winners may flip at exact-z ties only:
coverage exact, winner mismatch < 0.2%, z within rtol=1e-5, atol=1e-4.
The twin's own modes must agree with each other bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_vertex_raster import _geom_from_triangles, _identity_uniforms, _random_scene
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.ops.binning import bin_triangles
from tiny_renderer_tpu.ops.raster_pallas import rasterize_pallas
from tiny_renderer_tpu.ops.vertex import triangle_setup
from tiny_renderer_tpu_torch.convert import to_tensor
from tiny_renderer_tpu_torch.ops import raster_cuda

CFG = RenderConfig(width=256, height=128)
MODES = {"z": dict(emit_z=True, emit_idx=False), "idx": dict(emit_z=False, emit_idx=True),
         "z+idx": dict(emit_z=True, emit_idx=True)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _binned(geom, cfg=CFG, row_tile_offset=0):
    """Setup on the full frame (CFG), binned for `cfg` (a band of it when
    row_tile_offset is set)."""
    _, u = _identity_uniforms(CFG.width, CFG.height)
    s = triangle_setup(geom, u, CFG, needs=(), xp=np)
    records, tris, starts, _ = bin_triangles(s, cfg, row_tile_offset=row_tile_offset)
    return np.asarray(records), np.asarray(tris), np.asarray(starts)


def _grid(cfg):
    return dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w, tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x)


def _twin(binned, cfg=CFG, **kw):
    args = [to_tensor(a, "cpu") for a in binned]
    return raster_cuda.rasterize(*args, **_grid(cfg), **kw)


def _pallas(binned, cfg=CFG, row_tile_offset=None, **kw):
    records, tris, starts = binned
    z, idx, _, _ = rasterize_pallas(records, starts, row_tile_offset, tris,
                                    **_grid(cfg), interpret=True, **kw)
    return (None if z is None else np.asarray(z)), (None if idx is None else np.asarray(idx))


def _assert_parity(tz, tidx, pz, pidx):
    np.testing.assert_array_equal(tidx >= 0, pidx >= 0)
    assert (tidx != pidx).mean() < 0.002
    covered = pidx >= 0
    np.testing.assert_allclose(tz[covered], pz[covered], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_matches_pallas_interpret(seed, mode):
    binned = _binned(_random_scene(200, seed))
    kw = MODES[mode]
    tz, tidx = _twin(binned, **kw)
    pz, pidx = _pallas(binned, **kw)
    assert (tz is None) == (pz is None) and (tidx is None) == (pidx is None)
    _, ref_idx = _pallas(binned)  # z+idx, for the coverage mask
    if tz is not None:
        assert tz.dtype == torch.float32 and tz.shape == (CFG.padded_height, CFG.padded_width)
        tz = tz.numpy()
        np.testing.assert_array_equal(tz > -1e38, pz > -1e38)
        covered = ref_idx >= 0
        np.testing.assert_allclose(tz[covered], pz[covered], rtol=1e-5, atol=1e-4)
    if tidx is not None:
        assert tidx.dtype == torch.int32
        tidx = tidx.numpy()
        np.testing.assert_array_equal(tidx >= 0, pidx >= 0)
        assert (tidx != pidx).mean() < 0.002
    # The twin's three modes resolve identically.
    fz, fidx = _twin(binned)
    if tz is not None:
        np.testing.assert_array_equal(tz, fz.numpy())
    if tidx is not None:
        np.testing.assert_array_equal(tidx, fidx.numpy())


def test_twin_row_band_matches_pallas():
    """A band of tile rows (row_tile_offset) resolves like the same rows of
    the full frame, and like the Pallas kernel's band."""
    geom = _random_scene(200, 4)
    band = dataclasses.replace(CFG, height=2 * CFG.tile_h)
    binned = _binned(geom, band, row_tile_offset=2)
    tz, tidx = _twin(binned, band, row_tile_offset=2)
    pz, pidx = _pallas(binned, band, row_tile_offset=np.full((1,), 2, np.int32))
    _assert_parity(tz.numpy(), tidx.numpy(), pz, pidx)
    fz, fidx = _twin(_binned(geom))
    np.testing.assert_array_equal(tidx.numpy(), fidx.numpy()[2 * CFG.tile_h:])
    np.testing.assert_array_equal(tz.numpy(), fz.numpy()[2 * CFG.tile_h:])


@pytest.mark.parametrize("one_slot_chunks", [False, True])
def test_depth_tiebreak_first_triangle_wins(one_slot_chunks, monkeypatch):
    """Identical triangles: index 0 wins every pixel (the reference rejects
    z <= stored, shader.rs:175) — within one chunk of CSR slots and across
    chunks of one slot each."""
    if one_slot_chunks:
        monkeypatch.setattr(raster_cuda, "_REF_CHUNK_ELEMS", 1)
    tri = [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [-0.5, 0.5, 0.0]]
    tz, tidx = _twin(_binned(_geom_from_triangles([tri] * 12)))
    idx = tidx.numpy()
    assert (idx >= 0).sum() > 100
    assert (idx[idx >= 0] == 0).all()


def test_twin_invariant_to_chunking(monkeypatch):
    """The chunked lexicographic resolve equals the one-slot-at-a-time walk
    bit for bit."""
    binned = _binned(_random_scene(200, 7))
    z, idx = _twin(binned)
    monkeypatch.setattr(raster_cuda, "_REF_CHUNK_ELEMS", 1)
    z1, idx1 = _twin(binned)
    assert torch.equal(z, z1) and torch.equal(idx, idx1)


def test_cpu_tensors_run_the_twin_without_launching():
    binned = _binned(_random_scene(50, 5))
    before = raster_cuda.LAUNCHES
    z, idx = _twin(binned)
    rz, ridx = raster_cuda.rasterize_reference(*(to_tensor(a, "cpu") for a in binned), **_grid(CFG))
    assert raster_cuda.LAUNCHES == before
    assert torch.equal(z, rz) and torch.equal(idx, ridx)


@pytest.mark.parametrize("kw", [dict(spec=(("zfrag", 1, "zfrag"),)), dict(emit_strips=16),
                                dict(idx_dtype="int16")])
def test_unported_modes_raise(kw):
    binned = _binned(_random_scene(20, 6))
    with pytest.raises(NotImplementedError):
        _twin(binned, **kw)


def test_empty_tiles_clear():
    """Triangles all off screen: every pixel keeps the clear values."""
    binned = _binned(_geom_from_triangles([[[5, 5, 0], [6, 5, 0], [5, 6, 0]]]))
    z, idx = _twin(binned)
    assert (idx == -1).all() and (z == np.float32(-3.4028235e38)).all()
