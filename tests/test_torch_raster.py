"""Torch port: the raster's plain twins against the Pallas kernels.

Both consume the same binned inputs (JAX binning, eager).  The Pallas
kernels run in interpret mode, as the JAX suite runs them on the CPU; XLA may
contract their interpolations into FMAs (docs/DESIGN.md divergence #2), so:
coverage, strip planes, int16 values and const planes are compared exactly; winners may
flip at exact-z ties only (< 0.2% of pixels); z and the interp/zfrag planes
on agreeing pixels within rtol=1e-5, atol=1e-4; texel-index planes equal on
all but < 0.2% of agreeing pixels (an FMA can move a value across an integer
boundary).  The twin's own modes and layouts must agree with each other bit
for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_vertex_raster import _geom_from_triangles, _identity_uniforms, _random_scene
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.ops.binning import bin_triangles
from tiny_renderer_tpu.ops.raster_pallas import rasterize_pallas, rasterize_pallas_fused
from tiny_renderer_tpu.ops.vertex import triangle_setup
from tiny_renderer_tpu_torch.convert import to_tensor
from tiny_renderer_tpu_torch.ops import raster_cuda

CFG = RenderConfig(width=256, height=128)
MODES = {"z": dict(emit_z=True, emit_idx=False), "idx": dict(emit_z=False, emit_idx=True),
         "z+idx": dict(emit_z=True, emit_idx=True)}
SHADOW_SPEC = (("texidx", 1, "texidx:64:32"), ("intensity", 1, "interp"), ("zfrag", 1, "zfrag"))
SPECS = {
    "shadow": SHADOW_SPEC,
    "shadow-swizzled": (("texidx", 1, "texidx:64:32:16"),) + SHADOW_SPEC[1:],
    # Every plane mode: interp (uv), const (row0, du), zfrag.
    "const+interp": (("uv", 2, "interp"), ("row0", 3, "const"), ("du", 2, "const"),
                     ("zfrag", 1, "zfrag")),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _uv_scene(n, seed):
    """_random_scene with varied uv (some outside [0, 1], to reach the texel
    clamps) and normals, so every varying plane varies."""
    geom = _random_scene(n, seed)
    rng = np.random.default_rng(100 + seed)
    geom["tex_coords"] = rng.uniform(-0.1, 1.1, geom["tex_coords"].shape).astype(np.float32)
    nrm = rng.normal(size=geom["normals"].shape).astype(np.float32)
    geom["normals"] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    return geom


def _binned(geom, cfg=CFG, row_tile_offset=0, spec=(), needs=()):
    """Setup on the full frame (CFG), binned for `cfg` (a band of it when
    row_tile_offset is set; the gathered layout with csr_indirect=False)."""
    _, u = _identity_uniforms(CFG.width, CFG.height)
    s = triangle_setup(geom, u, CFG, needs=needs, xp=np)
    records, tris, starts, _ = bin_triangles(s, cfg, spec, row_tile_offset=row_tile_offset)
    return np.asarray(records), None if tris is None else np.asarray(tris), np.asarray(starts)


def _grid(cfg):
    return dict(tile_h=cfg.tile_h, tile_w=cfg.tile_w, tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x)


def _tensors(binned):
    return [None if a is None else to_tensor(a, "cpu") for a in binned]


def _twin(binned, cfg=CFG, **kw):
    return raster_cuda.rasterize(*_tensors(binned), **_grid(cfg), **kw)


def _np(t):
    return None if t is None else np.asarray(t)


def _pallas(binned, cfg=CFG, row_tile_offset=None, **kw):
    records, tris, starts = binned
    out = rasterize_pallas(records, starts, row_tile_offset, tris,
                           **_grid(cfg), interpret=True, **kw)
    return tuple(_np(t) for t in out)


def _assert_winners(tidx, pidx):
    np.testing.assert_array_equal(tidx >= 0, pidx >= 0)
    assert (tidx != pidx).mean() < 0.002


def _assert_parity(tz, tidx, pz, pidx):
    _assert_winners(tidx, pidx)
    covered = pidx >= 0
    np.testing.assert_allclose(tz[covered], pz[covered], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_matches_pallas_interpret(seed, mode):
    binned = _binned(_random_scene(200, seed))
    kw = MODES[mode]
    tz, tidx, _, _ = _twin(binned, **kw)
    pz, pidx, _, _ = _pallas(binned, **kw)
    assert (tz is None) == (pz is None) and (tidx is None) == (pidx is None)
    _, ref_idx, _, _ = _pallas(binned)  # z+idx, for the coverage mask
    if tz is not None:
        assert tz.dtype == torch.float32 and tz.shape == (CFG.padded_height, CFG.padded_width)
        tz = tz.numpy()
        np.testing.assert_array_equal(tz > -1e38, pz > -1e38)
        covered = ref_idx >= 0
        np.testing.assert_allclose(tz[covered], pz[covered], rtol=1e-5, atol=1e-4)
    if tidx is not None:
        assert tidx.dtype == torch.int32
        tidx = tidx.numpy()
        _assert_winners(tidx, pidx)
    # The twin's three modes resolve identically.
    fz, fidx, _, _ = _twin(binned)
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
    tz, tidx, _, _ = _twin(binned, band, row_tile_offset=2)
    pz, pidx, _, _ = _pallas(binned, band, row_tile_offset=np.full((1,), 2, np.int32))
    _assert_parity(tz.numpy(), tidx.numpy(), pz, pidx)
    fz, fidx, _, _ = _twin(_binned(geom))
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
    _, tidx, _, _ = _twin(_binned(_geom_from_triangles([tri] * 12)))
    idx = tidx.numpy()
    assert (idx >= 0).sum() > 100
    assert (idx[idx >= 0] == 0).all()


def test_twin_invariant_to_chunking(monkeypatch):
    """The chunked lexicographic resolve equals the one-slot-at-a-time walk
    bit for bit, varying planes included."""
    binned = _binned(_uv_scene(200, 7), spec=SHADOW_SPEC, needs=("vertex_intensity",))
    out = _twin(binned, spec=SHADOW_SPEC)
    monkeypatch.setattr(raster_cuda, "_REF_CHUNK_ELEMS", 1)
    out1 = _twin(binned, spec=SHADOW_SPEC)
    for a, b in zip(out[:3], out1[:3]):
        assert torch.equal(a, b)


def test_cpu_tensors_run_the_twin_without_launching():
    binned = _binned(_random_scene(50, 5))
    before = dict(raster_cuda.LAUNCHES)
    z, idx, _, _ = _twin(binned)
    rz, ridx, _, _ = raster_cuda.rasterize_reference(*_tensors(binned), **_grid(CFG))
    sz, sidx = raster_cuda.rasterize_fused(*_tensors(binned), *_tensors(binned), **_grid(CFG))
    assert raster_cuda.LAUNCHES == before
    assert torch.equal(z, rz) and torch.equal(idx, ridx)
    assert torch.equal(sz, z) and torch.equal(sidx, idx)


@pytest.mark.parametrize("seed", [0, 1])
def test_gathered_layout_matches_pallas(seed):
    """csr_indirect=False: records gathered into CSR order, no id list.  The
    twin resolves them like the indirect layout, bit for bit, and like the
    Pallas kernel's gathered walk."""
    geom = _uv_scene(200, seed)
    gcfg = dataclasses.replace(CFG, csr_indirect=False)
    gathered = _binned(geom, gcfg, spec=SHADOW_SPEC, needs=("vertex_intensity",))
    indirect = _binned(geom, spec=SHADOW_SPEC, needs=("vertex_intensity",))
    assert gathered[1] is None and gathered[0].shape[0] == indirect[1].shape[0]
    got = _twin(gathered, spec=SHADOW_SPEC, emit_strips=16)
    want = _twin(indirect, spec=SHADOW_SPEC, emit_strips=16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    pz, pidx, _, _ = _pallas(gathered)
    _assert_parity(got[0].numpy(), got[1].numpy(), pz, pidx)


@pytest.mark.parametrize("seed", [0, 1])
def test_int16_target_matches_pallas(seed):
    """The int16 index target holds the int32 resolve's values exactly."""
    binned = _binned(_random_scene(200, seed))
    _, idx16, _, strips16 = _twin(binned, emit_z=False, idx_dtype="int16", emit_strips=16)
    _, idx32, _, strips32 = _twin(binned, emit_z=False, emit_strips=16)
    assert idx16.dtype == torch.int16
    np.testing.assert_array_equal(idx16.numpy(), idx32.numpy())
    np.testing.assert_array_equal(strips16.numpy(), strips32.numpy())
    _, pidx, _, _ = _pallas(binned, emit_z=False, idx_dtype="int16")
    assert pidx.dtype == np.int16
    _assert_winners(idx16.numpy(), pidx)


@pytest.mark.parametrize("sl", [4, 16, 64])
def test_strip_plane_matches_pallas(sl):
    """emit_strips=SL: the (H, W/SL) max winning index of each strip — the
    max of the twin's own idx plane, and equal to the Pallas kernel's."""
    binned = _binned(_random_scene(200, 3))
    _, idx, _, strips = _twin(binned, emit_z=False, emit_strips=sl)
    assert strips.shape == (CFG.padded_height, CFG.padded_width // sl)
    want = idx.numpy().reshape(CFG.padded_height, -1, sl).max(-1)
    np.testing.assert_array_equal(strips.numpy(), want)
    _, pidx, _, pstrips = _pallas(binned, emit_z=False, emit_strips=sl)
    np.testing.assert_array_equal(strips.numpy(), pstrips)
    _assert_winners(idx.numpy(), pidx)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_varying_planes_match_pallas(name):
    """Phase 2: each plane mode at every pixel's winner, 0 where uncovered."""
    spec = SPECS[name]
    binned = _binned(_uv_scene(200, 2), spec=spec, needs=("vertex_intensity", "darboux"))
    _, tidx, tv, _ = _twin(binned, emit_z=False, spec=spec)
    _, pidx, pv, _ = _pallas(binned, emit_z=False, spec=spec)
    tidx, tv = tidx.numpy(), tv.numpy()
    planes = raster_cuda._plane_layout(spec)
    assert tv.shape == pv.shape == (len(planes), CFG.padded_height, CFG.padded_width)
    _assert_winners(tidx, pidx)
    agree = (tidx == pidx) & (tidx >= 0)
    assert agree.sum() > 1000
    assert (tv[:, tidx < 0] == 0).all()
    for mode, _lane, p, *_ in planes:
        a, b = tv[p][agree], pv[p][agree]
        if mode == "const":
            np.testing.assert_array_equal(a, b)
        elif mode == "texidx":
            assert (a == np.trunc(a)).all() and len(np.unique(a)) > 100
            assert (a != b).mean() < 0.002
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("indirect", [True, False])
def test_fused_matches_pallas(indirect):
    """K2's twin: the light pass's z and the camera pass's idx of one frame,
    equal bit for bit to the two single passes and within the tie budget of
    rasterize_pallas_fused."""
    cfg = dataclasses.replace(CFG, csr_indirect=indirect)
    light = _binned(_random_scene(200, 5), cfg)
    camera = _binned(_random_scene(150, 6), cfg)
    sz, idx = raster_cuda.rasterize_fused(*_tensors(light), *_tensors(camera), **_grid(cfg))
    assert torch.equal(sz, _twin(light, cfg, emit_idx=False)[0])
    assert torch.equal(idx, _twin(camera, cfg, emit_z=False)[1])
    pz, pidx = rasterize_pallas_fused(
        light[0], light[2], light[1], camera[0], camera[2], camera[1],
        **_grid(cfg), interpret=True,
    )
    pz, pidx = np.asarray(pz), np.asarray(pidx)
    np.testing.assert_array_equal(sz.numpy() > -1e38, pz > -1e38)
    lit = pz > -1e38
    np.testing.assert_allclose(sz.numpy()[lit], pz[lit], rtol=1e-5, atol=1e-4)
    _assert_winners(idx.numpy(), pidx)


def test_empty_tiles_clear():
    """Triangles all off screen: every pixel keeps the clear values."""
    binned = _binned(_geom_from_triangles([[[5, 5, 0], [6, 5, 0], [5, 6, 0]]]))
    z, idx, _, _ = _twin(binned)
    assert (idx == -1).all() and (z == np.float32(-3.4028235e38)).all()
