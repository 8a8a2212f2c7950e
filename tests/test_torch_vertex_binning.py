"""Torch port: vertex stage + CSR binning against the JAX package.

The JAX functions run eagerly (vertex with xp=numpy, binning op by op), so
there is no mul+add contraction on either side: integer edge coefficients,
validity, bboxes, flags, the CSR arrays and the records must be exactly
equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_vertex_raster import _geom_from_triangles, _random_scene
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.models.procedural import make_uv_sphere, to_geom
from tiny_renderer_tpu.ops import binning as jbin
from tiny_renderer_tpu.ops import mathlib as jml
from tiny_renderer_tpu.ops import vertex as jvx
from tiny_renderer_tpu.pipelines.shaders import VARYING_SPECS
from tiny_renderer_tpu_torch.convert import config_from, to_tensor
from tiny_renderer_tpu_torch.ops import binning as tbin
from tiny_renderer_tpu_torch.ops import mathlib as tml
from tiny_renderer_tpu_torch.ops import vertex as tvx

LIGHT = np.array([0.3, 0.2, 0.95], np.float32)
LOOK_FROM = np.array([0.2, 0.1, 0.98], np.float32)
LOOK_AT = np.zeros(3, np.float32)
UP = np.array([0.0, 1.0, 0.0], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _uniforms(cfg, shadow):
    """(JAX numpy uniforms, port uniforms) for the camera or light pass."""
    tcfg = config_from(cfg)
    t = {k: to_tensor(v, "cpu") for k, v in
         dict(light=LIGHT, look_from=LOOK_FROM, look_at=LOOK_AT, up=UP).items()}
    if shadow:
        return (jml.shadow_pass_1_prepare(cfg, LIGHT, LOOK_AT, UP, np),
                tml.shadow_pass_1_prepare(tcfg, t["light"], t["look_at"], t["up"]))
    return (jml.shadow_pass_2_prepare(cfg, LIGHT, LOOK_FROM, LOOK_AT, UP, np),
            tml.shadow_pass_2_prepare(tcfg, t["light"], t["look_from"], t["look_at"], t["up"]))


def _setups(geom, cfg, shadow=False, needs=("vertex_intensity",)):
    ju, tu = _uniforms(cfg, shadow)
    kw = dict(matrix_key="shadow_matrix", cull=False) if shadow else {}
    js = jvx.triangle_setup(geom, ju, cfg, needs=needs, xp=np, **kw)
    tgeom = {k: to_tensor(v, "cpu") for k, v in geom.items()}
    ts = tvx.triangle_setup(tgeom, tu, config_from(cfg), needs=needs, **kw)
    return js, ts


def _scenes():
    sphere = to_geom(make_uv_sphere(0.45, 12, 16))
    return {"soup0": _random_scene(200, 0), "soup1": _random_scene(150, 1, spread=0.5),
            "sphere": sphere}


SCENES = _scenes()
CFG = RenderConfig(width=256, height=128)


def _assert_setup_equal(js, ts):
    assert set(js) == set(ts)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
        if k not in ("coord_overflow", "valid"):
            assert str(ts[k].dtype) == f"torch.{np.asarray(js[k]).dtype.name}", k


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_triangle_setup_matches(name, shadow):
    js, ts = _setups(SCENES[name], CFG, shadow=shadow)
    _assert_setup_equal(js, ts)
    assert ts["valid"].any()


@pytest.mark.parametrize("needs", [("face_intensity",), ("darboux",)])
def test_triangle_setup_other_needs_match(needs):
    js, ts = _setups(SCENES["sphere"], CFG, needs=needs)
    _assert_setup_equal(js, ts)


def test_expand_geometry_matches_gather():
    geom = {k: to_tensor(v, "cpu") for k, v in SCENES["sphere"].items()}
    ex = tvx.expand_geometry(geom)
    np.testing.assert_array_equal(ex["pos_tri"].numpy(), SCENES["sphere"]["positions"][SCENES["sphere"]["pos_idx"]])
    ju, tu = _uniforms(CFG, False)
    a = tvx.triangle_setup(geom, tu, config_from(CFG), needs=("vertex_intensity",))
    b = tvx.triangle_setup(ex, tu, config_from(CFG), needs=("vertex_intensity",))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_coord_overflow_flagged():
    """A vertex near the camera's w=0 plane projects beyond the exact int32
    envelope: both packages drop the triangle and raise coord_overflow."""
    geom = _geom_from_triangles([
        [[0.1, 0.0, 5.9999], [0.01, 0.0, 0.0], [0.0, 0.01, 0.0]],
        [[-0.2, -0.2, 0.0], [0.2, -0.2, 0.0], [-0.2, 0.2, 0.0]],
    ])
    cfg = RenderConfig(width=256, height=128)
    ju = jml.default_prepare(cfg, LIGHT, np.array([0, 0, 1], np.float32), LOOK_AT, UP, np)
    tu = tml.default_prepare(config_from(cfg), *(to_tensor(v, "cpu") for v in
                             (LIGHT, np.array([0, 0, 1], np.float32), LOOK_AT, UP)))
    js = jvx.triangle_setup(geom, ju, cfg, cull=False, xp=np)
    ts = tvx.triangle_setup({k: to_tensor(v, "cpu") for k, v in geom.items()}, tu,
                            config_from(cfg), cull=False)
    _assert_setup_equal(js, ts)
    assert bool(ts["coord_overflow"]) and not bool(ts["valid"][0])


def _assert_binning_equal(js, ts, cfg):
    jr, jt, jstarts, jovf = jbin.bin_triangles(js, cfg)
    tr, tt, tstarts, tovf = tbin.bin_triangles(ts, config_from(cfg))
    assert jt is not None  # indirect layout on the JAX side too
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tstarts.numpy(), np.asarray(jstarts))
    assert bool(tovf) == bool(jovf)
    assert tt.dtype == torch.int32 and tstarts.dtype == torch.int32
    return bool(tovf)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_bin_triangles_matches(name, shadow, compact):
    cfg = dataclasses.replace(CFG, binning_compact=compact).resolve("shadow")
    js, ts = _setups(SCENES[name], cfg, shadow=shadow)
    _assert_binning_equal(js, ts, cfg)


@pytest.mark.parametrize("compact", [False, True])
def test_incidence_overflow_flagged(compact):
    cfg = dataclasses.replace(CFG, max_incidences=64, binning_compact=compact)
    js, ts = _setups(SCENES["soup0"], cfg)
    assert _assert_binning_equal(js, ts, cfg)


def test_span_clamp_flagged():
    """A triangle wider than max_span_x tiles loses coverage and is flagged."""
    cfg = dataclasses.replace(CFG, max_span_y=1, max_span_x=1)
    js, ts = _setups(SCENES["sphere"], cfg)
    assert _assert_binning_equal(js, ts, cfg)


def test_row_band_window_matches():
    """Binning a band of tile rows (row_tile_offset) matches JAX."""
    js, ts = _setups(SCENES["soup0"], CFG)
    band = dataclasses.replace(CFG, height=2 * CFG.tile_h)
    jr, jt, jstarts, jovf = jbin.bin_triangles(js, band, row_tile_offset=2)
    tr, tt, tstarts, tovf = tbin.bin_triangles(ts, config_from(band), row_tile_offset=2)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tstarts.numpy(), np.asarray(jstarts))
    assert bool(tovf) == bool(jovf)


def test_pack_records_with_varying_lanes_match():
    js, ts = _setups(SCENES["sphere"], CFG)
    spec = VARYING_SPECS["shadow"]
    np.testing.assert_array_equal(
        tbin.pack_triangle_records(ts, spec).numpy(),
        np.asarray(jbin.pack_triangle_records(js, spec, np)),
    )
    assert tbin.record_lanes(spec) == jbin.record_lanes(spec)


def test_compact_scatter_matches():
    rng = np.random.default_rng(3)
    mask = rng.random(300) < 0.3
    vals = np.arange(300, dtype=np.int32)
    for out_len in (50, 120, 300):
        want = np.asarray(jbin.compact_scatter(mask, vals, out_len, -7))
        got = tbin.compact_scatter(torch.from_numpy(mask), torch.from_numpy(vals), out_len, -7)
        np.testing.assert_array_equal(got.numpy(), want)
