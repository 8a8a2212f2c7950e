"""Torch port: explicit row bands (RenderConfig.row_bands = N) against the JAX package.

With row_bands > 1 the kernel raster bins and launches in disjoint tile-row
bands, each with its share of the incidence cap (frame._band_plan, as the
JAX package's).  The scene is test_torch_frame's (two spheres) at 128x64
with tile_h=8 (8 tile rows).  Held here:
* _band_plan and _banded_caps equal JAX's over a table of triangle counts,
  tile rows and band counts;
* every banded frame, z, shadow map and overflow flag equals the port's
  one-band render bit for bit (shadow, phong, darboux's full-screen shade,
  occlusion and the attr: pipeline "heat");
* heat banded equals JAX's banded
  render_frame(backend="pallas_interpret"): coverage exactly, shadow depths
  to f32 rounding, fewer than 0.5% of pixels apart (test_torch_frame's
  tolerance, the oracle tie-flip budget); shadow, phong, occlusion and
  darboux's full-screen shade each in a file of its own (test_torch_row_bands_*.py:
  JAX lowers its interpret kernels once per band shape, seconds each), and
  the cap divergence both packages share in test_torch_row_bands_caps.py;
* K2 never runs under bands, in render_frame or on the row shards, and the
  fused gate equals JAX's;
* --knob row_bands=N on the CLI, and the stage profile's binning prefix
  bins the bands.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_frame import GEOM, TEX, VIEW, _tiny_assets
from test_torch_register_pipeline import CUSTOM, HEAT_GEOM
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu_torch import Model, Scene, load_model
from tiny_renderer_tpu_torch import app as tapp
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.ops import mathlib as tml
from tiny_renderer_tpu_torch.ops import raster_cuda
from tiny_renderer_tpu_torch.parallel import make_row_mesh, render_frame_sharded
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines import profile as tprofile
from tiny_renderer_tpu_torch.utils.png import png_bytes

BASE = dict(width=128, height=64, tile_h=8)
BANDS = (2, 3, 8, 100)
PIPELINES = {"shadow": {}, "phong": {}, "darboux": dict(compact_shade=False), "occlusion": {},
             "heat": {}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def heat_pipeline():
    """The attr: pipeline "heat" registered in both packages for this module."""
    jshade, tshade, kw = CUSTOM["heat"]
    jframe.register_pipeline("heat", jshade, overwrite=True, **kw)
    tframe.register_pipeline("heat", tshade, overwrite=True, **kw)
    yield
    jframe.unregister_pipeline("heat")
    tframe.unregister_pipeline("heat")


def cfg_of(pipeline, row_bands, **extra):
    return RenderConfig(**BASE, **PIPELINES[pipeline], row_bands=row_bands, **extra)


def geom_of(pipeline):
    return HEAT_GEOM if pipeline == "heat" else GEOM


def port_frame(pipeline, cfg, geom=None, needs_z=True):
    g, t = scene_arrays(geom_of(pipeline) if geom is None else geom, TEX, "cpu")
    out = tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in VIEW), pipeline=pipeline,
                              config=config_from(cfg), needs_z=needs_z)
    return {k: (None if v is None else v.numpy()) for k, v in out.items()}


def jax_frame(pipeline, cfg, geom=None):
    geom = geom_of(pipeline) if geom is None else geom
    out = jframe.render_frame(
        {k: jnp.asarray(v) for k, v in geom.items()}, {k: jnp.asarray(v) for k, v in TEX.items()},
        *(jnp.asarray(v) for v in VIEW), pipeline=pipeline, config=cfg, backend="pallas_interpret",
    )
    return {k: np.asarray(v) for k, v in out.items()}


def assert_matches_jax(got, want):
    """test_torch_frame's tolerance: raster coverage exactly, shadow depths
    to f32 rounding, fewer than 0.5% of pixels apart, the same overflow."""
    np.testing.assert_array_equal(got["z"] > tml.F32_MIN, want["z"] > tml.F32_MIN)
    lit = want["shadow"] > tml.F32_MIN
    np.testing.assert_array_equal(got["shadow"] > tml.F32_MIN, lit)
    np.testing.assert_allclose(got["shadow"][lit], want["shadow"][lit], rtol=1e-5, atol=1e-4)
    assert (got["frame"] != want["frame"]).any(-1).mean() < 0.005
    assert bool(got["overflow"]) == bool(want["overflow"])


# -- the plan --------------------------------------------------------------


def _setups(T):
    return {"a1": np.zeros(T, np.int32)}, {"a1": torch.zeros(T, dtype=torch.int32)}


def _plan_rows(plan):
    return [(t0, bt, c.height, c.max_incidences) for t0, bt, c in plan]


@pytest.mark.parametrize("T", [10, 548, 5096, 81536])
@pytest.mark.parametrize("height,tile_h", [(64, 8), (800, 32), (100, 16)])
@pytest.mark.parametrize("row_bands", [1, 2, 3, 4, 7, 25, 100])
def test_band_plan_matches_jax(T, height, tile_h, row_bands):
    """(row_tile_offset, band tile rows, band height, band cap) of every
    band, including row_bands > tiles_y and uneven last bands; the 800-row
    table is the capacity phase's (25 tile rows)."""
    jcfg = RenderConfig(width=128, height=height, tile_h=tile_h, row_bands=row_bands)
    jset, tset = _setups(T)
    want = _plan_rows(jframe._band_plan(jset, jcfg))
    got = _plan_rows(tframe._band_plan(tset, config_from(jcfg)))
    assert got == want
    assert sum(bt for _, bt, _, _ in got) == jcfg.tiles_y


@pytest.mark.parametrize("T", [10, 548, 5096])
def test_band_plan_one_band_for_auto(T):
    """row_bands=0 is one band (the TPU budget plan is not ported); for
    reference-class scenes JAX's plan says one band too."""
    jcfg = RenderConfig(**BASE)
    jset, tset = _setups(T)
    want = _plan_rows(jframe._band_plan(jset, jcfg))
    got = _plan_rows(tframe._band_plan(tset, config_from(jcfg)))
    assert got == want == [(0, jcfg.tiles_y, jcfg.height, None)]


def test_banded_caps_match_jax():
    for cap in (8, 1024, 4096, 20384, 326144):
        for ty in (1, 2, 8, 25):
            for bt in range(1, ty + 1):
                assert tframe._banded_caps(cap, ty, bt) == jframe._banded_caps(cap, ty, bt)


# -- banded frames ----------------------------------------------------------


@pytest.fixture(scope="module")
def one_band():
    return {p: port_frame(p, cfg_of(p, 0)) for p in PIPELINES}


@pytest.mark.parametrize("row_bands", BANDS)
@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_banded_frame_equals_one_band(one_band, pipeline, row_bands):
    got, want = port_frame(pipeline, cfg_of(pipeline, row_bands)), one_band[pipeline]
    assert (want["frame"] > 0).any(-1).mean() > 0.02
    for k in ("frame", "z", "shadow", "overflow"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("row_bands", BANDS)
@pytest.mark.parametrize("pipeline", ["heat"])
def test_banded_frame_matches_jax(pipeline, row_bands):
    cfg = cfg_of(pipeline, row_bands)
    assert_matches_jax(port_frame(pipeline, cfg), jax_frame(pipeline, cfg))


@pytest.mark.parametrize("needs_z", [True, False])
def test_banded_launches(needs_z):
    """One K1 launch per band and pass (8 bands of one tile row), each at its
    band's tile-row offset; needs_z=False keeps the camera pass index-only."""
    g, t = scene_arrays(GEOM, TEX, "cpu")
    cfg = config_from(cfg_of("shadow", 8))
    calls = []
    real = raster_cuda.rasterize

    def spy(*args, **kw):
        calls.append((kw["row_tile_offset"], kw["tiles_y"], kw["emit_z"], kw["emit_idx"]))
        return real(*args, **kw)

    with mock.patch.object(raster_cuda, "rasterize", spy):
        tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in VIEW), pipeline="shadow",
                            config=cfg, needs_z=needs_z)
    light = [(o, 1, True, False) for o in range(8)]
    camera = [(o, 1, needs_z, True) for o in range(8)]
    assert calls == light + camera


# -- K2 and the bands -------------------------------------------------------


@pytest.mark.parametrize("row_bands,fused", [(0, True), (1, True), (2, False), (100, False)])
def test_fused_kernel_only_in_one_band(row_bands, fused):
    g, t = scene_arrays(GEOM, TEX, "cpu")
    cfg = config_from(cfg_of("shadow", row_bands, fuse_passes=True))
    with mock.patch.object(raster_cuda, "rasterize_fused", wraps=raster_cuda.rasterize_fused) as k2, \
            mock.patch.object(raster_cuda, "rasterize", wraps=raster_cuda.rasterize) as k1:
        out = tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in VIEW), pipeline="shadow",
                                  config=cfg, needs_z=False)
    n_bands = len(tframe._band_plan({"a1": torch.zeros(1)}, cfg))
    assert (k2.call_count, k1.call_count) == ((1, 0) if fused else (0, 2 * n_bands))
    want = port_frame("shadow", cfg_of("shadow", 0), needs_z=False)
    np.testing.assert_array_equal(out["frame"].numpy(), want["frame"])


@pytest.mark.parametrize("knobs", [
    dict(fuse_passes=True), dict(fuse_passes=True, row_bands=1), dict(fuse_passes=True, row_bands=2),
    dict(fuse_passes=True, row_bands=100), dict(fuse_passes=True, compact_shade=False),
    dict(fuse_passes=True, idx_int16=True, tile_h=16), dict(fuse_passes=True, row_bands=3, tile_h=16),
    dict(row_bands=2)])
@pytest.mark.parametrize("needs_z", [True, False])
def test_fused_gate_matches_jax(knobs, needs_z):
    jcfg = RenderConfig(**{**BASE, **knobs})
    jset, tset = _setups(548)
    want = jframe._use_fused_raster(jframe.PIPELINES["shadow"], jcfg, "pallas", jset, None, needs_z)
    got = tframe._use_fused_raster(tframe.PIPELINES["shadow"], config_from(jcfg), "kernel", tset,
                                   None, needs_z)
    assert got == want


@pytest.mark.parametrize("knobs", [dict(fuse_passes=True), dict(replicate_pass1=True), {}])
def test_row_shards_take_no_bands(knobs):
    """On 8 row shards with row_bands=2 each shard bins its window in one
    launch per pass, and K2 stays off under fuse_passes (JAX's sharded gate
    reads the frame's row_bands); the frame equals the banded single-device
    frame bit for bit."""
    g, t = scene_arrays(GEOM, TEX, "cpu")
    cfg = config_from(RenderConfig(width=64, height=64, tile_h=8, row_bands=2, **knobs))
    view = [to_tensor(v, "cpu") for v in VIEW]
    with mock.patch.object(raster_cuda, "rasterize_fused", wraps=raster_cuda.rasterize_fused) as k2, \
            mock.patch.object(raster_cuda, "rasterize", wraps=raster_cuda.rasterize) as k1:
        got = render_frame_sharded(g, t, *view, pipeline="shadow", config=cfg,
                                   mesh=make_row_mesh([torch.device("cpu")] * 8), needs_z=False)
    assert k2.call_count == 0 and k1.call_count == 16
    tiles = {1, 8} if knobs.get("replicate_pass1") else {1}  # the full-height light pass: 8
    assert {c.kwargs["tiles_y"] for c in k1.call_args_list} == tiles
    want = tframe.render_frame(g, t, *view, pipeline="shadow", config=cfg, needs_z=False)
    for k in ("frame", "shadow", "overflow"):
        assert torch.equal(got[k], want[k]), k


# -- the entry points -------------------------------------------------------


def test_cli_knob_row_bands(tmp_path):
    assets = _tiny_assets(tmp_path)
    pngs = {}
    for name, extra in (("one", []), ("bands", ["--knob", "row_bands=2"])):
        pngs[name] = tmp_path / f"{name}.png"
        assert tapp.main(["-p", str(assets), "-s", "shadow", "--size", "128", "64", "--frames", "1",
                          "--backend", "cpu", "--no-fps", "--save", str(pngs[name]), *extra]) == 0
    assert pngs["bands"].read_bytes() == pngs["one"].read_bytes()
    scene = Scene(load_model(str(assets), verbose=False), "shadow",
                  RenderConfig(width=128, height=64, row_bands=2), device="cpu")
    look_from, look_at, up, light = tapp._angles_to_vectors(0.0, 0.0)
    scene.set_camera(look_from, look_at, up)
    scene.set_light_direction(light)
    scene.render()
    assert pngs["bands"].read_bytes() == png_bytes(scene.get_frame_buffer())


def test_profile_bins_the_bands():
    """The binning prefix bins what the raster bins: R bands per pass."""
    model = Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))
    scene = Scene(model, "shadow", RenderConfig(**BASE, row_bands=3), device="cpu")
    with mock.patch.object(tprofile, "bin_triangles", wraps=tprofile.bin_triangles) as spy:
        fn = tprofile._prefix_fn("shadow", scene.config, "bin")
        view = [to_tensor(v, "cpu") for v in VIEW]
        fn(scene._geom, scene._textures, *view)
    offsets = [c.kwargs["row_tile_offset"] for c in spy.call_args_list]
    assert offsets == [0, 3, 6] * 2
    deltas, cumulative = tprofile.stage_breakdown(scene, iters=2)
    assert list(cumulative) == list(tprofile.STAGES)
