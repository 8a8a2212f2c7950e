"""Torch port: bit-identity of the raster knobs on the shadow pipeline.

The port's copy of tests/test_knob_matrix.py on a procedural scene: every
combination renders exactly the port's default frame (the raster resolve is
lexicographic and the shading expressions are shared, so a knob that
changes a pixel is a bug), and each stays within the repo's 0.5% tie-flip
budget of the JAX frame rendered with the same knobs
(backend="pallas_interpret", whose compiled shade may contract FMAs).
Rendered with needs_z=False so fuse_passes engages where its gate allows.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_frame import GEOM, TEX, VIEW
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.ops import raster_cuda
from tiny_renderer_tpu_torch.pipelines import frame as tframe

BASE = RenderConfig(width=64, height=64, strip_batch=32, tile_h=8)

# The JAX matrix's combos and slow set, plus the u8 writeback.
_SLOW = {"fuse+planes", "i16+planes", "sl32", "sl4", "t16", "swz16",
         "swz16+planes", "swz8+fullplane", "sswz16+swz16",
         "mask+planes", "i16", "sswz16"}
COMBOS = [
    ("fuse", dict(fuse_passes=True)),
    ("mask+planes", dict(strip_mask=True, strip_planes=True)),
    ("i16", dict(idx_int16=True, tile_h=16)),
    ("nocsr+mask", dict(csr_indirect=False, strip_mask=True)),
    ("fuse+planes", dict(fuse_passes=True, strip_planes=True)),
    ("i16+planes", dict(idx_int16=True, strip_planes=True, tile_h=16)),
    ("fullplane", dict(compact_shade=False)),
    ("sl32", dict(strip_len=32)),
    ("sl4", dict(strip_len=4)),
    ("t16", dict(tile_h=16)),
    ("swz16", dict(tex_tile=16)),
    ("swz16+planes", dict(tex_tile=16, strip_planes=True)),
    ("swz8+fullplane", dict(tex_tile=8, compact_shade=False)),
    ("sswz16", dict(shadow_tile=16)),
    ("sswz8+fuse", dict(shadow_tile=8, fuse_passes=True)),
    ("sswz16+swz16", dict(shadow_tile=16, tex_tile=16)),
    ("all-on", dict(fuse_passes=True, strip_mask=True, strip_planes=True,
                    idx_int16=True, csr_indirect=False, tile_h=16,
                    tex_tile=16, shadow_tile=16)),
    ("nopack", dict(strip_pack_words=False)),
]
COMBOS = [
    pytest.param(n, k, id=n, marks=pytest.mark.slow if n in _SLOW else ())
    for n, k in COMBOS
]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port(cfg, needs_z=False):
    g, t = scene_arrays(GEOM, TEX, "cpu")
    out = tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in VIEW), pipeline="shadow",
                              config=config_from(cfg), needs_z=needs_z)
    return {k: (None if v is None else v.numpy()) for k, v in out.items()}


@pytest.fixture(scope="module")
def baseline():
    return _port(BASE)


@pytest.mark.parametrize("name,knobs", COMBOS)
def test_knob_combo_bit_identical(baseline, name, knobs):
    out = _port(dataclasses.replace(BASE, **knobs))
    np.testing.assert_array_equal(out["frame"], baseline["frame"])
    np.testing.assert_array_equal(out["shadow"], baseline["shadow"])
    assert bool(out["overflow"]) == bool(baseline["overflow"])
    assert (out["frame"] > 0).any(-1).mean() > 0.05


@pytest.mark.parametrize("name,knobs", COMBOS)
def test_knob_combo_matches_jax(name, knobs):
    cfg = dataclasses.replace(BASE, **knobs)
    want = jframe.render_frame(
        {k: jnp.asarray(v) for k, v in GEOM.items()}, {k: jnp.asarray(v) for k, v in TEX.items()},
        *(jnp.asarray(v) for v in VIEW), pipeline="shadow", config=cfg,
        backend="pallas_interpret", needs_z=False,
    )
    got = _port(cfg)
    assert (got["frame"] != np.asarray(want["frame"])).any(-1).mean() < 0.005
    np.testing.assert_array_equal(got["shadow"] > -1e38, np.asarray(want["shadow"]) > -1e38)


def test_full_screen_shade_renders_like_default_with_z():
    """compact_shade=False with z emitted (Scene.render's posture): frame,
    z and shadow equal the default render's."""
    want = _port(BASE, needs_z=True)
    got = _port(dataclasses.replace(BASE, compact_shade=False), needs_z=True)
    for k in ("frame", "z", "shadow"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("knobs,needs_z", [
    (dict(fuse_passes=True), False), (dict(fuse_passes=True), True),
    (dict(fuse_passes=True, strip_planes=True), False),
    (dict(fuse_passes=True, idx_int16=True, tile_h=16), False),
    (dict(fuse_passes=True, compact_shade=False), False),
])
def test_fused_gate_matches_jax(monkeypatch, knobs, needs_z):
    """The port fuses the two rasters exactly where the JAX gate does."""
    cfg = dataclasses.replace(BASE, **knobs).resolve("shadow")
    calls = []
    fused = raster_cuda.rasterize_fused
    monkeypatch.setattr(raster_cuda, "rasterize_fused", lambda *a, **k: calls.append(1) or fused(*a, **k))
    _port(cfg, needs_z=needs_z)
    pspec = jframe._planes_spec("shadow", TEX, cfg, "pallas_interpret") if cfg.compact_shade else None
    setup = {"a1": np.zeros(GEOM["pos_idx"].shape[0])}
    want = jframe._use_fused_raster(jframe.PIPELINES["shadow"], cfg, "pallas_interpret",
                                    setup, pspec, needs_z)
    assert bool(calls) == bool(want)
