"""Torch port: the incidence-cap divergence of row bands, which the port
keeps for parity with the JAX package (ADVICE.md:4 calls it a fault of the
JAX side).

Each band's cap is the global cap's share of the band's tile rows, floored
at 4,096 (frame._banded_caps).  So bands can keep coverage the global cap
drops, and drop coverage it keeps.  Both directions, on seeded triangle
soups at 128x64 with tile_h=8, phong: the overflow flags as predicted, and
the port's frames equal JAX's banded render_frame(backend=
"pallas_interpret") under test_torch_row_bands.py's tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_frame import TEX, VIEW
from test_torch_row_bands import BASE, assert_matches_jax, jax_frame, port_frame
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.ops import mathlib as tml
from tiny_renderer_tpu_torch.ops.binning import bin_triangles
from tiny_renderer_tpu_torch.ops.vertex import triangle_setup


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _soup(n, seed):
    """A seeded triangle soup in the unit box (small triangles, ~1.3 tile
    rows each at 128x64 with 8-row tiles)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.9, 0.9, (n, 1, 3)).astype(np.float32)
    verts = (centers + rng.uniform(-0.08, 0.08, (n, 3, 3)).astype(np.float32)).reshape(-1, 3)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return {"positions": verts, "tex_coords": rng.uniform(0, 1, (3 * n, 2)).astype(np.float32),
            "normals": np.tile(np.float32([0, 0, 1]), (3 * n, 1)),
            "pos_idx": idx, "tex_idx": idx, "normal_idx": idx}


SOUP = _soup(3000, 3)


def _strip(n, seed):
    """n camera-facing triangles along one horizontal line (y = 0.06):
    most of their incidences fall in one tile row."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-0.9, 0.9, n), np.full(n, 0.06), rng.uniform(-0.3, 0.3, n)], -1)
    v = (c[:, None] + rng.uniform(-0.05, 0.05, (n, 3, 3))).astype(np.float32)
    area = ((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
            - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1]))
    v[area < 0] = v[area < 0][:, [0, 2, 1]]  # counter-clockwise: not back-face culled
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return {"positions": v.reshape(-1, 3), "tex_coords": rng.uniform(0, 1, (3 * n, 2)).astype(np.float32),
            "normals": np.tile(np.float32([0, 0, 1]), (3 * n, 1)),
            "pos_idx": idx, "tex_idx": idx, "normal_idx": idx}


def _incidences(geom, cfg):
    """(incidences per tile row under no cap, T) of phong's camera pass."""
    g, _ = scene_arrays(geom, TEX, "cpu")
    view = [to_tensor(v, "cpu") for v in VIEW]
    setup = triangle_setup(g, tml.default_prepare(cfg, *view), cfg, needs=("vertex_intensity",))
    _, _, starts, _ = bin_triangles(setup, dataclasses.replace(cfg, max_incidences=None))
    return torch.diff(starts).reshape(cfg.tiles_y, cfg.tiles_x).sum(1), setup["a1"].shape[0]


def test_overflow_divergence_matches_jax():
    """A global cap of 1,024 below the soup's ~2,000 incidences overflows
    (the span clamp T * max_span_y * max_span_x does not bind); two bands
    get caps floored at 4,096 and do not.  Both packages agree in both."""
    capped = RenderConfig(**BASE, max_incidences=1024).resolve("phong")
    rows, T = _incidences(SOUP, config_from(capped))
    n_inc = int(rows.sum())
    assert 1500 < n_inc < 4096 and T * capped.max_span_y * capped.max_span_x > 1024
    for row_bands, overflowed in ((0, True), (2, False)):
        cfg = dataclasses.replace(capped, row_bands=row_bands)
        got, want = port_frame("phong", cfg, geom=SOUP), jax_frame("phong", cfg, geom=SOUP)
        assert bool(got["overflow"]) is overflowed
        assert_matches_jax(got, want)
    # The cap dropped coverage one band kept.
    one, two = (port_frame("phong", dataclasses.replace(capped, row_bands=r), geom=SOUP)
                for r in (0, 2))
    assert (one["z"] > tml.F32_MIN).sum() < (two["z"] > tml.F32_MIN).sum()


def test_band_cap_drops_what_the_global_cap_keeps():
    """6,500 triangles along one line: the global cap (26,000) holds the
    ~6,000 incidences, the band cap of row_bands=8 (max(4096, 26000/8)) does
    not hold the ~4,700 of the fullest tile row.  Both packages overflow
    only under the bands, and agree on the frame that loses the dropped
    triangles."""
    geom = _strip(6500, 1)
    cfg = RenderConfig(**BASE).resolve("phong")
    rows, T = _incidences(geom, config_from(cfg))
    assert int(rows.max()) > 4096 and int(rows.sum()) < 4 * T
    got = {}
    for row_bands, overflowed in ((0, False), (8, True)):
        c = RenderConfig(**BASE, row_bands=row_bands)
        got[row_bands] = port_frame("phong", c, geom=geom)
        assert bool(got[row_bands]["overflow"]) is overflowed
        assert_matches_jax(got[row_bands], jax_frame("phong", c, geom=geom))
    # The band dropped the tail of its list: pixels those triangles won change.
    assert not np.array_equal(got[8]["z"], got[0]["z"])
