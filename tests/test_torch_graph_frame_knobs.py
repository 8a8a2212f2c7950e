"""Torch port: the static-shape strip shade under its knobs, against JAX.

Every built-in pipeline's _shade_strips under strip_len, strip_batch,
strip_mask + strip_planes and strip_pack_words, held to JAX's _shade_strips
on the same inputs (test_torch_graph_frame.shade_both; fewer than 0.5% of
pixels apart, JAX's compiled loop may contract FMAs) and to the port's own
frame at the default strip layout (bit for bit: a knob that changes a pixel
is a bug); and the shade of a scene that covers no strip and of one that
covers every strip.  64x64, tile_h=8.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_graph_frame import CFG, PIPELINES, shade_both

KNOBS = {
    "sl32": dict(strip_len=32, strip_batch=8),
    "sl8": dict(strip_len=8, strip_batch=16),
    "mask+planes": dict(strip_mask=True, strip_planes=True),
    "nopack": dict(strip_pack_words=False),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def grid_scene(offset=(0.0, 0.0, 0.0), n=12, half=1.5):
    """A flat n x n grid of quads in the z=0 plane, [-half, half]^2, facing
    +z (the camera), shifted by `offset`; uv follows x and y."""
    xs = np.linspace(-half, half, n + 1, dtype=np.float32)
    px, py = np.meshgrid(xs, xs)
    pos = np.stack([px.ravel(), py.ravel(), np.zeros(px.size, np.float32)], -1) + np.float32(offset)
    uv = np.stack([(px.ravel() + half) / (2 * half), (py.ravel() + half) / (2 * half)], -1)
    v = np.arange((n + 1) ** 2, dtype=np.int32).reshape(n + 1, n + 1)
    a, b, c, d = v[:-1, :-1].ravel(), v[:-1, 1:].ravel(), v[1:, :-1].ravel(), v[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, d], -1), np.stack([a, d, c], -1)]).astype(np.int32)
    return {"positions": pos.astype(np.float32), "tex_coords": uv.astype(np.float32),
            "normals": np.tile(np.float32([0, 0, 1]), (pos.shape[0], 1)),
            "pos_idx": tris, "tex_idx": tris, "normal_idx": tris}


@pytest.fixture(scope="module")
def default_frames():
    return {p: shade_both(p, CFG)[0] for p in PIPELINES}


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("pipeline", PIPELINES)
def test_shade_knobs_match_jax_and_default(default_frames, pipeline, knob):
    got, want, covered = shade_both(pipeline, dataclasses.replace(CFG, **KNOBS[knob]))
    np.testing.assert_array_equal(got, default_frames[pipeline])
    assert (got != want).any(-1).mean() < 0.005


@pytest.mark.parametrize("coverage", ["none", "all"])
@pytest.mark.parametrize("pipeline", ["shadow", "phong", "occlusion"])
def test_scene_covering_no_strip_or_every_strip(pipeline, coverage):
    geom = grid_scene((8.0, 0.0, 0.0) if coverage == "none" else (0.0, 0.0, 0.0))
    got, want, covered = shade_both(pipeline, CFG, geom=geom)
    if coverage == "all":
        assert covered.all() and (got > 0).any(-1).mean() > 0.5
    else:
        assert not covered.any() and not got.any() and not want.any()
    assert (got != want).any(-1).mean() < 0.005
