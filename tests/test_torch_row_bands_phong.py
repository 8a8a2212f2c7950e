"""Torch port: banded frames of the one-pass phong pipeline (the camera pass
index-only and with z, the strip shade) against the JAX package's banded
render_frame(backend="pallas_interpret"), at 128x64 with tile_h=8 and
row_bands 2, 3, 8 and 100, under test_torch_row_bands.py's tolerance
(raster coverage exactly, shadow depths to f32 rounding, fewer than 0.5% of
pixels apart, the same overflow).  The port's banded frames equal its
one-band frames bit for bit (test_torch_row_bands.py)."""

import pytest
import torch

from test_torch_row_bands import BANDS, assert_matches_jax, cfg_of, jax_frame, port_frame


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("row_bands", BANDS)
@pytest.mark.parametrize("pipeline", ["phong"])
def test_banded_frame_matches_jax(pipeline, row_bands):
    cfg = cfg_of(pipeline, row_bands)
    assert_matches_jax(port_frame(pipeline, cfg), jax_frame(pipeline, cfg))

