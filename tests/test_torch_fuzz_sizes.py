"""Torch port: random scenes at random sizes, tile-unaligned included,
against the JAX package (test_fuzz_configs.test_fuzz_size_and_scene's
draws, and one more pipeline at another unaligned size).

The port's frame must not overflow, must stay within the flip budget of
JAX's pallas_interpret frame and within the oracle budget
(test_torch_fuzz.py).
"""

import numpy as np
import pytest
import torch

from test_fuzz_configs import CASES, _random_scene
from test_torch_fuzz import held_to_jax_and_oracle
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.models.procedural import make_textures


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("width,height,tile_h,pipeline,seed", CASES + [(77, 45, 8, "occlusion", 3)])
def test_fuzz_size_and_scene(width, height, tile_h, pipeline, seed):
    rng = np.random.default_rng(100 + seed)
    geom = _random_scene(120, seed)
    light = np.array([np.sin(rng.uniform(-1, 1)), 0, np.cos(rng.uniform(-1, 1))], np.float32)
    look_from = np.array([np.sin(rng.uniform(-1, 1)), 0, np.cos(rng.uniform(-1, 1))], np.float32)
    view = (light, look_from, np.zeros(3, np.float32), np.array([0, 1, 0], np.float32))
    cfg = RenderConfig(width=width, height=height, tile_h=tile_h, tri_block=32)
    assert not held_to_jax_and_oracle(geom, make_textures(64), view, pipeline, cfg), \
        "unexpected binning overflow"
