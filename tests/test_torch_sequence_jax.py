"""Torch port: Scene.render_sequence, the call the benchmark's burst cells
time, against the JAX package's Scene.render_sequence.

Every built-in pipeline on both of the port's raster backends renders a
3-frame orbit at 64x64 on a small sphere.  Each frame covers more than 2%
of the pixels and lies within the oracle tie-flip budget of JAX's jnp-backend
frame at the same angles (fewer than 0.5% of pixels differ), and a checksum
burst (make_burst_fn without kept frames) on the same angles sums the same
bytes as the returned frames, unflipped.
"""

import functools

import numpy as np
import pytest
import torch

from tiny_renderer_tpu import RenderConfig as JRenderConfig
from tiny_renderer_tpu.scene import Scene as JScene
from tiny_renderer_tpu_torch import PIPELINE_NAMES, Model, RenderConfig, Scene
from tiny_renderer_tpu_torch.convert import to_tensor
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.pipelines.frame import BACKENDS, make_burst_fn

SIZE = 64
K = np.arange(3, dtype=np.float32)
CAMS = (0.05 + 0.4 * K).astype(np.float32)
LIGS = (0.1 - 0.3 * K).astype(np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.cache
def sphere():
    return Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))


@functools.cache
def jax_sequence(pipeline):
    """JAX's frames, rendered once for both of the port's backends."""
    scene = JScene(sphere(), pipeline, JRenderConfig(width=SIZE, height=SIZE), backend="jnp")
    return scene.render_sequence(CAMS, LIGS)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pipeline", PIPELINE_NAMES)
def test_render_sequence_matches_jax(pipeline, backend):
    scene = Scene(sphere(), pipeline, RenderConfig(width=SIZE, height=SIZE), device="cpu",
                  backend=backend)
    frames = scene.render_sequence(CAMS, LIGS)
    want = jax_sequence(pipeline)
    assert frames.shape == want.shape == (len(K), SIZE, SIZE, 3) and frames.dtype == np.uint8
    for i in range(len(K)):
        assert (frames[i] > 0).any(-1).mean() > 0.02, i
        assert (frames[i] != want[i]).any(-1).mean() < 0.005, i

    burst = make_burst_fn(pipeline, scene.config, backend=scene.backend)
    sums = burst(scene._geom, scene._textures, to_tensor(CAMS, "cpu"), to_tensor(LIGS, "cpu"))
    np.testing.assert_array_equal(
        sums["checksums"].numpy(),
        frames[:, ::-1].reshape(len(K), -1).sum(1, dtype=np.int64) % 2**32)
