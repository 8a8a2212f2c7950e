"""Torch port: Scene.block_until_ready and the burst checksum, as in the
JAX package.

The JAX Scene waits for a render with block_until_ready (the port's own
name is synchronize; both exist).  JAX's render_burst sums each frame as
uint32, which wraps at 2^32; the port folds its int64 sum mod 2^32
(frame_checksum).  A frame whose byte sum passes 2^32 is too slow to
render on the CPU, so the checksum is pinned on a synthetic one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_renderer_tpu_torch import Model, RenderConfig, Scene
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.pipelines.frame import frame_checksum


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("method", ["block_until_ready", "synchronize"])
def test_scene_waits_under_both_names(method):
    model = Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))
    scene = Scene(model, "shadow", RenderConfig(width=128, height=64), device="cpu")
    scene.set_light_direction([0.3, 0.0, 0.95])
    out = scene.render()
    assert getattr(scene, method)() is None
    assert out["frame"].shape == (64, 128, 3) and bool((out["frame"] > 0).any())


@pytest.mark.parametrize("shape,fill", [((2800, 2800, 3), 255), ((64, 32, 3), None)])
def test_frame_checksum_wraps_like_jax_uint32(shape, fill):
    rng = np.random.default_rng(5)
    if fill is None:
        frame = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        frame = np.full(shape, fill, np.uint8)
        frame[: shape[0] // 3] = rng.integers(0, 256, (shape[0] // 3, *shape[1:]), dtype=np.uint8)
    total = int(frame.sum(dtype=np.int64))
    want = int(jnp.sum(jnp.asarray(frame).astype(jnp.uint32)))
    got = frame_checksum(torch.from_numpy(frame))
    assert got.dtype == torch.int64 and got.ndim == 0
    assert int(got) == want == total % 2**32
    if fill is not None:
        assert total > 2**32
