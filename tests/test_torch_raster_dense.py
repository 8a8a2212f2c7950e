"""Torch port: the dense raster backend against the JAX package's.

rasterize_dense against rasterize_jnp on the same triangle setups.  Run op
by op (jax.disable_jit) the JAX function is the same f32 expression in the
same order, so z and idx must be equal bit for bit; compiled, XLA may
contract its z interpolation into FMAs (docs/DESIGN.md divergence #2), so
there coverage is exact, winners flip at exact-z ties only (< 0.2% of
pixels) and z agrees within rtol=1e-5.  Frames of render_frame(backend=
"dense") against the port's kernel backend (reciprocal z, DESIGN.md
divergence #3): coverage exact, fewer than 0.5% of pixels apart (the
tolerance of test_torch_frame.py); against JAX's render_frame(backend=
"jnp") in test_torch_oracle.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import GEOM, TEX, VIEW
from test_vertex_raster import _identity_uniforms, _random_scene
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.ops.raster_jnp import rasterize_jnp
from tiny_renderer_tpu.ops.vertex import triangle_setup
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.ops.raster_dense import rasterize_dense
from tiny_renderer_tpu_torch.pipelines import frame as tframe

CFG = RenderConfig(width=128, height=128, tri_block=32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(seed):
    _, u = _identity_uniforms(CFG.width, CFG.height)
    return triangle_setup(_random_scene(200, seed), u, CFG, needs=(), xp=np)


def _both(setup, rows, y_offset, jit):
    js = {k: jnp.asarray(v) for k, v in setup.items()}
    if jit:
        zj, ij = rasterize_jnp(js, rows, CFG.width, CFG.tri_block, y_offset=y_offset)
    else:
        with jax.disable_jit():
            zj, ij = rasterize_jnp(js, rows, CFG.width, CFG.tri_block, y_offset=y_offset)
    zt, it = rasterize_dense({k: to_tensor(v, "cpu") for k, v in setup.items()}, rows,
                             CFG.width, CFG.tri_block, y_offset=y_offset)
    assert zt.dtype == torch.float32 and it.dtype == torch.int32
    assert zt.shape == it.shape == (rows, CFG.width)
    return np.asarray(zj), np.asarray(ij), zt.numpy(), it.numpy()


@pytest.mark.parametrize("y_offset", [0, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_matches_jax_op_by_op(seed, y_offset):
    zj, ij, zt, it = _both(_setup(seed), 64, y_offset, jit=False)
    assert (it >= 0).mean() > 0.2
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(zt.view(np.int32), zj.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_matches_jax_compiled(seed):
    zj, ij, zt, it = _both(_setup(seed), 88, 40, jit=True)
    np.testing.assert_array_equal(it >= 0, ij >= 0)
    assert (it != ij).mean() < 0.002
    same = it == ij
    np.testing.assert_allclose(zt[same], zj[same], rtol=1e-5, atol=1e-4)


def test_dense_row_slab_equals_full_frame_rows():
    setup = {k: to_tensor(v, "cpu") for k, v in _setup(3).items()}
    z, idx = rasterize_dense(setup, CFG.height, CFG.width, CFG.tri_block)
    zs, ids = rasterize_dense(setup, 24, CFG.width, 16, y_offset=72)
    assert torch.equal(ids, idx[72:96]) and torch.equal(zs, z[72:96])


def _port(pipeline, backend, cfg=RenderConfig(width=256, height=128), needs_z=True):
    g, t = scene_arrays(GEOM, TEX, "cpu")
    out = tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in VIEW), pipeline=pipeline,
                              config=config_from(cfg), backend=backend, needs_z=needs_z)
    return {k: (None if v is None else v.numpy()) for k, v in out.items()}


@pytest.mark.parametrize("pipeline", ["shadow", "darboux", "occlusion"])
def test_dense_frame_matches_kernel_backend(pipeline):
    dense, kernel = _port(pipeline, "dense"), _port(pipeline, "kernel")
    for k in ("z", "shadow"):
        np.testing.assert_array_equal(dense[k] > -1e38, kernel[k] > -1e38, err_msg=k)
    assert (dense["frame"] != kernel["frame"]).any(-1).mean() < 0.005


def test_dense_ignores_the_raster_knobs():
    """The dense backend's full-screen shade: raster and shade knobs that
    select kernel modes give the same frame."""
    base = _port("shadow", "dense", needs_z=False)
    knobs = RenderConfig(width=256, height=128, fuse_passes=True, strip_mask=True,
                         strip_planes=True, idx_int16=True, compact_shade=False)
    other = _port("shadow", "dense", knobs, needs_z=False)
    assert base["z"] is None and other["z"] is None
    for k in ("frame", "shadow", "overflow"):
        np.testing.assert_array_equal(other[k], base[k], err_msg=k)


def test_dense_burst_matches_per_frame():
    g, t = scene_arrays(GEOM, TEX, "cpu")
    cfg = config_from(RenderConfig(width=128, height=64))
    cams = torch.tensor([0.1, -0.4], dtype=torch.float32)
    ligs = torch.tensor([0.3, 1.0], dtype=torch.float32)
    out = tframe.make_burst_fn("shadow", cfg, keep_frames=True, backend="dense")(g, t, cams, ligs)
    one = tframe.make_frame_fn("shadow", cfg, backend="dense")
    zero = torch.zeros(())
    for i in range(2):
        light = torch.stack([torch.sin(ligs[i]), zero, torch.cos(ligs[i])])
        look_from = torch.stack([torch.sin(cams[i]), zero, torch.cos(cams[i])])
        want = one(g, t, light, look_from, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]))
        assert torch.equal(out["frames"][i], want["frame"])


def test_unknown_backend_raises():
    g, t = scene_arrays(GEOM, TEX, "cpu")
    with pytest.raises(ValueError, match="backend"):
        tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in VIEW), pipeline="shadow",
                            config=config_from(RenderConfig(width=128, height=64)), backend="jnp")
