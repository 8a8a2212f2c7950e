"""Torch port: every built-in pipeline against the NumPy oracle, and the
dense backend's frame against the JAX package's.

The oracle (tiny_renderer_tpu.oracle.render_oracle) renders with the
reference's serial semantics.  Both raster backends of the port are held to
it, the dense backend (division z, full-screen gather shade) and the kernel
backend (its twin on the CPU: reciprocal z, strip shade), at two orbit
poses on a procedural sphere: coverage (z written) equal, frames within the
oracle tie-flip budget, fewer than 0.5% of pixels apart.  The same budget
holds render_frame(backend="dense") to JAX's render_frame(backend="jnp")
(whose compiled interpolations XLA may contract into FMAs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ORBIT_POSES, pose_camera
from test_torch_frame import GEOM as TWO_SPHERES
from test_torch_frame import TEX as TWO_SPHERES_TEX
from test_torch_frame import VIEW
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.models.procedural import make_textures, make_uv_sphere, to_geom
from tiny_renderer_tpu.oracle import render_oracle
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.pipelines import frame as tframe

CFG = RenderConfig(width=96, height=96, tri_block=32)
GEOM = to_geom(make_uv_sphere(stacks=10, slices=16))
TEX = make_textures(64)
PIPELINES = ("default", "phong", "normal_map", "specular", "darboux", "shadow", "occlusion")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("backend", ["dense", "kernel"])
@pytest.mark.parametrize("pose", ORBIT_POSES[:2], ids=lambda p: f"cam{p[0]:g}-light{p[1]:g}")
@pytest.mark.parametrize("pipeline", PIPELINES)
def test_pipeline_matches_oracle(pipeline, pose, backend):
    view = pose_camera(*pose)
    want = render_oracle(GEOM, TEX, *view, pipeline=pipeline, config=CFG)
    g, t = scene_arrays(GEOM, TEX, "cpu")
    got = tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in view), pipeline=pipeline,
                              config=config_from(CFG), backend=backend)
    frame = got["frame"].numpy()
    assert frame.shape == want["frame"].shape and (frame > 0).any()
    np.testing.assert_array_equal(got["z"].numpy() > -1e38, want["z"] > -1e38)
    assert (frame != want["frame"]).any(-1).mean() < 0.005


@pytest.mark.parametrize("pipeline", ["shadow", "phong"])
def test_dense_frame_matches_jax_jnp(pipeline):
    cfg = RenderConfig(width=128, height=96)
    want = jframe.render_frame(
        {k: jnp.asarray(v) for k, v in TWO_SPHERES.items()},
        {k: jnp.asarray(v) for k, v in TWO_SPHERES_TEX.items()},
        *(jnp.asarray(v) for v in VIEW), pipeline=pipeline, config=cfg, backend="jnp",
    )
    g, t = scene_arrays(TWO_SPHERES, TWO_SPHERES_TEX, "cpu")
    got = tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in VIEW), pipeline=pipeline,
                              config=config_from(cfg), backend="dense")
    got = {k: v.numpy() for k, v in got.items()}
    assert (got["frame"] > 0).any(-1).mean() > 0.05
    for k in ("z", "shadow"):
        np.testing.assert_array_equal(got[k] > -1e38, np.asarray(want[k]) > -1e38, err_msg=k)
    assert (got["frame"] != np.asarray(want["frame"])).any(-1).mean() < 0.005
    assert bool(got["overflow"]) == bool(want["overflow"])
