"""Torch port: the sharded shadow frame against the JAX package's.

The port's render_frame_sharded on [torch.device("cpu")] * 8 against JAX's
on its 8 virtual CPU devices, at the sizes of test_torch_parallel.py:
pallas_interpret against the kernel backend (64x64, tile_h=8), jnp against
the dense one (96x96).  Coverage (z and shadow written) exact, frames under
0.5% of pixels apart: XLA may contract the JAX side's interpolations into
FMAs (docs/DESIGN.md divergence #2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import GEOM, TEX, VIEW
from test_torch_parallel import CPU8, SIZES
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.parallel import make_row_mesh as jax_row_mesh
from tiny_renderer_tpu.parallel import render_frame_sharded as jax_render_frame_sharded
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.parallel import make_row_mesh, render_frame_sharded


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("backend,jax_backend", [("kernel", "pallas_interpret"), ("dense", "jnp")])
def test_sharded_shadow_matches_jax(backend, jax_backend):
    g, t = scene_arrays(GEOM, TEX, "cpu")
    view = [to_tensor(v, "cpu") for v in VIEW]
    jcfg = RenderConfig(**SIZES[backend])
    want = jax_render_frame_sharded(
        {k: jnp.asarray(v) for k, v in GEOM.items()}, {k: jnp.asarray(v) for k, v in TEX.items()},
        *(jnp.asarray(v) for v in VIEW), pipeline="shadow", config=jcfg,
        mesh=jax_row_mesh(jax.devices()[:8]), backend=jax_backend,
    )
    got = render_frame_sharded(g, t, *view, pipeline="shadow", config=config_from(jcfg),
                               mesh=make_row_mesh(CPU8), backend=backend)
    for k in ("z", "shadow"):
        np.testing.assert_array_equal(got[k].numpy() > -1e38, np.asarray(want[k]) > -1e38,
                                      err_msg=k)
    assert (got["frame"].numpy() != np.asarray(want["frame"])).any(-1).mean() < 0.005
    assert bool(got["overflow"]) == bool(want["overflow"])
