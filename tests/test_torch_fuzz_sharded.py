"""Torch port: the row shards on random poses and knobs against the JAX
package (test_fuzz_configs.test_fuzz_sharded_random_pose's draws, as
test_torch_fuzz.py holds its random knob draws).

The port's sharded frame on [torch.device("cpu")] * 8 must equal its
single-device frame bit for bit, as JAX's own sharded draws equal its
single-device frame, and stay within the flip budget of JAX's frame and
the oracle budget (test_torch_fuzz.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fuzz_configs import _random_scene
from test_torch_fuzz import FLIP_BUDGET, ORACLE_BUDGET, jax_frame, pose
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.models.procedural import make_textures
from tiny_renderer_tpu.oracle import render_oracle
from tiny_renderer_tpu.parallel import make_row_mesh as jax_row_mesh
from tiny_renderer_tpu.parallel import render_frame_sharded as jax_render_frame_sharded
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.parallel import make_row_mesh, render_frame_sharded
from tiny_renderer_tpu_torch.pipelines import frame as tframe

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_fuzz_sharded_random_pose(seed):
    """test_fuzz_sharded_random_pose's draws: random poses and pass-1 /
    triangle-axis knobs through the row shards on 8 CPU devices, bit-equal
    to the single-device frame on both backends; each backend's frame held
    to JAX's (dense: JAX's jnp frame sharded on its 8 virtual devices, as
    its own test renders it; kernel: JAX's pallas_interpret frame at
    128x128, whose 16-row shards take tile_h=8).  The kernel draws keep
    the span cap loose (max_span_y * tile_h >= the height): a tighter cap
    binds on the whole frame's bins and not on a shard's window of two
    tile rows, so the two would flag and drop different coverage, in both
    packages."""
    rng = np.random.default_rng(seed)
    pipeline = ["phong", "shadow", "darboux"][seed % 3]
    geom = _random_scene(100, seed)
    tex = make_textures(64)
    view = pose(rng, y=0.3)
    knobs = dict(binning_compact=bool(rng.integers(2)), shard_triangles=bool(rng.integers(2)),
                 replicate_pass1=bool(rng.integers(2)))
    g, t = scene_arrays(geom, tex, "cpu")
    views = [to_tensor(v, "cpu") for v in view]
    for backend, size in (("dense", dict(width=96, height=96)),
                          ("kernel", dict(width=128, height=128, tile_h=8, max_span_y=16))):
        cfg = RenderConfig(**size, tri_block=32, **knobs)
        got = render_frame_sharded(g, t, *views, pipeline=pipeline, config=config_from(cfg),
                                   mesh=make_row_mesh(CPU8), backend=backend)
        single_cfg = config_from(dataclasses.replace(cfg, shard_triangles=False))
        single = tframe.render_frame(g, t, *views, pipeline=pipeline, config=single_cfg,
                                     backend=backend)
        for k in ("frame", "z", "shadow", "overflow"):
            assert torch.equal(got[k], single[k]), f"{backend} sharded {k} != single under {cfg}"
        if backend == "dense":
            jout = jax_render_frame_sharded(
                jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
                *(jnp.asarray(v) for v in view), pipeline=pipeline, config=cfg,
                mesh=jax_row_mesh(jax.devices()[:8]))
            want, want_ovf = np.asarray(jout["frame"]), bool(np.asarray(jout["overflow"]))
        else:
            want, want_ovf = jax_frame(geom, tex, view, pipeline,
                                       dataclasses.replace(cfg, shard_triangles=False))
        frame = got["frame"].numpy()
        assert bool(got["overflow"]) == want_ovf and not want_ovf, f"{backend} overflow under {cfg}"
        flips = (frame != want).any(-1).mean()
        assert flips < FLIP_BUDGET, f"{backend}: {flips:.3%} of pixels differ from JAX under {cfg}"
        o = render_oracle(geom, tex, *view, pipeline=pipeline,
                          config=dataclasses.replace(cfg, shard_triangles=False))["frame"]
        assert (frame != o).any(-1).mean() < ORACLE_BUDGET, f"{backend}: oracle under {cfg}"
