"""Torch port: random knobs, scenes and poses against the JAX package
(the counterpart of tests/test_fuzz_configs.py, whose draws it reuses).

Each draw renders the same random scene (_random_scene) with the same knob
draw (_random_config) in both packages: the port's frame function on the
CPU against JAX's pallas_interpret frame.  The overflow flags must agree
and the frames differ on fewer than 0.2% of pixels (winner flips at exact
ties); where no cap bound (no overflow), the port's frame is also held to
the NumPy oracle within its 0.5% tie budget.  Here the JAX file's random knob draws;
the other pipelines' draws: test_torch_fuzz_pipelines.py; the sharded
random poses: test_torch_fuzz_sharded.py; the sizes and scenes
(tile-unaligned included): test_torch_fuzz_sizes.py (one file each, so
that each stays well inside a minute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fuzz_configs import _random_config, _random_scene
from tiny_renderer_tpu.models.procedural import make_textures
from tiny_renderer_tpu.oracle import render_oracle
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.pipelines import frame as tframe

FLIP_BUDGET = 0.002  # winner flips at exact ties against JAX's frame
ORACLE_BUDGET = 0.005  # the oracle tie-flip budget


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def pose(rng, y=0.0):
    """(light, look_from, look_at, up) at two random orbit angles, drawn as
    test_fuzz_configs draws them."""
    a, b = rng.uniform(-np.pi, np.pi, 2)
    return (np.array([np.sin(a), 0, np.cos(a)], np.float32),
            np.array([np.sin(b), y, np.cos(b)], np.float32),
            np.zeros(3, np.float32), np.array([0, 1, 0], np.float32))


def jax_frame(geom, tex, view, pipeline, cfg, backend="pallas_interpret"):
    fn = jframe.make_frame_fn(pipeline, cfg, backend=backend)
    out = fn(jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
             *(jnp.asarray(v) for v in view))
    return np.asarray(out["frame"]), bool(np.asarray(out["overflow"]))


def port_frame(geom, tex, view, pipeline, cfg, backend="kernel"):
    g, t = scene_arrays(geom, tex, "cpu")
    out = tframe.make_frame_fn(pipeline, config_from(cfg), backend=backend)(
        g, t, *(to_tensor(v, "cpu") for v in view))
    return out["frame"].numpy(), bool(out["overflow"])


def held_to_jax_and_oracle(geom, tex, view, pipeline, cfg):
    """The port's frame against JAX's pallas_interpret frame (overflow
    equal, < 0.2% of pixels apart) and, when nothing overflowed, against
    the oracle (< 0.5%).  Returns the port's overflow flag."""
    got, got_ovf = port_frame(geom, tex, view, pipeline, cfg)
    want, want_ovf = jax_frame(geom, tex, view, pipeline, cfg)
    assert got_ovf == want_ovf, f"overflow {got_ovf} (JAX {want_ovf}) under {cfg}"
    flips = (got != want).any(-1).mean()
    assert flips < FLIP_BUDGET, f"{flips:.3%} of pixels differ from JAX under {cfg}"
    assert (got > 0).any(), f"black frame under {cfg}"
    if not got_ovf:
        o = render_oracle(geom, tex, *view, pipeline=pipeline, config=cfg)["frame"]
        mismatch = (got != o).any(-1).mean()
        assert mismatch < ORACLE_BUDGET, f"{mismatch:.3%} of pixels differ from the oracle under {cfg}"
    return got_ovf


def random_knobs_draw(seed, pipeline):
    """test_fuzz_configs.test_fuzz_random_knobs's draw for `seed`: a random
    scene of 100 triangles, a random pose and knob composition at 96x96."""
    rng = np.random.default_rng(seed)
    geom = _random_scene(100, seed)
    view = pose(rng)
    cfg = _random_config(rng, 96, 96)
    return held_to_jax_and_oracle(geom, make_textures(64), view, pipeline, cfg)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_fuzz_random_knobs(seed):
    """The JAX file's draws (its pipeline by seed % 3) on the port."""
    random_knobs_draw(seed, ["phong", "shadow", "occlusion"][seed % 3])
