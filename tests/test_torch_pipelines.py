"""Torch port: the six pipelines beside shadow, frame for frame against the JAX package.

The scene is test_torch_frame's (two spheres, 256x128) with seeded random
texture, normal, tangent-normal and specular maps, so every normal-mapped
pipeline does varied work; a second map set gives the normal maps another
size than the texture (the mixed-dimension samplers and, for darboux, the
15-plane reference spec).  The JAX frame runs on the kernel path in
interpret mode (backend="pallas_interpret"), where XLA may contract
mul+add into FMAs, so frames are held to the repo's oracle tie-flip budget
(fewer than 0.5% of pixels differ); raster coverage is integer-exact and
must match exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_frame import CFG, GEOM, TEX, VIEW
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.ops import mathlib as tml
from tiny_renderer_tpu_torch.pipelines import frame as tframe

NEW_PIPELINES = ("default", "phong", "normal_map", "specular", "darboux", "occlusion")
MAPPED = ("normal_map", "specular", "darboux")


def random_maps(seed, normal_size=64):
    """TEX's texture plus seeded random normal, tangent and specular maps;
    the two normal maps are normal_size square."""
    rng = np.random.default_rng(seed)
    tex = dict(TEX)
    tex["normal_map"] = rng.integers(0, 256, (normal_size, normal_size, 3), dtype=np.uint8)
    tex["normal_map_tangent"] = rng.integers(0, 256, (normal_size, normal_size, 3), dtype=np.uint8)
    tex["specular_map"] = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    return tex


MAPS = {"same": random_maps(1), "mixed": random_maps(2, normal_size=32)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def port_frame(pipeline, tex, cfg=CFG, needs_z=True):
    g, t = scene_arrays(GEOM, tex, "cpu")
    out = tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in VIEW), pipeline=pipeline,
                              config=config_from(cfg), needs_z=needs_z)
    return {k: (None if v is None else v.numpy()) for k, v in out.items()}


def jax_frame(pipeline, tex, cfg=CFG):
    out = jframe.render_frame(
        {k: jnp.asarray(v) for k, v in GEOM.items()}, {k: jnp.asarray(v) for k, v in tex.items()},
        *(jnp.asarray(v) for v in VIEW), pipeline=pipeline, config=cfg, backend="pallas_interpret",
    )
    return {k: np.asarray(v) for k, v in out.items()}


CASES = [pytest.param(p, "same", id=p) for p in NEW_PIPELINES] + [
    pytest.param(p, "mixed", id=f"{p}-mixed-dims") for p in MAPPED
]


@pytest.mark.parametrize("pipeline,maps", CASES)
def test_frame_matches_jax(pipeline, maps):
    got, want = port_frame(pipeline, MAPS[maps]), jax_frame(pipeline, MAPS[maps])
    assert got["frame"].shape == (CFG.height, CFG.width, 3) and got["frame"].dtype == np.uint8
    covered = got["z"] > tml.F32_MIN
    np.testing.assert_array_equal(covered, want["z"] > tml.F32_MIN)
    assert covered.mean() > 0.05
    for out in (got, want):  # color only where the raster covered
        assert not ((out["frame"] > 0).any(-1) & ~covered).any()
    assert (got["frame"] > 0).any(-1).mean() > 0.02
    assert (got["frame"] != want["frame"]).any(-1).mean() < 0.005
    assert bool(got["overflow"]) == bool(want["overflow"])
    if tframe.PIPELINES[pipeline].two_pass:
        lit = want["shadow"] > tml.F32_MIN
        np.testing.assert_array_equal(got["shadow"] > tml.F32_MIN, lit)
        assert lit.mean() > 0.05
        np.testing.assert_allclose(got["shadow"][lit], want["shadow"][lit], rtol=1e-5, atol=1e-4)
    else:
        assert (got["shadow"] == np.float32(tml.F32_MIN)).all()
        np.testing.assert_array_equal(got["shadow"], want["shadow"])


def test_mixed_dims_maps_are_not_packed():
    """The mixed set has no packed plane and no texel-index plane: it goes
    through the per-map samplers, and darboux's kernel spec keeps all 15
    planes of the reference spec."""
    g, t = scene_arrays(GEOM, MAPS["mixed"], "cpu")
    for pipeline in MAPPED:
        packed = tframe.prepack_textures(t, pipeline, tile=16)
        assert not any(k.startswith("_pk:") for k in packed), pipeline
    spec = tframe.kernel_varying_spec("darboux", t, tile=16)
    assert spec == tframe.VARYING_SPECS["darboux"]
    assert sum(c for _, c, _ in spec) == 15
    same = tframe.kernel_varying_spec("darboux", scene_arrays(GEOM, MAPS["same"], "cpu")[1], tile=16)
    assert same == (("texidx", 1, "texidx:64:64:16"), ("local_z", 3, "interp"))


def test_one_pass_pipelines_launch_no_light_pass(monkeypatch):
    """One-pass pipelines raster the camera pass only; occlusion both."""
    calls = []
    raster = tframe.raster_cuda.rasterize
    monkeypatch.setattr(tframe.raster_cuda, "rasterize",
                        lambda *a, **k: calls.append(k["emit_idx"]) or raster(*a, **k))
    for pipeline in NEW_PIPELINES:
        calls.clear()
        port_frame(pipeline, MAPS["same"], needs_z=False)
        want = [False, True] if tframe.PIPELINES[pipeline].two_pass else [True]
        assert calls == want, pipeline
