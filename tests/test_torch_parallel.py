"""Torch port: the scale-out paths (parallel.sharding) on a mesh of CPU shards.

The mesh is [torch.device("cpu")] * 8, the counterpart of the JAX suite's 8
virtual CPU devices.  Kernel backend at 64x64 with tile_h=8 (8 rows per
shard, one tile row; the raster runs its twin on the CPU), dense backend at
96x96 (12 rows per shard).  Every sharded output (frame, z, shadow,
overflow) must equal the port's single-device render bit for bit.  The
comparison with the JAX package's sharded render is in
test_torch_parallel_jax.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_frame import GEOM, TEX, VIEW
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.examples import custom_pipeline
from tiny_renderer_tpu_torch.parallel import (
    make_pp_mesh,
    make_row_mesh,
    render_batch_sharded,
    render_frame_sharded,
    render_sequence_pipelined,
)
from tiny_renderer_tpu_torch.pipelines import frame as tframe

CPU8 = [torch.device("cpu")] * 8
SIZES = {"kernel": dict(width=64, height=64, tile_h=8), "dense": dict(width=96, height=96)}
KNOBS = {
    "default": ({}, True),
    "replicate_pass1": (dict(replicate_pass1=True), True),
    "shard_triangles": (dict(shard_triangles=True), True),
    "needs_z=False": ({}, False),
    "fuse_passes": (dict(fuse_passes=True), False),
    "strips+planes": (dict(strip_mask=True, strip_planes=True), True),
    "compact_shade=False": (dict(compact_shade=False), True),
}
# A triangle with a vertex near the projection singularity (w ~ 0: coords
# ~2^18) lies beyond the int32 exactness envelope and must flip overflow.
OVERFLOW_GEOM = {
    "positions": np.array([[-0.3, -0.3, 0.0], [0.3, -0.3, 0.0], [0.0, 0.3, 0.0],
                           [-0.2, -0.2, 0.0], [0.2, -0.2, 0.0], [0.3, 0.2, 5.9999]], np.float32),
    "tex_coords": np.full((6, 2), 0.5, np.float32),
    "normals": np.tile(np.array([[0, 0, 1]], np.float32), (6, 1)),
    **{k: np.array([[0, 1, 2], [3, 4, 5]], np.int32) for k in ("pos_idx", "tex_idx", "normal_idx")},
}
OVERFLOW_TEX = {k: np.zeros((16, 16, 3), np.uint8)
                for k in ("texture", "normal_map", "normal_map_tangent", "specular_map")}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(geom=GEOM, tex=TEX):
    g, t = scene_arrays(geom, tex, "cpu")
    return g, t, [to_tensor(v, "cpu") for v in VIEW]


def _cfg(backend, **knobs):
    return config_from(RenderConfig(**SIZES[backend], **knobs))


def _orbit(n, a0=0.0):
    angles = np.linspace(a0, a0 + 1.0, n, dtype=np.float32)
    lights = np.stack([[np.sin(a), 0, np.cos(a)] for a in angles]).astype(np.float32)
    froms = np.stack([[np.sin(a + 0.2), 0, np.cos(a + 0.2)] for a in angles]).astype(np.float32)
    return to_tensor(lights, "cpu"), to_tensor(froms, "cpu")


def _assert_equal(got, want, keys=("frame", "z", "shadow", "overflow")):
    for k in keys:
        assert (got[k] is None) == (want[k] is None), k
        if want[k] is not None:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# The dense backend has no kernel modes or strip shade for the other
# knobs to select.
CASES = [(b, k) for b in ("kernel", "dense") for k in KNOBS
         if b == "kernel" or k in ("default", "replicate_pass1", "shard_triangles", "needs_z=False")]


@pytest.mark.parametrize("pipeline", ["phong", "shadow"])
@pytest.mark.parametrize("backend,knob", CASES)
def test_row_sharded_matches_single_device(backend, knob, pipeline):
    knobs, needs_z = KNOBS[knob]
    # 8 shards of the triangle axis leave a padded tail.
    assert GEOM["pos_idx"].shape[0] % 8 != 0
    g, t, view = _scene()
    cfg = _cfg(backend, **knobs)
    mesh = make_row_mesh(CPU8)
    assert mesh.shape == {"batch": 1, "rows": 8}
    got = render_frame_sharded(g, t, *view, pipeline=pipeline, config=cfg, mesh=mesh,
                               backend=backend, needs_z=needs_z)
    want = tframe.render_frame(g, t, *view, pipeline=pipeline, config=cfg, needs_z=needs_z,
                               backend=backend)
    assert (want["frame"] > 0).any(-1).float().mean() > 0.05
    assert not bool(got["overflow"])
    _assert_equal(got, want)


@pytest.fixture
def glow():
    custom_pipeline.register()
    yield
    for name in ("toon", "glow"):
        tframe.unregister_pipeline(name)


@pytest.mark.parametrize("shard_triangles", [False, True])
@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_row_sharded_user_attribute(glow, backend, shard_triangles):
    """A registered pipeline with a user vertex attribute (attr:glow, a
    (T, 3, 1) plane that shard_triangles slices with the geometry)."""
    g, t, view = _scene()
    g["attr:glow"] = to_tensor(np.linspace(0.0, 1.0, 3 * GEOM["pos_idx"].shape[0], dtype=np.float32)
                               .reshape(-1, 3, 1), "cpu")
    cfg = _cfg(backend, shard_triangles=shard_triangles)
    got = render_frame_sharded(g, t, *view, pipeline="glow", config=cfg, mesh=make_row_mesh(CPU8),
                               backend=backend)
    want = tframe.render_frame(g, t, *view, pipeline="glow", config=cfg, backend=backend)
    assert (want["frame"] > 0).any()
    _assert_equal(got, want)


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_batch_sharded_2d_mesh(backend):
    g, t, (_, _, look_at, up) = _scene()
    cfg = _cfg(backend)
    mesh = make_row_mesh(CPU8, batch=2)
    assert mesh.shape == {"batch": 2, "rows": 4}
    lights, froms = _orbit(4)
    out = render_batch_sharded(g, t, lights, froms, look_at, up, pipeline="phong", config=cfg,
                               mesh=mesh, backend=backend)
    assert out["frame"].shape == (4, cfg.height, cfg.width, 3) and out["overflow"].shape == (4,)
    assert not bool(out["overflow"].any())
    for b in range(4):
        want = tframe.render_frame(g, t, lights[b], froms[b], look_at, up, pipeline="phong",
                                   config=cfg, backend=backend)
        assert torch.equal(out["frame"][b], want["frame"]) and torch.equal(out["z"][b], want["z"])
    noz = render_batch_sharded(g, t, lights, froms, look_at, up, pipeline="phong", config=cfg,
                               mesh=mesh, backend=backend, needs_z=False)
    assert noz["z"] is None and torch.equal(noz["frame"], out["frame"])


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_pipelined_sequence_matches_single_device(backend):
    g, t, (_, _, look_at, up) = _scene()
    cfg = _cfg(backend)
    mesh = make_pp_mesh(CPU8)
    assert mesh.shape == {"stage": 2, "rows": 4}
    lights, froms = _orbit(3, 0.4)
    out = render_sequence_pipelined(g, t, lights, froms, look_at, up, pipeline="shadow",
                                    config=cfg, mesh=mesh, backend=backend)
    assert out["frame"].shape == (3, cfg.height, cfg.width, 3)
    assert not bool(out["overflow"].any())
    for i in range(3):
        want = tframe.render_frame(g, t, lights[i], froms[i], look_at, up, pipeline="shadow",
                                   config=cfg, needs_z=False, backend=backend)
        assert torch.equal(out["frame"][i], want["frame"]), f"frame {i}"


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_coord_overflow_propagates(backend):
    """A triangle beyond the int32 exactness envelope flips overflow on the
    row-sharded and the pipelined paths, as on the single device."""
    g, t, (_, _, look_at, up) = _scene(OVERFLOW_GEOM, OVERFLOW_TEX)
    fwd = torch.tensor([0.0, 0.0, 1.0])
    cfg = _cfg(backend)
    single = tframe.render_frame(g, t, fwd, fwd, look_at, up, pipeline="phong", config=cfg,
                                 backend=backend)
    assert bool(single["overflow"])
    out = render_frame_sharded(g, t, fwd, fwd, look_at, up, pipeline="phong", config=cfg,
                               mesh=make_row_mesh(CPU8), backend=backend)
    assert bool(out["overflow"])
    seq = render_sequence_pipelined(g, t, torch.stack([fwd, fwd]), torch.stack([fwd, fwd]),
                                    look_at, up, pipeline="shadow", config=cfg,
                                    mesh=make_pp_mesh(CPU8), backend=backend)
    assert bool(seq["overflow"].all())


def test_invalid_configs_raise():
    g, t, (light, look_from, look_at, up) = _scene()
    cfg = _cfg("kernel")
    pp = make_pp_mesh(CPU8)
    args = (g, t, torch.stack([light, light]), torch.stack([look_from, look_from]), look_at, up)
    with pytest.raises(ValueError, match="single-pass"):
        render_sequence_pipelined(*args, pipeline="phong", config=cfg, mesh=pp)
    for knob in ("shard_triangles", "replicate_pass1"):
        with pytest.raises(ValueError, match="pass-1"):
            render_sequence_pipelined(*args, pipeline="shadow", mesh=pp,
                                      config=dataclasses.replace(cfg, **{knob: True}))
    with pytest.raises(ValueError, match="stage"):
        render_sequence_pipelined(*args, pipeline="shadow", config=cfg, mesh=make_row_mesh(CPU8))
    view = (light, look_from, look_at, up)
    with pytest.raises(ValueError, match="not divisible by rows axis"):
        render_frame_sharded(g, t, *view, pipeline="shadow", mesh=make_row_mesh(CPU8[:5]),
                             config=cfg)
    with pytest.raises(ValueError, match="shard height 16 not divisible by tile_h 32"):
        render_frame_sharded(g, t, *view, pipeline="shadow", mesh=make_row_mesh(CPU8[:4]),
                             config=config_from(RenderConfig(width=64, height=64)))
    with pytest.raises(ValueError, match="not divisible by batch axis"):
        render_batch_sharded(g, t, *args[2:4], look_at, up, pipeline="phong", config=cfg,
                             mesh=make_row_mesh(CPU8[:6], batch=3))
    with pytest.raises(ValueError, match="not divisible by batch=3"):
        make_row_mesh(CPU8, batch=3)
    with pytest.raises(ValueError, match="even device count"):
        make_pp_mesh(CPU8[:3])


def test_default_mesh_is_the_cuda_devices():
    n = torch.cuda.device_count()
    if n == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_row_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_pp_mesh()
    else:
        assert list(make_row_mesh().devices.flat) == [torch.device("cuda", i) for i in range(n)]
