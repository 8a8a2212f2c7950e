"""Torch port: the static-shape frame that CUDA graphs capture, against JAX.

The strip shade has static shapes and reads nothing on the host (the JAX
module's while_loop over strip batches becomes chunks of slots, each under a
device-side branch: test_torch_shade_chunks.py), so render_frame_jit and
render_burst can capture it on the card.  On the
CPU the same code runs eagerly.  Here, at 64x64: the port's _shade_strips
against JAX's on the same inputs at strip_batch=8, where JAX walks several
batches (coverage equal, fewer than 0.5% of pixels apart: JAX's compiled
loop may contract FMAs); the frame and the burst of every built-in pipeline
with every host read of a tensor made to raise; the burst against its
frames; the graph key (the registration generation, the geometry's
addresses) and the graph cache; dedup_gather bit-equal to JAX's at and past
its unique cap.  The knob matrix and the scenes that cover no strip or
every strip: test_torch_graph_frame_knobs.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_frame import GEOM, VIEW
from test_torch_pipelines import MAPS
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu.pipelines import shaders as jshaders
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.ops import mathlib as tml
from tiny_renderer_tpu_torch.ops import raster_cuda
from tiny_renderer_tpu_torch.ops.vertex import triangle_setup
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines import graphs as tgraphs
from tiny_renderer_tpu_torch.pipelines import shaders as tshaders

CFG = RenderConfig(width=64, height=64, tile_h=8, strip_batch=8)
PIPELINES = ("default", "phong", "normal_map", "specular", "darboux", "shadow", "occlusion")
TEX = MAPS["same"]
HOST_READS = ("__int__", "__bool__", "__float__", "item", "tolist", "numpy", "cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def port_frame(pipeline, cfg=CFG, geom=GEOM, tex=TEX):
    """make_frame_fn's frame on the CPU, as numpy arrays."""
    g, t = scene_arrays(geom, tex, "cpu")
    out = tframe.make_frame_fn(pipeline, config_from(cfg))(g, t, *(to_tensor(v, "cpu") for v in VIEW))
    return {k: (None if v is None else v.numpy()) for k, v in out.items()}


def shade_both(pipeline, cfg, geom=GEOM, tex=TEX):
    """The port's _shade_strips and JAX's on the same inputs: the port's
    uniforms, setup, light pass and camera raster (with the strip plane and
    the varying planes when the config asks for them), handed to both as
    numpy-made arrays.  Returns (port frame, JAX frame, covered pixels)."""
    g, t = scene_arrays(geom, tex, "cpu")
    cfg = config_from(cfg).resolve(pipeline)
    spec = tframe.PIPELINES[pipeline]
    views = [to_tensor(v, "cpu") for v in VIEW]
    u1, uniforms = tframe._uniforms(spec, cfg, *views)
    setup = triangle_setup(g, uniforms, cfg, needs=spec.needs)
    if spec.two_pass:
        setup1 = triangle_setup(g, u1, cfg, matrix_key="shadow_matrix", cull=False)
        shadow_z = tframe._light_pass(setup1, cfg, "kernel")[0]
    else:
        shadow_z = torch.full((cfg.height, cfg.width), tml.F32_MIN)
    kspec = tframe._planes_spec(pipeline, t, cfg) or ()
    _, idx, varys, strips, _ = tframe._rasterize(setup, cfg, "kernel", spec=kspec, emit_z=False,
                                                 emit_strips=tframe._strip_mask_len(cfg))
    textures = tframe._with_packed_plane(t, pipeline, cfg)
    shadow = tframe._shadow_for_shade(shadow_z, spec, cfg)
    args = (setup, idx, pipeline, uniforms, textures, cfg, shadow)
    kw = dict(strip_mask=strips, planes=varys, planes_spec=kspec)
    got = tframe._shade_strips(*args, **kw).numpy()

    def j(x):
        if isinstance(x, dict):
            return {k: j(v) for k, v in x.items()}
        return None if x is None else jnp.asarray(x.numpy())

    jargs = (j(setup), j(idx), pipeline, j(uniforms), j(textures), RenderConfig(**dataclasses.asdict(cfg)),
             j(shadow))
    want = np.asarray(jframe._shade_strips(*jargs, strip_mask=j(strips), planes=j(varys), planes_spec=kspec))
    return got, want, (idx >= 0).numpy()


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_static_shade_matches_jax_batches(pipeline):
    """strip_batch=8: JAX walks the covered strips in several while_loop
    batches; the port shades the chunks of frame.shade_chunks (several
    batches each; eagerly every chunk runs, and the covered count reaches
    past the first).  Same inputs, so the frames agree but for FMA
    contractions in JAX's compiled loop (the 0.5% budget).  (The whole frames against JAX's render_frame: the six other
    pipelines in test_torch_pipelines.py, shadow in test_torch_frame.py.)"""
    cfg = CFG.resolve(pipeline)
    got, want, covered = shade_both(pipeline, CFG)
    strips = covered.reshape(-1, cfg.strip_len).any(-1).sum()
    assert 2 * cfg.strip_batch < strips < covered.size // cfg.strip_len  # several batches, not all
    slots = covered.size // cfg.strip_len
    assert tframe.shade_chunks(slots, cfg.strip_batch)[0][1] < strips  # more than one chunk
    assert (got > 0).any(-1).mean() > 0.02 and not ((got > 0).any(-1) & ~covered).any()
    assert (got != want).any(-1).mean() < 0.005


@pytest.fixture
def no_host_reads(monkeypatch):
    """Every host read of a tensor value raises, except inside the CPU
    raster twins (which run only on the CPU and read their slot count)."""
    guard = [True]

    def refuse(name, orig):
        def method(self, *a, **k):
            if guard[0]:
                raise AssertionError(f"host read on the frame path: Tensor.{name}")
            return orig(self, *a, **k)
        return method

    def lifted(fn):
        def call(*a, **k):
            prev, guard[0] = guard[0], False
            try:
                return fn(*a, **k)
            finally:
                guard[0] = prev
        return call

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name, getattr(torch.Tensor, name)))
    for name in ("rasterize_reference", "rasterize_fused_reference"):
        monkeypatch.setattr(raster_cuda, name, lifted(getattr(raster_cuda, name)))
    return guard


@pytest.mark.parametrize("knobs", [{}, dict(strip_mask=True, strip_planes=True, occlusion_dedup=True),
                                   dict(fuse_passes=True, strip_pack_words=False)],
                         ids=["default", "mask+planes+dedup", "fuse+nopack"])
def test_frame_and_burst_read_nothing_on_the_host(no_host_reads, knobs):
    g, t = scene_arrays(GEOM, TEX, "cpu")
    views = [torch.from_numpy(v) for v in VIEW]
    with pytest.raises(AssertionError, match="host read"):
        bool(views[0].sum())  # the guard is on
    cams, ligs = torch.tensor([0.1, 0.5]), torch.tensor([-0.3, 0.2])
    for pipeline in PIPELINES:
        cfg = config_from(dataclasses.replace(CFG, **knobs))
        out = tframe.make_frame_fn(pipeline, cfg)(g, t, *views)
        burst = tframe.make_burst_fn(pipeline, cfg, keep_frames=True)(g, t, cams, ligs)
        assert out["frame"].shape == (64, 64, 3) and burst["frames"].shape == (2, 64, 64, 3)
    no_host_reads[0] = False
    assert bool((burst["frames"] > 0).any()) and bool((out["frame"] > 0).any())


def test_burst_equals_its_frames():
    g, t = scene_arrays(GEOM, TEX, "cpu")
    cfg = config_from(CFG)
    cams, ligs = torch.tensor([0.1, 0.6]), torch.tensor([-0.3, 1.0])
    out = tframe.render_burst(g, t, cams, ligs, pipeline="occlusion", config=cfg, keep_frames=True)
    zero = torch.zeros(())
    for i in range(2):
        look_from = torch.stack([torch.sin(cams[i]), zero, torch.cos(cams[i])])
        light = torch.stack([torch.sin(ligs[i]), zero, torch.cos(ligs[i])])
        one = tframe.render_frame(g, t, light, look_from, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]),
                                  pipeline="occlusion", config=cfg, needs_z=False)
        assert torch.equal(out["frames"][i], one["frame"])
        assert int(out["checksums"][i]) == int(tframe.frame_checksum(one["frame"]))
        assert bool(out["overflow"][i]) == bool(one["overflow"])


def _flat_shade(value):
    def shade(frag, uniforms, textures, config):
        return torch.full((*frag["x"].shape, 3), value, dtype=torch.uint8)
    return shade


def test_reregistered_pipeline_gets_a_new_frame_function():
    """JAX's gen key: a frame function made after a re-registration keys a
    graph of its own and renders the new shade."""
    spec = (("uv", 2, "interp"),)
    tframe.register_pipeline("gen_probe", _flat_shade(40), varying_spec=spec, overwrite=True)
    try:
        g, t = scene_arrays(GEOM, TEX, "cpu")
        views = [to_tensor(v, "cpu") for v in VIEW]
        cfg = config_from(CFG)
        old = tframe.make_frame_fn("gen_probe", cfg)
        old_frame = old(g, t, *views)["frame"]
        tframe.register_pipeline("gen_probe", _flat_shade(90), varying_spec=spec, overwrite=True)
        new = tframe.make_frame_fn("gen_probe", cfg)
        assert new.keywords["gen"] == old.keywords["gen"] + 1
        keys = [tframe._graph_key("frame", "gen_probe", fn.keywords["config"], "kernel", fn.keywords["gen"],
                                  g, t, views) for fn in (old, new)]
        assert keys[0] != keys[1]
        frame = new(g, t, *views)["frame"]
        covered = (frame > 0).any(-1)
        assert bool(covered.any()) and set(frame[covered].unique().tolist()) == {90}
        assert set(old_frame[(old_frame > 0).any(-1)].unique().tolist()) == {40}
        assert tframe.make_burst_fn("gen_probe", cfg).keywords["gen"] == new.keywords["gen"]
    finally:
        tframe.unregister_pipeline("gen_probe")


def test_graph_key_holds_addresses_not_values():
    g, t = scene_arrays(GEOM, TEX, "cpu")
    views = [to_tensor(v, "cpu") for v in VIEW]
    cfg = config_from(CFG).resolve("shadow")
    key = tframe._graph_key("frame", "shadow", cfg, "kernel", 0, g, t, views)
    # New view values: the same graph.  Another geometry tensor: another graph.
    other_views = [v + 1 for v in views]
    assert tframe._graph_key("frame", "shadow", cfg, "kernel", 0, g, t, other_views) == key
    g2 = {**g, "pos_tri": g["pos_tri"].clone()} if "pos_tri" in g else {**g, "positions": g["positions"].clone()}
    assert tframe._graph_key("frame", "shadow", cfg, "kernel", 0, g2, t, views) != key
    assert tframe._graph_key("frame", "shadow", cfg, "dense", 0, g, t, views) != key


def test_graph_cache_is_bounded_and_reuses():
    cache = tgraphs.GraphCache(size=2)
    made = []

    def capture(name):
        return lambda: made.append(name) or name

    assert cache.get("a", capture("a")) == "a"
    assert cache.get("b", capture("b")) == "b"
    assert cache.get("a", capture("a2")) == "a"  # hit: no capture, "a" most recent
    assert cache.get("c", capture("c")) == "c"  # evicts "b"
    assert cache.graphs() == ["a", "c"] and made == ["a", "b", "c"]
    assert cache.get("b", capture("b2")) == "b2"  # evicted: captured anew
    assert cache.graphs() == ["c", "b2"]


@pytest.mark.parametrize("unique", [100, 511, 512, 513, 3000])
def test_dedup_gather_bit_equal_to_jax(unique):
    """At and past the unique cap (cap = max(M >> 3, 256) = 512 at M = 4096):
    rank[-1] = unique - 1 >= cap takes the plain gather."""
    rng = np.random.default_rng(unique)
    table = rng.standard_normal(5000).astype(np.float32)
    pool = rng.choice(5000, unique, replace=False)
    idx = np.concatenate([pool, rng.choice(pool, 4096 - unique)]).astype(np.int64)
    idx = rng.permutation(idx).reshape(16, 256)
    want = np.asarray(jshaders.dedup_gather(jnp.asarray(table), jnp.asarray(idx)))
    got = tshaders.dedup_gather(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    assert got.shape == idx.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got, table[idx])


def test_occlusion_dedup_renders_the_same_frame():
    cfg = dataclasses.replace(CFG, occlusion_dedup=True)
    on, off = port_frame("occlusion", cfg), port_frame("occlusion")
    for k in ("frame", "z", "shadow", "overflow"):
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
