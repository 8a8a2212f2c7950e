"""Torch port: register_pipeline against the JAX package.

Three custom pipelines are registered in both packages with paired shades
(the JAX one in xp form, the port's on tensors, the same arithmetic):
"toon" (one pass, uv + intensity), "fog" (two_pass, uv + zfrag, reads the
shadow buffer) and "heat" (a user vertex attribute, attr:heat).  The scene
is test_torch_frame's (two spheres, 256x128).  Each port frame is held to
JAX's render_frame(backend="pallas_interpret"): raster coverage exactly,
and fewer than 0.5% of pixels differ (the repo's oracle tie-flip budget:
XLA may contract mul+add into FMAs inside the JAX strip shade).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_frame import CFG, GEOM, TEX, VIEW
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.ops import mathlib as jml
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu.pipelines import shaders as jsh
from tiny_renderer_tpu_torch import Model, Scene
from tiny_renderer_tpu_torch.config import resolve_for_pipeline
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.examples import custom_pipeline as example
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.ops import mathlib as tml
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines import shaders as tsh

TOON = dict(varying_spec=example.TOON_SPEC, maps=("texture",), needs=("vertex_intensity",))
FOG = dict(varying_spec=(("uv", 2, "interp"), ("zfrag", 1, "zfrag")), maps=("texture",),
           two_pass=True)
HEAT = dict(varying_spec=(("uv", 2, "interp"), ("attr:heat", 1, "interp")), maps=("texture",))


def j_toon(frag, uniforms, textures, config, xp):
    color = jsh.sample_frag(textures, frag, ("texture",), xp)["texture"]
    t = xp.ceil(xp.clip(frag["intensity"], 0.0, 1.0) * xp.float32(4.0)) / xp.float32(4.0)
    return jml.color_blend(color, xp.asarray(jsh.BLACK), t, xp)


def j_fog(frag, uniforms, textures, config, xp):
    sm = jml.mat4_mul(uniforms["shadow_matrix"], uniforms["i_vpmv"])
    p = xp.stack([frag["x"].astype(xp.float32), frag["y"].astype(xp.float32), frag["zfrag"]],
                 axis=-1)
    sc = jml.mat4_transform_point(sm, p, xp)
    sval = jsh._shadow_fetch(frag["shadow_buffer"], sc[..., 0], sc[..., 1], config.width, xp,
                             tile=jsh.plane_tile_effective(config, frag["shadow_buffer"].shape))
    lit = xp.where(sc[..., 2] + xp.float32(config.shadow_bias) < sval,
                   xp.float32(0.3), xp.float32(1.0))
    t = lit * xp.clip(frag["zfrag"] / xp.float32(config.depth), 0.0, 1.0)
    color = jsh.sample_frag(textures, frag, ("texture",), xp)["texture"]
    return jml.color_blend(color, xp.asarray(jsh.BLACK), t, xp)


def t_fog(frag, uniforms, textures, config):
    sm = tml.mat4_mul(uniforms["shadow_matrix"], uniforms["i_vpmv"])
    p = torch.stack([frag["x"].to(torch.float32), frag["y"].to(torch.float32), frag["zfrag"]],
                    dim=-1)
    sc = tml.mat4_transform_point(sm, p)
    sval = tsh._shadow_fetch(frag["shadow_buffer"], sc[..., 0], sc[..., 1], config.width,
                             tile=tsh.plane_tile_effective(config, frag["shadow_buffer"].shape))
    lit = torch.where(sc[..., 2] + tml.f32(config.shadow_bias) < sval, tml.f32(0.3), 1.0)
    t = lit * (frag["zfrag"] / tml.f32(config.depth)).clamp(0.0, 1.0)
    color = tsh.sample_frag(textures, frag, ("texture",))["texture"]
    return tml.color_blend(color, torch.zeros(3, dtype=torch.uint8), t)


def j_heat(frag, uniforms, textures, config, xp):
    color = jsh.sample_frag(textures, frag, ("texture",), xp)["texture"]
    t = xp.clip(frag["attr:heat"][..., 0], 0.0, 1.0)
    return jml.color_blend(color, xp.asarray(jsh.BLACK), t, xp)


def t_heat(frag, uniforms, textures, config):
    color = tsh.sample_frag(textures, frag, ("texture",))["texture"]
    t = frag["attr:heat"][..., 0].clamp(0.0, 1.0)
    return tml.color_blend(color, torch.zeros(3, dtype=torch.uint8), t)


CUSTOM = {"toon": (j_toon, example.shade_toon, TOON), "fog": (j_fog, t_fog, FOG),
          "heat": (j_heat, t_heat, HEAT)}


def heat_attr(geom):
    """Smooth position-derived per-corner values (T, 3, 1): neighbouring
    triangles agree at shared vertices, so tie-flip pixels shade nearly
    alike (the construction of the JAX package's test)."""
    corners = geom["positions"][geom["pos_idx"]]
    return (0.5 + 0.5 * np.sin(4.0 * corners[..., 0] + 2.0 * corners[..., 1]))[..., None].astype(
        np.float32)


HEAT_GEOM = {**GEOM, "attr:heat": heat_attr(GEOM)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def custom_pipelines():
    """toon, fog and heat registered in both packages for this module."""
    for name, (jshade, tshade, kw) in CUSTOM.items():
        jframe.register_pipeline(name, jshade, **kw)
        tframe.register_pipeline(name, tshade, **kw)
    yield
    for name in CUSTOM:
        jframe.unregister_pipeline(name)
        tframe.unregister_pipeline(name)


def geom_of(pipeline):
    return HEAT_GEOM if pipeline == "heat" else GEOM


def port_frame(pipeline, cfg=CFG, needs_z=True, geom=None):
    g, t = scene_arrays(geom_of(pipeline) if geom is None else geom, TEX, "cpu")
    out = tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in VIEW), pipeline=pipeline,
                              config=config_from(cfg), needs_z=needs_z)
    return {k: (None if v is None else v.numpy()) for k, v in out.items()}


def jax_frame(pipeline, cfg=CFG, geom=None):
    geom = geom_of(pipeline) if geom is None else geom
    out = jframe.render_frame(
        {k: jnp.asarray(v) for k, v in geom.items()}, {k: jnp.asarray(v) for k, v in TEX.items()},
        *(jnp.asarray(v) for v in VIEW), pipeline=pipeline, config=cfg, backend="pallas_interpret",
    )
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("pipeline", list(CUSTOM))
def test_custom_frame_matches_jax(pipeline):
    got, want = port_frame(pipeline), jax_frame(pipeline)
    covered = got["z"] > tml.F32_MIN
    np.testing.assert_array_equal(covered, want["z"] > tml.F32_MIN)
    assert covered.mean() > 0.05
    assert (got["frame"] > 0).any(-1).mean() > 0.02
    assert (got["frame"] != want["frame"]).any(-1).mean() < 0.005
    assert bool(got["overflow"]) == bool(want["overflow"])
    lit = want["shadow"] > tml.F32_MIN
    np.testing.assert_array_equal(got["shadow"] > tml.F32_MIN, lit)
    if pipeline == "fog":
        assert lit.mean() > 0.05
        np.testing.assert_allclose(got["shadow"][lit], want["shadow"][lit], rtol=1e-5, atol=1e-4)


def test_custom_attr_changes_the_frame():
    cold = {**GEOM, "attr:heat": np.zeros_like(HEAT_GEOM["attr:heat"])}
    assert not np.array_equal(port_frame("heat", geom=cold)["frame"], port_frame("heat")["frame"])


def test_custom_attr_burst_matches_per_frame():
    g, t = scene_arrays(HEAT_GEOM, TEX, "cpu")
    cfg = config_from(CFG)
    cams = torch.tensor([0.1, 0.6, -0.4])
    ligs = torch.tensor([-0.3, 0.2, 1.0])
    out = tframe.make_burst_fn("heat", cfg, keep_frames=True)(g, t, cams, ligs)
    assert out["frames"].shape == (3, CFG.height, CFG.width, 3)
    assert not torch.equal(out["frames"][0], out["frames"][2])
    zero = torch.zeros(())
    for i in range(3):
        look_from = torch.stack([torch.sin(cams[i]), zero, torch.cos(cams[i])])
        light = torch.stack([torch.sin(ligs[i]), zero, torch.cos(ligs[i])])
        one = tframe.render_frame(g, t, light, look_from, torch.zeros(3),
                                  torch.tensor([0.0, 1.0, 0.0]), pipeline="heat", config=cfg)
        assert torch.equal(out["frames"][i], one["frame"])


def test_scene_vertex_attrs():
    """Scene(vertex_attrs=) takes a bare name or "attr:<name>" and renders
    what render_frame renders with the attribute in the geometry."""
    model = Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))
    corners = model.mesh.positions[model.mesh.pos_idx]
    vals = (0.5 + 0.5 * np.sin(3.0 * corners[..., 0]))[..., None]
    cfg = RenderConfig(width=128, height=64)
    frames = []
    for key in ("heat", "attr:heat"):
        scene = Scene(model, "heat", config_from(cfg), device="cpu", vertex_attrs={key: vals})
        scene.set_light_direction(VIEW[0])
        frames.append(scene.get_frame_buffer())
    np.testing.assert_array_equal(frames[0], frames[1])
    assert (frames[0] > 0).any(-1).mean() > 0.05
    with pytest.raises(ValueError, match="attr:heat"):
        Scene(model, "heat", config_from(cfg), device="cpu").render()


def test_custom_attr_missing_or_misshapen_raises():
    with pytest.raises(ValueError, match="attr:heat"):
        port_frame("heat", geom=GEOM)
    bad = {**GEOM, "attr:heat": np.zeros((7, 3, 1), np.float32)}
    with pytest.raises(ValueError, match="num_triangles"):
        port_frame("heat", geom=bad)


def test_attr_refused_under_full_screen_shade():
    """Reference behaviour: the JAX package fails on attr: varyings under
    compact_shade=False (pack_triangle_records has no source for them); the
    port refuses the same configuration before any launch."""
    cfg = dataclasses.replace(CFG, compact_shade=False)
    with pytest.raises(KeyError, match="attr:heat"):
        jax_frame("heat", cfg)
    with pytest.raises(ValueError, match="compact_shade"):
        port_frame("heat", cfg)


KNOBS = {
    "fullplane": dict(compact_shade=False),
    "planes": dict(strip_planes=True),
    "mask": dict(strip_mask=True),
    "mask+planes": dict(strip_mask=True, strip_planes=True),
    "i16": dict(idx_int16=True),
    "nocsr": dict(csr_indirect=False),
    "nopack": dict(strip_pack_words=False),
}
KNOB_CASES = [pytest.param(p, KNOBS[k], id=f"{p}-{k}") for p in ("toon", "fog") for k in KNOBS]
KNOB_CASES += [pytest.param("fog", dict(fuse_passes=True), id="fog-fuse"),
               pytest.param("heat", KNOBS["mask+planes"], id="heat-mask+planes"),
               pytest.param("heat", KNOBS["nocsr"], id="heat-nocsr")]


@functools.cache
def default_frame(pipeline):
    return port_frame(pipeline, needs_z=False)


@pytest.mark.parametrize("pipeline,knobs", KNOB_CASES)
def test_knob_frames_bit_identical(pipeline, knobs):
    want = default_frame(pipeline)
    got = port_frame(pipeline, dataclasses.replace(CFG, **knobs), needs_z=False)
    np.testing.assert_array_equal(got["frame"], want["frame"])
    np.testing.assert_array_equal(got["shadow"], want["shadow"])


def test_fog_planes_spec_is_texidx_and_zfrag():
    """strip_planes on a two_pass custom pipeline gives the phase-2 layout
    texidx + zfrag (chip_smoke holds it to its twin on the card)."""
    _, t = scene_arrays(GEOM, TEX, "cpu")
    cfg = config_from(dataclasses.replace(CFG, strip_planes=True)).resolve("fog")
    assert tframe._planes_spec("fog", t, cfg) == (("texidx", 1, "texidx:64:64"), ("zfrag", 1, "zfrag"))
    assert tframe._planes_spec("heat", t, cfg) is None


def _solid(channel, value):
    def shade(frag, uniforms, textures, config):
        rgb = torch.zeros(frag["intensity"].shape + (3,), dtype=torch.uint8)
        rgb[..., channel] = value
        return rgb
    return shade


SOLID = dict(varying_spec=(("intensity", 1, "interp"),), needs=("vertex_intensity",))


def test_overwrite_takes_effect_at_once():
    tframe.register_pipeline("swap", _solid(0, 200), **SOLID)
    try:
        gen = tframe.registry_generation("swap")
        red = port_frame("swap")["frame"]
        assert (red[..., 0] == 200).any() and not (red[..., 1] == 200).any()
        tframe.register_pipeline("swap", _solid(1, 200), overwrite=True, **SOLID)
        assert tframe.registry_generation("swap") == gen + 1
        green = port_frame("swap")["frame"]
        assert (green[..., 1] == 200).any() and not (green[..., 0] == 200).any()
    finally:
        tframe.unregister_pipeline("swap")


def test_reregister_after_unregister_not_stale():
    tframe.register_pipeline("regen", _solid(0, 10), **SOLID)
    try:
        assert (port_frame("regen")["frame"][..., 0] == 10).any()
        tframe.unregister_pipeline("regen")
        tframe.register_pipeline("regen", _solid(0, 77), **SOLID)
        b = port_frame("regen")["frame"]
        assert (b[..., 0] == 77).any() and not (b[..., 0] == 10).any()
    finally:
        tframe.unregister_pipeline("regen")


def test_unregister_clears_every_table():
    tframe.register_pipeline("tmp", example.shade_toon, varying_spec=(("uv", 2, "interp"),),
                             maps=("texture",))
    tables = (tframe.PIPELINES, tsh.VARYING_SPECS, tsh.PIPELINE_MAPS, tframe._GATHER_KEYS)
    assert all("tmp" in table for table in tables)
    tframe.unregister_pipeline("tmp")
    assert not any("tmp" in table for table in tables)
    tframe.unregister_pipeline("tmp")  # idempotent
    for name in tframe._BUILTIN_PIPELINES:
        with pytest.raises(ValueError, match="built-in"):
            tframe.unregister_pipeline(name)
    assert len(tframe._BUILTIN_PIPELINES) == 7


def test_custom_names_apply_no_tuned_group():
    """A custom name has no tuned group: resolve applies only the
    resolution's span caps, as in the JAX package."""
    base = RenderConfig()
    got = resolve_for_pipeline(config_from(base), "toon")
    assert dataclasses.asdict(got) == dataclasses.asdict(base.resolve("toon"))
    assert (got.tex_tile, got.strip_len, got.max_span_y) == (0, 16, 4)


BAD = {
    "already-registered": ("dup", dict(varying_spec=())),
    "unknown-varying": ("bad", dict(varying_spec=(("wobble", 1, "interp"),))),
    "bad-mode": ("bad", dict(varying_spec=(("uv", 2, "zfrag"),))),
    "uv-components": ("bad", dict(varying_spec=(("uv", 3, "interp"),))),
    "zfrag-components": ("bad", dict(varying_spec=(("zfrag", 2, "zfrag"),))),
    "unknown-need": ("bad", dict(varying_spec=(), needs=("sparkles",))),
    "intensity-without-need": ("bad", dict(varying_spec=(("intensity", 1, "interp"),))),
    "local_z-without-darboux": ("bad", dict(varying_spec=(("local_z", 3, "interp"),))),
    "const-without-darboux": ("bad", dict(varying_spec=(("row0", 3, "const"),))),
    "attr-mode": ("bad", dict(varying_spec=(("attr:x", 1, "const"),))),
    "attr-0-components": ("bad", dict(varying_spec=(("attr:x", 0, "interp"),))),
    "attr-9-components": ("bad", dict(varying_spec=(("attr:x", 9, "interp"),))),
    "attr-str-components": ("bad", dict(varying_spec=(("attr:x", "x", "interp"),))),
    "unregister-built-in": ("shadow", None),
}


@pytest.mark.parametrize("case", list(BAD))
def test_validation_messages_match_jax(case):
    name, kw = BAD[case]
    for frame_mod, shade in ((jframe, j_toon), (tframe, example.shade_toon)):
        frame_mod.register_pipeline("dup", shade, varying_spec=())
    try:
        messages = []
        for frame_mod, shade in ((jframe, j_toon), (tframe, example.shade_toon)):
            with pytest.raises(ValueError) as err:
                if kw is None:
                    frame_mod.unregister_pipeline(name)
                else:
                    frame_mod.register_pipeline(name, shade, **kw)
            messages.append(str(err.value))
        assert messages[0] == messages[1]
        assert "bad" not in tframe.PIPELINES and "bad" not in jframe.PIPELINES
    finally:
        jframe.unregister_pipeline("dup")
        tframe.unregister_pipeline("dup")
