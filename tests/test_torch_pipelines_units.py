"""Torch port: the pieces the six pipelines beside shadow add, one by one against JAX.

rotation_between, the occlusion probe's coordinates and accumulation,
darboux's full-screen shade with its per-triangle constant gather, the
unpacked samplers, compute_varyings' local_z, and the entry points that
now take every pipeline name.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_frame import CFG, GEOM, VIEW, _tiny_assets
from test_torch_pipelines import MAPS
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.ops import mathlib as jml
from tiny_renderer_tpu.ops.vertex import triangle_setup as jsetup
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu.pipelines import shaders as jsh
from tiny_renderer_tpu_torch import PIPELINE_NAMES, Scene
from tiny_renderer_tpu_torch import app as tapp
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.assets.model import Model
from tiny_renderer_tpu_torch.ops import mathlib as tml
from tiny_renderer_tpu_torch.ops.vertex import triangle_setup as tsetup
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines import shaders as tsh


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_RNG = np.random.default_rng(5)
ROTATIONS = {
    "aligned": ([0.0, 0.0, 1.0], [0.0, 0.0, 2.5]),
    "opposite": ([0.0, 0.0, 1.0], [0.0, 0.0, -0.7]),
    "near-aligned": ([0.0, 0.0, 1.0], [1e-8, 0.0, 1.0]),
    **{f"generic{i}": ([0.0, 0.0, 1.0], _RNG.normal(size=3).tolist()) for i in range(3)},
    "generic-both": (_RNG.normal(size=3).tolist(), _RNG.normal(size=3).tolist()),
}


@pytest.mark.parametrize("name", list(ROTATIONS))
def test_rotation_between_matches_jax(name):
    a, b = (np.array(v, np.float32) for v in ROTATIONS[name])
    want = jml.rotation_between(a, b, np)
    got = tml.rotation_between(_t(a), _t(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if name == "aligned":
        np.testing.assert_array_equal(got, np.eye(3, dtype=np.float32))
    if name == "opposite":
        np.testing.assert_array_equal(got, np.diag(np.float32([1, -1, -1])))
    if name.startswith("generic"):  # a rotation taking a's direction to b's
        np.testing.assert_allclose(got @ (a / np.linalg.norm(a)), b / np.linalg.norm(b), atol=1e-5)


def _occlusion_inputs(seed, n=2000):
    """Seeded fragments on screen, both packages' occlusion uniforms."""
    rng = np.random.default_rng(seed)
    cfg = RenderConfig(width=256, height=128)
    xf = rng.uniform(0, 255, n).astype(np.float32)
    yf = rng.uniform(0, 127, n).astype(np.float32)
    zf = rng.uniform(0, 255, n).astype(np.float32)
    light = np.array([0.4, 0.2, 0.9], np.float32)

    def uniforms(m, xp, view):
        u1 = m.shadow_pass_1_prepare(cfg, view[0], view[2], view[3], *xp)
        u = m.shadow_pass_2_prepare(cfg, *view, *xp)
        u["shadow_matrix"] = u1["shadow_matrix"]
        return u

    view = (light, *VIEW[1:])
    return cfg, (xf, yf, zf), uniforms(jml, (np,), view), uniforms(tml, (), tuple(_t(v) for v in view))


@pytest.mark.parametrize("seed", [0, 1])
def test_occlusion_sample_coords_match_jax(seed):
    """The 17 probe coordinates, held within the last ulps that acos/sin/cos
    in rotation_between may differ by (on these seeds they are equal)."""
    cfg, (xf, yf, zf), ju, tu = _occlusion_inputs(seed)
    wx, wy = jsh.occlusion_sample_coords(xf, yf, zf, ju, cfg, np)
    gx, gy = tsh.occlusion_sample_coords(_t(xf), _t(yf), _t(zf), tu, config_from(cfg))
    assert gx.shape == (cfg.occlusion_samples + 1, xf.size) and gx.dtype == torch.float32
    np.testing.assert_allclose(gx.numpy(), wx, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(gy.numpy(), wy, rtol=1e-6, atol=1e-3)
    # Row n, the fragment's own coordinate, has no transcendental in it.
    np.testing.assert_array_equal(gx.numpy()[-1], wx[-1])
    np.testing.assert_array_equal(gy.numpy()[-1], wy[-1])


@pytest.mark.parametrize("seed", [0, 1])
def test_occlusion_update_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cfg = RenderConfig()
    n = cfg.occlusion_samples
    svals = rng.uniform(-5, 260, (n, 3000)).astype(np.float32)
    fval = rng.uniform(-5, 260, 3000).astype(np.float32)
    svals[:, :100] = tml.F32_MIN  # samples off the light's coverage
    fval[100:200] = tml.F32_MIN
    want = jsh.occlusion_update(svals, fval, cfg, np)
    got = tsh.occlusion_update(_t(svals), _t(fval), config_from(cfg)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < 1).mean() > 0.1


def test_occlusion_coefficient_matches_jax():
    """The probe over a seeded shadow plane: the gathered values and the
    coefficient agree on all but the fragments whose probe index moved by
    the ulps of rotation_between."""
    cfg, (xf, yf, zf), ju, tu = _occlusion_inputs(2)
    plane = np.random.default_rng(3).uniform(0, 255, (cfg.height, cfg.width)).astype(np.float32)
    want = jsh.occlusion_coefficient(xf, yf, zf, plane, ju, cfg, np)
    got = tsh.occlusion_coefficient(_t(xf), _t(yf), _t(zf), _t(plane), tu, config_from(cfg)).numpy()
    assert (got != want).mean() < 0.005
    assert (got < 1).mean() > 0.1


def test_shade_darboux_const_gather_matches_jax():
    """The full-screen darboux shade: the kernel planes (texidx + local_z)
    plus the per-triangle constants by _add_const_gather, fed with the same
    planes to both packages."""
    cfg = CFG.resolve("darboux")
    tex_np = MAPS["same"]
    g, t = scene_arrays(GEOM, tex_np, "cpu")
    t = tframe.prepack_textures(t, "darboux", tile=cfg.tex_tile)
    tcfg = config_from(cfg)
    tu = tml.default_prepare(tcfg, *(to_tensor(v, "cpu") for v in VIEW))
    ts = tsetup(g, tu, tcfg, needs=("darboux",))
    kspec = tsh.kernel_varying_spec("darboux", t, tile=cfg.tex_tile)
    assert [n for n, _, _ in kspec] == ["texidx", "local_z"]
    _z, idx, varys, _s, _o = tframe._rasterize(ts, tcfg, spec=kspec, emit_z=False)
    frag = tframe._fragments_from_planes(kspec, varys, cfg.height, cfg.width)
    tframe._add_const_gather(frag, kspec, tsh.VARYING_SPECS["darboux"], ts, idx)
    got = tsh.shade_darboux(frag, tu, t, tcfg).numpy()

    ju = jml.default_prepare(cfg, *(jnp.asarray(v) for v in VIEW), jnp)
    js = jsetup({k: jnp.asarray(v) for k, v in GEOM.items()}, ju, cfg, needs=("darboux",), xp=jnp)
    jt = jframe.prepack_textures({k: jnp.asarray(v) for k, v in tex_np.items()}, "darboux",
                                 tile=cfg.tex_tile)
    jfrag = jframe._fragments_from_planes(kspec, jnp.asarray(varys.numpy()), cfg.height, cfg.width)
    jframe._add_const_gather(jfrag, kspec, jsh.VARYING_SPECS["darboux"], js, jnp.asarray(idx.numpy()))
    for name in ("row0", "row1", "du", "dv"):
        np.testing.assert_array_equal(frag[name].numpy(), np.asarray(jfrag[name]), err_msg=name)
    want = np.asarray(jsh.shade_darboux(jfrag, ju, jt, cfg, jnp))
    covered = idx.numpy() >= 0
    assert covered.mean() > 0.05
    assert (got[covered] != want[covered]).any(-1).mean() < 0.005


@pytest.mark.parametrize("names", [("texture",), ("texture", "normal_map"),
                                   ("texture", "normal_map", "specular_map"),
                                   ("texture", "normal_map_tangent"), ("specular_map",)])
@pytest.mark.parametrize("maps", ["same", "mixed", "tangent-quirk"])
def test_unpacked_samplers_match_jax(names, maps):
    """sample_maps without a packed plane: the channel-concat gather (dims
    agree) or the per-map samplers (dims differ), uv in and out of [0, 1]."""
    tex = dict(MAPS["mixed" if maps == "mixed" else "same"])
    if maps == "tangent-quirk":  # texel coords from normal_map's dims, fetch clamped to the tangent map's
        tex["normal_map_tangent"] = tex["normal_map_tangent"][:16, :48]
    uv = np.random.default_rng(4).uniform(-0.2, 1.2, (500, 2)).astype(np.float32)
    want = jsh.sample_maps(tex, uv, names, np)
    got = tsh.sample_maps({k: _t(v) for k, v in tex.items()}, _t(uv), names)
    for n in names:
        np.testing.assert_array_equal(got[n].numpy(), want[n], err_msg=n)


def test_compute_varyings_reads_local_z_from_t_norm():
    rng = np.random.default_rng(6)
    frag = {"bar": rng.uniform(0, 1, (40, 3)).astype(np.float32),
            "uv": rng.uniform(0, 1, (40, 3, 2)).astype(np.float32),
            "t_norm": rng.normal(size=(40, 3, 3)).astype(np.float32),
            **{k: rng.normal(size=(40, c)).astype(np.float32)
               for k, c in (("row0n", 3), ("row1n", 3), ("du", 2), ("dv", 2))}}
    spec = jsh.VARYING_SPECS["darboux"]
    want = jsh.compute_varyings(frag, spec, np)
    got = tsh.compute_varyings({k: _t(v) for k, v in frag.items()}, spec)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_pipeline_tables_match_jax():
    assert PIPELINE_NAMES == tuple(jframe.PIPELINES)
    assert tsh.VARYING_SPECS == jsh.VARYING_SPECS
    assert tsh.PIPELINE_MAPS == jframe._PIPELINE_MAPS
    assert tframe._GATHER_KEYS == jframe._GATHER_KEYS
    for name, spec in tframe.PIPELINES.items():
        want = jframe.PIPELINES[name]
        assert (spec.needs, spec.two_pass) == (want.needs, want.two_pass), name


@pytest.mark.parametrize("pipeline", PIPELINE_NAMES)
def test_scene_renders_every_pipeline(pipeline):
    model = Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))
    scene = Scene(model, pipeline, RenderConfig(width=128, height=64), device="cpu")
    scene.set_light_direction(VIEW[0])
    frame = scene.get_frame_buffer()
    assert frame.shape == (64, 128, 3) and (frame > 0).any()
    assert scene.get_shadow_buffer().shape == (64, 128, 3)
    seq = scene.render_sequence([0.0, 0.3], [0.0, -0.3])
    assert seq.shape == (2, 64, 128, 3) and (seq > 0).any()


def test_app_writes_png_for_darboux_on_cpu(tmp_path):
    (tmp_path / "assets").mkdir()
    assets = _tiny_assets(tmp_path / "assets")
    png = tmp_path / "out.png"
    rc = tapp.main(["-p", str(assets), "-s", "darboux", "--size", "128", "64", "--frames", "2",
                    "--save", str(png), "--backend", "cpu"])
    assert rc == 0
    data = png.read_bytes()
    assert data.startswith(b"\x89PNG") and len(data) > 100


def test_app_accepts_every_pipeline_name():
    parser = tapp.build_arg_parser()
    for name in PIPELINE_NAMES:
        assert parser.parse_args(["-s", name]).pipeline == name
    with pytest.raises(SystemExit):
        parser.parse_args(["-s", "toon"])
