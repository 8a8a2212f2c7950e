"""Torch port: the shadow frame slice end to end against the JAX package.

The JAX frame runs eagerly on the kernel path in interpret mode
(backend="pallas_interpret"); its strip shade runs inside a compiled
while_loop where XLA may contract mul+add into FMAs, so frames are held to
the repo's oracle tie-flip budget: fewer than 0.5% of pixels differ.
Shadow-map and z coverage are integer-exact and must match exactly.
"""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.models.procedural import make_textures, make_uv_sphere, to_geom
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu_torch import Model, Scene, load_model
from tiny_renderer_tpu_torch import app as tapp
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.ops import mathlib as tml
from tiny_renderer_tpu_torch.pipelines import frame as tframe

CFG = RenderConfig(width=256, height=128)
VIEW = tuple(np.array(v, np.float32) for v in
             ([0.3, 0.0, 0.95], [0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene_np():
    rng = np.random.default_rng(0)
    geom = to_geom(make_uv_sphere(0.45, 14, 18))
    # A second, smaller sphere in front casts a shadow onto the first.
    small = to_geom(make_uv_sphere(0.12, 6, 8))
    n = geom["positions"].shape[0]
    geom = {
        "positions": np.concatenate([geom["positions"], small["positions"] + np.float32([0.15, 0.05, 0.5])]),
        "tex_coords": np.concatenate([geom["tex_coords"], small["tex_coords"]]),
        "normals": np.concatenate([geom["normals"], small["normals"]]),
        **{k: np.concatenate([geom[k], small[k] + n]).astype(np.int32)
           for k in ("pos_idx", "tex_idx", "normal_idx")},
    }
    tex = make_textures(64)
    tex["texture"] = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    return geom, tex


GEOM, TEX = _scene_np()


@pytest.fixture(scope="module")
def jax_frame():
    out = jframe.render_frame(
        {k: jnp.asarray(v) for k, v in GEOM.items()},
        {k: jnp.asarray(v) for k, v in TEX.items()},
        *(jnp.asarray(v) for v in VIEW),
        pipeline="shadow", config=CFG, backend="pallas_interpret",
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _port_frame(needs_z, geom=GEOM, tex=TEX, cfg=CFG):
    g, t = scene_arrays(geom, tex, "cpu")
    out = tframe.render_frame(g, t, *(to_tensor(v, "cpu") for v in VIEW),
                              pipeline="shadow", config=config_from(cfg), needs_z=needs_z)
    return {k: (None if v is None else v.numpy()) for k, v in out.items()}


@pytest.mark.parametrize("needs_z", [True, False])
def test_frame_matches_jax(jax_frame, needs_z):
    out = _port_frame(needs_z)
    assert out["frame"].shape == (CFG.height, CFG.width, 3) and out["frame"].dtype == np.uint8
    covered = (out["frame"] > 0).any(-1).mean()
    assert covered > 0.05
    assert (out["frame"] != jax_frame["frame"]).any(-1).mean() < 0.005
    np.testing.assert_array_equal(out["shadow"] > -1e38, jax_frame["shadow"] > -1e38)
    lit = jax_frame["shadow"] > -1e38
    np.testing.assert_allclose(out["shadow"][lit], jax_frame["shadow"][lit], rtol=1e-5, atol=1e-4)
    assert bool(out["overflow"]) == bool(jax_frame["overflow"])
    if needs_z:
        np.testing.assert_array_equal(out["z"] > -1e38, jax_frame["z"] > -1e38)
    else:
        assert out["z"] is None


def test_frame_is_shadowed():
    """The small sphere darkens part of the big one: some covered pixels are
    lit at shadow_dim (the shadow compare is exercised, not bypassed)."""
    lit = _port_frame(False)["frame"].astype(np.int32)
    cfg = RenderConfig(width=256, height=128, shadow_dim=1.0)
    unshadowed = _port_frame(False, cfg=cfg)["frame"].astype(np.int32)
    darker = (lit.sum(-1) < unshadowed.sum(-1)).mean()
    assert darker > 0.001


def test_prepacked_jax_textures_render_the_same():
    """Textures prepacked by the JAX package (tile-swizzled _pk: plane)
    cross over unchanged and give the same frame."""
    packed = jframe.prepack_textures(
        {k: jnp.asarray(v) for k, v in TEX.items()}, "shadow", tile=16
    )
    assert any(k.startswith("_pk:texture@16") for k in packed)
    a = _port_frame(False)
    b = _port_frame(False, tex={k: np.asarray(v) for k, v in packed.items()})
    np.testing.assert_array_equal(a["frame"], b["frame"])


def test_empty_scene_matches_jax():
    geom = {k: v[:0] for k, v in GEOM.items()}
    want = jframe.render_frame(
        {k: jnp.asarray(v) for k, v in geom.items()}, {k: jnp.asarray(v) for k, v in TEX.items()},
        *(jnp.asarray(v) for v in VIEW), pipeline="shadow", config=CFG, backend="pallas_interpret",
    )
    got = _port_frame(True, geom=geom)
    for k in ("frame", "z", "shadow", "overflow"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_burst_matches_per_frame():
    g, t = scene_arrays(GEOM, TEX, "cpu")
    cfg = config_from(CFG)
    cams = torch.tensor([0.1, 0.6, -0.4], dtype=torch.float32)
    ligs = torch.tensor([-0.3, 0.2, 1.0], dtype=torch.float32)
    out = tframe.make_burst_fn("shadow", cfg, keep_frames=True)(g, t, cams, ligs)
    assert out["frames"].shape == (3, CFG.height, CFG.width, 3)
    look_at, up = torch.zeros(3), torch.tensor([0.0, 1.0, 0.0])
    zero = torch.zeros(())
    for i in range(3):
        look_from = torch.stack([torch.sin(cams[i]), zero, torch.cos(cams[i])])
        light = torch.stack([torch.sin(ligs[i]), zero, torch.cos(ligs[i])])
        one = tframe.make_frame_fn("shadow", cfg)(g, t, light, look_from, look_at, up)
        assert torch.equal(out["frames"][i], one["frame"])
        assert int(out["checksums"][i]) == int(one["frame"].sum(dtype=torch.int64))
        assert bool(out["overflow"][i]) == bool(one["overflow"])


def _tga(path, rgb):
    """Uncompressed 24-bit TGA, bottom-left origin."""
    h, w, _ = rgb.shape
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0)
    path.write_bytes(header + rgb[::-1, :, ::-1].tobytes())


def _tiny_assets(tmp_path):
    (tmp_path / "model.obj").write_text(
        "v -0.5 -0.5 0\nv 0.5 -0.5 0\nv 0 0.5 0\nv -0.3 -0.2 0.3\nv 0.1 -0.2 0.3\nv -0.1 0.1 0.3\n"
        "vt 0 0\nvt 1 0\nvt 0.5 1\n"
        "vn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1\nf 4/1/1 5/2/1 6/3/1\n"
    )
    rng = np.random.default_rng(2)
    for name in ("texture", "normal_map", "normal_map_tangent", "specular_map"):
        _tga(tmp_path / f"{name}.tga", rng.integers(1, 256, (8, 8, 3), dtype=np.uint8))
    return tmp_path


def test_scene_api_on_cpu(tmp_path):
    model = load_model(str(_tiny_assets(tmp_path)), verbose=False)
    scene = Scene(model, "shadow", RenderConfig(width=128, height=64), device="cpu")
    scene.set_camera(*VIEW[1:])
    scene.set_light_direction(VIEW[0])
    scene.render()
    frame = scene.get_frame_buffer()
    assert frame.shape == (64, 128, 3) and (frame > 0).any()
    assert scene.get_z_buffer().shape == (64, 128, 3)
    assert scene.get_shadow_buffer().shape == (64, 128, 3)
    assert scene.overflowed is False
    seq = scene.render_sequence([0.0, 0.3], [0.0, -0.3])
    assert seq.shape == (2, 64, 128, 3)
    with pytest.raises(ValueError):
        Scene(model, "toon", device="cpu")


def test_app_writes_png_on_cpu(tmp_path):
    (tmp_path / "assets").mkdir()
    assets = _tiny_assets(tmp_path / "assets")
    png = tmp_path / "out.png"
    rc = tapp.main(["-p", str(assets), "-s", "shadow", "--size", "128", "64", "--frames", "2",
                    "--orbit", "--save", str(png), "--backend", "cpu"])
    assert rc == 0
    data = png.read_bytes()
    assert data.startswith(b"\x89PNG") and len(data) > 100


def test_scene_z_view_matches_rust_cast():
    model = Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))
    scene = Scene(model, "shadow", RenderConfig(width=128, height=64), device="cpu")
    out = scene.render()
    want = tml.rust_f32_to_u8(out["z"]).numpy()[::-1]
    np.testing.assert_array_equal(scene.get_z_buffer()[..., 0], want)
