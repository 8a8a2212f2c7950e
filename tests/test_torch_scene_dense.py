"""Torch port: the dense raster backend through the entry points.

Scene(backend="dense"), the CLI's --raster dense, the dense stage profile
and the frame server's --raster dense, each against the port's
render_frame(backend="dense") (the JAX package's "jnp" backend, held to
JAX's rasterize_jnp in test_torch_raster_dense.py) on the CPU at small
sizes: Scene and the CLI equal it bit for bit, the served PNG byte for
byte.  The dense profile has no binning stage, as the JAX profile's jnp
path has none."""

import math
import threading
import urllib.request
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import GEOM, TEX, VIEW, _tiny_assets
from tiny_renderer_tpu import RenderConfig as JRenderConfig
from tiny_renderer_tpu.pipelines import profile as jprofile
from tiny_renderer_tpu_torch import Model, RenderConfig, Scene, load_model
from tiny_renderer_tpu_torch import app as tapp
from tiny_renderer_tpu_torch.convert import to_tensor
from tiny_renderer_tpu_torch.examples import serve_http
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines import profile as tprofile
from tiny_renderer_tpu_torch.utils.png import png_bytes

CFG = RenderConfig(width=128, height=64)
PIPELINES = ("default", "phong", "normal_map", "specular", "darboux", "shadow", "occlusion")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def sphere():
    return Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))


def posed(scene, camera=0.0, light=0.0):
    look_from, look_at, up, light_dir = tapp._angles_to_vectors(camera, light)
    scene.set_camera(look_from, look_at, up)
    scene.set_light_direction(light_dir)
    return scene


def direct(scene, camera=0.0, light=0.0, needs_z=True):
    """render_frame(backend="dense") on the scene's arrays at orbit angles."""
    vecs = tapp._angles_to_vectors(camera, light)
    look_from, look_at, up, light_dir = (to_tensor(np.float32(v), "cpu") for v in vecs)
    return tframe.render_frame(scene._geom, scene._textures, light_dir, look_from, look_at, up,
                               pipeline=scene.pipeline_name, config=scene.config, needs_z=needs_z,
                               backend="dense")


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_scene_dense_equals_render_frame(pipeline):
    scene = posed(Scene(sphere(), pipeline, CFG, device="cpu", backend="dense"), 0.3, -0.4)
    assert scene.backend == "dense"
    got, want = scene.render(), direct(scene, 0.3, -0.4)
    for k in ("frame", "z", "shadow", "overflow"):
        assert torch.equal(got[k], want[k]), k
    assert (got["frame"] > 0).any()
    kernel = posed(Scene(sphere(), pipeline, CFG, device="cpu"), 0.3, -0.4).render()
    assert torch.equal(got["z"] > -1e38, kernel["z"] > -1e38)


def test_scene_dense_sequence_equals_per_frame():
    scene = Scene(sphere(), "shadow", CFG, device="cpu", backend="dense")
    seq = scene.render_sequence([0.1, 0.5], [-0.2, 0.3])
    for i, (c, l) in enumerate(((0.1, -0.2), (0.5, 0.3))):
        frame = direct(scene, c, l, needs_z=False)["frame"].numpy()[::-1]
        np.testing.assert_array_equal(seq[i], frame)


def test_scene_refuses_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        Scene(sphere(), "phong", CFG, device="cpu", backend="jnp")


def test_cli_raster_dense(tmp_path):
    assets = str(_tiny_assets(tmp_path))
    png = tmp_path / "dense.png"
    assert tapp.main(["-p", assets, "-s", "shadow", "--size", "128", "64", "--frames", "1",
                      "--backend", "cpu", "--raster", "dense", "--no-fps", "--save", str(png)]) == 0
    scene = posed(Scene(load_model(assets, verbose=False), "shadow", CFG, device="cpu"))
    want = direct(scene)["frame"].numpy()[::-1]
    assert png.read_bytes() == png_bytes(want)
    seq = tmp_path / "seq"
    assert tapp.main(["-p", assets, "-s", "phong", "--size", "128", "64", "--frames", "2",
                      "--backend", "cpu", "--raster", "dense", "--no-fps", "--save-seq", str(seq)]) == 0
    assert len(list(seq.iterdir())) == 2
    help_text = tapp.build_arg_parser().format_help()
    assert "--raster {kernel,dense}" in help_text and "jnp" in help_text


def test_dense_stage_breakdown_has_no_binning():
    scene = Scene(sphere(), "shadow", CFG, device="cpu", backend="dense")
    deltas, cumulative = tprofile.stage_breakdown(scene, iters=2)
    assert list(cumulative) == ["vertex", "raster", "full"] == list(tprofile.stages("dense"))
    assert list(deltas) == ["vertex", "raster", "full", "uniforms", "fetch"]
    assert sum(deltas[s]["host"] for s in cumulative) == pytest.approx(cumulative["full"]["host"])
    lines = []
    tprofile.print_stage_breakdown(scene, iters=2, out=lines.append)
    assert "dense raster" in lines[0] and not any("binning" in line for line in lines)
    # The dense prefixes launch no tile raster and no binning.
    fn = tprofile._prefix_fn("shadow", scene.config, "raster", "dense")
    with mock.patch.object(tprofile, "bin_triangles", side_effect=AssertionError), \
            mock.patch.object(tframe.raster_cuda, "rasterize", side_effect=AssertionError):
        idx = fn(scene._geom, scene._textures, *(to_tensor(np.float32(v), "cpu") for v in VIEW))
    assert idx.shape == (CFG.height, CFG.width)


def test_jax_dense_profile_has_no_binning_stage():
    """JAX's jnp "bin" prefix is its vertex prefix: no binning work."""
    cfg = JRenderConfig(width=64, height=32)
    args = ({k: jnp.asarray(v) for k, v in GEOM.items()}, {k: jnp.asarray(v) for k, v in TEX.items()},
            *(jnp.asarray(v) for v in VIEW))
    vertex = jprofile._prefix_fn("shadow", cfg, "jnp", "vertex")(*args)
    binned = jprofile._prefix_fn("shadow", cfg, "jnp", "bin")(*args)
    assert float(vertex) == float(binned)


@pytest.fixture(scope="module")
def dense_server():
    srv, service = serve_http.serve(None, port=0, size=64, device="cpu", backend="dense")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("pipeline", ["shadow", "phong"])
def test_server_raster_dense(dense_server, pipeline):
    base, service = dense_server
    with urllib.request.urlopen(f"{base}/render?pipeline={pipeline}&camera=0.9", timeout=120) as r:
        body = r.read()
    assert service.backend == "dense" and service._scenes[pipeline].backend == "dense"
    scene = Scene(service.model, pipeline, RenderConfig(width=64, height=64), device="cpu",
                  backend="dense")
    scene.set_camera([math.sin(0.9), 0.0, math.cos(0.9)], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    scene.set_light_direction([math.sin(-0.6), 0.0, math.cos(-0.6)])
    scene.render()
    assert body == png_bytes(scene.get_frame_buffer())


def test_server_cli_takes_raster(capsys):
    with pytest.raises(SystemExit):
        serve_http.main(["--help"])
    out = capsys.readouterr().out
    assert "--raster {kernel,dense}" in out and "--backend {cuda,cpu}" in out
