"""Torch port: the sharded example (examples.sharded_render) on the CPU.

Run in process, on a small procedural sphere in place of the flagship
stand-in (whose 5,096 triangles make the CPU twin raster slow): on the
kernel backend at 160x160 over 5 shards (32 rows each, the default tile
height), on the dense backend at 64x64 over 8; plain and --pipelined.  Each
PNG must equal, byte for byte, the PNG of the same frame rendered on one
device.  Bad flags exit with a message and no traceback.
"""

import numpy as np
import pytest
import torch

from tiny_renderer_tpu_torch import Model, RenderConfig
from tiny_renderer_tpu_torch import app
from tiny_renderer_tpu_torch.convert import scene_arrays, to_tensor
from tiny_renderer_tpu_torch.examples import sharded_render
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.ops.vertex import expand_geometry
from tiny_renderer_tpu_torch.pipelines.frame import render_frame
from tiny_renderer_tpu_torch.utils.png import png_bytes

CASES = {"kernel": ["--size", "160", "--shards", "5"], "dense": ["--size", "64", "--shards", "8"]}
MODEL = Model(mesh=make_uv_sphere(0.45, 14, 18), **make_textures(64))


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(app, "flagship_model", lambda: MODEL)


@pytest.fixture(scope="module")
def scene():
    model = MODEL
    m = model.mesh
    g, t = scene_arrays(
        {"positions": m.positions, "tex_coords": m.tex_coords, "normals": m.normals,
         "pos_idx": m.pos_idx, "tex_idx": m.tex_idx, "normal_idx": m.normal_idx},
        {"texture": model.texture, "normal_map": model.normal_map,
         "normal_map_tangent": model.normal_map_tangent, "specular_map": model.specular_map},
        "cpu",
    )
    return expand_geometry(g), t


def _direct_png(scene, size, backend, light, look_from):
    g, t = scene
    out = render_frame(g, t, to_tensor(np.float32(light), "cpu"),
                       to_tensor(np.float32(look_from), "cpu"), torch.zeros(3),
                       torch.tensor([0.0, 1.0, 0.0]), pipeline="shadow",
                       config=RenderConfig(width=size, height=size), needs_z=False,
                       backend=backend)
    return png_bytes(out["frame"].numpy()[::-1])


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_example_png_equals_direct_render(tmp_path, capsys, scene, backend):
    out = tmp_path / "sharded.png"
    sharded_render.main(CASES[backend] + ["--device", "cpu", "--backend", backend,
                                          "--out", str(out)])
    assert "overflow=False" in capsys.readouterr().out
    size = int(CASES[backend][1])
    want = _direct_png(scene, size, backend, sharded_render.LIGHT, sharded_render.LOOK_FROM)
    assert out.read_bytes() == want


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_example_pipelined_pngs_equal_direct_renders(tmp_path, capsys, scene, backend):
    out = tmp_path / "pp.png"
    sharded_render.main(CASES[backend] + ["--device", "cpu", "--backend", backend,
                                          "--out", str(out), "--pipelined"])
    assert "overflow=[False, False, False]" in capsys.readouterr().out
    size = int(CASES[backend][1])
    angles = np.linspace(0.0, 0.9, sharded_render.N_PIPELINED, dtype=np.float32)
    pngs = [(tmp_path / f"pp-{i}.png").read_bytes() for i in range(len(angles))]
    for i, a in enumerate(angles):
        want = _direct_png(scene, size, backend, [np.sin(a + 0.35), 0.0, np.cos(a + 0.35)],
                           [np.sin(a + 0.25), 0.0, np.cos(a + 0.25)])
        assert pngs[i] == want, f"frame {i}"
    assert pngs[0] != pngs[2]


@pytest.mark.parametrize("args,msg", [
    (["--size"], "--size needs a value"),
    (["--size", "abc"], "--size must be an integer"),
    (["--size", "100", "--shards", "8"], "positive multiple of the mesh's row axis"),
    (["--size", "160", "--pipelined", "--replicate-pass1"], "mutually exclusive"),
    (["--size", "100"], "shard height 20 not divisible by tile_h 32"),
])
def test_example_flag_errors(tmp_path, args, msg):
    with pytest.raises(SystemExit) as e:
        sharded_render.main(args + ["--device", "cpu", "--out", str(tmp_path / "x.png")])
    assert msg in str(e.value.code)
    assert not (tmp_path / "x.png").exists()
