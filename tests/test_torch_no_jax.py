"""Torch port: the package never imports jax (the GPU machine has none)."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import torch
    torch.set_num_threads(1)
    import numpy as np
    import tiny_renderer_tpu_torch as trt
    from tiny_renderer_tpu_torch.app import flagship_model
    from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere

    model = trt.Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))
    scene = trt.Scene(model, "shadow", trt.RenderConfig(width=128, height=64), device="cpu")
    scene.set_light_direction([0.3, 0.0, 0.95])
    frame = scene.get_frame_buffer()
    assert frame.shape == (64, 128, 3) and (frame > 0).any()
    for name in ("darboux", "occlusion"):
        other = trt.Scene(model, name, trt.RenderConfig(width=128, height=64), device="cpu")
        other.set_light_direction([0.3, 0.0, 0.95])
        assert (other.get_frame_buffer() > 0).any(), name
    assert flagship_model().num_triangles == 5096
    # The entry points above the frame path.
    import tiny_renderer_tpu_torch.__main__
    import tiny_renderer_tpu_torch.pipelines.profile
    import tiny_renderer_tpu_torch.utils.timing
    import tiny_renderer_tpu_torch.viewer_x11
    from tiny_renderer_tpu_torch.examples import custom_pipeline, serve_http
    custom_pipeline.register()
    glow = trt.Scene(model, "glow", trt.RenderConfig(width=128, height=64), device="cpu",
                     vertex_attrs={"glow": custom_pipeline.glow_attribute(model)})
    assert (glow.get_frame_buffer() > 0).any()
    # The scale-out path and the dense backend.
    from tiny_renderer_tpu_torch.examples import sharded_render
    from tiny_renderer_tpu_torch.ops import raster_dense
    from tiny_renderer_tpu_torch.parallel import make_row_mesh, render_frame_sharded
    g, t = scene._geom, scene._textures
    view = [torch.tensor(v, dtype=torch.float32)
            for v in ([0.3, 0.0, 0.95], [0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])]
    cfg = trt.RenderConfig(width=128, height=64, tile_h=8)
    sharded = render_frame_sharded(g, t, *view, pipeline="shadow", config=cfg,
                                   mesh=make_row_mesh([torch.device("cpu")] * 8))
    assert (sharded["frame"] > 0).any() and not bool(sharded["overflow"])
    from tiny_renderer_tpu_torch.parallel import make_pp_mesh, render_batch_sharded, render_sequence_pipelined
    lights, froms = torch.stack([view[0], view[0]]), torch.stack([view[1], view[1]])
    batch = render_batch_sharded(g, t, lights, froms, view[2], view[3], pipeline="shadow", config=cfg,
                                 mesh=make_row_mesh([torch.device("cpu")] * 8, batch=2))
    seq = render_sequence_pipelined(g, t, lights, froms, view[2], view[3], pipeline="shadow", config=cfg,
                                    mesh=make_pp_mesh([torch.device("cpu")] * 8))
    assert torch.equal(batch["frame"][0], sharded["frame"]) and torch.equal(seq["frame"][1], sharded["frame"])
    # The native asset loader, mesh subdivision, row bands, the dense backend
    # through Scene.
    from tiny_renderer_tpu_torch.assets import mesh_tools, native
    assert native.native_available()
    big = mesh_tools.subdivide_mesh(model.mesh, 1)
    assert big.num_triangles == 4 * model.num_triangles
    banded = trt.Scene(trt.Model(mesh=big, **make_textures(16)), "shadow",
                       trt.RenderConfig(width=128, height=64, tile_h=8, row_bands=3), device="cpu")
    banded.set_light_direction([0.3, 0.0, 0.95])
    assert (banded.get_frame_buffer() > 0).any()
    dense = trt.Scene(model, "phong", trt.RenderConfig(width=64, height=32), device="cpu",
                      backend="dense")
    dense.set_light_direction([0.3, 0.0, 0.95])
    assert (dense.get_frame_buffer() > 0).any()
    loaded = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "tiny_renderer_tpu."))]
    assert loaded == ["jax"] and sys.modules["jax"] is None and "bench" not in sys.modules, loaded
    print("OK", trt.PIPELINE_NAMES)
""")


def test_package_imports_and_renders_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "OK ('default', 'phong', 'normal_map', 'specular', 'darboux', 'shadow', 'occlusion')" in proc.stdout


def test_package_sources_never_import_jax():
    for path in [*(ROOT / "tiny_renderer_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from tiny_renderer_tpu." not in text and "import tiny_renderer_tpu\n" not in text, path
        # Nor the root bench.py (the JAX package's harness).
        assert not re.search(r"^\s*(import bench\b|from bench import)", text, re.M), path
