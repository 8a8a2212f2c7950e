"""Torch port: the vertex layer's CUDA wrapper (ops/vertex_cuda.py) on the CPU.

No nvcc and no card here, so the kernels themselves are held to their plain
versions by chip_smoke.py's vertex phase.  Here: the prepare kernel's packed
buffer, packed from the plain uniforms and unpacked to views, equals
frame._uniforms key for key and bit for bit for every built-in pipeline, and
frames rendered from those views equal the plain frames (so every key the
setups and the shades read is in the buffer); the setup buffers' layout
gives back setup_reference's outputs; the wrapper refuses a wrong dtype,
shape, contiguity or device before any launch; CPU tensors take the plain
path and never reach the library; launches made under a capture count at
each replay, apart from raster_cuda.LAUNCHES.
"""

import numpy as np
import pytest
import torch

from tiny_renderer_tpu_torch import Model, RenderConfig, Scene
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.ops import mathlib as ml
from tiny_renderer_tpu_torch.ops import raster_cuda, vertex_cuda
from tiny_renderer_tpu_torch.ops.vertex import EXACT_COORD_MAX, gather_triangles, setup_reference, triangle_setup
from tiny_renderer_tpu_torch.pipelines import frame as tframe

PIPELINES = ("default", "phong", "normal_map", "specular", "darboux", "shadow", "occlusion")
CFG = RenderConfig(width=64, height=64)
VIEW = ([0.3, 0.2, 0.95], [0.2, 0.1, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
NEEDS = ((), ("face_intensity",), ("vertex_intensity",), ("face_intensity", "vertex_intensity"))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def views():
    return [torch.tensor(v, dtype=torch.float32) for v in VIEW]


def scene(pipeline):
    model = Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))
    s = Scene(model, pipeline, CFG, device="cpu")
    s.set_light_direction(VIEW[0])
    s.set_camera(*VIEW[1:])
    return s


def bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def assert_bit_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(bits(got[k]), bits(want[k])), k


def pack_prepares(monkeypatch):
    """The prepares return their uniforms as the CUDA path does: views into
    one buffer of vertex_cuda's layout (here packed from the plain ones)."""

    def default(config, light_direction, look_from, look_at, up):
        u = ml.prepare_reference(config, light_direction, look_from, look_at, up)
        return vertex_cuda.unpack(vertex_cuda.pack(u))

    def pass_2(config, light_direction, look_from, look_at, up):
        u = ml.prepare_reference(config, light_direction, look_from, look_at, up, inverses=True)
        return vertex_cuda.unpack(vertex_cuda.pack(u, inverses=True), inverses=True)

    monkeypatch.setattr(ml, "default_prepare", default)
    monkeypatch.setattr(ml, "shadow_pass_2_prepare", pass_2)


@pytest.fixture
def no_library(monkeypatch):
    """Any use of the kernels' library raises."""

    def refuse():
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(vertex_cuda, "_library", refuse)


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_packed_uniforms_equal_plain(pipeline, monkeypatch):
    spec = tframe.PIPELINES[pipeline]
    cfg = CFG.resolve(pipeline)
    want = tframe._uniforms(spec, cfg, *views())
    pack_prepares(monkeypatch)
    got = tframe._uniforms(spec, cfg, *views())
    assert (got[0] is None) == (want[0] is None) == (not spec.two_pass)
    for g, w in zip(got, want):
        if w is not None:
            assert_bit_equal(g, w)
    u = got[1]
    assert u["vpmv"].untyped_storage().data_ptr() == u["t_light_direction"].untyped_storage().data_ptr()
    keys = {k for k, _ in vertex_cuda.uniform_layout(spec.two_pass)}
    assert set(u) == (keys | {"shadow_matrix"} if spec.two_pass else keys)
    if spec.two_pass:
        assert u["shadow_matrix"] is got[0]["vpmv"]


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_frame_from_packed_uniforms(pipeline, monkeypatch):
    """Every key the setups and the pipeline's shade read is in the buffer's
    views, and the frame they give is the plain frame."""
    s = scene(pipeline)
    args = (s._geom, s._textures, *views())
    want = tframe.render_frame(*args, pipeline=pipeline, config=s.config)
    pack_prepares(monkeypatch)
    got = tframe.render_frame(*args, pipeline=pipeline, config=s.config)
    for k in ("frame", "z", "shadow", "overflow"):
        assert torch.equal(got[k], want[k]), k
    assert (got["frame"] > 0).any()


@pytest.mark.parametrize("needs", NEEDS)
def test_setup_layout(needs):
    """The setup kernel's buffers, filled in their layout from
    setup_reference's outputs, give those outputs back through the
    wrapper's views."""
    s = scene("shadow")
    tris = gather_triangles(s._geom)
    u = ml.shadow_pass_2_prepare(s.config, *views())
    want = setup_reference(tris, u, s.config, needs=needs)
    T = tris["pos"].shape[0]
    ints = torch.cat([want[k].reshape(-1) for k, _ in vertex_cuda.SETUP_INTS])
    floats = [want[k].reshape(-1) for k, _ in vertex_cuda.SETUP_FLOATS]
    if "vertex_intensity" in needs:
        floats.append(want["intensity"].reshape(-1))
    elif "face_intensity" in needs:
        floats.append(want["intensity"][:, 0])
    floats = torch.cat(floats)
    assert ints.numel() == vertex_cuda._size(vertex_cuda.SETUP_INTS) * T == 17 * T
    per_tri = vertex_cuda._INTENSITY[intensity_of(needs)][1]
    assert floats.numel() == (vertex_cuda._size(vertex_cuda.SETUP_FLOATS) + per_tri) * T
    got = vertex_cuda.setup_outputs(ints, floats, want["valid"], want["coord_overflow"], intensity_of(needs))
    assert_bit_equal(got, want)
    for k, v in got.items():
        if k != "intensity" or per_tri == 3:
            assert v.is_contiguous(), k
    if per_tri == 1:
        assert got["intensity"].stride() == want["intensity"].stride()


def intensity_of(needs):
    return ("vertex_intensity" if "vertex_intensity" in needs
            else "face_intensity" if "face_intensity" in needs else None)


def _prepare_args(**change):
    args = dict(zip(("light_direction", "look_from", "look_at", "up"), views()))
    args.update(change)
    return args


@pytest.mark.parametrize("case,match", [
    ("dtype", "float32"),
    ("shape", r"\(3\)"),
    ("contiguity", "non-contiguous"),
    ("device", "on cpu"),
])
def test_prepare_refuses(case, match, no_library):
    bad = {"dtype": torch.zeros(3, dtype=torch.float64),
           "shape": torch.zeros(4),
           "contiguity": torch.zeros(6)[::2],
           "device": torch.zeros(3)}[case]
    with pytest.raises(ValueError, match=match):
        vertex_cuda.prepare(CFG, **_prepare_args(up=bad))


@pytest.mark.parametrize("case,match", [
    ("pos dtype", "pos: .*float32"),
    ("uv shape", r"uv_raw: .*x3x2\)"),
    ("matrix contiguity", "shadow_matrix: .*non-contiguous"),
    ("camera_direction missing", "camera_direction"),
    ("device", "on cpu"),
])
def test_setup_refuses(case, match, no_library):
    s = scene("shadow")
    tris = dict(gather_triangles(s._geom))
    u = dict(ml.shadow_pass_2_prepare(s.config, *views()))
    u["shadow_matrix"] = u["vpmv"]
    kw = dict(matrix_key="shadow_matrix", cull=False)
    if case == "pos dtype":
        tris["pos"] = tris["pos"].double()
    elif case == "uv shape":
        tris["uv_raw"] = tris["uv_raw"][:, :2]
    elif case == "matrix contiguity":
        u["shadow_matrix"] = u["vpmv"].t()
    elif case == "camera_direction missing":
        del u["camera_direction"]
        kw = dict(cull=True)
    with pytest.raises((ValueError, KeyError), match=match):
        vertex_cuda.setup(tris, u, s.config, exact_max=EXACT_COORD_MAX, **kw)


@pytest.mark.parametrize("pipeline", ("default", "shadow"))
def test_cpu_tensors_take_the_plain_path(pipeline, no_library):
    vertex_cuda.reset_launches()
    s = scene(pipeline)
    cfg = s.config
    l, f, a, up = views()
    assert_bit_equal(ml.default_prepare(cfg, l, f, a, up), ml.prepare_reference(cfg, l, f, a, up))
    u2 = ml.shadow_pass_2_prepare(cfg, l, f, a, up)
    assert_bit_equal(u2, ml.prepare_reference(cfg, l, f, a, up, inverses=True))
    spec = tframe.PIPELINES[pipeline]
    setup = triangle_setup(s._geom, u2, cfg, needs=spec.needs)
    want = setup_reference(gather_triangles(s._geom), u2, cfg, needs=spec.needs)
    assert_bit_equal({k: setup[k] for k in want}, want)
    s.render()
    assert (s.get_frame_buffer() > 0).any()
    assert vertex_cuda.LAUNCHES == {"prepare": 0, "setup": 0}


def test_launches_count_at_each_replay():
    """A launch under a capture counts into the capture's dict of vertex
    launches, none into raster_cuda's or into LAUNCHES; each replay adds
    them to vertex_cuda.LAUNCHES."""
    vertex_cuda.reset_launches()
    raster_before = dict(raster_cuda.LAUNCHES)
    with raster_cuda.recording() as raster, vertex_cuda.recording() as vertex:
        for kernel in ("prepare", "prepare", "setup", "setup"):
            raster_cuda.launch_counts(vertex_cuda.LAUNCHES)[kernel] += 1
    assert vertex == {"prepare": 2, "setup": 2} and not any(raster.values())
    assert vertex_cuda.LAUNCHES == {"prepare": 0, "setup": 0}
    for _ in range(3):
        vertex_cuda.replayed(vertex)
    assert vertex_cuda.LAUNCHES == {"prepare": 6, "setup": 6}
    assert raster_cuda.LAUNCHES == raster_before
    raster_cuda.launch_counts(vertex_cuda.LAUNCHES)["setup"] += 1  # outside a capture
    assert vertex_cuda.LAUNCHES["setup"] == 7
    vertex_cuda.reset_launches()


def test_viewport_projection_is_the_stack_constants():
    vp, pr = ml.viewport_projection(800, 600, 255, -0.2)
    assert vp.dtype == pr.dtype == np.float32
    assert vp[0, 0] == vp[0, 3] == np.float32(799) / np.float32(2)
    assert vp[1, 1] == np.float32(599) / np.float32(2) and vp[2, 2] == np.float32(255) / np.float32(2)
    assert pr[3, 2] == np.float32(-0.2) and np.array_equal(np.delete(pr.ravel(), 14), np.eye(4).ravel()[[
        i for i in range(16) if i != 14]])
