"""Torch port: the darboux chunk body's CUDA wrapper (ops/darboux_cuda.py) and its dispatch, on the CPU.

No nvcc and no card here, so the kernel itself is held to the torch body by
chip_smoke.py's darboux phase.  Here: the wrapper refuses a wrong dtype,
shape, contiguity or device before any launch; CPU tensors take the torch
body through render_frame, render_burst and Scene.render_sequence and never
reach the library; the body applies only on a CUDA device with the packed
plane (maps of mixed dimensions have none) and only to the built-in spec
(a custom pipeline registered over "darboux" runs its own shade); where it
applies, _shade_strips hands it each chunk's slots, the strip plane, the
accumulator and the frame's geometry in place of the torch body, between
the marks the torch body sets; launches made under a capture count at each
replay, apart from the raster, vertex and occlusion counters."""

import dataclasses

import pytest
import torch

from tiny_renderer_tpu_torch import Model, RenderConfig, Scene
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.ops import darboux_cuda, occlusion_cuda, raster_cuda, vertex_cuda
from tiny_renderer_tpu_torch.ops.vertex import triangle_setup
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines import shaders
from tiny_renderer_tpu_torch.utils import timing

CFG = RenderConfig(width=64, height=32)
VIEW = ([0.4, 0.2, 0.9], [0.2, 0.1, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
# bin_triangles' four steps, then the caller's stage mark.
BINNING = ["binning.keys", "binning.sort", "binning.csr", "binning.records", "binning"]
DARBOUX_MARKS = ["vertex", "darboux_setup", "vertex", *BINNING, "raster", "shade", "darboux", "shade"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_library(monkeypatch):
    """Any use of the kernel's library raises."""

    def refuse():
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(darboux_cuda, "_library", refuse)


def model(size=16, mixed=False):
    maps = make_textures(size)
    if mixed:  # the tangent map at another size: no packed plane
        maps["normal_map_tangent"] = make_textures(2 * size)["normal_map_tangent"]
    return Model(mesh=make_uv_sphere(0.45, 8, 10), **maps)


def scene(config=CFG, mixed=False):
    s = Scene(model(mixed=mixed), "darboux", config, device="cpu")
    s.set_light_direction(VIEW[0])
    s.set_camera(*VIEW[1:])
    return s


def views():
    return [torch.tensor(v, dtype=torch.float32) for v in VIEW]


def chunk_args(**change):
    """A darboux chunk's arguments on the CPU, as _shade_strips passes them."""
    s = scene()
    cfg = s.config
    _, u = tframe._uniforms(tframe.PIPELINES["darboux"], cfg, *views())
    setup = triangle_setup(s._geom, u, cfg, needs=("darboux",))
    pk, tile = shaders._find_pk(s._textures, shaders.PIPELINE_MAPS["darboux"])
    n_strips = cfg.width * cfg.height // cfg.strip_len
    args = dict(setup=setup, strips=torch.full((n_strips, cfg.strip_len), -1, dtype=torch.int32),
                cids=torch.arange(8), acc=torch.zeros((n_strips + 1, cfg.strip_len), dtype=torch.int32),
                plane=pk, tile=tile, light=u["t_light_direction"], width=cfg.width,
                pixels=cfg.width * cfg.height)
    args.update(change)
    return args


@pytest.mark.parametrize("case,match", [
    ("edge dtype", "a1: .*int32"),
    ("edge contiguity", "cz: .*non-contiguous"),
    ("varying shape", r"t_norm: .*\(\d+x3x3\)"),
    ("varying dtype", "du: .*float32"),
    ("light shape", r"light: .*\(3\)"),
    ("strips dtype", "strips: .*int32 or int16"),
    ("strips contiguity", "strips: .*contiguous"),
    ("cids dtype", "cids: .*int64"),
    ("acc shape", "acc: .*int32"),
    ("acc dtype", "acc: .*uint8"),
    ("plane shape", r"plane: .*\(h, w, 2\)"),
    ("device", "on cpu"),
])
def test_chunk_body_refuses(case, match, no_library):
    a = chunk_args()
    setup = dict(a["setup"])
    if case == "edge dtype":
        setup["a1"] = setup["a1"].long()
    elif case == "edge contiguity":
        setup["cz"] = torch.stack([setup["cz"], setup["cz"]], dim=-1)[:, 0]
    elif case == "varying shape":
        setup["t_norm"] = setup["t_norm"][:, :2]
    elif case == "varying dtype":
        setup["du"] = setup["du"].double()
    elif case == "light shape":
        a["light"] = a["light"][:2]
    elif case == "strips dtype":
        a["strips"] = a["strips"].long()
    elif case == "strips contiguity":
        a["strips"] = a["strips"].t()
    elif case == "cids dtype":
        a["cids"] = a["cids"].int()
    elif case == "acc shape":
        a["acc"] = a["acc"][:-1]
    elif case == "acc dtype":
        a["acc"] = a["acc"].to(torch.uint8)
    elif case == "plane shape":
        a["plane"] = a["plane"][..., :1]
    a["setup"] = setup
    darboux_cuda.reset_launches()
    with pytest.raises(ValueError, match=match):
        darboux_cuda.chunk_body(a.pop("setup"), a.pop("strips"), a.pop("cids"), a.pop("acc"), a.pop("plane"),
                                a.pop("tile"), a.pop("light"), **a)
    assert darboux_cuda.LAUNCHES == {"body": 0}


def render_frame(s):
    return tframe.render_frame(s._geom, s._textures, *views(), pipeline="darboux", config=s.config)["frame"]


def render_burst(s):
    angles = torch.tensor([0.1, 0.4], dtype=torch.float32)
    return tframe.render_burst(s._geom, s._textures, angles, angles, pipeline="darboux", config=s.config,
                               keep_frames=True)["frames"]


def render_sequence(s):
    return torch.from_numpy(s.render_sequence([0.1, 0.4], [0.2, 0.3]).copy())


@pytest.mark.parametrize("entry", (render_frame, render_burst, render_sequence))
def test_cpu_tensors_take_the_torch_body(entry, no_library):
    """A darboux frame, burst or sequence on the CPU renders through the
    torch body: no launch is counted, the library is never loaded, and the
    tracer's snapshot shows no darboux launch."""
    darboux_cuda.reset_launches()
    frames = entry(scene())
    assert frames.dtype == torch.uint8 and (frames > 0).any()
    assert darboux_cuda.LAUNCHES == {"body": 0}
    assert timing.snapshot()["darboux_launches"] == {"body": 0}


@pytest.mark.parametrize("device,mixed,applies", [
    ("cpu", False, False),
    ("cuda", False, True),
    ("cuda", True, False),
])
def test_body_applies_on_cuda_with_the_packed_plane(device, mixed, applies, no_library):
    """The fused body is offered only for a CUDA device and the packed plane
    of the pipeline's maps: maps of mixed dimensions are never packed, so
    they keep the torch body (and its tangent sampler's dims quirk)."""
    s = scene(mixed=mixed)
    textures = tframe._with_packed_plane(s._textures, "darboux", s.config)
    assert (shaders._find_pk(textures, shaders.PIPELINE_MAPS["darboux"])[0] is None) == mixed
    body = tframe.PIPELINES["darboux"].fused_body(textures, torch.device(device))
    assert (body is not None) == applies
    if applies:  # a CUDA body given CPU tensors raises before any launch: no fallback
        a = chunk_args()
        darboux_cuda.reset_launches()
        with pytest.raises(ValueError, match="CUDA device"):
            body(a["setup"], a["strips"], a["cids"], a["acc"], {"t_light_direction": a["light"]},
                 width=a["width"], pixels=a["pixels"], y_offset=0)
        assert darboux_cuda.LAUNCHES == {"body": 0}


def test_custom_pipeline_over_darboux_runs_its_own_shade(monkeypatch):
    """A pipeline registered over the name "darboux" has no fused body, so
    its strip shade runs its own shade function on every device; the
    built-in spec is the only one that carries the kernel."""
    for table in (tframe.PIPELINES, shaders.VARYING_SPECS, shaders.PIPELINE_MAPS, tframe._GATHER_KEYS):
        monkeypatch.setitem(table, "darboux", table["darboux"])
    assert tframe.PIPELINES["darboux"].fused_body is shaders.darboux_fused_body

    def solid(frag, uniforms, textures, config):
        return torch.full((*frag["x"].shape, 3), 77, dtype=torch.uint8)

    spec = tframe.register_pipeline("darboux", solid, varying_spec=(("uv", 2, "interp"),),
                                    maps=("texture", "normal_map_tangent"), needs=("darboux",), overwrite=True)
    assert spec.fused_body is None and tframe.PIPELINES["darboux"] is spec
    frame = render_frame(scene())
    assert set(frame.unique().tolist()) == {0, 77}


def cuda_like_body(monkeypatch):
    """The built-in body offered on the CPU as on a CUDA device, with
    darboux_cuda.chunk_body recording its arguments in place of a launch
    (it writes nothing, so the covered pixels stay black)."""
    calls = []
    spec = tframe.PIPELINES["darboux"]
    monkeypatch.setitem(tframe.PIPELINES, "darboux", dataclasses.replace(
        spec, fused_body=lambda textures, device: spec.fused_body(textures, torch.device("cuda"))))
    monkeypatch.setattr(darboux_cuda, "chunk_body", lambda *a, **k: calls.append((a, k)))
    return calls


@pytest.mark.parametrize("strip_batch,bodies", ((512, 1), (8, 3)))
def test_shade_strips_hands_each_chunk_to_the_body(strip_batch, bodies, monkeypatch):
    """Where the body applies, each chunk body of _shade_strips is one call
    of it with the chunk's slot ids, the strip plane, the frame's
    accumulator (packed words, or triples), the packed plane and its tile,
    the light and the frame's geometry; the torch body does not run (its
    gather would read the setup), and the marks keep the torch body's
    labels, in order."""
    calls = cuda_like_body(monkeypatch)
    cfg = dataclasses.replace(CFG, strip_batch=strip_batch)
    s = scene(cfg)
    monkeypatch.setattr(tframe, "_gather_fragments", None)
    ring = timing._Ring(torch.device("cpu"), frames=4)
    timing.enable()
    try:
        with timing.marking(ring) as marks:
            frame = render_frame(s)
        ring.issue(marks, lambda: None)
        (fr,), _ = ring.drain()
    finally:
        timing.disable()
        timing.snapshot()
    assert not frame.any() and len(calls) == bodies
    b = DARBOUX_MARKS.index("raster") + 1  # the first body's first mark
    assert fr["labels"] == DARBOUX_MARKS[:b] + DARBOUX_MARKS[b:b + 2] * bodies + ["shade"]
    rc = s.config.resolve("darboux")
    n_strips = rc.width * rc.height // rc.strip_len
    slots = -(-n_strips // rc.strip_batch) * rc.strip_batch
    pk, tile = shaders._find_pk(s._textures, shaders.PIPELINE_MAPS["darboux"])
    for (args, kw), (start, end) in zip(calls, tframe.shade_chunks(slots, rc.strip_batch)):
        setup, strips, cids, acc, plane, got_tile, light = args
        assert strips.shape == (n_strips, rc.strip_len) and strips.dtype == torch.int32
        assert cids.dtype == torch.int64 and cids.numel() == end - start
        assert acc.shape == (n_strips + 1, rc.strip_len) and acc.dtype == torch.int32
        assert plane is pk and got_tile == tile == rc.tex_tile and light.shape == (3,)
        assert kw == {"width": rc.width, "pixels": rc.width * rc.height, "y_offset": 0}
        assert {"t_norm", "row0n", "row1n", "du", "dv"} <= set(setup)


def test_row_slab_passes_its_first_row(monkeypatch):
    """A row slab's shade (parallel.sharding's, y_offset > 0) gives the body
    the slab's first global row, the slab's pixels and u8 triples under
    strip_pack_words=False."""
    calls = cuda_like_body(monkeypatch)
    s = scene(dataclasses.replace(CFG, strip_pack_words=False))
    rc = s.config.resolve("darboux")
    spec = tframe.PIPELINES["darboux"]
    _, u = tframe._uniforms(spec, rc, *views())
    setup = triangle_setup(s._geom, u, rc, needs=spec.needs)
    tframe._camera_pass_and_shade(setup, u, "darboux", s._textures, rc, "kernel", None, False, rows=16, y0=16)
    (args, kw), = calls
    assert kw == {"width": rc.width, "pixels": 16 * rc.width, "y_offset": 16}
    assert args[3].shape == (16 * rc.width // rc.strip_len + 1, rc.strip_len, 3) and args[3].dtype == torch.uint8


def test_launches_count_at_each_replay():
    """A launch under a capture counts into the capture's dict of darboux
    launches, none into raster_cuda's, vertex_cuda's, occlusion_cuda's or
    LAUNCHES; each replay adds them to darboux_cuda.LAUNCHES."""
    darboux_cuda.reset_launches()
    before = [dict(m.LAUNCHES) for m in (raster_cuda, vertex_cuda, occlusion_cuda)]
    with raster_cuda.recording() as raster, vertex_cuda.recording() as vertex, \
            occlusion_cuda.recording() as occlusion, darboux_cuda.recording() as darboux:
        for _ in range(3):  # one launch a chunk body
            raster_cuda.launch_counts(darboux_cuda.LAUNCHES)["body"] += 1
    assert darboux == {"body": 3} and not any(raster.values()) and not any(vertex.values())
    assert not any(occlusion.values()) and darboux_cuda.LAUNCHES == {"body": 0}
    for _ in range(4):
        darboux_cuda.replayed(darboux)
    assert darboux_cuda.LAUNCHES == {"body": 12}
    assert [m.LAUNCHES for m in (raster_cuda, vertex_cuda, occlusion_cuda)] == before
    raster_cuda.launch_counts(darboux_cuda.LAUNCHES)["body"] += 1  # outside a capture
    assert darboux_cuda.LAUNCHES == {"body": 13}
    darboux_cuda.reset_launches()


def test_snapshot_copies_the_counter():
    """timing.snapshot() shows darboux_cuda.LAUNCHES as darboux_launches, a
    copy the caller may keep."""
    darboux_cuda.reset_launches()
    raster_cuda.launch_counts(darboux_cuda.LAUNCHES)["body"] += 2
    snap = timing.snapshot()["darboux_launches"]
    assert snap == {"body": 2} and snap is not darboux_cuda.LAUNCHES
    darboux_cuda.reset_launches()
    assert snap == {"body": 2}
