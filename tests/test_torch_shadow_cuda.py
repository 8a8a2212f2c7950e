"""Torch port: the shadow chunk body's CUDA wrapper (ops/shadow_cuda.py) and its dispatch, on the CPU.

No nvcc and no card here, so the kernel itself is held to the torch body by
chip_smoke.py's shadow phase.  Here: the wrapper refuses a wrong dtype,
shape, contiguity or device before any launch; CPU tensors take the torch
body through render_frame, render_burst and Scene.render_sequence and never
reach the library; the body applies only on a CUDA device with the packed
texture plane and only to the built-in spec (a custom pipeline registered
over "shadow" runs its own shade); where it applies, _shade_strips hands it
each chunk's slots, the strip plane, the accumulator, the shadow map as the
shade reads it (tile-swizzled under shadow_tile), the light's matrices, the
config's bias and dim and the frame's geometry in place of the torch body,
and the frame keeps the torch body's stage marks; launches made under a
capture count at each replay, apart from the other kernels' counters."""

import dataclasses

import pytest
import torch

from tiny_renderer_tpu_torch import Model, RenderConfig, Scene
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.ops import darboux_cuda, occlusion_cuda, raster_cuda, shadow_cuda, vertex_cuda
from tiny_renderer_tpu_torch.ops import mathlib as ml
from tiny_renderer_tpu_torch.ops.vertex import triangle_setup
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines import shaders
from tiny_renderer_tpu_torch.utils import timing

CFG = RenderConfig(width=64, height=32)
VIEW = ([0.4, 0.2, 0.9], [0.2, 0.1, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
# bin_triangles' four steps, then the caller's stage mark.
BINNING = ["binning.keys", "binning.sort", "binning.csr", "binning.records", "binning"]
SHADOW_MARKS = ["vertex", *BINNING, "raster", *BINNING, "raster", "shade"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_library(monkeypatch):
    """Any use of the kernel's library raises."""

    def refuse():
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(shadow_cuda, "_library", refuse)


def scene(config=CFG):
    s = Scene(Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16)), "shadow", config, device="cpu")
    s.set_light_direction(VIEW[0])
    s.set_camera(*VIEW[1:])
    return s


def views():
    return [torch.tensor(v, dtype=torch.float32) for v in VIEW]


def unpacked(textures):
    """The textures without their packed planes."""
    return {k: v for k, v in textures.items() if not k.startswith("_pk:")}


def chunk_args(**change):
    """A shadow chunk's arguments on the CPU, as the fused body passes them."""
    s = scene()
    cfg = s.config
    _, u = tframe._uniforms(tframe.PIPELINES["shadow"], cfg, *views())
    setup = triangle_setup(s._geom, u, cfg, needs=("vertex_intensity",))
    setup = {key: setup[key].contiguous() for key in shadow_cuda.COLUMNS}  # as the setup kernel lays them out
    pk, tile = shaders._find_pk(s._textures, shaders.PIPELINE_MAPS["shadow"])
    n_strips = cfg.width * cfg.height // cfg.strip_len
    args = dict(setup=setup, strips=torch.full((n_strips, cfg.strip_len), -1, dtype=torch.int32),
                cids=torch.arange(8), acc=torch.zeros((n_strips + 1, cfg.strip_len), dtype=torch.int32),
                plane=pk, tile=tile, shadow=torch.zeros((cfg.height, cfg.width)), shadow_tile=0,
                shadow_matrix=u["shadow_matrix"].contiguous(), i_vpmv=u["i_vpmv"].contiguous(),
                bias=ml.f32(cfg.shadow_bias), dim=ml.f32(cfg.shadow_dim), shadow_width=cfg.width,
                width=cfg.width, pixels=cfg.width * cfg.height)
    args.update(change)
    return args


def launch(a):
    """shadow_cuda.chunk_body on the arguments of chunk_args."""
    positional = ("setup", "strips", "cids", "acc", "plane", "tile", "shadow", "shadow_tile", "shadow_matrix",
                  "i_vpmv")
    args = [a.pop(k) for k in positional]
    shadow_cuda.chunk_body(*args, **a)


@pytest.mark.parametrize("case,match", [
    ("edge dtype", "a1: .*int32"),
    ("edge contiguity", "cz: .*non-contiguous"),
    ("varying shape", r"uv: .*\(\d+x3x2\)"),
    ("varying dtype", "intensity: .*float32"),
    ("strips dtype", "strips: .*int32 or int16"),
    ("strips contiguity", "strips: .*contiguous"),
    ("cids dtype", "cids: .*int64"),
    ("acc shape", "acc: .*int32"),
    ("acc dtype", "acc: .*uint8"),
    ("plane shape", r"plane: .*\(h, w, 1\)"),
    ("shadow shape", r"shadow: .*\(h, w\) float32 shadow map"),
    ("shadow dtype", "shadow: .*float32.*float64"),
    ("shadow columns apart", "shadow: .*rows are contiguous.*strides"),
    ("matrix shape", r"shadow_matrix: .*\(4x4\)"),
    ("matrix contiguity", "i_vpmv: .*non-contiguous"),
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
        setup["uv"] = setup["uv"][:, :2]
    elif case == "varying dtype":
        setup["intensity"] = setup["intensity"].double()
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
        a["plane"] = torch.cat([a["plane"], a["plane"]], dim=-1)
    elif case == "shadow shape":
        a["shadow"] = a["shadow"].reshape(-1)
    elif case == "shadow dtype":
        a["shadow"] = a["shadow"].double()
    elif case == "shadow columns apart":
        a["shadow"] = torch.zeros((a["shadow"].shape[1], a["shadow"].shape[0])).t()
    elif case == "matrix shape":
        a["shadow_matrix"] = a["shadow_matrix"][:3]
    elif case == "matrix contiguity":
        a["i_vpmv"] = a["i_vpmv"].t()
    a["setup"] = setup
    shadow_cuda.reset_launches()
    with pytest.raises(ValueError, match=match):
        launch(a)
    assert shadow_cuda.LAUNCHES == {"body": 0}


def test_row_padded_map_is_read_in_place(no_library):
    """A shadow map whose rows lie further apart than its width (the
    raster's depth plane is such a view) passes the layout check: only the
    device is wrong here."""
    a = chunk_args()
    h, w = a["shadow"].shape
    a["shadow"] = torch.zeros((h, w + 64))[:, :w]
    assert not a["shadow"].is_contiguous()
    with pytest.raises(ValueError, match="expected a tensor on a CUDA device"):
        launch(a)


def render_frame(s):
    return tframe.render_frame(s._geom, s._textures, *views(), pipeline="shadow", config=s.config)["frame"]


def render_burst(s):
    angles = torch.tensor([0.1, 0.4], dtype=torch.float32)
    return tframe.render_burst(s._geom, s._textures, angles, angles, pipeline="shadow", config=s.config,
                               keep_frames=True)["frames"]


def render_sequence(s):
    return torch.from_numpy(s.render_sequence([0.1, 0.4], [0.2, 0.3]).copy())


@pytest.mark.parametrize("entry", (render_frame, render_burst, render_sequence))
def test_cpu_tensors_take_the_torch_body(entry, no_library):
    """A shadow frame, burst or sequence on the CPU renders through the
    torch body: no launch is counted, the library is never loaded, and the
    tracer's snapshot shows no shadow launch."""
    shadow_cuda.reset_launches()
    frames = entry(scene())
    assert frames.dtype == torch.uint8 and (frames > 0).any()
    assert shadow_cuda.LAUNCHES == {"body": 0}
    assert timing.snapshot()["shadow_launches"] == {"body": 0}


@pytest.mark.parametrize("device,packed,applies", [
    ("cpu", True, False),
    ("cuda", True, True),
    ("cuda", False, False),
])
def test_body_applies_on_cuda_with_the_packed_plane(device, packed, applies, no_library):
    """The fused body is offered only for a CUDA device and the packed plane
    of the texture; without it the torch body runs (its per-map sampler)."""
    s = scene()
    textures = s._textures if packed else unpacked(s._textures)
    assert (shaders._find_pk(textures, shaders.PIPELINE_MAPS["shadow"])[0] is not None) == packed
    body = tframe.PIPELINES["shadow"].fused_body(textures, torch.device(device))
    assert (body is not None) == applies
    if applies:  # a CUDA body given CPU tensors raises before any launch: no fallback
        a = chunk_args()
        uniforms = {"shadow_matrix": a["shadow_matrix"], "i_vpmv": a["i_vpmv"]}
        shadow_cuda.reset_launches()
        with pytest.raises(ValueError, match="CUDA device"):
            body(a["setup"], a["strips"], a["cids"], a["acc"], uniforms, width=a["width"], pixels=a["pixels"],
                 y_offset=0, config=s.config.resolve("shadow"), shadow=a["shadow"])
        assert shadow_cuda.LAUNCHES == {"body": 0}


def test_custom_pipeline_over_shadow_runs_its_own_shade(monkeypatch):
    """A pipeline registered over the name "shadow" has no fused body, so
    its strip shade runs its own shade function on every device; the
    built-in spec is the only one that carries the kernel."""
    for table in (tframe.PIPELINES, shaders.VARYING_SPECS, shaders.PIPELINE_MAPS, tframe._GATHER_KEYS):
        monkeypatch.setitem(table, "shadow", table["shadow"])
    assert tframe.PIPELINES["shadow"].fused_body is shaders.shadow_fused_body

    def solid(frag, uniforms, textures, config):
        return torch.full((*frag["x"].shape, 3), 77, dtype=torch.uint8)

    spec = tframe.register_pipeline("shadow", solid, varying_spec=(("uv", 2, "interp"),), maps=("texture",),
                                    needs=("vertex_intensity",), two_pass=True, overwrite=True)
    assert spec.fused_body is None and tframe.PIPELINES["shadow"] is spec
    frame = render_frame(scene())
    assert set(frame.unique().tolist()) == {0, 77}


def cuda_like_body(monkeypatch):
    """The built-in body offered on the CPU as on a CUDA device, with
    shadow_cuda.chunk_body recording its arguments in place of a launch
    (it writes nothing, so the covered pixels stay black)."""
    calls = []
    spec = tframe.PIPELINES["shadow"]
    monkeypatch.setitem(tframe.PIPELINES, "shadow", dataclasses.replace(
        spec, fused_body=lambda textures, device: spec.fused_body(textures, torch.device("cuda"))))
    monkeypatch.setattr(shadow_cuda, "chunk_body", lambda *a, **k: calls.append((a, k)))
    return calls


@pytest.mark.parametrize("strip_batch,bodies,shadow_tile", ((512, 1, 0), (8, 3, 0), (512, 1, 16)))
def test_shade_strips_hands_each_chunk_to_the_body(strip_batch, bodies, shadow_tile, monkeypatch):
    """Where the body applies, each chunk body of _shade_strips is one call
    of it with the chunk's slot ids, the strip plane, the frame's
    accumulator, the packed plane and its tile, the shadow map as the shade
    reads it (swizzled under shadow_tile) and its tile, the light's
    matrices, the config's float32 bias and dim and the frame's geometry;
    the torch body does not run (its gather would read the setup), and the
    frame's marks are the torch body's: the body sets none."""
    calls = cuda_like_body(monkeypatch)
    cfg = dataclasses.replace(CFG, strip_batch=strip_batch, shadow_tile=shadow_tile)
    s = scene(cfg)
    monkeypatch.setattr(tframe, "_gather_fragments", None)
    ring = timing._Ring(torch.device("cpu"), frames=4)
    timing.enable()
    try:
        with timing.marking(ring) as marks:
            out = tframe.render_frame(s._geom, s._textures, *views(), pipeline="shadow", config=s.config)
        ring.issue(marks, lambda: None)
        (fr,), _ = ring.drain()
    finally:
        timing.disable()
        snap = timing.snapshot()
    assert not out["frame"].any() and len(calls) == bodies
    assert fr["labels"] == SHADOW_MARKS and fr["pixels"] is None
    assert not any(k.endswith(".pixels") for k in snap["counters"])
    rc = s.config.resolve("shadow")
    n_strips = rc.width * rc.height // rc.strip_len
    slots = -(-n_strips // rc.strip_batch) * rc.strip_batch
    pk, tile = shaders._find_pk(s._textures, shaders.PIPELINE_MAPS["shadow"])
    _, u = tframe._uniforms(tframe.PIPELINES["shadow"], rc, *views())
    want_map = shaders.swizzle_plane(out["shadow"], shadow_tile) if shadow_tile else out["shadow"]
    for (args, kw), (start, end) in zip(calls, tframe.shade_chunks(slots, rc.strip_batch)):
        setup, strips, cids, acc, plane, got_tile, shadow, got_shadow_tile, sm, i_vpmv = args
        assert strips.shape == (n_strips, rc.strip_len) and strips.dtype == torch.int32
        assert cids.dtype == torch.int64 and cids.numel() == end - start
        assert acc.shape == (n_strips + 1, rc.strip_len) and acc.dtype == torch.int32
        assert plane is pk and got_tile == tile == rc.tex_tile
        assert got_shadow_tile == shadow_tile and torch.equal(shadow, want_map)
        assert torch.equal(sm, u["shadow_matrix"]) and torch.equal(i_vpmv, u["i_vpmv"])
        assert sm.is_contiguous() and i_vpmv.is_contiguous()
        assert kw == {"bias": ml.f32(rc.shadow_bias), "dim": ml.f32(rc.shadow_dim), "shadow_width": rc.width,
                      "width": rc.width, "pixels": rc.width * rc.height, "y_offset": 0}
        assert {"uv", "intensity", "zv"} <= set(setup)


def test_row_slab_passes_its_first_row(monkeypatch):
    """A row slab's shade (parallel.sharding's, y_offset > 0) gives the body
    the slab's first global row, the slab's pixels, the whole shadow map and
    u8 triples under strip_pack_words=False."""
    calls = cuda_like_body(monkeypatch)
    s = scene(dataclasses.replace(CFG, strip_pack_words=False))
    rc = s.config.resolve("shadow")
    spec = tframe.PIPELINES["shadow"]
    shadow_z = tframe.render_frame(s._geom, s._textures, *views(), pipeline="shadow", config=rc)["shadow"]
    calls.clear()
    _, u = tframe._uniforms(spec, rc, *views())
    setup = triangle_setup(s._geom, u, rc, needs=spec.needs)
    tframe._camera_pass_and_shade(setup, u, "shadow", s._textures, rc, "kernel", shadow_z, False, rows=16, y0=16)
    (args, kw), = calls
    assert kw["y_offset"] == 16 and kw["pixels"] == 16 * rc.width and kw["shadow_width"] == rc.width
    assert args[3].shape == (16 * rc.width // rc.strip_len + 1, rc.strip_len, 3) and args[3].dtype == torch.uint8
    assert torch.equal(args[6], shadow_z)


def test_launches_count_at_each_replay():
    """A launch under a capture counts into the capture's dict of shadow
    launches, none into raster_cuda's, vertex_cuda's, occlusion_cuda's,
    darboux_cuda's or LAUNCHES; each replay adds them to
    shadow_cuda.LAUNCHES."""
    shadow_cuda.reset_launches()
    others = (raster_cuda, vertex_cuda, occlusion_cuda, darboux_cuda)
    before = [dict(m.LAUNCHES) for m in others]
    with raster_cuda.recording() as raster, vertex_cuda.recording() as vertex, \
            occlusion_cuda.recording() as occlusion, darboux_cuda.recording() as darboux, \
            shadow_cuda.recording() as shadow:
        for _ in range(3):  # one launch a chunk body
            raster_cuda.launch_counts(shadow_cuda.LAUNCHES)["body"] += 1
    assert shadow == {"body": 3} and shadow_cuda.LAUNCHES == {"body": 0}
    assert not any(v for d in (raster, vertex, occlusion, darboux) for v in d.values())
    for _ in range(4):
        shadow_cuda.replayed(shadow)
    assert shadow_cuda.LAUNCHES == {"body": 12}
    assert [m.LAUNCHES for m in others] == before
    raster_cuda.launch_counts(shadow_cuda.LAUNCHES)["body"] += 1  # outside a capture
    assert shadow_cuda.LAUNCHES == {"body": 13}
    shadow_cuda.reset_launches()


def test_snapshot_copies_the_counter():
    """timing.snapshot() shows shadow_cuda.LAUNCHES as shadow_launches, a
    copy the caller may keep."""
    shadow_cuda.reset_launches()
    raster_cuda.launch_counts(shadow_cuda.LAUNCHES)["body"] += 2
    snap = timing.snapshot()["shadow_launches"]
    assert snap == {"body": 2} and snap is not shadow_cuda.LAUNCHES
    shadow_cuda.reset_launches()
    assert snap == {"body": 2}
