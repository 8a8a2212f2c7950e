"""Torch port: the strip shade's covered-count chunks and dedup_gather's two
sides, the counterparts of JAX's while_loop and lax.cond, against JAX.

The port's _shade_strips cuts its slots into the chunks of
frame.shade_chunks, each run under graphs.device_if(count > its first
slot): on the card a replayed graph skips the chunks past the covered
count, as JAX's loop stops there; eagerly every chunk runs.  Here, at 64x64
and strip_batch=8 (several JAX loop batches, three port chunks of 32, 96 and
128 slots): the shade against JAX's _shade_strips on the same inputs
with the camera pass cut to a given number of covered strips (none, inside
the first chunk, exactly on a chunk's end, every strip), with and without
strip_mask + strip_planes and strip_pack_words, within the 0.5% of pixels
of test_torch_graph_frame.py (JAX's compiled loop may contract FMAs).
Then a stand-in for device_if that evaluates the predicate (lifting the
host-read guard) and skips false bodies, as a replay does: every frame and
burst of the seven pipelines equals the eager one, with the number of chunk
bodies the chunk rule gives; dedup_gather runs one side on either side of
its cap, bit-equal to JAX's; a torch without conditional nodes raises.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_frame import GEOM, VIEW
from test_torch_graph_frame import CFG, HOST_READS, PIPELINES, TEX, no_host_reads  # noqa: F401
from test_torch_graph_frame_knobs import grid_scene
from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu.pipelines import shaders as jshaders
from tiny_renderer_tpu_torch.convert import config_from, scene_arrays, to_tensor
from tiny_renderer_tpu_torch.ops import mathlib as tml
from tiny_renderer_tpu_torch.ops.vertex import triangle_setup
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines import graphs as tgraphs
from tiny_renderer_tpu_torch.pipelines import shaders as tshaders

SLOTS = 256  # 64 * 64 / 16 strips, a multiple of strip_batch 8
KNOBS = {
    "default": {},
    "mask+planes": dict(strip_mask=True, strip_planes=True),
    "nopack": dict(strip_pack_words=False),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _name(body):
    return getattr(body, "func", body).__name__


class Calls(list):
    """The (body name, taken) of every device_if call; `guarded()` turns the
    host-read guard on around the port's code under test."""

    def __init__(self, guard):
        super().__init__()
        self.guard = guard

    @contextlib.contextmanager
    def guarded(self):
        self.guard[0] = True
        try:
            yield
        finally:
            self.guard[0] = False


@pytest.fixture
def skipping(monkeypatch, no_host_reads):  # noqa: F811
    """device_if as a replay decides: the predicate read (the host-read
    guard lifted for that read only), a false body skipped."""
    no_host_reads[0] = False
    calls = Calls(no_host_reads)

    def device_if(pred, body):
        assert pred.dtype == torch.bool and pred.dim() == 0
        prev, no_host_reads[0] = no_host_reads[0], False
        try:
            taken = bool(pred)
        finally:
            no_host_reads[0] = prev
        calls.append((_name(body), taken))
        if taken:
            body()

    monkeypatch.setattr(tgraphs, "device_if", device_if)
    return calls


def chunks_run(count, cfg):
    """Chunk bodies the rule runs at `count` covered strips."""
    slots = -(-(cfg.width * cfg.height // cfg.strip_len) // cfg.strip_batch) * cfg.strip_batch
    return sum(start < count for start, _ in tframe.shade_chunks(slots, cfg.strip_batch))


def test_chunk_rule():
    assert tframe.shade_chunks(SLOTS, 8) == [(0, 32), (32, 128), (128, 256)]
    # The tuned layouts at 800x800: shadow's 40,448 slots of 512, occlusion's 80,896 of 1024.
    for slots, batch in ((40448, 512), (80896, 1024), (8, 8), (24, 8), (1000, 1000)):
        bounds = tframe.shade_chunks(slots, batch)
        assert bounds[0][0] == 0 and bounds[-1][1] == slots
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(s < e and s % batch == 0 for s, e in bounds)
    assert tframe.shade_chunks(40448, 512)[0] == (0, 5120)  # 4,744 covered strips: one chunk


def shade_pair(pipeline, cfg, keep=None, geom=GEOM, guarded=contextlib.nullcontext):
    """The port's _shade_strips and JAX's on the same inputs (the port's
    uniforms, setup, light pass and camera raster, with the strip plane
    and the varying planes the config asks for), the camera pass cut to
    its first `keep` covered strips (all when None).  Returns (port frame,
    JAX frame, covered strips)."""
    g, t = scene_arrays(geom, TEX, "cpu")
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
    SL = cfg.strip_len
    cov = (idx.reshape(-1, SL) >= 0).any(-1)
    if keep is not None:
        drop = torch.cumsum(cov.to(torch.int64), 0) > keep
        idx = torch.where(drop[:, None], -1, idx.reshape(-1, SL)).reshape(idx.shape)
        if strips is not None:
            strips = torch.where(drop.reshape(strips.shape), -1, strips)
        cov = cov & ~drop
    textures = tframe._with_packed_plane(t, pipeline, cfg)
    shadow = tframe._shadow_for_shade(shadow_z, spec, cfg)
    with guarded():
        got = tframe._shade_strips(setup, idx, pipeline, uniforms, textures, cfg, shadow, strip_mask=strips,
                                   planes=varys, planes_spec=kspec)
    got = got.numpy()

    def j(x):
        if isinstance(x, dict):
            return {k: j(v) for k, v in x.items()}
        return None if x is None else jnp.asarray(x.numpy())

    want = np.asarray(jframe._shade_strips(
        j(setup), j(idx), pipeline, j(uniforms), j(textures), RenderConfig(**dataclasses.asdict(cfg)),
        j(shadow), strip_mask=j(strips), planes=j(varys), planes_spec=kspec))
    return got, want, int(cov.sum())


# (covered strips kept, expected chunk bodies): none; inside the first chunk;
# exactly the first chunk's end; one strip past it; every strip (a grid
# filling the frame).  The scene covers 50 strips.
COVERAGES = {"none": (0, 0), "inside-first": (20, 1), "first-end": (32, 1), "past-first-end": (33, 2),
             "all": (None, 3)}


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("coverage", list(COVERAGES))
def test_chunked_shade_matches_jax(skipping, coverage, knob):
    keep, bodies = COVERAGES[coverage]
    pipeline = "occlusion" if knob == "default" else "shadow"
    cfg = dataclasses.replace(CFG, strip_len=16, **KNOBS[knob])
    geom = grid_scene() if coverage == "all" else GEOM
    got, want, count = shade_pair(pipeline, cfg, keep=keep, geom=geom, guarded=skipping.guarded)
    assert count == (SLOTS if coverage == "all" else keep)
    chunk_calls = [taken for name, taken in skipping if name == "chunk"]
    assert len(chunk_calls) == 3 and sum(chunk_calls) == bodies == chunks_run(count, config_from(cfg))
    covered = (got > 0).any(-1)
    assert covered.sum() == (want > 0).any(-1).sum()
    if count == 0:
        assert not got.any() and not want.any()
    else:
        assert covered.mean() > 0.02
    assert (got != want).any(-1).mean() < 0.005


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_skipped_chunks_leave_the_eager_frame_and_burst(skipping, pipeline):
    """Under the skipping stand-in (and the host-read guard) make_frame_fn's
    frame and the burst's frames equal the eager ones (every chunk run),
    and the chunk bodies run are those the covered count reaches."""
    g, t = scene_arrays(GEOM, TEX, "cpu")
    views = [to_tensor(v, "cpu") for v in VIEW]
    cfg = config_from(CFG).resolve(pipeline)
    cams, ligs = torch.tensor([0.1, 0.5]), torch.tensor([-0.3, 0.2])
    with skipping.guarded():
        skipped = tframe.make_frame_fn(pipeline, cfg)(g, t, *views)
        burst = tframe.make_burst_fn(pipeline, cfg, keep_frames=True)(g, t, cams, ligs)
    calls = list(skipping)
    skipping.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgraphs, "device_if", lambda pred, body: body())  # eager: every body
        eager = tframe.make_frame_fn(pipeline, cfg)(g, t, *views)
        eager_burst = tframe.make_burst_fn(pipeline, cfg, keep_frames=True)(g, t, cams, ligs)
    for k in ("frame", "z", "shadow", "overflow"):
        assert torch.equal(skipped[k], eager[k]), k
    assert torch.equal(burst["frames"], eager_burst["frames"])
    assert torch.equal(burst["checksums"], eager_burst["checksums"])
    count = int((eager["z"] > tml.F32_MIN).reshape(-1, cfg.strip_len).any(-1).sum())
    frame_chunks = [taken for name, taken in calls[:3]]
    assert [name for name, _ in calls] == ["chunk"] * 9  # the frame's three chunks, then each burst frame's
    assert sum(frame_chunks) == chunks_run(count, cfg) and 0 < sum(frame_chunks) < 3
    assert frame_chunks == sorted(frame_chunks, reverse=True)  # a prefix of the chunks


@pytest.mark.parametrize("coverage", ["none", "all"])
def test_skipped_chunks_at_no_and_full_coverage(skipping, coverage):
    geom = grid_scene((8.0, 0.0, 0.0) if coverage == "none" else (0.0, 0.0, 0.0))
    g, t = scene_arrays(geom, TEX, "cpu")
    views = [to_tensor(v, "cpu") for v in VIEW]
    for pipeline in ("shadow", "occlusion"):
        cfg = config_from(dataclasses.replace(CFG, occlusion_dedup=True)).resolve(pipeline)
        skipping.clear()
        with skipping.guarded():
            got = tframe.make_frame_fn(pipeline, cfg)(g, t, *views)
        taken = [ran for name, ran in skipping if name == "chunk"]
        assert taken == [coverage == "all"] * 3
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tgraphs, "device_if", lambda pred, body: body())
            want = tframe.make_frame_fn(pipeline, cfg)(g, t, *views)
        assert torch.equal(got["frame"], want["frame"])
        assert bool((got["frame"] > 0).any()) == (coverage == "all")


@pytest.mark.parametrize("unique", [100, 512, 513, 3000])
def test_dedup_gather_takes_one_side(skipping, unique):
    """cap = max(M >> 3, 256) = 512 at M = 4096: rank[-1] = unique - 1 >=
    cap takes the plain gather, else the deduplicated one; one body runs,
    bit-equal to JAX's lax.cond."""
    rng = np.random.default_rng(unique)
    table = rng.standard_normal(5000).astype(np.float32)
    pool = rng.choice(5000, unique, replace=False)
    idx = rng.permutation(np.concatenate([pool, rng.choice(pool, 4096 - unique)])).reshape(16, 256)
    want = np.asarray(jshaders.dedup_gather(jnp.asarray(table), jnp.asarray(idx)))
    with skipping.guarded():
        got = tshaders.dedup_gather(torch.from_numpy(table), torch.from_numpy(idx))
    got = got.numpy()
    assert skipping == [("deduped", unique <= 512), ("plain", unique > 512)]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got, table[idx])


def test_device_if_outside_capture_runs_the_body():
    ran = []
    tgraphs.device_if(torch.tensor(False), functools.partial(ran.append, 1))
    assert ran == [1]


class _CudaPred:
    """A stand-in for a 0-d bool CUDA tensor."""
    is_cuda = True
    dtype = torch.bool

    def dim(self):
        return 0


def test_device_if_without_conditional_nodes_raises(monkeypatch):
    """Under a capture whose allocations CapturedGraph does not route into
    the graph's pool (a torch without _cuda_beginAllocateCurrentThreadToPool,
    or a capture made elsewhere), device_if raises; the body never runs
    unconditionally in a graph."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(tgraphs._CAPTURE, "pooled", False, raising=False)
    ran = []
    with pytest.raises(RuntimeError, match="cannot capture a conditional graph node.*"
                                           "_cuda_beginAllocateCurrentThreadToPool"):
        tgraphs.device_if(_CudaPred(), lambda: ran.append(1))
    assert ran == []


def test_make_grid_covers_every_strip():
    """The wall the card's shade phase renders at full coverage: every strip
    of the frame covered at the stock pose, nothing dropped by the span
    caps."""
    from tiny_renderer_tpu_torch import RenderConfig as TorchConfig
    from tiny_renderer_tpu_torch import Scene
    from tiny_renderer_tpu_torch.assets.model import Model
    from tiny_renderer_tpu_torch.models.procedural import make_grid

    maps = {k: v.numpy() for k, v in scene_arrays(GEOM, TEX, "cpu")[1].items()
            if k in ("texture", "normal_map", "normal_map_tangent", "specular_map")}
    sc = Scene(Model(mesh=make_grid(), **maps), "shadow", TorchConfig(width=96, height=96, tile_h=8), device="cpu")
    sc.set_light_direction(VIEW[0])
    sc.set_camera(*VIEW[1:])
    out = sc.render()
    assert bool((out["z"] > tml.F32_MIN).all()) and not bool(out["overflow"])
    assert make_grid().pos_idx.shape == (2 * 24 * 24, 3)
