"""Torch port: the sharded paths cut into segments at their collectives
(parallel.sharding), the code that CUDA graphs capture on the card.

On the CPU the segments run eagerly.  Here, on the CPU meshes of
test_torch_parallel.py (kernel backend at 64x64, tile_h=8): the three
sharded paths with every host read of a tensor made to raise; the same
paths through a stand-in for CapturedGraph (it runs the segment at its
"capture" and again at each "replay", on its own copies of the inputs), so
that the program cache, the lazy capture at the first call, the
collectives' reused buffers and the replays run here: under every knob set
of chip_smoke's SHARD_CONFIGS each replayed frame equals the eager sharded
frame and render_frame at a second pose, which captures nothing; the
program key (the mesh, the registration generation, addresses not
values); the per-device input copies, made once with stable addresses;
a failed capture raises.
"""

import collections

import numpy as np
import pytest
import torch

from test_torch_graph_frame import no_host_reads  # noqa: F401  (a fixture)
from test_torch_parallel import CPU8, _assert_equal, _cfg, _orbit, _scene
from tiny_renderer_tpu_torch.parallel import (
    make_pp_mesh,
    make_row_mesh,
    render_batch_sharded,
    render_frame_sharded,
    render_sequence_pipelined,
    sharding,
)
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines.graphs import GraphCache

# chip_smoke.py's SHARD_CONFIGS: knobs, needs_z.
SHARD_CONFIGS = {
    "default": ({}, True),
    "fuse_passes": (dict(fuse_passes=True), False),
    "replicate_pass1": (dict(replicate_pass1=True), True),
    "shard_triangles": (dict(shard_triangles=True), True),
    "needs_z=False": ({}, False),
    "strips+planes": (dict(strip_mask=True, strip_planes=True), True),
}
# Segments (graphs per device) of a sharded frame: the vertex stage, the
# setups' all_gather under shard_triangles, the light pass, the map's
# all_gather of a two-pass pipeline, the camera pass and shade.
SEGMENTS = {("shadow", "default"): 2, ("shadow", "fuse_passes"): 2, ("shadow", "replicate_pass1"): 1,
            ("shadow", "shard_triangles"): 3, ("shadow", "needs_z=False"): 2,
            ("shadow", "strips+planes"): 2, ("phong", "default"): 1, ("phong", "shard_triangles"): 2}
POSE2 = (np.array([-0.4, 0.0, 0.92], np.float32), np.array([0.35, 0.1, 0.93], np.float32))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class StandIn:
    """CapturedGraph's contract on the CPU: the static inputs are copies,
    fn runs twice at construction (the warm-up and the capture) and again
    at each call on the static inputs, after the new inputs are copied in."""

    def __init__(self, fn, inputs, name, hold=(), device=None):
        self.fn, self.name, self.hold = fn, name, hold
        self.inputs = [x.to(device, copy=True) for x in inputs]
        fn(*self.inputs)
        fn(*self.inputs)

    def __call__(self, *inputs):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.fn(*self.inputs)


@pytest.fixture
def standin(monkeypatch):
    """The sharded paths take their capture path on the CPU, with StandIn
    as the graph and a program cache of their own; yields the captures
    made (the graphs' names)."""
    made = []

    class Counted(StandIn):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self.name)

    monkeypatch.setattr(sharding, "CapturedGraph", Counted)
    monkeypatch.setattr(sharding, "_captures", lambda devices: True)
    monkeypatch.setattr(sharding, "_PROGRAMS", GraphCache())
    return made


def _view2(view):
    return [torch.from_numpy(v) for v in POSE2] + list(view[2:])


def _eager_frame(g, t, view, pipeline, cfg, mesh, needs_z):
    return sharding._frame_sharded(g, t, tuple(view), pipeline=pipeline, config=cfg, mesh=mesh,
                                   backend="kernel", needs_z=needs_z, eager=True)


CASES = [("shadow", k) for k in SHARD_CONFIGS] + [("phong", "default"), ("phong", "shard_triangles")]


@pytest.mark.parametrize("pipeline,knob", CASES)
def test_replayed_frame_equals_eager_and_single(standin, pipeline, knob):
    knobs, needs_z = SHARD_CONFIGS[knob]
    g, t, view = _scene()
    cfg = _cfg("kernel", **knobs)
    mesh = make_row_mesh(CPU8)
    for i, v in enumerate((view, _view2(view))):
        got = render_frame_sharded(g, t, *v, pipeline=pipeline, config=cfg, mesh=mesh, needs_z=needs_z)
        if i == 0:
            assert len(standin) == SEGMENTS[pipeline, knob], standin
            assert all(pipeline in name and "on cpu" in name for name in standin)
        else:
            assert len(standin) == SEGMENTS[pipeline, knob], "the second pose captured"
        eager = _eager_frame(g, t, v, pipeline, cfg, mesh, needs_z)
        want = tframe.render_frame(g, t, *v, pipeline=pipeline, config=cfg, needs_z=needs_z)
        assert (want["frame"] > 0).any() and not bool(got["overflow"])
        _assert_equal(got, eager)
        _assert_equal(got, want)


def test_batch_and_pipelined_replay(standin):
    """The two batch groups on the same devices share one program; the
    pipelined sequence captures its two stages once; a second call with
    other poses captures nothing.  Every frame equals its single-device
    render."""
    g, t, (_, _, look_at, up) = _scene()
    cfg = _cfg("kernel")
    bmesh, pmesh = make_row_mesh(CPU8, batch=2), make_pp_mesh(CPU8)
    for a0 in (0.0, 0.5):
        lights, froms = _orbit(4, a0)
        batch = render_batch_sharded(g, t, lights, froms, look_at, up, pipeline="shadow", config=cfg,
                                     mesh=bmesh)
        seq = render_sequence_pipelined(g, t, lights[:3], froms[:3], look_at, up, pipeline="shadow",
                                        config=cfg, mesh=pmesh)
        assert len(standin) == 4, standin  # 2 segments of the batch, 2 stages
        eager = sharding._batch_sharded(g, t, lights, froms, look_at, up, pipeline="shadow", config=cfg,
                                        mesh=bmesh, backend="kernel", needs_z=True, eager=True)
        for k in ("frame", "z", "overflow"):
            assert torch.equal(batch[k], eager[k]), k
        for b in range(4):
            want = tframe.render_frame(g, t, lights[b], froms[b], look_at, up, pipeline="shadow",
                                       config=cfg)
            assert torch.equal(batch["frame"][b], want["frame"]) and torch.equal(batch["z"][b], want["z"])
            if b < 3:
                assert torch.equal(seq["frame"][b], tframe.render_frame(
                    g, t, lights[b], froms[b], look_at, up, pipeline="shadow", config=cfg,
                    needs_z=False)["frame"])
        assert not bool(batch["overflow"].any()) and not bool(seq["overflow"].any())


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "stand-in graphs"])
def test_sharded_paths_read_nothing_on_the_host(request, no_host_reads, captured):  # noqa: F811
    if captured:
        request.getfixturevalue("standin")
    g, t, (light, look_from, look_at, up) = _scene()
    lights, froms = _orbit(2)
    for knobs, needs_z in SHARD_CONFIGS.values():
        cfg = _cfg("kernel", **knobs)
        for _ in range(2):
            out = render_frame_sharded(g, t, light, look_from, look_at, up, pipeline="shadow",
                                       config=cfg, mesh=make_row_mesh(CPU8), needs_z=needs_z)
    cfg = _cfg("kernel")
    batch = render_batch_sharded(g, t, lights, froms, look_at, up, pipeline="phong", config=cfg,
                                 mesh=make_row_mesh(CPU8, batch=2))
    seq = render_sequence_pipelined(g, t, lights, froms, look_at, up, pipeline="shadow", config=cfg,
                                    mesh=make_pp_mesh(CPU8))
    no_host_reads[0] = False
    assert bool((out["frame"] > 0).any()) and bool((batch["frame"] > 0).any())
    assert bool((seq["frame"] > 0).any())


def test_program_key_is_the_mesh_gen_and_addresses():
    g, t, view = _scene()
    cfg = _cfg("kernel").resolve("shadow")
    mesh = make_row_mesh(CPU8)

    def key(gen=0, geom=g, views=view, m=mesh):
        return sharding._program_key("sharded frame", "shadow", cfg, "kernel", gen, geom, t, views, m,
                                     list(m.devices.flat))

    assert key(views=[v + 1 for v in view]) == key()  # new view values: the same program
    assert key(gen=1) != key()
    assert key(m=make_row_mesh(CPU8[:4])) != key()
    # The same devices in another layout.
    other = make_row_mesh(CPU8, batch=2)
    assert sharding._program_key("sharded frame", "shadow", cfg, "kernel", 0, g, t, view, other,
                                 list(mesh.devices.flat)) != key()
    assert key(geom={**g, "pos_idx": g["pos_idx"].clone()}) != key()


def _flat_shade(value):
    def shade(frag, uniforms, textures, config):
        return torch.full((*frag["x"].shape, 3), value, dtype=torch.uint8)
    return shade


def test_reregistered_pipeline_gets_a_new_program(standin):
    spec = (("uv", 2, "interp"),)
    g, t, view = _scene()
    cfg, mesh = _cfg("kernel"), make_row_mesh(CPU8)
    frames = []
    try:
        for value in (40, 90):
            tframe.register_pipeline("gen_probe", _flat_shade(value), varying_spec=spec, overwrite=True)
            frames.append(render_frame_sharded(g, t, *view, pipeline="gen_probe", config=cfg,
                                               mesh=mesh)["frame"])
    finally:
        tframe.unregister_pipeline("gen_probe")
    assert len(standin) == 2  # one segment each
    for frame, value in zip(frames, (40, 90)):
        covered = (frame > 0).any(-1)
        assert bool(covered.any()) and set(frame[covered].unique().tolist()) == {value}


def test_inputs_placed_once_with_stable_addresses(monkeypatch):
    made = []

    def counted(value, device):
        made.append(device)
        return dict(value)

    monkeypatch.setattr(sharding, "_to", counted)
    monkeypatch.setattr(sharding, "_PLACED", collections.OrderedDict())
    g, t, view = _scene()
    cfg = _cfg("kernel")
    mesh = make_row_mesh(CPU8)
    first = render_frame_sharded(g, t, *view, pipeline="shadow", config=cfg, mesh=mesh)
    assert len(made) == 2  # the geometry and the textures, once for the one device
    placed = sharding._placed(g, torch.device("cpu"))
    tex = sharding._placed(t, torch.device("cpu"), "shadow", cfg.resolve("shadow"))
    second = render_frame_sharded(g, t, *_view2(view), pipeline="shadow", config=cfg, mesh=mesh)
    render_batch_sharded(g, t, *_orbit(2), view[2], view[3], pipeline="shadow", config=cfg,
                         mesh=make_row_mesh(CPU8, batch=2))
    assert len(made) == 2 and not torch.equal(first["frame"], second["frame"])
    assert sharding._placed(g, torch.device("cpu")) is placed
    assert all(placed[k].data_ptr() == g[k].data_ptr() for k in g)
    # The packed texture plane is made once too.
    assert sharding._placed(t, torch.device("cpu"), "shadow", cfg.resolve("shadow")) is tex
    assert len(tex) == len(t) + 1
    # Another source tensor (a new address): a new placement.
    sharding._placed({**g, "pos_idx": g["pos_idx"].clone()}, torch.device("cpu"))
    assert len(made) == 3


def test_failed_capture_raises(monkeypatch, standin):
    def refuse(fn, inputs, name, hold=(), device=None):
        raise RuntimeError(f"capturing {name} as a CUDA graph failed")

    monkeypatch.setattr(sharding, "CapturedGraph", refuse)
    g, t, view = _scene()
    with pytest.raises(RuntimeError, match="sharded frame.*'shadow'"):
        render_frame_sharded(g, t, *view, pipeline="shadow", config=_cfg("kernel"),
                             mesh=make_row_mesh(CPU8))


def test_merged_segments_take_the_inputs_first():
    calls = []

    def seg(name):
        def run(st, *ins):
            calls.append((name, ins))
        return run

    steps = [("a", seg("a"), None), ("b", seg("b"), "gather"), ("c", seg("c"), None),
             ("d", seg("d"), None)]
    merged = sharding._merged(steps)
    assert [(n, c) for n, _, c in merged] == [("a+b", "gather"), ("c+d", None)]
    merged[0][1]({}, 1, 2)
    merged[1][1]({}, 3)
    assert calls == [("a", (1, 2)), ("b", ()), ("c", (3,)), ("d", ())]
