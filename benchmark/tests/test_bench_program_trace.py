"""The readers of the program's own spans, stamps and counters
(program_trace.py and the nine metrics that read it): each gives a number
from a stretch that recorded something and None where the program recorded
nothing or has no tracer; the helper on a CPU scene at 96^2 runs the mix's
loop for its stretch (the same code for either loop kind) and leaves the
tracer off, also when the stretch fails."""

import pytest

from benchmark import harness, program_trace

BURST = ("vertex_span_ms.burst", "binning_span_ms.burst", "raster_span_ms.burst", "shade_span_ms.burst",
         "shade_chunks.burst", "fetch_ms.burst", "render_share.burst")
INTERACTIVE = ("launch_ms.interactive", "frame_device_ms.interactive")


def readings(scene=None):
    return harness.Readings(scene, {"width": 96, "height": 96}, 10, {}, None)


def read(name, r):
    return harness.metric_reader(name).read(r)


def span(name, sid, parent, ms):
    return {"name": name, "start_ns": 0, "end_ns": int(ms * 1e6), "ms": ms, "id": sid, "parent": parent,
            "call": sid if parent is None else parent}


def frame(vertex, binning, raster, shade, chunks):
    stages = {"vertex": vertex, "binning": binning, "raster": raster, "shade": shade}
    return {"stages": stages, "span_ms": sum(stages.values()), "chunks": chunks, "covered": 10 * chunks}


def stretches():
    burst = {"spans": [span("scene.render_sequence", 1, None, 200.0), span("sequence.copy", 2, 1, 48.0),
                       span("scene.render_sequence", 3, None, 200.0), span("sequence.copy", 4, 3, 60.0)],
             "frames": [frame(1.4, 0.3, 0.05, 0.7, 1), frame(1.5, 0.4, 0.05, 0.8, 2),
                        frame(1.6, 0.35, 0.05, 0.9, 1)],
             "counters": {"sequence.frames": 120}, "dropped": {"spans": 0, "frames": 0}, "launches": {}}
    interactive = {"spans": [span("scene.render", 1, None, 0.5), span("graph.replay", 2, 1, 0.2),
                             span("scene.render", 3, None, 0.5), span("graph.replay", 4, 3, 0.3),
                             span("graph.replay", 5, None, 9.0)],  # not under scene.render
                   "frames": [frame(1.0, 0.2, 0.05, 0.75, 1), frame(1.2, 0.2, 0.05, 0.75, 1)],
                   "counters": {}, "dropped": {"spans": 0, "frames": 0}, "launches": {}}
    return {"orbit-burst": {"snapshot": burst, "window_s": 0.01, "steps": 2},
            "interactive": {"snapshot": interactive, "window_s": 0.01, "steps": 2}}


def test_readers_read_a_stretch():
    r = readings()
    r.program_trace = stretches()
    got = {name: read(name, r) for name in BURST + INTERACTIVE}
    assert got == pytest.approx({
        "vertex_span_ms.burst": 1.5, "binning_span_ms.burst": 0.35, "raster_span_ms.burst": 0.05,
        "shade_span_ms.burst": 0.8, "shade_chunks.burst": 4 / 3,
        "fetch_ms.burst": 54.0 / 60,                       # the median call's copy over its 60 frames
        "render_share.burst": 100.0 * (2.45 + 2.75 + 2.9) / 10.0,
        "launch_ms.interactive": 0.25, "frame_device_ms.interactive": 2.1})


def test_readers_return_nothing_where_nothing_was_recorded(monkeypatch):
    r = readings()
    empty = {"spans": [], "frames": [], "counters": {}, "dropped": {"spans": 0, "frames": 0}, "launches": {}}
    r.program_trace = {mix: {"snapshot": empty, "window_s": 1.0, "steps": 1}
                       for mix in ("orbit-burst", "interactive")}
    assert all(read(name, r) is None for name in BURST + INTERACTIVE)
    # A program without the tracer (an older tree): no stretch at all.
    monkeypatch.setattr(program_trace, "_tracer", lambda: None)
    assert all(read(name, readings()) is None for name in BURST + INTERACTIVE)


@pytest.fixture
def small(monkeypatch):
    """The diablo-shadow cells at 96^2 on the CPU (a 12 x 16 sphere, 64^2
    maps), their stretches cut to the least steps: 3 calls of 3 frames and
    3 frames."""
    from tiny_renderer_tpu_torch.utils import timing

    cell = harness.find_cell("diablo-shadow.orbit-burst")
    config = dict(cell.config, width=96, height=96, mesh=dict(cell.config["mesh"], stacks=12, slices=16),
                  maps={"size": 64})
    scene, _, _ = harness.build_scene(config, 5, "cpu")
    traffic = program_trace._traffic
    monkeypatch.setattr(program_trace, "_traffic", lambda mix: dict(traffic(mix), frames_per_call=3))
    monkeypatch.setattr(program_trace, "STRETCH_S", 0.0)
    yield scene
    timing.disable()
    timing.snapshot()


def test_stretch_on_the_cpu(small):
    from tiny_renderer_tpu_torch.utils import timing

    r = readings(small)
    burst = program_trace.stretch(r, "orbit-burst")
    names = [s["name"] for s in burst["snapshot"]["spans"]]
    assert names.count("scene.render_sequence") == names.count("sequence.copy") == program_trace.MIN_STEPS == 3
    assert burst["steps"] == 3 and burst["window_s"] > 0
    assert burst["snapshot"]["counters"]["shade.frames"] == burst["snapshot"]["counters"]["sequence.frames"] == 9
    assert not timing.tracing()
    assert program_trace.stretch(r, "orbit-burst") is burst  # cached on the Readings
    frames = program_trace.stretch(r, "interactive")
    names = [s["name"] for s in frames["snapshot"]["spans"]]
    assert names.count("scene.render") == names.count("scene.fetch") == 3
    assert not timing.tracing()
    # The CPU renders eagerly: no device frame, no graph; the copy is a span.
    assert read("fetch_ms.burst", r) > 0
    assert read("vertex_span_ms.burst", r) is None and read("launch_ms.interactive", r) is None


def test_stretch_leaves_the_tracer_off_when_it_fails(small, monkeypatch):
    from tiny_renderer_tpu_torch import Scene
    from tiny_renderer_tpu_torch.utils import timing

    def fail(self, *args):
        raise RuntimeError("broken")

    monkeypatch.setattr(Scene, "render_sequence", fail)
    with pytest.raises(RuntimeError, match="broken"):
        program_trace.stretch(readings(small), "orbit-burst")
    assert not timing.tracing()
