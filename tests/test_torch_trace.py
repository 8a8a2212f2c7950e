"""Torch port: the tracer of utils/timing.py (host spans, counters, the
frame graph's stage stamps).

On the CPU: with the tracer off nothing is recorded, the frame graph's key
is the key it had before the tracer existed and the frames are unchanged;
with it on, Scene.render, get_frame_buffer and render_sequence record their
spans with their parents and one call id per public call (the graph path
through a stand-in for CapturedGraph, as sharding's tests do); the spans are
record_function ranges of a CPU torch.profiler trace, the tracer on or off;
GraphCache counts captures, hits and evictions; spans stay bounded and
apart by thread; shade.chunks is the chunk rule at the covered count of a
frame under and of one over the first chunk's end (12.5% of the strips at
64x64 and strip_batch 8); the ring's bookkeeping on the mark kernel's plain
version (stages, spans, chunks, call ids, overwritten frames dropped); a
mark whose body did not run reads absent, not stale; a snapshot taken after
the tracer is off drains what it issued while on; binning's step marks
add into their stage, which spans the stamps it spanned without them; the
clock calibration against a fake device clock; the gaps between frames
split over the host's spans, per snapshot, and report()'s lines for them;
an occlusion frame's probe stage and covered pixels, eagerly and under
marks on the CPU ring;
a darboux frame's darboux_setup and darboux stages and covered pixels
likewise, a skipped chunk body's darboux marks absent, and drained frames'
pixels in their shade's counter (the shadow frame's marks unchanged); a
specular frame's specular stage and covered pixels likewise, a skipped
chunk body's specular marks absent, and each pipeline's mark list its own;
render_burst's host destination filled byte-equal to its kept frames, and
render_sequence on the CPU eager, its spans kept, sequence.overlapped 0.

On the card (marker `card`, skipped without CUDA; this file imports no JAX,
so there: ``python -m pytest tests/test_torch_trace.py --noconftest -m card``):
frames bit-identical with the tracer on and off through Scene.render and
render_sequence; the frames numbered in turn, the stamps monotone in each
frame and its span within EVENT_EXTRA_MS of CUDA events around the same
replay; two traced 60-frame sequences on the host's clock (the clock's
error within CLOCK_ERROR_NS, each frame inside its replay and copy spans,
gaps and frame spans summing to the stamps' stretch); a burst traced by
torch.profiler with the tracer off holds the kernels it held before the
tracer ran, the traced graph those and one mark kernel a mark; a traced occlusion burst's probe stage and covered
pixels, beside the shadow frame's unchanged marks; a traced darboux burst's
two stages and covered pixels; a traced specular burst's stage and covered
pixels, its frames equal to the untraced burst's.
"""

import collections
import json
import math
import re
import threading
import time

import numpy as np
import pytest
import torch

from tiny_renderer_tpu_torch import Model, RenderConfig, Scene
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.ops.mathlib import F32_MIN
from tiny_renderer_tpu_torch.pipelines import frame as tframe
from tiny_renderer_tpu_torch.pipelines import graphs
from tiny_renderer_tpu_torch.pipelines.graphs import GraphCache, signature
from tiny_renderer_tpu_torch.utils import timing

# bin_triangles' four steps, then the caller's stage mark.
BINNING = ["binning.keys", "binning.sort", "binning.csr", "binning.records", "binning"]
FRAME_MARKS = ["start", "vertex", *BINNING, "raster", *BINNING, "raster", "shade"]
CAMS, LIGS = [0.1, 0.25, 0.4], [-0.2, -0.3, -0.45]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def tracer():
    """The tracer off and emptied before and after the test."""
    timing.disable()
    timing.snapshot()
    yield timing
    timing.disable()
    timing.snapshot()


def scene(radius=0.45, device="cpu", size=64, **knobs):
    model = Model(mesh=make_uv_sphere(radius, 8, 10), **make_textures(16))
    s = Scene(model, "shadow", RenderConfig(width=size, height=size, **knobs), device=device)
    s.set_light_direction([0.3, 0.0, 0.95])
    s.set_camera([0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    return s


class StandIn(graphs.CapturedGraph):
    """CapturedGraph's contract on the CPU: fn runs at the capture and again
    at each replay (_launch), on its own copies of the inputs."""

    def __init__(self, fn, inputs, name, hold=(), device=None, marked=False):
        self.fn, self.lock, self.launches, self.vertex_launches = fn, threading.Lock(), {}, {}
        self.occlusion_launches, self.darboux_launches, self.shadow_launches = {}, {}, {}
        self.binning_launches = {}
        self.inputs = [x.clone() for x in inputs]
        self.outputs = fn(*self.inputs)

    def _launch(self, inputs):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.outputs = self.fn(*self.inputs)


@pytest.fixture
def standin(monkeypatch):
    """Frames and bursts take their graph path on the CPU, with StandIn."""
    monkeypatch.setattr(tframe, "_captures", lambda device: True)
    monkeypatch.setattr(tframe, "CapturedGraph", StandIn)
    monkeypatch.setattr(tframe, "_GRAPHS", GraphCache())


def public_calls(s):
    """Scene.render, get_frame_buffer and render_sequence once each."""
    s.render()
    return s.get_frame_buffer(), s.render_sequence(CAMS, LIGS)


def test_off_records_nothing_and_keys_stay(tracer):
    s = scene()
    frame, seq = public_calls(s)
    snap = timing.snapshot()
    assert snap["spans"] == [] and snap["frames"] == [] and snap["counters"] == {}
    assert snap["dropped"] == {"spans": 0, "frames": 0}
    args = ("frame", "shadow", s.config, "kernel", 0, s._geom, s._textures, (torch.zeros(3),) * 4)
    before = ("frame", "shadow", s.config, "kernel", 0, signature(s._geom), signature(s._textures),
              signature(args[-1], addresses=False))
    assert tframe._graph_key(*args) == before
    timing.enable()
    assert tframe._graph_key(*args) == before + ("traced",)
    on_frame, on_seq = public_calls(s)
    assert np.array_equal(frame, on_frame) and np.array_equal(seq, on_seq)


def test_public_calls_record_their_spans(tracer, standin):
    s = scene()
    timing.enable()
    public_calls(s)
    s.render()  # a second frame: the cached graph
    snap = timing.snapshot()
    spans = snap["spans"]
    by_id = {sp["id"]: sp for sp in spans}
    roots = [sp for sp in spans if sp["parent"] is None]
    assert [r["name"] for r in sorted(roots, key=lambda r: r["start_ns"])] == [
        "scene.render", "scene.fetch", "scene.render_sequence", "scene.render"]
    assert all(r["call"] == r["id"] for r in roots)

    def tree(root):
        got = sorted((sp["name"], by_id[sp["parent"]]["name"]) for sp in spans
                     if sp["call"] == root["call"] and sp is not root)
        for sp in spans:  # every child inside its parent
            if sp["call"] == root["call"] and sp is not root:
                parent = by_id[sp["parent"]]
                assert parent["start_ns"] <= sp["start_ns"] <= sp["end_ns"] <= parent["end_ns"]
        return got

    render, fetch, seq, render2 = sorted(roots, key=lambda r: r["start_ns"])
    assert tree(render) == tree(render2) == sorted([
        ("scene.stage", "scene.render"), ("graph.replay", "scene.render"), ("frame.clone", "scene.render")])
    assert tree(fetch) == sorted([("fetch.wait", "scene.fetch"), ("fetch.copy", "scene.fetch")])
    assert tree(seq) == sorted([("sequence.issue", "scene.render_sequence"),
                                ("sequence.wait", "scene.render_sequence"),
                                ("sequence.copy", "scene.render_sequence"),
                                ("sequence.alloc", "sequence.issue"), ("sequence.angles", "sequence.issue")]
                               + [("graph.replay", "sequence.issue")] * len(CAMS))
    assert len({sp["call"] for sp in spans}) == 4
    counters = snap["counters"]
    assert counters["graph.captures"] == 2 and counters["graph.hits"] == 1
    assert counters["shade.frames"] == 2 + len(CAMS) + 2  # each capture's run, then each replay


@pytest.mark.parametrize("on", [False, True])
def test_spans_are_profiler_ranges(tracer, tmp_path, on):
    s = scene()
    if on:
        timing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        public_calls(s)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert ranges >= {"scene.render", "scene.stage", "scene.fetch", "fetch.wait", "fetch.copy",
                      "scene.render_sequence", "sequence.issue", "sequence.wait", "sequence.copy"}
    assert bool(timing.snapshot()["spans"]) == on


def test_graph_cache_counts(tracer):
    cache = GraphCache(size=2)
    made = []
    timing.enable()
    for key in "abacb":  # a, b captured; a hit; c evicts b; b evicts a
        cache.get(key, lambda key=key: made.append(key) or key)
    assert made == ["a", "b", "c", "b"]
    counters = timing.snapshot()["counters"]
    assert (counters["graph.captures"], counters["graph.hits"], counters["graph.evictions"]) == (4, 1, 2)
    timing.disable()
    cache.get("d", lambda: "d")
    assert timing.snapshot()["counters"] == {}


def test_spans_bounded_and_apart_by_thread(tracer, monkeypatch):
    monkeypatch.setattr(timing, "MAX_SPANS", 6)
    timing.enable()
    barrier = threading.Barrier(2)

    def work():
        barrier.wait()
        for _ in range(3):
            with timing.span("outer"):
                with timing.span("inner"):
                    pass

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    snap = timing.snapshot()
    assert len(snap["spans"]) == 6 and snap["dropped"]["spans"] == 6
    by_id = {sp["id"]: sp for sp in snap["spans"]}
    for sp in snap["spans"]:
        if sp["name"] == "outer":
            assert sp["parent"] is None and sp["call"] == sp["id"]
        else:
            assert sp["call"] == sp["parent"]
            if sp["parent"] in by_id:
                assert by_id[sp["parent"]]["name"] == "outer"
    assert timing.snapshot()["dropped"] == {"spans": 0, "frames": 0}


def test_shade_chunks_is_the_chunk_rule(tracer):
    """Strips covered by a small sphere (under the first chunk's end of
    32 of 256 slots) and by a large one (over it)."""
    chunks = {}
    for radius in (0.25, 0.7):
        s = scene(radius, strip_batch=8)
        cfg = s.config
        n = int((s.render()["z"] > F32_MIN).reshape(-1, cfg.strip_len).any(-1).sum())
        slots = -(-(cfg.width * cfg.height // cfg.strip_len) // cfg.strip_batch) * cfg.strip_batch
        bounds = tframe.shade_chunks(slots, cfg.strip_batch)
        assert bounds == [(0, 32), (32, 128), (128, 256)]
        timing.enable()
        s.render()
        counters = timing.snapshot()["counters"]
        timing.disable()
        assert counters["shade.frames"] == 1
        assert counters["shade.chunks"] == sum(start < n for start, _ in bounds)
        chunks[radius] = (n, counters["shade.chunks"])
    assert chunks[0.25][0] < 32 < chunks[0.7][0]
    assert chunks[0.25][1] == 1 < chunks[0.7][1]


def test_ring_bookkeeping(tracer):
    """Frames issued into a ring of 4 (the stamps written by the mark
    kernel's plain version, as a replay would): the ring keeps the last 4,
    the 2 it overwrote are dropped, each kept frame gives its stages, span,
    covered count, chunks and call id."""
    ring = timing._Ring(torch.device("cpu"), frames=4)
    marks = timing.FrameMarks(ring)
    marks.labels, marks.chunk_starts = list(FRAME_MARKS), (0, 32, 128)
    # ns from the previous mark: start, vertex, the light pass's binning
    # steps and stage mark, raster, the camera pass's, raster, shade.
    steps = [0, 1000, 40, 60, 30, 50, 20, 300, 20, 30, 10, 30, 10, 400, 500]

    def replay(k, covered):
        def launch():
            t = 10_000 * k
            for slot, step in enumerate(steps):
                t += step
                last = slot == len(steps) - 1
                timing.mark_reference(ring.words, slot, slot == 0, covered if last else None, now_ns=t)
        return launch

    timing.enable()
    calls = []
    for k, covered in enumerate((5, 40, 0, 31, 32, 200)):
        with timing.span("scene.render") as sp:
            ring.issue(marks, replay(k, covered))
            calls.append(sp.id)
    got, dropped = ring.drain()
    assert dropped == 2 and len(got) == 4 and ring.drain() == ([], 0)
    for fr, call, covered, chunks in zip(got, calls[2:], (0, 31, 32, 200), (0, 1, 1, 3)):
        assert fr["call"] == call and fr["labels"] == FRAME_MARKS
        assert fr["stages"] == pytest.approx({"vertex": 1e-3, "binning": 3e-4, "raster": 7e-4, "shade": 5e-4,
                                              "binning.keys": 6e-5, "binning.sort": 9e-5, "binning.csr": 4e-5,
                                              "binning.records": 8e-5})
        assert fr["span_ms"] == pytest.approx(sum(v for k, v in fr["stages"].items() if "." not in k))
        assert fr["covered"] == covered and fr["chunks"] == chunks
        assert fr["stamps_ns"] == sorted(fr["stamps_ns"])
    # A frame without a covered count (no strip shade) reads none.
    ring.issue(marks, lambda: [timing.mark_reference(ring.words, slot, slot == 0, now_ns=slot)
                               for slot in range(len(steps))])
    (fr,), _ = ring.drain()
    assert fr["covered"] is None and fr["chunks"] is None


def test_drain_points_wait_for_half_a_ring(tracer, monkeypatch):
    """The program's drain points leave a ring alone until it holds half a
    ring of frames; a snapshot drains every frame."""
    ring = timing._Ring(torch.device("cpu"), frames=8)
    marks = timing.FrameMarks(ring)
    marks.labels = ["start", "shade"]
    monkeypatch.setattr(timing, "_RINGS", {0: ring})
    timing.enable()

    def frame():
        ring.issue(marks, lambda: [timing.mark_reference(ring.words, slot, slot == 0) for slot in (0, 1)])

    for _ in range(3):
        frame()
        timing.drain()
    assert len(ring.issued) == 3
    frame()
    timing.drain()
    assert not ring.issued
    frame()
    snap = timing.snapshot()
    assert len(snap["frames"]) == 5 and not ring.issued and snap["dropped"]["frames"] == 0


def test_snapshot_after_disable_drains(tracer, monkeypatch):
    """Frames issued while the tracer was on are the snapshot's after it
    is turned off, numbered in the order they ran; none waits in the ring
    for the next session."""
    ring = timing._Ring(torch.device("cpu"), frames=8)
    marks = timing.FrameMarks(ring)
    marks.labels = ["start", "shade"]
    monkeypatch.setattr(timing, "_RINGS", {0: ring})
    timing.enable()
    for _ in range(3):
        ring.issue(marks, lambda: [timing.mark_reference(ring.words, slot, slot == 0) for slot in (0, 1)])
    timing.disable()
    snap = timing.snapshot()
    assert [fr["frame"] for fr in snap["frames"]] == [1, 2, 3] and not ring.issued
    timing.enable()
    assert timing.snapshot()["frames"] == []


def test_marks_that_did_not_run_read_absent(tracer):
    """A frame whose second chunk body was skipped (its two marks did not
    run), in the row an earlier frame filled (a ring of one frame): its
    marks read absent, not the earlier frame's stamps; the stage after them
    is charged from the last stamp present, and no stage is negative."""
    labels = ["start", "vertex", "shade", "probe", "shade", "probe", "shade"]
    ring = timing._Ring(torch.device("cpu"), frames=1)
    marks = timing.FrameMarks(ring)
    marks.labels = list(labels)

    def frame(t0, skipped=()):
        def launch():
            for slot in range(len(labels)):
                if slot not in skipped:
                    timing.mark_reference(ring.words, slot, slot == 0, now_ns=t0 + 100 * slot,
                                          pixels=50 if slot == len(labels) - 1 else None)
        return launch

    ring.issue(marks, frame(1_000))
    (full,), _ = ring.drain()
    assert full["stages"] == pytest.approx({"vertex": 1e-4, "shade": 3e-4, "probe": 2e-4})
    assert full["pixels"] == 50
    ring.issue(marks, frame(5_000, skipped=(4, 5)))
    row = ring.words[1].tolist()
    assert row[4] == row[5] == -1  # cleared by the frame's first mark
    (fr,), dropped = ring.drain()
    assert dropped == 0 and fr["labels"] == labels
    assert fr["stamps_ns"] == [5_000, 5_100, 5_200, 5_300, None, None, 5_600]
    assert fr["stages"] == pytest.approx({"vertex": 1e-4, "shade": 1e-4 + 3e-4, "probe": 1e-4})
    assert all(v >= 0 for v in fr["stages"].values())
    assert fr["span_ms"] == pytest.approx(6e-4) and fr["pixels"] == 50


OCCLUSION_MARKS = ["vertex", *BINNING, "raster", *BINNING, "raster", "shade", "probe", "shade"]


def test_steps_add_into_their_stage(tracer):
    """A frame with binning's step marks against the same frame without
    them (the stamps of the marks both have equal): every stage but the
    steps reads the same, binning the same stamp interval, and the steps
    sum to it less the piece from the last step to the stage's own mark."""
    rng = np.random.default_rng(3)
    stamps = np.cumsum(rng.integers(100, 5_000, size=len(FRAME_MARKS))).tolist()
    stepless = [k for k, label in enumerate(FRAME_MARKS) if "." not in label]

    def drained(labels, times):
        ring = timing._Ring(torch.device("cpu"), frames=2)
        marks = timing.FrameMarks(ring)
        marks.labels = list(labels)
        ring.issue(marks, lambda: [timing.mark_reference(ring.words, slot, slot == 0, now_ns=t)
                                   for slot, t in enumerate(times)])
        (fr,), _ = ring.drain()
        return fr

    fr = drained(FRAME_MARKS, stamps)
    before = drained([FRAME_MARKS[k] for k in stepless], [stamps[k] for k in stepless])
    assert {k: v for k, v in fr["stages"].items() if "." not in k} == pytest.approx(before["stages"])
    assert fr["span_ms"] == before["span_ms"]
    steps = sum(v for k, v in fr["stages"].items() if k.startswith("binning."))
    tails = [stamps[k] - stamps[k - 1] for k, label in enumerate(FRAME_MARKS) if label == "binning"]
    assert fr["stages"]["binning"] == pytest.approx(steps + sum(tails) / 1e6)
    spanned = sum(stamps[k] - stamps[k - 5] for k, label in enumerate(FRAME_MARKS) if label == "binning")
    assert fr["stages"]["binning"] == pytest.approx(spanned / 1e6)


def test_calibration_recovers_a_fake_clock(tracer):
    """calibrate() against a device clock a known offset from a fake host
    clock, read at a random point of each round trip of random length: the
    offset within the reported error, the error half the shortest round
    trip; the clock over a period and stamps moved onto the host's clock;
    a CPU ring's offset and error 0."""
    rng = np.random.default_rng(11)
    offset = 1_234_567_891
    now, trips, stamped = [50_000], [], []

    def stamp():
        before, after = (int(x) for x in rng.integers(200, 40_000, size=2))
        now[0] += before
        stamped.append(now[0] + offset)
        now[0] += after
        trips.append(before + after)

    got = timing.calibrate(stamp, lambda: stamped[-1], clock=lambda: now[0], rounds=16)
    assert len(trips) == 16 and got["error_ns"] == -(-min(trips) // 2)
    assert abs(got["offset_ns"] - offset) <= got["error_ns"]
    start = {"offset_ns": 1_000, "error_ns": 5, "host_ns": 0}
    end = {"offset_ns": 1_100, "error_ns": 7, "host_ns": 1_000_000}
    period = timing.clock_period(start, end)
    assert period["error_ns"] == 7 and period["drift_ppm"] == pytest.approx(100.0)
    assert timing.to_host([1_000, None, 500_000 + 1_050, 1_001_100], start, end) == [0, None, 500_000, 1_000_000]
    cpu = timing._Ring(torch.device("cpu"), frames=2).calibrate()
    assert cpu["offset_ns"] == cpu["error_ns"] == 0


def gap_frame(number, call, first, last):
    return {"frame": number, "call": call, "device": "cpu", "stamps_ns": [first, None, last],
            "host_ns": [first, None, last]}


def test_gaps_split_over_host_spans(tracer):
    """Gaps between synthetic frames: one within a call, one at a call
    boundary, none after a frame the ring dropped; each gap's interval
    split over the innermost span open on any thread, "host" where none."""
    frames = [gap_frame(1, 1, 1_000, 1_500), gap_frame(2, 1, 1_700, 2_300), gap_frame(3, 5, 3_000, 3_400),
              gap_frame(5, 5, 3_600, 3_900)]  # frame 4 dropped
    sp = [("scene.render_sequence", 900, 2_500, 1, None, 1), ("sequence.issue", 950, 1_600, 2, 1, 1),
          ("graph.replay", 1_550, 1_600, 3, 2, 1), ("sequence.copy", 2_000, 2_500, 4, 1, 1),
          ("serve.request", 2_600, 2_700, 9, None, 9),  # another thread's call
          ("scene.render_sequence", 2_800, 3_950, 5, None, 5), ("sequence.issue", 2_850, 3_100, 6, 5, 5),
          ("sequence.alloc", 2_850, 2_900, 7, 6, 5)]
    spans = [{"name": n, "start_ns": a, "end_ns": b, "ms": (b - a) / 1e6, "id": i, "parent": p, "call": c}
             for n, a, b, i, p, c in sp]
    gaps = timing.frame_gaps(frames, spans)
    assert [(g["after_frame"], g["call_boundary"]) for g in gaps] == [(1, False), (2, True)]
    assert [g["ms"] for g in gaps] == pytest.approx([2e-4, 7e-4])
    assert gaps[0]["host_ms"] == pytest.approx({"sequence.issue": 5e-5, "graph.replay": 5e-5,
                                                "scene.render_sequence": 1e-4})
    assert gaps[1]["host_ms"] == pytest.approx({"sequence.copy": 2e-4, "host": 2e-4, "serve.request": 1e-4,
                                                "scene.render_sequence": 5e-5, "sequence.alloc": 5e-5,
                                                "sequence.issue": 1e-4})


def test_snapshot_gaps_clock_and_report(tracer, monkeypatch):
    """Frames issued into a CPU ring under spans: each snapshot holds the
    gaps between its own frames only (none before its first), a gap
    within a call under that call's span, one between calls partly in
    "host"; the frames' host stamps their stamps (offset 0), the clock's
    offset, error and drift 0; report() prints binning's steps, both kinds
    of gap and the clock."""
    ring = timing._Ring(torch.device("cpu"), frames=8)
    marks = timing.FrameMarks(ring)
    marks.labels = ["start", "binning.keys", "binning", "shade"]
    monkeypatch.setattr(timing, "_RINGS", {0: ring})
    timing.enable()

    def frame():
        ring.issue(marks, lambda: [timing.mark_reference(ring.words, slot, slot == 0) for slot in range(4)])

    with timing.span("scene.render_sequence"):
        frame()
        frame()
    snap = timing.snapshot()
    assert snap["clock"] == {"cpu": {"offset_ns": [0, 0], "host_ns": snap["clock"]["cpu"]["host_ns"],
                                     "error_ns": 0, "drift_ppm": 0.0}}
    assert all(fr["host_ns"] == fr["stamps_ns"] for fr in snap["frames"])
    (gap,) = snap["gaps"]
    assert not gap["call_boundary"] and set(gap["host_ms"]) <= {"scene.render_sequence", "graph.replay"}
    for _ in range(2):
        with timing.span("scene.render_sequence"):
            frame()
        time.sleep(0.002)
    snap = timing.snapshot()
    (gap,) = snap["gaps"]  # none between the two snapshots
    assert gap["call_boundary"] and gap["host_ms"]["host"] >= 1.0
    assert sum(gap["host_ms"].values()) == pytest.approx(gap["ms"], abs=1e-6)
    text = timing.report(snap)
    assert re.search(r"^  binning steps \(median ms\): keys [0-9.]+; of binning [0-9.]+$", text, re.M)
    assert re.search(r"^gaps between frames at call boundaries: 1, median [0-9.]+ ms, total [0-9.]+ ms; "
                     r"the host meanwhile \(ms\): host [0-9.]+", text, re.M)
    assert "clock cpu: offset 0 ns, error 0 ns, drift 0.00 ppm" in text and "within a call" not in text
    assert "within a call: 1," in timing.report({**snap, "gaps": [dict(gap, call_boundary=False)]})


def occlusion_scene(radius=0.45, size=64):
    model = Model(mesh=make_uv_sphere(radius, 8, 10), **make_textures(16))
    s = Scene(model, "occlusion", RenderConfig(width=size, height=size), device="cpu")
    s.set_light_direction([0.3, 0.0, 0.95])
    s.set_camera([0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    return s


def test_occlusion_probe_and_pixels_cpu(tracer):
    """A traced eager occlusion frame counts its covered pixels (the
    counter occlusion.pixels); under marks, on a CPU ring, the frame gives
    the probe's stage and the same pixels.  A shadow frame counts none."""
    s = occlusion_scene()
    covered = int((s.render()["z"] > F32_MIN).sum())
    assert covered > 0
    timing.enable()
    s.render()
    counters = timing.snapshot()["counters"]
    assert counters["occlusion.pixels"] == covered and counters["shade.frames"] == 1
    ring = timing._Ring(torch.device("cpu"), frames=4)
    with timing.marking(ring) as marks:
        s.render()  # eagerly every mark writes its stamp now, as a replay would
    ring.issue(marks, lambda: None)
    (fr,), _ = ring.drain()
    assert fr["labels"] == OCCLUSION_MARKS
    assert fr["stages"]["probe"] > 0 and fr["pixels"] == covered and fr["chunks"] == 1
    scene().render()
    assert "occlusion.pixels" not in timing.snapshot()["counters"]


def darboux_scene(radius=0.45, size=64, **knobs):
    model = Model(mesh=make_uv_sphere(radius, 8, 10), **make_textures(16))
    s = Scene(model, "darboux", RenderConfig(width=size, height=size, **knobs), device="cpu")
    s.set_light_direction([0.3, 0.0, 0.95])
    s.set_camera([0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    return s


DARBOUX_MARKS = ["vertex", "darboux_setup", "vertex", *BINNING, "raster", "shade", "darboux", "shade"]


def test_darboux_stages_and_pixels_cpu(tracer):
    """A traced eager darboux frame counts its covered pixels (the counter
    darboux.pixels, not occlusion.pixels); under marks, on a CPU ring, the
    frame gives the Darboux pieces' stage darboux_setup, the shade's stage
    darboux and the same pixels."""
    s = darboux_scene()
    covered = int((s.render()["z"] > F32_MIN).sum())
    assert covered > 0
    timing.enable()
    s.render()
    counters = timing.snapshot()["counters"]
    assert counters["darboux.pixels"] == covered and counters["shade.frames"] == 1
    assert "occlusion.pixels" not in counters
    ring = timing._Ring(torch.device("cpu"), frames=4)
    with timing.marking(ring) as marks:
        s.render()  # eagerly every mark writes its stamp now, as a replay would
    ring.issue(marks, lambda: None)
    (fr,), _ = ring.drain()
    assert fr["labels"] == DARBOUX_MARKS
    assert fr["stages"]["darboux_setup"] > 0 and fr["stages"]["darboux"] > 0
    assert fr["pixels"] == covered and fr["pixels_counter"] == "darboux.pixels" and fr["chunks"] == 1


def test_darboux_skipped_body_reads_absent(tracer, monkeypatch):
    """A darboux frame of three chunk bodies (strip_batch 8) whose covered
    strips end inside the first: the second and third bodies are skipped
    as a replay skips them (their mark nodes do not run), so their darboux
    marks read absent and the stage darboux is the first body's alone."""
    s = darboux_scene(radius=0.25, strip_batch=8)
    covered = int((s.render()["z"] > F32_MIN).sum())
    ring = timing._Ring(torch.device("cpu"), frames=4)
    skipped, real_mark = [False], ring.mark
    monkeypatch.setattr(ring, "mark", lambda *a, **k: None if skipped[0] else real_mark(*a, **k))

    def device_if(pred, body):
        skipped[0] = not bool(pred)
        try:
            body()
        finally:
            skipped[0] = False

    monkeypatch.setattr(graphs, "device_if", device_if)
    timing.enable()
    with timing.marking(ring) as marks:
        s.render()
    ring.issue(marks, lambda: None)
    (fr,), _ = ring.drain()
    b = DARBOUX_MARKS.index("raster") + 1  # the first body's first mark
    bodies = DARBOUX_MARKS[b:b + 2] * 3
    assert fr["labels"] == DARBOUX_MARKS[:b] + bodies + ["shade"]
    stamps = fr["stamps_ns"]
    assert stamps[b + 2:b + 6] == [None] * 4 and None not in stamps[:b + 2] + stamps[b + 6:]
    assert fr["stages"]["darboux"] == pytest.approx((stamps[b + 1] - stamps[b]) / 1e6)
    assert fr["stages"]["shade"] == pytest.approx((stamps[b] - stamps[b - 1] + stamps[b + 6] - stamps[b + 1]) / 1e6)
    assert fr["chunks"] == 1 and fr["pixels"] == covered


def test_drained_pixels_go_to_their_shade_counter(tracer, monkeypatch):
    """Frames drained from a device's ring: an occlusion frame's pixels go
    to occlusion.pixels and a darboux frame's to darboux.pixels, each with
    its own stages; a shadow frame keeps FRAME_MARKS and stamps no pixels."""
    ring = timing._Ring(torch.device("cpu"), frames=8)
    monkeypatch.setattr(timing, "_RINGS", {0: ring})
    timing.enable()
    covered = {}
    for name, make in (("occlusion", occlusion_scene), ("darboux", darboux_scene), ("shadow", scene)):
        s = make()
        with timing.marking(ring) as marks:
            covered[name] = int((s.render()["z"] > F32_MIN).sum())
        ring.issue(marks, lambda: None)
    snap = timing.snapshot()
    occ, darb, shadow = snap["frames"]
    assert "probe" in occ["stages"] and occ["pixels"] == covered["occlusion"]
    assert "darboux" in darb["stages"] and darb["pixels"] == covered["darboux"]
    assert shadow["labels"] == FRAME_MARKS[1:] and shadow["pixels"] is None
    assert snap["counters"]["occlusion.pixels"] == covered["occlusion"]
    assert snap["counters"]["darboux.pixels"] == covered["darboux"]


def specular_scene(radius=0.45, size=64, **knobs):
    model = Model(mesh=make_uv_sphere(radius, 8, 10), **make_textures(16))
    s = Scene(model, "specular", RenderConfig(width=size, height=size, **knobs), device="cpu")
    s.set_light_direction([0.3, 0.0, 0.95])
    s.set_camera([0.2, 0.0, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    return s


SPECULAR_MARKS = ["vertex", *BINNING, "raster", "shade", "specular", "shade"]


def test_specular_stage_and_pixels_cpu(tracer):
    """A traced eager specular frame counts its covered pixels (the counter
    specular.pixels, not darboux.pixels or occlusion.pixels); under marks,
    on a CPU ring, the frame gives the shade's stage specular and the same
    pixels, and its frame bytes are those of the untraced frame."""
    s = specular_scene()
    untraced = s.render()
    covered = int((untraced["z"] > F32_MIN).sum())
    assert covered > 0
    timing.enable()
    traced = s.render()
    assert torch.equal(traced["frame"], untraced["frame"])
    counters = timing.snapshot()["counters"]
    assert counters["specular.pixels"] == covered and counters["shade.frames"] == 1
    assert "darboux.pixels" not in counters and "occlusion.pixels" not in counters
    ring = timing._Ring(torch.device("cpu"), frames=4)
    with timing.marking(ring) as marks:
        s.render()  # eagerly every mark writes its stamp now, as a replay would
    ring.issue(marks, lambda: None)
    (fr,), _ = ring.drain()
    assert fr["labels"] == SPECULAR_MARKS
    assert fr["stages"]["specular"] > 0 and fr["stages"]["shade"] > 0
    assert fr["pixels"] == covered and fr["pixels_counter"] == "specular.pixels" and fr["chunks"] == 1


def test_specular_skipped_body_reads_absent(tracer, monkeypatch):
    """A specular frame of three chunk bodies (strip_batch 8) whose covered
    strips end inside the first: the second and third bodies are skipped
    as a replay skips them (their mark nodes do not run), so their specular
    marks read absent and the stage specular is the first body's alone."""
    s = specular_scene(radius=0.25, strip_batch=8)
    covered = int((s.render()["z"] > F32_MIN).sum())
    ring = timing._Ring(torch.device("cpu"), frames=4)
    skipped, real_mark = [False], ring.mark
    monkeypatch.setattr(ring, "mark", lambda *a, **k: None if skipped[0] else real_mark(*a, **k))

    def device_if(pred, body):
        skipped[0] = not bool(pred)
        try:
            body()
        finally:
            skipped[0] = False

    monkeypatch.setattr(graphs, "device_if", device_if)
    timing.enable()
    with timing.marking(ring) as marks:
        s.render()
    ring.issue(marks, lambda: None)
    (fr,), _ = ring.drain()
    b = SPECULAR_MARKS.index("raster") + 1  # the first body's first mark
    bodies = SPECULAR_MARKS[b:b + 2] * 3
    assert fr["labels"] == SPECULAR_MARKS[:b] + bodies + ["shade"]
    stamps = fr["stamps_ns"]
    assert stamps[b + 2:b + 6] == [None] * 4 and None not in stamps[:b + 2] + stamps[b + 6:]
    assert fr["stages"]["specular"] == pytest.approx((stamps[b + 1] - stamps[b]) / 1e6)
    assert fr["stages"]["shade"] == pytest.approx((stamps[b] - stamps[b - 1] + stamps[b + 6] - stamps[b + 1]) / 1e6)
    assert fr["chunks"] == 1 and fr["pixels"] == covered


@pytest.mark.parametrize("name, make, labels, counter", [
    ("shadow", scene, FRAME_MARKS[1:], None),
    ("darboux", darboux_scene, DARBOUX_MARKS, "darboux.pixels"),
    ("occlusion", occlusion_scene, OCCLUSION_MARKS, "occlusion.pixels"),
    ("specular", specular_scene, SPECULAR_MARKS, "specular.pixels"),
], ids=["shadow", "darboux", "occlusion", "specular"])
def test_each_pipeline_marks_its_own_stages(tracer, monkeypatch, name, make, labels, counter):
    """Frames drained from a device's ring, one pipeline a case: each
    frame's mark list is its pipeline's own (the shadow and darboux frames'
    unchanged by the specular marks), and its covered pixels go to its
    shade's counter only (none for shadow)."""
    ring = timing._Ring(torch.device("cpu"), frames=4)
    monkeypatch.setattr(timing, "_RINGS", {0: ring})
    timing.enable()
    s = make()
    with timing.marking(ring) as marks:
        covered = int((s.render()["z"] > F32_MIN).sum())
    ring.issue(marks, lambda: None)
    snap = timing.snapshot()
    (fr,) = snap["frames"]
    assert fr["labels"] == labels
    pixel_counters = {k for k in snap["counters"] if k.endswith(".pixels")}
    if counter is None:
        assert fr["pixels"] is None and not pixel_counters
    else:
        assert fr["pixels"] == covered and fr["pixels_counter"] == counter
        assert pixel_counters == {counter} and snap["counters"][counter] == covered


@pytest.mark.parametrize("make", [scene, occlusion_scene], ids=["shadow", "occlusion"])
def test_burst_fills_host_frames_cpu(tracer, make):
    """render_burst with a host destination (render_sequence's on CUDA) on
    CPU tensors fills it with the keep_frames frames, byte for byte, and
    returns it as the frames, with the same checksums and flags."""
    s = make()
    args = (s._geom, s._textures, torch.tensor(CAMS), torch.tensor(LIGS))
    kw = dict(pipeline=s.pipeline_name, config=s.config)
    kept = tframe.render_burst(*args, keep_frames=True, **kw)
    host = torch.zeros((len(CAMS), s.config.height, s.config.width, 3), dtype=torch.uint8)
    timing.enable()
    out = tframe.render_burst(*args, host_frames=host, **kw)
    assert out["frames"] is host and "copied" not in out
    assert torch.equal(host, kept["frames"]) and bool(host.any())
    assert torch.equal(out["checksums"], kept["checksums"]) and torch.equal(out["overflow"], kept["overflow"])
    assert timing.snapshot()["counters"].get("sequence.overlapped", 0) == 0


def test_render_sequence_cpu_spans_and_no_overlap(tracer):
    """On the CPU render_sequence stays eager and copies nothing to pinned
    memory: its three spans under it, the frames it returned counted,
    sequence.overlapped 0, and the frames those of render_burst."""
    s = scene()
    timing.enable()
    seq = s.render_sequence(CAMS, LIGS)
    snap = timing.snapshot()
    root, = [sp for sp in snap["spans"] if sp["parent"] is None]
    assert root["name"] == "scene.render_sequence"
    assert sorted(sp["name"] for sp in snap["spans"] if sp["parent"] == root["id"]) == [
        "sequence.copy", "sequence.issue", "sequence.wait"]
    assert snap["counters"]["sequence.frames"] == len(CAMS)
    assert snap["counters"].get("sequence.overlapped", 0) == 0
    kept = tframe.render_burst(s._geom, s._textures, torch.tensor(CAMS), torch.tensor(LIGS),
                               pipeline="shadow", config=s.config, keep_frames=True)
    assert np.array_equal(seq, kept["frames"].numpy()[:, ::-1])


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def card_scene(card):
    from tiny_renderer_tpu_torch.app import flagship_model

    s = Scene(flagship_model(), "shadow", RenderConfig(), device=card)
    s.set_light_direction([0.3, 0.0, 0.95])
    return s


POSES = ([0.2, 0.0, 0.98], [-0.6, 0.0, 0.8], [0.9, 0.0, 0.44])


def traced_calls(s):
    out = []
    for look_from in POSES:
        s.set_camera(look_from, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
        s.render()
        out.append(s.get_frame_buffer())
    return out, s.render_sequence(np.linspace(0.0, 1.0, 8), np.linspace(0.5, -0.5, 8))


# A replayed frame's stamp span against CUDA events around the same
# Scene.render, queued behind a sleep so the events time the device alone:
# the events hold besides the span the view's copies in, the three output
# clones and the first and last mark's own launches (0.038-0.041 ms over 40
# frames on an H100).
EVENT_EXTRA_MS = (0.01, 0.1)


@pytest.mark.card
def test_card_frames_equal_and_stamps(card, tracer):
    s = card_scene(card)
    off, seq_off = traced_calls(s)
    timing.enable()
    on, seq_on = traced_calls(s)
    snap = timing.snapshot()
    events = []
    for look_from in POSES:
        s.set_camera(look_from, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
        torch.cuda._sleep(50_000_000)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        s.render()
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize(card)
    timed = timing.snapshot()
    timing.disable()
    assert all(np.array_equal(a, b) for a, b in zip(off, on)) and np.array_equal(seq_off, seq_on)
    frames = snap["frames"]
    assert len(frames) == len(POSES) + 8 and snap["dropped"]["frames"] == 0
    assert [fr["frame"] for fr in frames] == list(range(frames[0]["frame"], frames[0]["frame"] + len(frames)))
    roots = {sp["id"]: sp["name"] for sp in snap["spans"] if sp["parent"] is None}
    for fr in frames:
        assert fr["labels"] == FRAME_MARKS + (["shade"] if roots[fr["call"]] == "scene.render_sequence" else [])
        assert fr["stamps_ns"] == sorted(fr["stamps_ns"])
        assert fr["covered"] > 0 and fr["chunks"] >= 1
    assert [roots[fr["call"]] for fr in frames] == ["scene.render"] * len(POSES) + ["scene.render_sequence"] * 8
    assert len(timed["frames"]) == len(POSES) and timed["dropped"]["frames"] == 0
    for fr, (a, b) in zip(timed["frames"], events):
        extra = a.elapsed_time(b) - fr["span_ms"]
        assert EVENT_EXTRA_MS[0] <= extra <= EVENT_EXTRA_MS[1], (a.elapsed_time(b), fr["span_ms"])


# The most a card's clock calibration may be off by (half its shortest
# round trip of a mark and a synchronize).
CLOCK_ERROR_NS = 25_000


@pytest.mark.card
def test_card_sequence_on_the_host_clock(card, tracer):
    """Two traced 60-frame render_sequence calls after the one that
    captures the graph: the clock's error within CLOCK_ERROR_NS and its
    drift a number; the k-th frame of a call starts on the host's clock no
    earlier than the call's k-th graph.replay span less the error, and
    ends no later than the call's sequence.copy span plus it; the gaps
    (one at the call boundary) and the frames' spans sum to the ring's
    first-to-last stamp."""
    s = card_scene(card)
    cams, ligs = np.linspace(0.0, 1.0, 60), np.linspace(0.5, -0.5, 60)
    timing.enable()
    s.render_sequence(cams, ligs)  # captures the traced burst graph
    timing.snapshot()
    for _ in range(2):
        s.render_sequence(cams, ligs)
    snap = timing.snapshot()
    timing.disable()
    frames, gaps = snap["frames"], snap["gaps"]
    assert len(frames) == 120 and snap["dropped"] == {"spans": 0, "frames": 0}
    clock = snap["clock"][str(card)]
    err = clock["error_ns"]
    assert 0 <= err <= CLOCK_ERROR_NS and math.isfinite(clock["drift_ppm"]), clock
    spans = collections.defaultdict(list)
    for sp in sorted(snap["spans"], key=lambda sp: sp["start_ns"]):
        spans[sp["call"], sp["name"]].append(sp)
    issued = collections.Counter()
    for fr in frames:
        replay = spans[fr["call"], "graph.replay"][issued[fr["call"]]]
        issued[fr["call"]] += 1
        (copy,) = spans[fr["call"], "sequence.copy"]
        host = [t for t in fr["host_ns"] if t is not None]
        assert host[0] >= replay["start_ns"] - err, (host[0] - replay["start_ns"], err)
        assert host[-1] <= copy["end_ns"] + err, (host[-1] - copy["end_ns"], err)
    assert list(issued.values()) == [60, 60]
    assert len(gaps) == 119 and [g["after_frame"] for g in gaps if g["call_boundary"]] == [frames[59]["frame"]]
    first, last = frames[0]["stamps_ns"][0], [t for t in frames[-1]["stamps_ns"] if t is not None][-1]
    assert sum(g["ms"] for g in gaps) + sum(fr["span_ms"] for fr in frames) == pytest.approx((last - first) / 1e6)
    assert all(g["ms"] >= 0 and sum(g["host_ms"].values()) == pytest.approx(g["ms"], abs=1e-3) for g in gaps)


# Kernels the CUDA driver runs for a graph's memset and memcpy nodes: it
# may run those nodes as these kernels or as copies and sets of their own,
# and with the mark nodes in the graph it takes the latter.
DRIVER_KERNELS = ("memset32", "memcpy32_post")


@pytest.mark.card
def test_card_profiled_burst_kernels(card, tracer, tmp_path):
    """The device work of a profiled 8-frame burst with the tracer off,
    before and after the tracer ran (the same graph: the same kernels),
    and in the traced graph: the same work and one mark kernel a mark."""
    s = card_scene(card)
    cams = torch.linspace(0.0, 1.0, 8, device=card)
    ligs = torch.linspace(0.5, -0.5, 8, device=card)
    burst = tframe.make_burst_fn("shadow", s.config)

    def device_ops(name):
        burst(s._geom, s._textures, cams, ligs)  # the graph captured and warm
        torch.cuda.synchronize(card)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            burst(s._geom, s._textures, cams, ligs)
            torch.cuda.synchronize(card)
        prof.export_chrome_trace(str(tmp_path / f"{name}.json"))
        events = json.loads((tmp_path / f"{name}.json").read_text())["traceEvents"]
        # (The profiler names a set "Memset (Device)" or "Memset (Unknown)".)
        return collections.Counter((e["cat"], e["name"][:120] if e["cat"] != "gpu_memset" else "Memset")
                                   for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))

    before = device_ops("before")
    timing.enable()
    traced = device_ops("traced")
    timing.disable()
    after = device_ops("after")
    marks = sum(n for (cat, name), n in traced.items() if "mark_kernel" in name)
    assert after == before and not any("mark_kernel" in name for _, name in before)
    assert marks == 8 * len(FRAME_MARKS + ["shade"])
    assert sum(traced.values()) - marks == sum(before.values()), (traced - before, before - traced)

    def kernels(ops):
        return collections.Counter({k: n for k, n in ops.items() if k[0] == "kernel" and "mark_kernel" not in k[1]})

    assert not kernels(traced) - kernels(before)
    assert all(name in DRIVER_KERNELS for _, name in kernels(before) - kernels(traced))


@pytest.mark.card
def test_card_occlusion_burst_probe_and_pixels(card, tracer):
    """A traced 8-frame occlusion burst: every frame has a probe stage and
    its covered pixels, equal to the covered pixels of the same frame
    rendered eagerly with the tracer off; a traced shadow burst's frames
    keep their marks and carry no pixels."""
    from tiny_renderer_tpu_torch.app import flagship_model

    model = flagship_model()
    cams = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    ligs = np.linspace(0.5, -0.5, 8, dtype=np.float32)
    s = Scene(model, "occlusion", RenderConfig(), device=card)
    want = []
    for c, l in zip(cams, ligs):
        a = torch.tensor([c, l], device=card)
        zero = torch.zeros((), device=card)
        look_from = torch.stack([torch.sin(a[0]), zero, torch.cos(a[0])])
        light = torch.stack([torch.sin(a[1]), zero, torch.cos(a[1])])
        out = tframe.render_frame(s._geom, s._textures, light, look_from, torch.zeros(3, device=card),
                                  torch.tensor([0.0, 1.0, 0.0], device=card), pipeline="occlusion",
                                  config=s.config)
        want.append(int((out["z"] > F32_MIN).sum()))
    timing.enable()
    s.render_sequence(cams, ligs)
    shadow = Scene(model, "shadow", RenderConfig(), device=card)
    shadow.render_sequence(cams, ligs)
    frames = timing.snapshot()["frames"]
    timing.disable()
    occ = [fr for fr in frames if "probe" in fr["labels"]]
    assert len(occ) == 8 and len(frames) == 16
    for fr, n in zip(occ, want):
        assert fr["stages"]["probe"] > 0 and fr["pixels"] == n and fr["chunks"] >= 1
        assert fr["labels"][:14] == ["start", "vertex", *BINNING, "raster", *BINNING, "raster"]
        assert fr["labels"][-2:] == ["shade", "shade"]
    for fr in frames[8:]:
        assert fr["labels"] == FRAME_MARKS + ["shade"] and fr["pixels"] is None and fr["covered"] > 0


@pytest.mark.card
def test_card_darboux_burst_stages_and_pixels(card, tracer):
    """A traced 8-frame darboux burst: every frame has the Darboux pieces'
    stage and the shade's, and its covered pixels, equal to the covered
    pixels of the same frame rendered eagerly with the tracer off; the
    counter darboux.pixels is their sum with the first frame's again (the
    capture's eager warm-up renders the first pose, and an eager frame
    counts) and occlusion.pixels stays empty."""
    from tiny_renderer_tpu_torch.app import flagship_model

    cams = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    ligs = np.linspace(0.5, -0.5, 8, dtype=np.float32)
    s = Scene(flagship_model(), "darboux", RenderConfig(), device=card)
    want = []
    for c, l in zip(cams, ligs):
        a = torch.tensor([c, l], device=card)
        zero = torch.zeros((), device=card)
        look_from = torch.stack([torch.sin(a[0]), zero, torch.cos(a[0])])
        light = torch.stack([torch.sin(a[1]), zero, torch.cos(a[1])])
        out = tframe.render_frame(s._geom, s._textures, light, look_from, torch.zeros(3, device=card),
                                  torch.tensor([0.0, 1.0, 0.0], device=card), pipeline="darboux",
                                  config=s.config)
        want.append(int((out["z"] > F32_MIN).sum()))
    timing.enable()
    s.render_sequence(cams, ligs)
    snap = timing.snapshot()
    timing.disable()
    frames = snap["frames"]
    assert len(frames) == 8
    for fr, n in zip(frames, want):
        assert fr["labels"][:10] == ["start", "vertex", "darboux_setup", "vertex", *BINNING, "raster"]
        assert fr["labels"][-2:] == ["shade", "shade"]
        assert fr["stages"]["darboux_setup"] > 0 and fr["stages"]["darboux"] > 0
        assert fr["pixels"] == n and fr["chunks"] >= 1
    assert snap["counters"]["darboux.pixels"] == sum(want) + want[0]
    assert "occlusion.pixels" not in snap["counters"]


@pytest.mark.card
def test_card_specular_burst_stage_and_pixels(card, tracer):
    """A traced 8-frame specular burst: every frame has the shade's stage
    specular and its covered pixels, equal to the covered pixels of the
    same frame rendered eagerly with the tracer off; the counter
    specular.pixels is their sum with the first frame's again (the
    capture's eager warm-up frame counts); the frames equal the untraced
    burst's."""
    from tiny_renderer_tpu_torch.app import flagship_model

    cams = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    ligs = np.linspace(0.5, -0.5, 8, dtype=np.float32)
    s = Scene(flagship_model(), "specular", RenderConfig(), device=card)
    want = []
    for c, l in zip(cams, ligs):
        a = torch.tensor([c, l], device=card)
        zero = torch.zeros((), device=card)
        look_from = torch.stack([torch.sin(a[0]), zero, torch.cos(a[0])])
        light = torch.stack([torch.sin(a[1]), zero, torch.cos(a[1])])
        out = tframe.render_frame(s._geom, s._textures, light, look_from, torch.zeros(3, device=card),
                                  torch.tensor([0.0, 1.0, 0.0], device=card), pipeline="specular",
                                  config=s.config)
        want.append(int((out["z"] > F32_MIN).sum()))
    untraced = s.render_sequence(cams, ligs)
    timing.enable()
    traced = s.render_sequence(cams, ligs)
    snap = timing.snapshot()
    timing.disable()
    assert np.array_equal(traced, untraced)
    frames = snap["frames"]
    assert len(frames) == 8
    for fr, n in zip(frames, want):
        assert fr["labels"][:8] == ["start", "vertex", *BINNING, "raster"]
        assert fr["labels"][-2:] == ["shade", "shade"] and "specular" in fr["labels"]
        assert fr["stages"]["specular"] > 0 and fr["pixels"] == n and fr["chunks"] >= 1
    assert snap["counters"]["specular.pixels"] == sum(want) + want[0]
    assert "darboux.pixels" not in snap["counters"] and "occlusion.pixels" not in snap["counters"]
