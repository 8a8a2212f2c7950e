"""Timing and observability (``tiny_renderer_tpu.utils.timing``).

The reference's only instrumentation is an FPS counter printed once per
second (src/app.rs:230-242); FpsCounter reproduces it.  StageTimer adds
named wall-time stages that wait for the device, and `profile_trace`
wraps torch.profiler for a Chrome trace of host and device activity.

The tracer, off by default (``enable()``, ``disable()``, ``snapshot()``):

* host spans: ``with span(name):`` records the name, start and end
  (time.perf_counter_ns), the parent span and the id of the public call
  that caused it (the call id of the thread's outermost open span, shared
  by all its spans and device frames), kept in memory, at most MAX_SPANS
  (the rest counted as dropped), thread by thread.  Whenever a
  torch.profiler session records, each span is also a record_function
  range of the same name, with the tracer on or off, so the profiler's
  trace shows the program's spans on the timeline of the device activity;
* counters: ``count(name, n)``;
* device stage stamps: ``mark(label)`` in the capture of a frame graph
  (graphs.CapturedGraph(..., marked=True)) with the tracer on records a
  node of csrc/trace_mark.cu that writes %globaltimer into the device's
  ring of RING_FRAMES frames; at each replay the frame's first mark claims
  the next row and clears it, so a mark whose node the replay skipped (in
  the body of an IF node that did not run) reads absent.  Elsewhere (eager
  frames, the CPU, any other graph) mark does nothing.  ``shade_count``
  gives the strip shade's covered count to the frame's next mark, or,
  eagerly, reads it into the counters; ``shade_pixels`` and
  ``frame_pixels`` do the same with the covered pixels of a frame whose
  shade asks for them (the occlusion probe: counter ``occlusion.pixels``;
  the darboux shade: ``darboux.pixels``).  The ring is drained
  (``drain()``) where the program already waits for the device, once it
  holds half a ring of frames, and at each snapshot; each frame yields its
  stages' device ms (the time from the previous mark that ran to each mark
  that ran, summed by the mark's label), its device span (first mark to
  last), its covered count and chunk bodies, its covered pixels, and the
  call id of the call that issued it.  Frames overwritten before a drain
  are counted as dropped.

Off, a span site costs two module-level reads (the tracer's flag and
torch.autograd.profiler's), a mark site one; a graph captured with the
tracer off holds no mark.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import itertools
import os
import statistics
import threading
import time
from pathlib import Path

import torch
import torch.autograd.profiler as _profiler


class FpsCounter:
    """Prints `FPS --- N` once per second, like src/app.rs:230-242."""

    def __init__(self, enabled: bool = True, out=print):
        self.enabled = enabled
        self._out = out
        self._begin = time.monotonic()
        self._frames = 0

    def tick(self):
        if not self.enabled:
            return
        self._frames += 1
        now = time.monotonic()
        if now - self._begin > 1.0:
            self._out(f"FPS --- {self._frames}")
            self._begin = now
            self._frames = 0


class StageTimer:
    """Accumulates named stage wall times.  `sync`: a tensor whose CUDA
    device is synchronized before the stage's clock stops (nothing extra on
    the CPU, where torch ops finish before they return)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(f"{name}: {1e3 * total / n:.3f} ms/iter over {n} iters")
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Optional torch.profiler trace around a block (--profile): CPU
    activity, and CUDA activity when a GPU is present, exported as a Chrome
    trace to <log_dir>/trace.json."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# -- the tracer ---------------------------------------------------------------

MAX_SPANS = 100_000   # spans kept between snapshots (the rest counted as dropped)
MAX_FRAMES = 10_000   # drained device frames kept between snapshots
RING_FRAMES = 512     # frames a device's ring holds before it wraps
RING_SLOTS = 61       # marks a frame may make (more are counted, not recorded)
MARK_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "trace_mark.cu"

_ON = False           # the tracer's state
_MARKING = 0          # captures recording marks now (any thread)
_LOCK = threading.Lock()
_LOCAL = threading.local()  # .stack: [(span id, call id)] of open spans; .marks: FrameMarks
_IDS = itertools.count(1)
_spans = []           # (name, start ns, end ns, id, parent id, call id)
_frames = []          # drained device frames
_counters = collections.Counter()
_dropped = {"spans": 0, "frames": 0}
_RINGS = {}           # device index -> _Ring


def tracing() -> bool:
    """True while the tracer is on."""
    return _ON


def enable():
    """Turn the tracer on; on a CUDA machine build the mark kernel
    (csrc/trace_mark.cu) first, so that no capture builds it."""
    global _ON
    if torch.cuda.is_available():
        _mark_library()
    _ON = True


def disable():
    """Turn the tracer off (what it recorded stays until snapshot())."""
    global _ON
    _ON = False


class _Span:
    __slots__ = ("name", "rf", "rec", "id", "parent", "call", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = _ON
        if self.rec:
            stack = _stack()
            self.id = next(_IDS)
            self.parent, self.call = stack[-1] if stack else (None, self.id)
            stack.append((self.id, self.call))
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rec:
            t1 = time.perf_counter_ns()
            _stack().pop()
            with _LOCK:
                if len(_spans) < MAX_SPANS:
                    _spans.append((self.name, self.t0, t1, self.id, self.parent, self.call))
                else:
                    _dropped["spans"] += 1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager around one layer's work: a host span while the
    tracer is on, a record_function range while a profiler records."""
    if _ON or _profiler._is_profiler_enabled:
        return _Span(name)
    return _NULL


def _stack():
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _call_id():
    """The call id of this thread's open spans (None outside any)."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1][1] if stack else None


def count(name: str, n=1):
    """Add n to the counter `name` while the tracer is on."""
    if _ON:
        with _LOCK:
            _counters[name] += n


# -- device stage stamps ------------------------------------------------------

@functools.cache
def _mark_library():
    """csrc/trace_mark.cu, built with nvcc at first use, its functions'
    argument types set."""
    from ..ops import raster_cuda

    lib = ctypes.CDLL(str(raster_cuda.build(source=MARK_SOURCE)[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.trace_mark.argtypes = [p, p, i, i, i, i, p, p]
    lib.trace_mark_load.argtypes = []
    for f in (lib.trace_mark, lib.trace_mark_load):
        f.restype = i
    lib.trace_error_string.argtypes = [i]
    lib.trace_error_string.restype = ctypes.c_char_p
    return lib


def _check(err, what):
    if err:
        raise RuntimeError(f"trace mark: {what} failed: {_mark_library().trace_error_string(err).decode()}")


def mark_reference(words, slot, advance, covered=None, now_ns=None, pixels=None):
    """csrc/trace_mark.cu's mark_kernel in plain torch on a ring `words`
    ((frames + 1, stride) int64): the stamp now_ns (default: the host's
    clock) of mark `slot`, the frame's first when `advance`."""
    frames, stride = words.shape[0] - 1, words.shape[1]
    f = int(words[0, 0]) + (1 if advance else 0)
    if f <= 0:
        return
    row = words[1 + (f - 1) % frames]
    if advance:
        words[0, 0] = f
        row[:stride - 2] = -1
        row[stride - 2] = f
        row[stride - 1] = -1
    row[slot] = time.perf_counter_ns() if now_ns is None else now_ns
    if covered is not None:
        row[stride - 1] = int(covered)
    if pixels is not None:
        row[stride - 3] = int(pixels)


class _Ring:
    """A device's ring of frame stamps (csrc/trace_mark.cu's layout) and the
    frames issued into it, in the order the device runs them (one stream)."""

    def __init__(self, device, frames=RING_FRAMES):
        self.device, self.frames = device, frames
        self.words = torch.zeros((frames + 1, RING_SLOTS + 3), dtype=torch.int64, device=device)
        self.lock = threading.Lock()
        self.issued = collections.deque()  # (frame number, call id, FrameMarks), not drained yet
        self.last = 0                      # frames issued so far

    def mark(self, slot, advance, covered=None, pixels=None):
        if self.words.is_cuda:
            lib = _mark_library()
            ptrs = [t.data_ptr() if t is not None else None for t in (covered, pixels)]
            _check(lib.trace_mark(torch.cuda.current_stream(self.device).cuda_stream, self.words.data_ptr(),
                                  self.frames, self.words.shape[1], slot, int(advance), *ptrs), "a launch")
        else:
            mark_reference(self.words, slot, advance, covered, pixels=pixels)

    def issue(self, marks, launch):
        """launch() one frame of a graph whose capture recorded `marks`."""
        with self.lock:
            self.last += 1
            self.issued.append((self.last, _call_id(), marks))
            launch()

    def drain(self):
        """(frames, dropped) of the frames issued since the last drain: the
        rows still holding them are read (after the work issued before on
        the current stream); the older ones the ring overwrote are dropped."""
        with self.lock:
            if not self.issued:
                return [], 0
            first, last = self.issued[0][0], self.issued[-1][0]
            lo = max(first, last - self.frames + 1)
            rows = [(f - 1) % self.frames + 1 for f in (lo, last)]
            if rows[0] <= rows[1]:
                words = self.words[rows[0]:rows[1] + 1].tolist()
            else:
                words = self.words[rows[0]:].tolist() + self.words[1:rows[1] + 1].tolist()
            out, dropped = [], 0
            while self.issued:
                f, call, marks = self.issued.popleft()
                row = words[f - lo] if f >= lo else None
                if row is None or row[-2] != f:
                    dropped += 1
                else:
                    out.append(_frame_record(row, call, marks, self.device))
            return out, dropped


def _frame_record(row, call, marks, device):
    """One drained frame: its number in the ring (the device's frame
    counter), its stages' device ms, span, covered count, chunk bodies run,
    covered pixels and the counter they go to, stamps (None for a mark that
    did not run) and labels, and the call id that issued it.  A stage is
    charged from the previous stamp present to each stamp present."""
    labels = marks.labels
    stamps = [t if t >= 0 else None for t in row[:len(labels)]]
    stages, present = {}, []
    for label, t in zip(labels, stamps):
        if t is None:
            continue
        if present:
            stages[label] = stages.get(label, 0.0) + (t - present[-1]) / 1e6
        present.append(t)
    covered = None if row[-1] < 0 else row[-1]
    chunks = (None if covered is None or marks.chunk_starts is None
              else sum(s < covered for s in marks.chunk_starts))
    return {"frame": row[-2], "call": call, "device": str(device), "labels": list(labels), "stamps_ns": stamps,
            "stages": stages, "span_ms": (present[-1] - present[0]) / 1e6, "covered": covered, "chunks": chunks,
            "pixels": None if row[-3] < 0 else row[-3], "pixels_counter": marks.pixels_counter}


class FrameMarks:
    """The marks one frame graph's capture recorded into a ring: their
    labels, the shade's covered count and its chunks' first slots
    (shade_count) and the covered pixels (frame_pixels), each waiting for
    the next mark, the counter the pixels go to, and the tensors the nodes
    read."""

    def __init__(self, ring):
        self.ring, self.labels, self.hold = ring, [], []
        self.covered = self.chunk_starts = self.pixels = self.pixels_counter = None

    def add(self, label):
        slot = len(self.labels)
        if slot >= RING_SLOTS:
            count("trace.marks_over")
            return
        covered, pixels, self.covered, self.pixels = self.covered, self.pixels, None, None
        self.ring.mark(slot, slot == 0, covered, pixels)
        self.labels.append(label)


def frame_ring(device):
    """The ring of `device` (made and the mark kernel loaded on first use),
    or None while the tracer is off.  Called before a capture: nothing here
    may be allocated or loaded inside one."""
    if not _ON:
        return None
    device = torch.device(device)
    with _LOCK:
        ring = _RINGS.get(device.index)
        if ring is None:
            with torch.cuda.device(device):
                _check(_mark_library().trace_mark_load(), "loading the mark kernel")
            ring = _RINGS[device.index] = _Ring(device)
    return ring


@contextlib.contextmanager
def marking(ring):
    """Around the capture of a frame graph: the marks this thread makes
    inside go into the graph, writing into `ring`.  Yields the FrameMarks
    (None, and nothing recorded, when ring is None)."""
    global _MARKING
    if ring is None:
        yield None
        return
    marks = FrameMarks(ring)
    with _LOCK:
        _MARKING += 1
    _LOCAL.marks = marks
    try:
        yield marks
    finally:
        _LOCAL.marks = None
        with _LOCK:
            _MARKING -= 1


def _marks():
    return getattr(_LOCAL, "marks", None) if _MARKING else None


def mark(label: str):
    """A stage stamp of the frame under marked capture (see the module's
    note); nothing elsewhere."""
    if _MARKING:
        marks = _marks()
        if marks is not None:
            marks.add(label)


def shade_count(covered, chunk_starts):
    """The strip shade's covered count (a 0-d int32 tensor) and the first
    slots of its chunks.  Under a marked capture the frame's next mark
    records the count on the device; otherwise, with the tracer on and no
    capture under way, the count is read here: the counters shade.chunks
    (chunk bodies with a covered slot, run or, eagerly, not skipped) and
    shade.frames."""
    marks = _marks()
    if marks is not None:
        marks.covered, marks.chunk_starts = covered, tuple(chunk_starts)
        marks.hold.append(covered)
    elif _ON and not (covered.is_cuda and torch.cuda.is_current_stream_capturing()):
        n = int(covered)
        count("shade.chunks", sum(s < n for s in chunk_starts))
        count("shade.frames")


def shade_pixels(counter):
    """Called by a shade as it is issued: with the tracer on, the frame's
    frame_pixels then counts its covered pixels under the counter
    `counter` ("occlusion.pixels" for the occlusion probe,
    "darboux.pixels" for the darboux shade)."""
    if _ON:
        _LOCAL.pixels_counter = counter


def frame_pixels(idx):
    """The covered pixels (idx >= 0) of a frame whose shade asked for them
    since the last call (shade_pixels), as a 0-d int32 count: under a
    marked capture the frame's next mark records it on the device (the
    frame's "pixels", drained into the shade's counter); otherwise, with
    the tracer on and no capture under way, it is read into the shade's
    counter.  Nothing for any other frame."""
    counter = getattr(_LOCAL, "pixels_counter", None)
    if counter is None:
        return
    _LOCAL.pixels_counter = None
    marks = _marks()
    if marks is not None:
        marks.pixels = (idx >= 0).sum(dtype=torch.int32)
        marks.pixels_counter = counter
        marks.hold.append(marks.pixels)
    elif _ON and not (idx.is_cuda and torch.cuda.is_current_stream_capturing()):
        count(counter, int((idx >= 0).sum()))


def drain(everything=False):
    """While the tracer is on, move the device frames finished on the
    current stream out of each ring that holds half a ring of them (the
    program's drain points, which wait for the device anyway, read a ring a
    few times a turn, not at every frame); with `everything`, on or off,
    out of every ring."""
    if not (_RINGS and (_ON or everything)):
        return
    rings = [ring for ring in list(_RINGS.values())
             if ring.issued and (everything or len(ring.issued) >= ring.frames // 2)]
    if not rings:
        return
    with span("trace.drain"):
        for ring in rings:
            got, dropped = ring.drain()
            with _LOCK:
                _dropped["frames"] += dropped
                for fr in got:
                    if fr["chunks"] is not None:
                        _counters["shade.chunks"] += fr["chunks"]
                        _counters["shade.frames"] += 1
                    if fr["pixels"] is not None:
                        _counters[fr["pixels_counter"]] += fr["pixels"]
                    if len(_frames) < MAX_FRAMES:
                        _frames.append(fr)
                    else:
                        _dropped["frames"] += 1


def snapshot() -> dict:
    """What the tracer recorded since the last snapshot, which it clears
    (the tracer on or off: the frames issued while it was on are drained
    here): spans (name, start_ns, end_ns, ms, id, parent id, call id), counters
    (while the tracer is on, with graph.pool_bytes: the pools of the
    captured graphs alive), the drained device frames, the spans and frames
    dropped, and copies of raster_cuda.LAUNCHES, vertex_cuda.LAUNCHES,
    occlusion_cuda.LAUNCHES and darboux_cuda.LAUNCHES."""
    from ..ops import darboux_cuda, occlusion_cuda, raster_cuda, vertex_cuda
    from ..pipelines import graphs

    drain(everything=True)
    with _LOCK:
        spans, frames, counters = list(_spans), list(_frames), dict(_counters)
        dropped = dict(_dropped)
        _spans.clear()
        _frames.clear()
        _counters.clear()
        _dropped.update(spans=0, frames=0)
    if _ON:
        counters["graph.pool_bytes"] = graphs.pool_bytes()
    return {
        "spans": [{"name": n, "start_ns": a, "end_ns": b, "ms": (b - a) / 1e6, "id": i, "parent": p, "call": c}
                  for n, a, b, i, p, c in spans],
        "counters": counters,
        "frames": frames,
        "dropped": dropped,
        "launches": dict(raster_cuda.LAUNCHES),
        "vertex_launches": dict(vertex_cuda.LAUNCHES),
        "occlusion_launches": dict(occlusion_cuda.LAUNCHES),
        "darboux_launches": dict(darboux_cuda.LAUNCHES),
    }


def report(snap) -> str:
    """A snapshot as text: per-stage device ms (median over the frames),
    host spans (count and median ms by name) and the counters."""
    lines = []
    frames = snap["frames"]
    if frames:
        stages = {}
        for fr in frames:
            for k, v in fr["stages"].items():
                stages.setdefault(k, []).append(v)
        lines.append(f"device stages of {len(frames)} traced frames (median ms): "
                     + ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in stages.items())
                     + f"; frame span {statistics.median(fr['span_ms'] for fr in frames):.3f}")
    by_name = {}
    for s in snap["spans"]:
        by_name.setdefault(s["name"], []).append(s["ms"])
    if by_name:
        lines.append("host spans:")
    for name, ms in by_name.items():
        lines.append(f"  {name:24s} {len(ms):6d} spans, median {statistics.median(ms):.3f} ms")
    if snap["counters"]:
        lines.append("counters: " + ", ".join(f"{k} {v}" for k, v in sorted(snap["counters"].items())))
    lines.append(f"dropped: {snap['dropped']}; raster launches: "
                 f"{ {k: v for k, v in snap['launches'].items() if v} }")
    return "\n".join(lines)
