"""One stretch of a cell's traffic traced by the program's own tracer.

The per-layer metrics that read the program's spans, stage stamps and
counters share it: ``stretch(r, mix)`` turns the tracer of
``tiny_renderer_tpu_torch.utils.timing`` on, runs the loop of the mix
``traffic/<mix>.json`` on the run's Scene (its ``step()``, along the mix's
orbit steps) for STRETCH_S seconds and at least MIN_STEPS steps, takes the
tracer's snapshot and turns the tracer off again before it returns, so
that everything else the run measures sees the program as its window ran
it.  What a step rendered is read from the snapshot (its spans, frames and
counters), so any loop kind's step will do.

One step first captures the traced graph (turning the tracer on gives the
frame a graph of its own) and is left out.  No profiler records during the
stretch, but the run's profiled stretch came before it in the same
process, and a process's graph launches stay slower once a profiler
session has ended: the stretch's host spans carry that.  The result is
cached on the Readings.  Where the program has no tracer, stretch()
returns None and each reader nothing.
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path

from benchmark import harness

BENCH_DIR = Path(__file__).resolve().parent
STRETCH_S = 4.0   # host seconds of a stretch (a burst: ~20 calls; a frame mix: ~1,500 frames)
MIN_STEPS = 3
SEED = 17         # the stretch's orbit start (its poses need not repeat the window's)


def _tracer():
    """The program's tracer module, or None where it has none."""
    try:
        from tiny_renderer_tpu_torch.utils import timing
    except ImportError:
        return None
    return timing if all(hasattr(timing, f) for f in ("enable", "disable", "snapshot")) else None


def stretch(r, mix):
    """{"snapshot": the tracer's snapshot, "window_s": the stretch's host
    seconds, "steps": the loop's steps in it} of one traced stretch of
    `mix` on the Readings' Scene, or None."""
    cache = r.__dict__.setdefault("program_trace", {})
    if mix not in cache:
        cache[mix] = _run(r._scene, mix)
    return cache[mix]


def _traffic(mix):
    return harness.load_json(BENCH_DIR / "traffic" / f"{mix}.json")


def _run(scene, mix):
    timing = _tracer()
    if timing is None:
        return None
    traffic = _traffic(mix)
    loop = harness.loop_module(traffic["loop"], BENCH_DIR).Loop(scene, traffic, SEED)
    timing.enable()
    try:
        loop.step()  # captures the traced graph
        loop.sync()
        timing.snapshot()
        steps = 0
        t0 = time.perf_counter()
        while steps < MIN_STEPS or time.perf_counter() - t0 < STRETCH_S:
            loop.step()
            steps += 1
        loop.sync()
        window = time.perf_counter() - t0
        snap = timing.snapshot()
    finally:
        timing.disable()
    return {"snapshot": snap, "window_s": window, "steps": steps}


def frames(r, mix):
    """The drained device frames of the stretch ([] where none)."""
    t = stretch(r, mix)
    return t["snapshot"]["frames"] if t else []


def counter(r, mix, name):
    """The stretch's counter `name` (0 where it counted nothing)."""
    t = stretch(r, mix)
    return t["snapshot"]["counters"].get(name, 0) if t else 0


def stage_ms(r, mix, stage):
    """The median over the stretch's device frames of one stage's ms, or None."""
    got = [f["stages"][stage] for f in frames(r, mix) if stage in f["stages"]]
    return statistics.median(got) if got else None


def spans(r, mix, name, parent=None):
    """The ms of the stretch's spans named `name` (under a span named
    `parent`, where given)."""
    t = stretch(r, mix)
    if t is None:
        return []
    all_spans = t["snapshot"]["spans"]
    names = {s["id"]: s["name"] for s in all_spans}
    return [s["ms"] for s in all_spans
            if s["name"] == name and (parent is None or names.get(s["parent"]) == parent)]
