"""The readers of binning's four steps and of the gaps between frames
(binning_{keys,sort,csr,records}_ms.burst, frame_gap_ms.burst,
call_gap_ms.burst): each gives the median of a stand-in stretch's frames or
gaps, and None where the program recorded nothing, where its snapshot has
no gaps and no steps (an older program), or where it has no tracer."""

import pytest

from benchmark import harness, program_trace

STEPS = ("binning_keys_ms.burst", "binning_sort_ms.burst", "binning_csr_ms.burst", "binning_records_ms.burst")
GAPS = ("frame_gap_ms.burst", "call_gap_ms.burst")


def readings():
    return harness.Readings(None, {"width": 96, "height": 96}, 10, {}, None)


def read(name, r):
    return harness.metric_reader(name).read(r)


def frame(keys, sort, csr, records):
    steps = {"binning.keys": keys, "binning.sort": sort, "binning.csr": csr, "binning.records": records}
    stages = {"vertex": 0.03, "binning": sum(steps.values()) + 0.002, "raster": 0.035, "shade": 0.15, **steps}
    return {"stages": stages, "span_ms": 0.59, "chunks": 1, "covered": 10}


def gap(ms, boundary):
    return {"device": "cuda:0", "after_frame": 1, "ms": ms, "call_boundary": boundary, "host_ms": {"host": ms}}


def stretch(frames, gaps=None):
    snap = {"spans": [], "frames": frames, "counters": {}, "dropped": {"spans": 0, "frames": 0}, "launches": {}}
    if gaps is not None:
        snap["gaps"] = gaps
    return {"orbit-burst": {"snapshot": snap, "window_s": 1.0, "steps": 2}}


def test_readers_read_steps_and_gaps():
    r = readings()
    r.program_trace = stretch([frame(0.10, 0.05, 0.03, 0.18), frame(0.12, 0.06, 0.02, 0.19),
                               frame(0.11, 0.07, 0.04, 0.17)],
                              [gap(0.004, False), gap(0.006, False), gap(0.005, False), gap(0.9, True),
                               gap(1.3, True)])
    got = {name: read(name, r) for name in STEPS + GAPS}
    assert got == pytest.approx({"binning_keys_ms.burst": 0.11, "binning_sort_ms.burst": 0.06,
                                 "binning_csr_ms.burst": 0.03, "binning_records_ms.burst": 0.18,
                                 "frame_gap_ms.burst": 0.005, "call_gap_ms.burst": 1.1})


@pytest.mark.parametrize("name", STEPS + GAPS)
def test_reader_returns_nothing_where_nothing_was_recorded(monkeypatch, name):
    r = readings()
    r.program_trace = stretch([], [])
    assert read(name, r) is None
    # An older program: frames without the steps, a snapshot without gaps.
    older = frame(0.1, 0.1, 0.1, 0.1)
    older["stages"] = {k: v for k, v in older["stages"].items() if "." not in k}
    r = readings()
    r.program_trace = stretch([older])
    assert read(name, r) is None
    # Gaps of the other kind only.
    r = readings()
    r.program_trace = stretch([], [gap(1.0, name.startswith("frame_"))])
    assert read(name, r) is None
    # A program without the tracer: no stretch at all.
    monkeypatch.setattr(program_trace, "_tracer", lambda: None)
    assert read(name, readings()) is None
