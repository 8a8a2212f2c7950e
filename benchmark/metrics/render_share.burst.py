"""Share of a traced stretch of the mix (program_trace: no profiler
records during it, but it follows the run's profiled stretch in the same
process) in which the device was rendering a frame: the sum of the
frames' device spans (first stage stamp to last) over the stretch's host
window, in %."""

from benchmark import program_trace

UNIT = "%"


def read(r):
    t = program_trace.stretch(r, "orbit-burst")
    frames = program_trace.frames(r, "orbit-burst")
    if not frames or t["window_s"] <= 0:
        return None
    return 100.0 * sum(f["span_ms"] for f in frames) / (1e3 * t["window_s"])
