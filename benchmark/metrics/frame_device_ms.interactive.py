"""Device ms of the interactive frame: the replayed frame's span from its
first stage stamp to its last (utils/timing.py mark, %globaltimer), the
median over the frames of a traced stretch of the mix (program_trace)."""

import statistics

from benchmark import program_trace

UNIT = "ms"


def read(r):
    got = [f["span_ms"] for f in program_trace.frames(r, "interactive")]
    return statistics.median(got) if got else None
