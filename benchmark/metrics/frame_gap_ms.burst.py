"""Device ms between two frames of one render_sequence call: the program's
gaps within a call (utils/timing.py: from one frame's last stage stamp to
the next frame's first, %globaltimer in the frame graph), the median over
a traced stretch of the mix (program_trace). Nothing where the program
records no gaps."""

import statistics

from benchmark import program_trace

UNIT = "ms"


def read(r):
    t = program_trace.stretch(r, "orbit-burst")
    gaps = [g["ms"] for g in t["snapshot"].get("gaps", ()) if not g["call_boundary"]] if t else []
    return statistics.median(gaps) if gaps else None
