"""The burst's device-to-host copy per frame: the program's span
sequence.copy (render_sequence's frames.cpu() of the whole burst), the
median over the calls of a traced stretch of the mix (program_trace) over
the frames a call returned (the program's counter sequence.frames over
the calls), in ms."""

import statistics

from benchmark import program_trace

UNIT = "ms"


def read(r):
    copies = program_trace.spans(r, "orbit-burst", "sequence.copy")
    returned = program_trace.counter(r, "orbit-burst", "sequence.frames")
    if not copies or not returned:
        return None
    return statistics.median(copies) / (returned / len(copies))
