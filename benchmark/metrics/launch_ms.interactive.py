"""Host ms of the interactive frame's graph launch: the program's span
graph.replay under scene.render (the view's copy into the graph's inputs
and the replay), the median over a traced stretch of the mix
(program_trace).  The stretch follows the run's profiled stretch in the
same process, whose profiler session leaves every later launch slower:
the number holds that cost, not the launch of a process never profiled."""

import statistics

from benchmark import program_trace

UNIT = "ms"


def read(r):
    got = program_trace.spans(r, "interactive", "graph.replay", parent="scene.render")
    return statistics.median(got) if got else None
