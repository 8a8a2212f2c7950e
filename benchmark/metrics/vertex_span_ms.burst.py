"""Device ms of the vertex stage (the angles' sin and cos, both passes' matrix stacks and triangle_setup) inside the replayed burst frame: the program's
stage stamps (utils/timing.py mark, %globaltimer in the frame graph), the
median over the frames of a traced stretch of the mix (program_trace)."""

from benchmark import program_trace

UNIT = "ms"


def read(r):
    return program_trace.stage_ms(r, "orbit-burst", "vertex")
