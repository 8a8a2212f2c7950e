"""Device ms of the occlusion probe (sample coordinates, depth-buffer
indices, the gather and the 16-step update, over the strip shade's chunk
bodies that ran) inside the replayed burst frame: the program's stage
stamps (utils/timing.py mark `probe`, %globaltimer in the frame graph), the
median over the frames of a traced stretch of the mix (program_trace)."""

from benchmark import program_trace

UNIT = "ms"


def read(r):
    return program_trace.stage_ms(r, "orbit-burst", "probe")
