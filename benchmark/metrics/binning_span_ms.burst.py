"""Device ms of binning (bin_triangles of the light and the camera pass) inside the replayed burst frame: the program's
stage stamps (utils/timing.py mark, %globaltimer in the frame graph), the
median over the frames of a traced stretch of the mix (program_trace)."""

from benchmark import program_trace

UNIT = "ms"


def read(r):
    return program_trace.stage_ms(r, "orbit-burst", "binning")
