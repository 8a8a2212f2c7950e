"""Device ms of the raster (K1 of the light and the camera pass, from each pass's binning mark to its raster mark) inside the replayed burst frame: the program's
stage stamps (utils/timing.py mark, %globaltimer in the frame graph), the
median over the frames of a traced stretch of the mix (program_trace)."""

from benchmark import program_trace

UNIT = "ms"


def read(r):
    return program_trace.stage_ms(r, "orbit-burst", "raster")
