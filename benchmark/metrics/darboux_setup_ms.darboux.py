"""Device ms of the Darboux pieces of the vertex layer (each triangle's
transformed normals, normalized edge directions and uv deltas, computed
after the setup kernel) inside the replayed burst frame: the program's
stage stamps (utils/timing.py marks `vertex` -> `darboux_setup` in
vertex.triangle_setup), the median over the frames of a traced stretch of
the mix (program_trace)."""

from benchmark import program_trace

UNIT = "ms"


def read(r):
    return program_trace.stage_ms(r, "orbit-burst", "darboux_setup")
