"""The raster kernels' share of their roofline: the least time the two-pass
raster's bytes need at the H100's HBM rate (roofline.raster_bytes) over
the kernels' device time per frame in the traced bursts, in %."""

from benchmark import roofline, tracing

UNIT = "%"


def read(r):
    s = tracing.per_frame_seconds(r.trace, roofline.RASTER_KERNELS)
    if not s:
        return None
    nbytes = roofline.raster_bytes(r.config["width"], r.config["height"], r.triangles)
    return 100.0 * roofline.least_seconds(nbytes) / s
