"""The raster kernels' device time per frame in the traced bursts: every
kernel named as K1 (raster_kernel<idx, planes>) or K2 (raster_fused_kernel)
of the program's csrc/raster.cu, in ms."""

from benchmark import roofline, tracing

UNIT = "ms"


def read(r):
    s = tracing.per_frame_seconds(r.trace, roofline.RASTER_KERNELS)
    return None if s is None else 1e3 * s
