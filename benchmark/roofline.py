"""Peaks of the card and the least bytes a kernel's work needs.

Peaks: NVIDIA's published H100 SXM data sheet, dense rates, at the full
700 W power limit (a card set lower runs slower; the harness prints the
limit beside every run).  The raster's bytes count the work, not the
program's record layout: what any implementation of the two-pass shadow
raster has to read and write once.
"""

from __future__ import annotations

import re

H100_SXM = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}

# The program's raster kernels as a trace names them (csrc/raster.cu): K1's
# instantiations raster_kernel<with_idx, with_planes> and K2.
RASTER_KERNELS = re.compile(r"raster_kernel<|raster_fused_kernel")

PLANE_BYTES = 4          # one f32 depth or i32 winner per pixel
VERTEX_BYTES = 3 * 3 * 4  # a triangle's three screen-space (x, y, z) f32


def raster_bytes(width, height, triangles, passes=2):
    """Least bytes of the shadow frame's raster: each pass writes one plane
    (the light pass its depth, the camera pass its winner) and reads each
    triangle's screen-space vertices once."""
    return passes * (width * height * PLANE_BYTES + triangles * VERTEX_BYTES)


def least_seconds(nbytes, flops=0.0, peaks=H100_SXM):
    """The larger of bytes over the HBM rate and f32 operations over the f32 peak."""
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["fp32_flops_per_s"])
