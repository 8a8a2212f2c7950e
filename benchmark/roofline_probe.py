"""The least work of the occlusion probe (shader.rs:882-941), for its share
of the roofline.

The count is of what any implementation of the probe has to do at a frame's
covered pixels, not of how the program does it, so a later probe kernel is
judged against the same yardstick.  Bytes: the light's depth plane read
once, and each covered pixel's depth read and its colour written.  f32
operations a covered pixel: the fragment's world and shadow coordinates (a
point through a 4x4 matrix with its divide and its depth-buffer index: 4
rows of 3 multiplies and 3 adds, 3 divides, 2 rounds, a multiply and an
add, 31), the samples (the fragment's world position plus the frame's
rotated, scaled direction, 3 adds, then the same 31), and the update steps
(compare, difference, scale, min, multiply, subtract: 6).
"""

from __future__ import annotations

from benchmark import roofline

SAMPLES = 16
POINT_FLOPS = 31
SAMPLE_FLOPS = 3 + POINT_FLOPS
UPDATE_FLOPS = 6
FLOPS_PER_PIXEL = 2 * POINT_FLOPS + SAMPLES * (SAMPLE_FLOPS + UPDATE_FLOPS)  # 702
DEPTH_BYTES = 4   # one f32 of the light's depth plane, or of a fragment's depth
COLOUR_BYTES = 3  # one RGB u8 pixel


def probe_bytes(width, height, pixels):
    return width * height * DEPTH_BYTES + pixels * (DEPTH_BYTES + COLOUR_BYTES)


def probe_flops(pixels):
    return pixels * FLOPS_PER_PIXEL


def least_seconds(width, height, pixels):
    """The least time of one frame's probe at the H100's peaks (roofline.least_seconds)."""
    return roofline.least_seconds(probe_bytes(width, height, pixels), probe_flops(pixels))
