"""The least work of the darboux shade (shader.rs:597-654), for its share of
the roofline.

The count is of what any implementation of the shade has to do at a frame's
covered pixels, from the interpolated varyings to the colour, not of how
the program does it, so a later shade kernel is judged against the same
yardstick.  Bytes a covered pixel: its two texels read (the texture and the
tangent-space map, 3 B each) and its colour written (3 B).  f32 operations
a covered pixel (a normalize is a dot of 3 multiplies and 2 adds, a square
root and 3 divides: 9):

* the texel coordinates, uv times the maps' dimensions: 2 multiplies (both
  maps are read at the same texel where their dimensions agree);
* the sampled normal decoded, byte / 255 - 0.5 a channel, and normalized:
  6 + 9 = 15;
* the interpolated normal normalized: 9;
* the 3x3 inverse: 9 cofactors of 2 multiplies and a subtraction (27), the
  determinant from the first row's (3 multiplies, 2 adds: 5) and a divide
  an element (9): 41 (the negated cofactor swaps its operands, no extra
  operation);
* the two solves, the inverse times (du, 0) and (dv, 0): 3 rows of 2
  multiplies and an add each, 18;
* the tangent and bitangent normalized: 18 (the third column is the
  normalized interpolated normal, already counted);
* the tangent-space sum, 3 rows of 3 multiplies and 2 adds, 15, and its
  normalize, 9;
* the diffuse dot: 5;
* the blend toward black, t c1 + (1 - t) c2 a channel: 1 + 3 * 3 = 10.
"""

from __future__ import annotations

from benchmark import roofline

NORMALIZE_FLOPS = 9
FLOPS_PER_PIXEL = (2 + (6 + NORMALIZE_FLOPS) + NORMALIZE_FLOPS + (27 + 5 + 9) + 18 + 2 * NORMALIZE_FLOPS
                   + (15 + NORMALIZE_FLOPS) + 5 + 10)  # 142
TEXEL_BYTES = 3   # one RGB u8 texel
COLOUR_BYTES = 3  # one RGB u8 pixel


def darboux_bytes(pixels):
    return pixels * (2 * TEXEL_BYTES + COLOUR_BYTES)


def darboux_flops(pixels):
    return pixels * FLOPS_PER_PIXEL


def least_seconds(width, height, pixels):
    """The least time of one frame's darboux shade at the H100's peaks
    (roofline.least_seconds); the frame's size adds no work of its own."""
    return roofline.least_seconds(darboux_bytes(pixels), darboux_flops(pixels))
