"""The least work of the specular shade (shader.rs:498-530), for its share
of the roofline.

The count is of what any implementation of the shade has to do at a frame's
covered pixels, from the interpolated uv to the colour, not of how the
program does it, so a later shade kernel is judged against the same
yardstick.  Bytes a covered pixel: its three texels read (the texture and
the object-space normal map, 3 B each, and the specular map, 1 B: the
upstream's is an 8-bpp grayscale image) and its colour written (3 B).  f32
operations a covered pixel (a normalize is a dot of 3 multiplies and 2
adds, a square root and 3 divides: 9):

* the texel coordinates, uv times the maps' dimensions: 2 multiplies (the
  three maps are read at the same texel where their dimensions agree);
* the sampled normal decoded, byte / 255 - 0.5 a channel, and normalized:
  6 + 9 = 15;
* the normal through ``it_m``, 3 rows of 3 multiplies and 2 adds: 15, and
  normalized: 9;
* the diffuse dot ``d``: 5;
* the reflection ``t_n (2 d) - light``: 1 + 3 multiplies and 3
  subtractions, 7;
* its normalize, of which only ``r.z`` is needed: the dot (5), the square
  root and one divide, 7;
* ``max(r.z, 0)``: 1;
* the ``pow``, as a log2, a multiply and an exp2: 3;
* times 0.6: 1, and ``d + spec``: 1;
* the colour, 3 multiplies and 3 clamps at 255: 6.
"""

from __future__ import annotations

from benchmark import roofline

NORMALIZE_FLOPS = 9
FLOPS_PER_PIXEL = (2 + (6 + NORMALIZE_FLOPS) + (15 + NORMALIZE_FLOPS) + 5 + 7 + 7 + 1 + 3 + 1 + 1
                   + 6)  # 72
TEXEL_BYTES = 3     # one RGB u8 texel (the texture, the normal map)
SPECULAR_BYTES = 1  # one grayscale u8 texel
COLOUR_BYTES = 3    # one RGB u8 pixel


def specular_bytes(pixels):
    return pixels * (2 * TEXEL_BYTES + SPECULAR_BYTES + COLOUR_BYTES)


def specular_flops(pixels):
    return pixels * FLOPS_PER_PIXEL


def least_seconds(width, height, pixels):
    """The least time of one frame's specular shade at the H100's peaks
    (roofline.least_seconds); the frame's size adds no work of its own."""
    return roofline.least_seconds(specular_bytes(pixels), specular_flops(pixels))
