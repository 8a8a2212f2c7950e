"""The shadow strip chunk body as a CUDA kernel (``csrc/shadow.cu``): one launch, one thread a fragment.

``chunk_body`` does for CUDA tensors what a chunk body of
``frame._shade_strips`` does for the shadow pipeline in torch code: each
slot's strip and pixels, the winner ids, the barycentrics
(``frame._gather_fragments``, reading the winners' setup columns in place),
the varyings (``shaders.compute_varyings``: uv, the intensity, the depth),
``shaders.shade_shadow`` (the light-view point, the shadow-map value and the
compare, the texel from the packed plane, the blend) and the writeback into
the strip shade's accumulator, packed words or u8 triples.
``shaders.shadow_fused_body`` dispatches here for CUDA tensors with the
packed plane; otherwise the torch body runs, which the kernel equals bit for
bit (see the note at the top of shadow.cu).

The kernel is built at first use with nvcc into ``_build/`` like the raster
(``raster_cuda.build``).  ``LAUNCHES`` counts the launches issued: eager
ones once, and a launch made while a CUDA graph is captured at each replay
(``recording``, ``replayed``), as raster_cuda counts its own.  So it counts
the launches a replayed graph holds, one a chunk body of the strip shade
whether the body's IF node runs it or skips it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import raster_cuda
from .darboux_cuda import EDGES, IDX_BYTES, check_chunk
from .vertex_cuda import check_float32

# Kernel launches issued (see above; the torch body counts none).
LAUNCHES = {"body": 0}

SOURCE = raster_cuda.SOURCE.parent / "shadow.cu"

# The float32 setup columns the kernel reads besides the edge coefficients
# (darboux_cuda.EDGES), with their shapes a triangle.
VARYINGS = (("uv", (3, 2)), ("intensity", (3,)), ("zv", (3,)))
COLUMNS = EDGES + tuple(key for key, _ in VARYINGS)

_INT_MAX = 2**31 - 1


def reset_launches():
    """Set every LAUNCHES count to 0."""
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))


def recording():
    """raster_cuda.recording for this module's LAUNCHES."""
    return raster_cuda.recording(LAUNCHES)


def replayed(counts):
    """raster_cuda.replayed for this module's LAUNCHES."""
    raster_cuda.replayed(counts, LAUNCHES)


@functools.cache
def _library():
    """csrc/shadow.cu, built with nvcc at first use, its functions'
    argument types set."""
    lib = ctypes.CDLL(str(raster_cuda.build(source=SOURCE)[0]))
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.shadow_chunk_body.argtypes = [p] * 11 + [i, p, i, i, i, i, i, i, p, i, i, i, p, i, u, i, u,
                                                 ctypes.c_longlong, p, p, f, f, p, i, p]
    lib.shadow_chunk_body.restype = i
    lib.shadow_error_string.argtypes = [i]
    lib.shadow_error_string.restype = ctypes.c_char_p
    return lib


def _check(setup, strips, cids, acc, plane, shadow, shadow_matrix, i_vpmv):
    """Raise unless the arguments are what the kernel reads, on one CUDA
    device (see chunk_body)."""
    dev = strips.device
    T = check_chunk(setup, strips, cids, acc)
    strip_len = strips.shape[1]
    if plane.dtype != torch.int32 or plane.dim() != 3 or plane.shape[2] != 1 or not plane.is_contiguous():
        raise ValueError(f"plane: expected a contiguous (h, w, 1) int32 packed plane, got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    if shadow.dtype != torch.float32 or shadow.dim() != 2 or shadow.stride(1) != 1 \
            or shadow.stride(0) < shadow.shape[1]:
        raise ValueError(f"shadow: expected an (h, w) float32 shadow map whose rows are contiguous, got "
                         f"{tuple(shadow.shape)} {shadow.dtype} with strides {shadow.stride()}")
    check_float32([(key, setup[key], (T, *shape)) for key, shape in VARYINGS] +
                  [("shadow_matrix", shadow_matrix, (4, 4)), ("i_vpmv", i_vpmv, (4, 4))], dev)
    for name, t in (("strips", strips), ("cids", cids), ("acc", acc), ("plane", plane), ("shadow", shadow),
                    *((key, setup[key]) for key in EDGES)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected a tensor on a CUDA device ({dev}), got one on {t.device}")
    if strips.numel() > _INT_MAX or cids.numel() * strip_len > _INT_MAX or plane.numel() > _INT_MAX \
            or shadow.numel() > _INT_MAX:
        raise ValueError(f"{strips.numel()} pixels, {cids.numel()} slots of {strip_len}, a plane of "
                         f"{plane.numel()} words or a map of {shadow.numel()}: the kernel takes at most "
                         f"{_INT_MAX} of each")


def chunk_body(setup, strips, cids, acc, plane, tile, shadow, shadow_tile, shadow_matrix, i_vpmv, *, bias, dim,
               shadow_width, width, pixels, y_offset=0):
    """One shadow chunk body of frame._shade_strips for CUDA tensors, in one
    launch on the current stream: for each slot of `cids` (contiguous int64
    strip ids; n_strips marks a fill slot) and each lane, the winner id from
    `strips` (the contiguous (n_strips, strip_len) int32 or int16 idx plane,
    -1 uncovered or past the last of `pixels` pixels) and the winner's
    setup columns (triangle_setup's int32 a1..cz and float32 uv, intensity,
    zv, each contiguous), shaded as shaders.shade_shadow shades: the light's
    view by shadow_matrix @ i_vpmv (contiguous 4x4 float32), the value of
    `shadow` (the (h, w) float32 map as the shade reads it, tile-swizzled
    by `shadow_tile`, 0: row-major; its rows contiguous, read in place
    however far apart) at the rounded point in rows `shadow_width` wide, the compare against it with the float32 `bias`,
    the coefficient `dim` in shadow, the texel of `plane` (the (h, w, 1)
    int32 packed texture plane, tile-swizzled by `tile`) and the blend
    toward black; written into acc's row of the strip: `acc` (n_strips + 1,
    strip_len) int32 packed words, or (n_strips + 1, strip_len, 3) uint8
    triples; 0 where uncovered.  The pixel of lane l of strip s is min(s *
    strip_len + l, pixels - 1), in rows `width` wide, the first of them
    global row y_offset.  Fill slots write nothing (the torch body writes
    them to the spare row n_strips)."""
    _check(setup, strips, cids, acc, plane, shadow, shadow_matrix, i_vpmv)
    n_strips, strip_len = strips.shape
    h, w = plane.shape[:2]
    lib = _library()
    with torch.cuda.device(strips.device):
        err = lib.shadow_chunk_body(
            *(setup[key].data_ptr() for key in COLUMNS),
            strips.data_ptr(), IDX_BYTES[strips.dtype], cids.data_ptr(), cids.numel(), n_strips, strip_len,
            pixels, width, y_offset, plane.data_ptr(), w, h, tile, shadow.data_ptr(), shadow_width,
            shadow.numel(), shadow_tile, shadow.shape[1], shadow.stride(0), shadow_matrix.data_ptr(),
            i_vpmv.data_ptr(), bias, dim, acc.data_ptr(), int(acc.dtype == torch.int32),
            torch.cuda.current_stream(strips.device).cuda_stream)
    if err:
        raise RuntimeError(f"shadow_chunk_body launch failed: {lib.shadow_error_string(err).decode()}")
    raster_cuda.launch_counts(LAUNCHES)["body"] += 1
