"""The darboux strip chunk body as a CUDA kernel (``csrc/darboux.cu``): one launch, one thread a fragment.

``chunk_body`` does for CUDA tensors what a chunk body of
``frame._shade_strips`` does for the darboux pipeline in torch code: each
slot's strip and pixels, the winner ids, the barycentrics
(``frame._gather_fragments``, reading the winners' setup columns in place),
the varyings (``shaders.compute_varyings``), the two map samples from the
packed plane, ``shaders.shade_darboux`` and the writeback into the strip
shade's accumulator, packed words or u8 triples.  ``shaders.darboux_fused_body``
dispatches here for CUDA tensors with the packed plane; otherwise the torch
body runs, which the kernel equals bit for bit (see the note at the top of
darboux.cu).

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
from .vertex_cuda import check_float32

# Kernel launches issued (see above; the torch body counts none).
LAUNCHES = {"body": 0}

SOURCE = raster_cuda.SOURCE.parent / "darboux.cu"

# The setup columns the kernel reads: the int32 edge coefficients, and the
# float32 varyings with their shapes a triangle.
EDGES = ("a1", "b1", "c1", "a2", "b2", "c2", "cz")
VARYINGS = (("uv", (3, 2)), ("t_norm", (3, 3)), ("row0n", (3,)), ("row1n", (3,)), ("du", (2,)), ("dv", (2,)))

_INT_MAX = 2**31 - 1
_IDX_BYTES = {torch.int32: 4, torch.int16: 2}


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
    """csrc/darboux.cu, built with nvcc at first use, its functions'
    argument types set."""
    lib = ctypes.CDLL(str(raster_cuda.build(source=SOURCE)[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.darboux_chunk_body.argtypes = [p] * 13 + [p, i, p, i, i, i, i, i, i, p, i, i, i, p, p, i, p]
    lib.darboux_chunk_body.restype = i
    lib.darboux_error_string.argtypes = [i]
    lib.darboux_error_string.restype = ctypes.c_char_p
    return lib


def _check(setup, strips, cids, acc, plane, light):
    """Raise unless the arguments are what the kernel reads, on one CUDA
    device (see chunk_body)."""
    dev = strips.device
    T = setup["cz"].shape[0]
    for key in EDGES:
        t = setup[key]
        if t.dtype != torch.int32 or tuple(t.shape) != (T,) or not t.is_contiguous():
            raise ValueError(f"{key}: expected a contiguous ({T},) int32 tensor, got "
                             f"{'' if t.is_contiguous() else 'a non-contiguous '}{tuple(t.shape)} {t.dtype}")
    if strips.dtype not in _IDX_BYTES or strips.dim() != 2 or not strips.is_contiguous():
        raise ValueError(f"strips: expected a contiguous (strips, strip_len) int32 or int16 tensor, got "
                         f"{tuple(strips.shape)} {strips.dtype}")
    n_strips, strip_len = strips.shape
    if cids.dtype != torch.int64 or cids.dim() != 1 or not cids.is_contiguous():
        raise ValueError(f"cids: expected a contiguous 1-d int64 tensor, got {tuple(cids.shape)} {cids.dtype}")
    words = (n_strips + 1, strip_len)
    if not acc.is_contiguous() or (acc.dtype, tuple(acc.shape)) not in ((torch.int32, words),
                                                                         (torch.uint8, (*words, 3))):
        raise ValueError(f"acc: expected a contiguous {words} int32 or {(*words, 3)} uint8 tensor, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    if plane.dtype != torch.int32 or plane.dim() != 3 or plane.shape[2] != 2 or not plane.is_contiguous():
        raise ValueError(f"plane: expected a contiguous (h, w, 2) int32 packed plane, got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    check_float32([(key, setup[key], (T, *shape)) for key, shape in VARYINGS] + [("light", light, (3,))], dev)
    for name, t in (("strips", strips), ("cids", cids), ("acc", acc), ("plane", plane),
                    *((key, setup[key]) for key in EDGES)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected a tensor on a CUDA device ({dev}), got one on {t.device}")
    if strips.numel() > _INT_MAX or cids.numel() * strip_len > _INT_MAX or plane.numel() > _INT_MAX:
        raise ValueError(f"{strips.numel()} pixels, {cids.numel()} slots of {strip_len} or a plane of "
                         f"{plane.numel()} words: the kernel takes at most {_INT_MAX} of each")


def chunk_body(setup, strips, cids, acc, plane, tile, light, *, width, pixels, y_offset=0):
    """One darboux chunk body of frame._shade_strips for CUDA tensors, in
    one launch on the current stream: for each slot of `cids` (contiguous
    int64 strip ids; n_strips marks a fill slot) and each lane, the winner
    id from `strips` (the contiguous (n_strips, strip_len) int32 or int16
    idx plane, -1 uncovered or past the last of `pixels` pixels) and the
    winner's setup columns (triangle_setup's int32 a1..cz and float32 uv,
    t_norm, row0n, row1n, du, dv, each contiguous), shaded under `light`
    (t_light_direction) with the maps of `plane` (the (h, w, 2) int32
    packed plane, tile-swizzled by `tile`, 0: row-major), written into acc's
    row of the strip: `acc` (n_strips + 1, strip_len) int32 packed words,
    or (n_strips + 1, strip_len, 3) uint8 triples; 0 where uncovered.  The
    pixel of lane l of strip s is min(s * strip_len + l, pixels - 1), in
    rows `width` wide, the first of them global row y_offset.  Fill slots
    write nothing (the torch body writes them to the spare row n_strips)."""
    _check(setup, strips, cids, acc, plane, light)
    n_strips, strip_len = strips.shape
    h, w = plane.shape[:2]
    lib = _library()
    with torch.cuda.device(strips.device):
        err = lib.darboux_chunk_body(
            *(setup[key].data_ptr() for key in EDGES), *(setup[key].data_ptr() for key, _ in VARYINGS),
            strips.data_ptr(), _IDX_BYTES[strips.dtype], cids.data_ptr(), cids.numel(), n_strips, strip_len,
            pixels, width, y_offset, plane.data_ptr(), w, h, tile, light.data_ptr(), acc.data_ptr(),
            int(acc.dtype == torch.int32), torch.cuda.current_stream(strips.device).cuda_stream)
    if err:
        raise RuntimeError(f"darboux_chunk_body launch failed: {lib.darboux_error_string(err).decode()}")
    raster_cuda.launch_counts(LAUNCHES)["body"] += 1
