"""Binning as a CUDA kernel (``csrc/binning.cu``): one launch a pass.

``bin_triangles`` does for CUDA tensors what ``binning.bin_triangles_reference``
does in torch code: each triangle's clamped tile rectangle, the CSR
incidence list (``starts``, the triangle ids in tile-major order, ids
ascending within a tile, T - 1 past the kept incidences), the overflow flag
and the record table (or, gathered, its rows in CSR order).  It is a stable
counting sort by tile in place of the candidate keys, the 32-bit sort and
``searchsorted``, and its outputs equal the plain version's bit for bit
(see the note at the top of binning.cu).  ``binning.bin_triangles``
dispatches here for CUDA tensors.

The kernel is built at first use with nvcc into ``_build/`` like the raster
(``raster_cuda.build``).  ``LAUNCHES`` counts the launches issued
(``bin``): eager ones once, and a launch made while a CUDA graph is
captured at each replay (``recording``, ``replayed``), as raster_cuda
counts its own.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import raster_cuda
from .binning import BASE_LANES, incidence_cap, record_lanes, spec_columns

# Kernel launches issued (the plain version counts none).
LAUNCHES = {"bin": 0}

SOURCE = raster_cuda.SOURCE.parent / "binning.cu"

# The setup columns the kernel reads, in its order (binning.cu's Column),
# with their dtype; zv's three vertices follow, then the spec lanes'.
COLUMNS = (("valid", torch.bool),) + tuple(
    (key, torch.int32) for key in ("x0", "x1", "y0", "y1", "a1", "b1", "c1", "a2", "b2", "c2", "cz"))
MAX_LANES = 128  # binning.cu kMaxLanes

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
    """csrc/binning.cu, built with nvcc at first use, its functions'
    argument types set."""
    lib = ctypes.CDLL(str(raster_cuda.build(source=SOURCE)[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.binning_launch.argtypes = [p, p] + [i] * 13 + [p, p, p, p, p]
    lib.binning_launch.restype = i
    lib.binning_error_string.argtypes = [i]
    lib.binning_error_string.restype = ctypes.c_char_p
    return lib


def columns(setup, spec=()):
    """[(name, (T,) tensor)] the kernel reads, in its order: COLUMNS, zv's
    three vertices, the spec lanes (binning.spec_columns).  Raises unless
    the record fits MAX_LANES, each is a (T,) tensor of its dtype (float32
    past COLUMNS) whose elements lie within an int32 offset, and then
    unless each lies on one CUDA device."""
    valid = setup["valid"]
    T, dev = valid.shape[0], valid.device
    zv = setup["zv"]
    cols = [(key, setup[key], dtype) for key, dtype in COLUMNS]
    cols += [(f"zv[:, {v}]", zv[:, v], torch.float32) for v in range(3)]
    cols += [(f"spec lane {BASE_LANES + n}", c, torch.float32) for n, c in enumerate(spec_columns(setup, spec))]
    if record_lanes(spec) > MAX_LANES:
        raise ValueError(f"the spec's record has {record_lanes(spec)} lanes; the binning kernel writes at most "
                         f"{MAX_LANES}")
    for name, t, dtype in cols:
        if t.dtype != dtype or tuple(t.shape) != (T,):
            raise ValueError(f"{name}: expected a ({T},) {dtype} column, got {tuple(t.shape)} {t.dtype}")
        if T and (T - 1) * t.stride(0) > _INT_MAX:
            raise ValueError(f"{name}: its last element lies past the kernel's int32 offset (stride {t.stride(0)})")
    for name, t, _ in cols:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected a tensor on a CUDA device ({dev}), got one on {t.device}")
    return [(name, t) for name, t, _ in cols]


def bin_triangles(setup, config, spec=(), row_tile_offset=0):
    """binning.bin_triangles_reference's (records, tris, starts, overflowed)
    for CUDA tensors, in one launch on the current stream (see the module
    docstring).  The setup's columns are read in place through their
    strides; the outputs are new tensors."""
    cols = columns(setup, spec)
    T = setup["valid"].shape[0]
    dev = setup["valid"].device
    lanes = record_lanes(spec)
    cap = incidence_cap(T, config)
    # The plain version's id list: its sorted keys cut at cap, of which the
    # uncompacted hold one a candidate.
    slots = cap if config.binning_compact else min(cap, T * config.max_span_y * config.max_span_x)
    gathered = not config.csr_indirect
    if max(T, slots) * lanes > _INT_MAX:
        raise ValueError(f"binning: {max(T, slots)} record rows of {lanes} lanes overflow the kernel's int32 index")
    records = torch.empty((slots if gathered else T, lanes), dtype=torch.float32, device=dev)
    tris = None if gathered else torch.empty((slots,), dtype=torch.int32, device=dev)
    starts = torch.empty((config.num_tiles + 1,), dtype=torch.int32, device=dev)
    overflowed = torch.empty((), dtype=torch.bool, device=dev)
    ptrs = (ctypes.c_void_p * len(cols))(*(t.data_ptr() for _, t in cols))
    strides = (ctypes.c_int * len(cols))(*(t.stride(0) for _, t in cols))
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.binning_launch(
            ptrs, strides, len(cols) - len(COLUMNS) - 3, T, config.tiles_x, config.tiles_y, config.tile_h,
            config.tile_w, config.max_span_y, config.max_span_x, row_tile_offset, cap, slots,
            int(config.binning_compact), lanes, records.data_ptr(), None if tris is None else tris.data_ptr(),
            starts.data_ptr(), overflowed.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"binning_launch failed: {lib.binning_error_string(err).decode()}")
    raster_cuda.launch_counts(LAUNCHES)["bin"] += 1
    return records, tris, starts, overflowed
