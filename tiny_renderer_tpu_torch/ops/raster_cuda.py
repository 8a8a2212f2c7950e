"""The tile raster's depth resolve: K1 phase 1 as a CUDA kernel, and its twin.

``rasterize`` is the counterpart of ``tiny_renderer_tpu.ops.raster_pallas.
rasterize_pallas`` in the modes the shadow frame path uses: depth only,
index only, and depth + index.  For CUDA tensors it launches the
hand-written kernel in ``csrc/raster.cu`` (see the note at its top); for CPU
tensors it runs ``rasterize_reference``, the plain torch version of the same
function.  The modes that are not ported (varying planes, strip plane,
int16 index target) raise ``NotImplementedError`` on either device.

The kernel is built at first use with nvcc into ``_build/`` beside the
package, as a plain-C shared library loaded with ctypes, and cached there by
a hash of the source and the flags.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .binning import BASE_LANES
from .mathlib import F32_MIN

LAUNCHES = 0  # kernel launches made by rasterize (not by the twin)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "raster.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_MAX_THREADS = 1024
_REF_CHUNK_ELEMS = 1 << 23  # twin: (tiles x slots x pixels) elements per step


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME): nvcc is needed to build the raster kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(force: bool = False):
    """Compile csrc/raster.cu into BUILD_DIR (unless an up-to-date build is
    cached there, or `force`).  Returns (library path, seconds spent
    compiling, nvcc's output).  Raises RuntimeError with nvcc's stderr if
    the build fails."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"raster_{digest}.so"
    log = BUILD_DIR / f"raster_{digest}.log"
    if lib.exists() and not force:
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    out = proc.stdout + proc.stderr
    log.write_text(out)
    return lib, seconds, out


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.raster_depth.argtypes = [p, i, p, p, i, i, i, i, i, p, p, p]
    lib.raster_depth.restype = i
    lib.raster_error_string.argtypes = [i]
    lib.raster_error_string.restype = ctypes.c_char_p
    lib.raster_pixels_per_thread.argtypes = []
    lib.raster_pixels_per_thread.restype = i
    return lib


def _check_modes(spec, emit_strips, idx_dtype, emit_idx, emit_z):
    if spec:
        raise NotImplementedError("varying planes (K1 phase 2) are not ported")
    if emit_strips:
        raise NotImplementedError("the strip coverage plane (K1 emit_strips) is not ported")
    if idx_dtype != "int32":
        raise NotImplementedError("the int16 index target (K1 int16 mode) is not ported")
    if not (emit_z or emit_idx):
        raise ValueError("the raster must emit z, idx or both")


def rasterize(records, tris, starts, *, tile_h, tile_w, tiles_y, tiles_x,
              row_tile_offset=0, emit_idx=True, emit_z=True, spec=(),
              emit_strips=0, idx_dtype="int32"):
    """Resolve the winning depth and triangle index of every pixel.

    records (T, lanes) f32, tris (cap,) i32 and starts (tiles+1,) i32 are
    bin_triangles' CSR layout (tris entries < T, starts <= cap; not checked
    on the device).  row_tile_offset shifts the tile rows' pixel
    coordinates (a band of a taller frame).

    Returns (z, idx) of shape (tiles_y*tile_h, tiles_x*tile_w): z f32
    (F32_MIN where uncovered) or None unless emit_z, idx i32 (-1 where
    uncovered) or None unless emit_idx.  CUDA tensors launch the kernel,
    CPU tensors run rasterize_reference.
    """
    _check_modes(spec, emit_strips, idx_dtype, emit_idx, emit_z)
    if records.device.type == "cpu":
        return rasterize_reference(
            records, tris, starts, tile_h=tile_h, tile_w=tile_w,
            tiles_y=tiles_y, tiles_x=tiles_x, row_tile_offset=row_tile_offset,
            emit_idx=emit_idx, emit_z=emit_z,
        )
    if records.device.type != "cuda":
        raise ValueError(f"rasterize runs on cuda or cpu tensors, got {records.device}")
    return _launch(records, tris, starts, tile_h, tile_w, tiles_y, tiles_x,
                   row_tile_offset, emit_idx, emit_z)


def _launch(records, tris, starts, tile_h, tile_w, tiles_y, tiles_x, row_off,
            emit_idx, emit_z):
    global LAUNCHES
    num_tiles = tiles_y * tiles_x
    for name, t, dtype, ndim in (("records", records, torch.float32, 2),
                                 ("tris", tris, torch.int32, 1),
                                 ("starts", starts, torch.int32, 1)):
        if t.device != records.device or t.dtype != dtype or t.ndim != ndim:
            raise ValueError(
                f"{name}: expected a {ndim}-D {dtype} tensor on {records.device}, "
                f"got {t.ndim}-D {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if records.shape[1] < BASE_LANES or records.shape[0] >= 1 << 24:
        raise ValueError(f"records must be (T < 2^24, >= {BASE_LANES}) f32, got {tuple(records.shape)}")
    if starts.shape[0] != num_tiles + 1:
        raise ValueError(f"starts must have {num_tiles + 1} entries, got {starts.shape[0]}")
    if tris.shape[0] == 0 or num_tiles == 0:
        raise ValueError("rasterize needs at least one tile and one CSR slot")

    lib = _library()
    pix = lib.raster_pixels_per_thread()
    threads, rem = divmod(tile_h * tile_w, pix)
    if rem or threads % 32 or threads > _MAX_THREADS:
        raise ValueError(
            f"tile {tile_h}x{tile_w} unsupported: the kernel needs a multiple of "
            f"{32 * pix} pixels and at most {_MAX_THREADS * pix}"
        )

    shape = (tiles_y * tile_h, tiles_x * tile_w)
    dev = records.device
    z = torch.empty(shape, dtype=torch.float32, device=dev) if emit_z else None
    idx = torch.empty(shape, dtype=torch.int32, device=dev) if emit_idx else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raster_depth(
            records.data_ptr(), records.shape[1], tris.data_ptr(), starts.data_ptr(),
            num_tiles, tiles_x, tile_h, tile_w, int(row_off),
            z.data_ptr() if z is not None else None,
            idx.data_ptr() if idx is not None else None,
            stream,
        )
    if err:
        raise RuntimeError(f"raster_depth launch failed: {lib.raster_error_string(err).decode()}")
    LAUNCHES += 1
    return z, idx


def rasterize_reference(records, tris, starts, *, tile_h, tile_w, tiles_y,
                        tiles_x, row_tile_offset=0, emit_idx=True, emit_z=True,
                        spec=(), emit_strips=0, idx_dtype="int32"):
    """Plain torch version of ``rasterize`` (same signature and outputs).

    Vectorized over all tiles' pixels and over chunks of CSR slot ranks.
    Each chunk resolves its candidates lexicographically — max z, then the
    lowest slot — and merges into the running result only on a strictly
    greater z; that equals the kernel's sequential strict-`>` walk in
    ascending slot order.  Per-candidate arithmetic is the kernel's, op for
    op, so on the card the two agree bit for bit.
    """
    _check_modes(spec, emit_strips, idx_dtype, emit_idx, emit_z)
    dev = records.device
    nt = tiles_y * tiles_x
    P = tile_h * tile_w
    tile = torch.arange(nt, device=dev)
    ty, tx = tile // tiles_x, tile % tiles_x
    pix = torch.arange(P, device=dev)
    row, col = pix // tile_w, pix % tile_w
    px = (tx[:, None] * tile_w + col[None, :]).to(torch.float32)[:, None, :]
    py = ((ty[:, None] + row_tile_offset) * tile_h + row[None, :]).to(torch.float32)[:, None, :]

    best = torch.full((nt, P), F32_MIN, dtype=torch.float32, device=dev)
    bidx = torch.full((nt, P), -1, dtype=torch.int32, device=dev)
    s0 = starts[:-1].long()
    count = starts[1:].long() - s0
    max_count = int(count.max()) if nt else 0
    step = max(1, min(max_count, _REF_CHUNK_ELEMS // max(1, nt * P)))
    for j0 in range(0, max_count, step):
        j = torch.arange(j0, min(j0 + step, max_count), device=dev)
        slot = (s0[:, None] + j[None, :]).clamp(max=tris.shape[0] - 1)
        live = (j[None, :] < count[:, None])[..., None]  # (nt, J, 1)
        rec = records[tris[slot].long()]  # (nt, J, lanes)

        def lane(k):
            return rec[..., k, None]  # (nt, J, 1)

        cx = lane(0) * px + lane(1) * py + lane(2)
        cy = lane(3) * px + lane(4) * py + lane(5)
        cxs = cx * lane(6)
        cys = cy * lane(6)
        inside = (cxs >= 0.0) & (cys >= 0.0) & (lane(7) - cxs - cys >= 0.0)
        u = cx * lane(8)
        v = cy * lane(8)
        w = 1.0 - (cx + cy) * lane(8)
        z = (w * lane(9) + u * lane(10)) + v * lane(11)
        # A candidate at or below the clear value (or NaN) can never win.
        ok = inside & live & (z > F32_MIN)
        zc = torch.where(ok, z, float("-inf"))
        zmax = zc.max(dim=1).values  # (nt, P)
        rank = torch.arange(j.shape[0], device=dev)[None, :, None]
        first = torch.where(ok & (zc == zmax[:, None, :]), rank, j.shape[0]).min(dim=1).values
        gidx = rec[..., 12].to(torch.int32)  # (nt, J)
        win = zmax > best
        best = torch.where(win, zmax, best)
        bidx = torch.where(win, torch.gather(gidx, 1, first.clamp(max=j.shape[0] - 1)), bidx)

    def frame(t):
        return (t.reshape(tiles_y, tiles_x, tile_h, tile_w).permute(0, 2, 1, 3)
                .reshape(tiles_y * tile_h, tiles_x * tile_w))

    return (frame(best) if emit_z else None, frame(bidx) if emit_idx else None)
