"""The tile raster: K1 and K2 of ``raster_pallas.py`` as CUDA kernels, and their twins.

``rasterize`` is the counterpart of ``tiny_renderer_tpu.ops.raster_pallas.
rasterize_pallas`` in every mode: depth only, index only, depth + index, the
gathered record layout (``tris=None``), the int16 index target, the strip
coverage plane (``emit_strips``) and the varying planes of phase 2
(``spec``).  ``rasterize_fused`` is the counterpart of
``rasterize_pallas_fused``: both passes of a two-pass frame in one launch.
For CUDA tensors they launch the hand-written kernels in ``csrc/raster.cu``
(see the note at its top); for CPU tensors they run ``rasterize_reference``
and ``rasterize_fused_reference``, the plain torch versions of the same
functions.

The kernels are built at first use with nvcc into ``_build/`` beside the
package, as a plain-C shared library loaded with ctypes, and cached there by
a hash of the source, the headers it includes and the flags.  A kernel block
covers one SUBTILE of a bin tile and walks only the 4x8 rects a candidate
may cover; ``cull_masks`` models that cull in plain torch (for accounting
and tests; chip_smoke.py holds it to the kernel's own masks from the probe
build, ``build(probe=True)``).  ``LAUNCHES`` counts kernel launches by mode: ``raster`` (every K1
launch), ``fused`` (every K2 launch), ``gathered``, ``int16``, ``strips``,
``planes`` (the launches that ran that mode), and ``offset`` and
``fused_offset`` (the K1 and K2 launches at a nonzero row_tile_offset: the
row shards of parallel.sharding).  A launch made while a CUDA graph is
captured (``recording``) runs only when the graph is replayed: it is
counted at each replay (``replayed``), not at the capture.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from .binning import BASE_LANES
from .mathlib import F32_MIN

# Kernel launches by mode (not counting the twins).
LAUNCHES = dict.fromkeys(
    ("raster", "fused", "gathered", "int16", "strips", "planes", "offset", "fused_offset"), 0)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "raster.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_PLANES = 16  # varying planes one K1 launch emits (the plane table is a kernel argument)
_PLANE_MODES = {"interp": 0, "const": 1, "zfrag": 2, "texidx": 3}
# Record lanes one output plane of each mode reads from its first lane.
PLANE_LANES = {"interp": 3, "zfrag": 3, "const": 1, "texidx": 6}
_REF_CHUNK_ELEMS = 1 << 23  # twin: (tiles x slots x pixels) elements per step
# Rows and columns of the sub-tile one kernel block covers (csrc/raster.cu
# kSubH, kSubW): tile_h and tile_w must be multiples of them.
SUBTILE = (8, 32)
_EXACT_SPAN = 2.0 ** 23  # csrc/raster.cu kExactSpan


# .counts: {id(totals): the launches of the capture under way in this
# thread}, one entry for each dict of totals being recorded.
_CAPTURE = threading.local()


def reset_launches():
    """Set every LAUNCHES count to 0."""
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))


@contextlib.contextmanager
def recording(totals=LAUNCHES):
    """Around the capture of a CUDA graph: the launches this thread makes
    inside are recorded into the graph, not run, so they go into the dict
    this yields instead of `totals` (LAUNCHES, or another module's dict of
    counts).  Pass it to replayed() at each replay."""
    counts = dict.fromkeys(totals, 0)
    capture = _CAPTURE.__dict__.setdefault("counts", {})
    capture[id(totals)] = counts
    try:
        yield counts
    finally:
        del capture[id(totals)]


def replayed(counts, totals=LAUNCHES):
    """Count one replay of a graph whose capture recorded `counts`."""
    for k, n in counts.items():
        totals[k] += n


def launch_counts(totals=LAUNCHES):
    """Where a launch is counted: the capture under way, else `totals`."""
    return getattr(_CAPTURE, "counts", {}).get(id(totals), totals)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME): nvcc is needed to build the raster kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(force: bool = False, probe: bool = False, source: Path = SOURCE):
    """Compile csrc/raster.cu (or another plain-C CUDA `source`, with the
    headers of its directory that it includes) into BUILD_DIR (unless an
    up-to-date build is cached there, or `force`); with
    `probe`, its probe build (-DRASTER_PROBE, see the note in raster.cu).
    Returns (library path, seconds spent compiling, nvcc's output).  Raises
    RuntimeError with nvcc's stderr if the build fails."""
    flags = NVCC_FLAGS + (("-DRASTER_PROBE",) if probe else ())
    text = source.read_bytes()
    # The headers beside it that it includes ("name") are part of the source.
    headers = b"".join((source.parent / h.decode()).read_bytes()
                       for h in re.findall(rb'^#include "([^"]+)"', text, re.MULTILINE))
    digest = hashlib.sha256(text + headers + "\0".join(flags).encode()).hexdigest()[:16]
    name = f"{source.stem}{'_probe' if probe else ''}_{digest}"
    lib, log = BUILD_DIR / f"{name}.so", BUILD_DIR / f"{name}.log"
    if lib.exists() and not force:
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(source)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {source.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    out = proc.stdout + proc.stderr
    log.write_text(out)
    return lib, seconds, out


@functools.cache
def _library(probe: bool = False):
    """The built library (the probe build with `probe`), its functions'
    argument types set."""
    lib = ctypes.CDLL(str(build(probe=probe)[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.raster_depth.argtypes = [p, i, p, p, i, i, i, i, i, p, p, i, p, i, p, i, ip, p]
    lib.raster_depth.restype = i
    lib.raster_fused.argtypes = [p, i, p, p, p, i, p, p, i, i, i, i, i, p, p, p]
    lib.raster_fused.restype = i
    lib.raster_error_string.argtypes = [i]
    lib.raster_error_string.restype = ctypes.c_char_p
    if probe:
        lib.raster_set_probe.argtypes = [p, p]
        lib.raster_set_probe.restype = i
    return lib


def _plane_layout(spec):
    """[(mode, record_lane, plane_index, W, H, tile)] for each output plane
    of `spec` (raster_pallas._plane_layout).  "texidx:W:H[:tile]" reads 6
    record lanes (uv per vertex) and makes one plane, the flat texel index
    (an exact integer in f32); "zfrag" interpolates the base z lanes 9-11."""
    planes = []
    lane = BASE_LANES
    p = 0
    for _name, comps, mode in spec or ():
        if mode.startswith("texidx"):
            parts = mode.split(":")
            tile = int(parts[3]) if len(parts) > 3 else 0
            planes.append(("texidx", lane, p, int(parts[1]), int(parts[2]), tile))
            lane += PLANE_LANES["texidx"]
            p += 1
            continue
        for _ in range(comps):
            if mode in ("interp", "const"):
                planes.append((mode, lane, p, 0, 0, 0))
                lane += PLANE_LANES[mode]
            elif mode == "zfrag":
                planes.append(("zfrag", 9, p, 0, 0, 0))
            else:
                raise ValueError(f"unknown varying mode {mode!r}")
            p += 1
    return planes


def _check_modes(records, planes, tile_w, emit_strips, idx_dtype, emit_idx, emit_z):
    if idx_dtype not in ("int32", "int16"):
        raise ValueError(f"idx_dtype must be 'int32' or 'int16', got {idx_dtype!r}")
    if emit_strips and (emit_strips < 0 or tile_w % emit_strips):
        raise ValueError(f"emit_strips={emit_strips} must divide tile_w={tile_w}")
    if not (emit_z or emit_idx or emit_strips or planes):
        raise ValueError("the raster must emit z, idx or both")
    used = max((lane + PLANE_LANES[m] for m, lane, *_ in planes), default=BASE_LANES)
    if used > records.shape[1]:
        raise ValueError(f"the varying spec reads {used} record lanes, records have {records.shape[1]}")


def rasterize(records, tris, starts, *, tile_h, tile_w, tiles_y, tiles_x,
              row_tile_offset=0, emit_idx=True, emit_z=True, spec=(),
              emit_strips=0, idx_dtype="int32"):
    """Resolve the winning depth and triangle of every pixel, and what the
    optional outputs derive from the winner.

    records, tris, starts are bin_triangles' CSR layout: with tris (cap,)
    i32, records is the (T, lanes) f32 table indirected through it; with
    tris None, records is gathered in CSR order, (cap, lanes).  starts is
    (tiles+1,) i32.  Entries are not checked on the device.
    row_tile_offset shifts the tile rows' pixel coordinates (a band of a
    taller frame).  spec: a varying spec (pipelines.shaders); its planes
    are interpolated at each pixel's winner.  emit_strips=SL: also emit the
    per-SL-pixel strip max of idx.  idx_dtype: "int32" or "int16" (exact
    while T < 32768; the resolve runs in int32 either way).

    Returns (z, idx, varys, strips), spatial shape (tiles_y*tile_h,
    tiles_x*tile_w) =: (Hp, Wp): z f32 (F32_MIN where uncovered) unless not
    emit_z; idx (-1 where uncovered) when emit_idx, spec or emit_strips;
    varys (P, Hp, Wp) f32 (0 where uncovered) when spec; strips
    (Hp, Wp/SL) i32 when emit_strips.  Absent outputs are None.  CUDA
    tensors launch the kernel, CPU tensors run rasterize_reference.
    """
    kw = dict(tile_h=tile_h, tile_w=tile_w, tiles_y=tiles_y, tiles_x=tiles_x,
              row_tile_offset=row_tile_offset, emit_idx=emit_idx, emit_z=emit_z,
              spec=spec, emit_strips=emit_strips, idx_dtype=idx_dtype)
    if records.device.type == "cpu":
        return rasterize_reference(records, tris, starts, **kw)
    if records.device.type != "cuda":
        raise ValueError(f"rasterize runs on cuda or cpu tensors, got {records.device}")
    return _launch(records, tris, starts, **kw)


def rasterize_fused(rec1, tris1, starts1, rec2, tris2, starts2, *, tile_h, tile_w,
                    tiles_y, tiles_x, row_tile_offset=0):
    """Both passes of a two-pass frame in one launch (rasterize_pallas_fused):
    the light pass's depth and the camera pass's winning index on the same
    tile grid.  Each (rec, tris, starts) triple is one pass's binning; both
    passes use the same layout (tris both given or both None).  Returns
    (shadow_z f32, idx i32) of padded shape.  CUDA tensors launch the
    kernel, CPU tensors run rasterize_fused_reference."""
    if (tris1 is None) != (tris2 is None):
        raise ValueError("both passes must use the same record layout")
    grid = dict(tile_h=tile_h, tile_w=tile_w, tiles_y=tiles_y, tiles_x=tiles_x,
                row_tile_offset=row_tile_offset)
    if rec1.device.type == "cpu":
        return rasterize_fused_reference(rec1, tris1, starts1, rec2, tris2, starts2, **grid)
    if rec1.device.type != "cuda":
        raise ValueError(f"rasterize_fused runs on cuda or cpu tensors, got {rec1.device}")
    return _launch_fused(rec1, tris1, starts1, rec2, tris2, starts2, **grid)


def _check_pass(records, tris, starts, num_tiles):
    dev = records.device
    for name, t, dtype, ndim in (("records", records, torch.float32, 2), ("tris", tris, torch.int32, 1),
                                 ("starts", starts, torch.int32, 1)):
        if t is not None and (t.dtype != dtype or t.ndim != ndim or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {ndim}-D {dtype} tensor on {dev}, "
                             f"got {t.ndim}-D {t.dtype} on {t.device}")
    rows, lanes = records.shape
    if lanes < BASE_LANES or rows >= 1 << 24:
        raise ValueError(f"records must be (rows < 2^24, >= {BASE_LANES}) f32, got {(rows, lanes)}")
    if starts.shape[0] != num_tiles + 1:
        raise ValueError(f"starts must have {num_tiles + 1} entries, got {starts.shape[0]}")
    if num_tiles == 0 or (rows if tris is None else tris.shape[0]) == 0:
        raise ValueError("rasterize needs at least one tile and one CSR slot")


def _check_tile(tile_h, tile_w):
    if tile_h % SUBTILE[0] or tile_w % SUBTILE[1]:
        raise ValueError(
            f"tile {tile_h}x{tile_w} unsupported: the kernel's blocks cover {SUBTILE[0]}x{SUBTILE[1]} "
            "sub-tiles, so tile_h and tile_w must be multiples of them"
        )


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, lib, what):
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.raster_error_string(err).decode()}")


def _launch(records, tris, starts, *, tile_h, tile_w, tiles_y, tiles_x, row_tile_offset,
            emit_idx, emit_z, spec, emit_strips, idx_dtype):
    planes = _plane_layout(spec) if spec else []
    _check_modes(records, planes, tile_w, emit_strips, idx_dtype, emit_idx, emit_z)
    if len(planes) > MAX_PLANES:
        raise ValueError(f"{len(planes)} varying planes; the kernel emits at most {MAX_PLANES}")
    num_tiles = tiles_y * tiles_x
    _check_pass(records, tris, starts, num_tiles)
    _check_tile(tile_h, tile_w)
    lib = _library()

    shape = (tiles_y * tile_h, tiles_x * tile_w)
    dev = records.device
    with_idx = emit_idx or bool(planes) or emit_strips > 0
    idx_t = torch.int16 if idx_dtype == "int16" else torch.int32
    z = torch.empty(shape, dtype=torch.float32, device=dev) if emit_z else None
    idx = torch.empty(shape, dtype=idx_t, device=dev) if with_idx else None
    varys = torch.empty((len(planes), *shape), dtype=torch.float32, device=dev) if planes else None
    strips = None
    if emit_strips:
        # Strips that cross a sub-tile border are combined with atomicMax.
        strips = torch.empty((shape[0], shape[1] // emit_strips), dtype=torch.int32, device=dev)
        if SUBTILE[1] % emit_strips:
            strips.fill_(-1)
    desc = (ctypes.c_int * (5 * len(planes)))(
        *[v for m, lane, _p, w, h, t in planes for v in (_PLANE_MODES[m], lane, w, h, t)]
    ) if planes else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raster_depth(
            records.data_ptr(), records.shape[1], _ptr(tris), starts.data_ptr(),
            num_tiles, tiles_x, tile_h, tile_w, int(row_tile_offset),
            _ptr(z), _ptr(idx), int(idx_t == torch.int16), _ptr(strips), int(emit_strips),
            _ptr(varys), len(planes), desc, stream,
        )
    _raise_on(err, lib, "raster_depth")
    counts = launch_counts()
    counts["raster"] += 1
    counts["gathered"] += tris is None
    counts["int16"] += idx is not None and idx_t == torch.int16
    counts["strips"] += emit_strips > 0
    counts["planes"] += bool(planes)
    counts["offset"] += row_tile_offset != 0
    return z, idx, varys, strips


def _launch_fused(rec1, tris1, starts1, rec2, tris2, starts2, *, tile_h, tile_w, tiles_y,
                  tiles_x, row_tile_offset):
    num_tiles = tiles_y * tiles_x
    _check_pass(rec1, tris1, starts1, num_tiles)
    _check_pass(rec2, tris2, starts2, num_tiles)
    if rec2.device != rec1.device:
        raise ValueError("both passes must lie on one device")
    _check_tile(tile_h, tile_w)
    lib = _library()
    shape = (tiles_y * tile_h, tiles_x * tile_w)
    shadow_z = torch.empty(shape, dtype=torch.float32, device=rec1.device)
    idx = torch.empty(shape, dtype=torch.int32, device=rec1.device)
    with torch.cuda.device(rec1.device):
        stream = torch.cuda.current_stream(rec1.device).cuda_stream
        err = lib.raster_fused(
            rec1.data_ptr(), rec1.shape[1], _ptr(tris1), starts1.data_ptr(),
            rec2.data_ptr(), rec2.shape[1], _ptr(tris2), starts2.data_ptr(),
            num_tiles, tiles_x, tile_h, tile_w, int(row_tile_offset),
            shadow_z.data_ptr(), idx.data_ptr(), stream,
        )
    _raise_on(err, lib, "raster_fused")
    counts = launch_counts()
    counts["fused"] += 1
    counts["gathered"] += tris1 is None
    counts["fused_offset"] += row_tile_offset != 0
    return shadow_z, idx


def rasterize_reference(records, tris, starts, *, tile_h, tile_w, tiles_y,
                        tiles_x, row_tile_offset=0, emit_idx=True, emit_z=True,
                        spec=(), emit_strips=0, idx_dtype="int32"):
    """Plain torch version of ``rasterize`` (same signature and outputs).

    Phase 1 is vectorized over all tiles' pixels and over chunks of CSR
    slot ranks.  Each chunk resolves its candidates lexicographically — max
    z, then the lowest slot — and merges into the running result only on a
    strictly greater z; that equals the kernel's sequential strict-`>` walk
    in ascending slot order.  Phase 2 reads the winning slot's record once
    per pixel.  Per-candidate arithmetic is the kernel's, op for op, so on
    the card the two agree bit for bit.
    """
    planes = _plane_layout(spec)
    _check_modes(records, planes, tile_w, emit_strips, idx_dtype, emit_idx, emit_z)
    dev = records.device
    nt = tiles_y * tiles_x
    P = tile_h * tile_w
    tile = torch.arange(nt, device=dev)
    ty, tx = tile // tiles_x, tile % tiles_x
    pix = torch.arange(P, device=dev)
    row, col = pix // tile_w, pix % tile_w
    px = (tx[:, None] * tile_w + col[None, :]).to(torch.float32)  # (nt, P)
    py = ((ty[:, None] + row_tile_offset) * tile_h + row[None, :]).to(torch.float32)

    def rows_of(slot):
        return slot if tris is None else tris[slot].long()

    best = torch.full((nt, P), F32_MIN, dtype=torch.float32, device=dev)
    bidx = torch.full((nt, P), -1, dtype=torch.int32, device=dev)
    bslot = torch.zeros((nt, P), dtype=torch.int64, device=dev)
    n_slots = records.shape[0] if tris is None else tris.shape[0]
    s0 = starts[:-1].long()
    count = starts[1:].long() - s0
    max_count = int(count.max()) if nt else 0
    step = max(1, min(max_count, _REF_CHUNK_ELEMS // max(1, nt * P)))
    for j0 in range(0, max_count, step):
        j = torch.arange(j0, min(j0 + step, max_count), device=dev)
        slot = (s0[:, None] + j[None, :]).clamp(max=n_slots - 1)  # (nt, J)
        live = (j[None, :] < count[:, None])[..., None]  # (nt, J, 1)
        rec = records[rows_of(slot)]  # (nt, J, lanes)

        def lane(k):
            return rec[..., k, None]  # (nt, J, 1)

        cx = lane(0) * px[:, None, :] + lane(1) * py[:, None, :] + lane(2)
        cy = lane(3) * px[:, None, :] + lane(4) * py[:, None, :] + lane(5)
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
        first = first.clamp(max=j.shape[0] - 1)
        gidx = rec[..., 12].to(torch.int32)  # (nt, J)
        win = zmax > best
        best = torch.where(win, zmax, best)
        bidx = torch.where(win, torch.gather(gidx, 1, first), bidx)
        bslot = torch.where(win, torch.gather(slot, 1, first), bslot)

    def frame(t):
        return (t.reshape(*t.shape[:-2], tiles_y, tiles_x, tile_h, tile_w)
                .transpose(-3, -2).reshape(*t.shape[:-2], tiles_y * tile_h, tiles_x * tile_w))

    with_idx = emit_idx or bool(planes) or emit_strips > 0
    varys = _varying_planes(records[rows_of(bslot)], px, py, bidx >= 0, planes) if planes else None
    idx = frame(bidx)
    strips = None
    if emit_strips:
        strips = idx.reshape(idx.shape[0], -1, emit_strips).amax(dim=-1)
    return (
        frame(best) if emit_z else None,
        idx.to(torch.int16 if idx_dtype == "int16" else torch.int32) if with_idx else None,
        frame(varys) if varys is not None else None,
        strips,
    )


def _varying_planes(rec, px, py, covered, planes):
    """Phase 2 of the twin: the (P, ...) varying planes at each pixel's
    winning record `rec` (..., lanes), 0 where not covered.  Barycentrics
    by exact division (raster_pallas.py:266-268), interpolation
    (a0*w + a1*u) + a2*v, and the texel fold NaN->0, max 0, trunc,
    min dim-1, then the optional tile swizzle (:282-301)."""

    def lane(k):
        return rec[..., k]

    cx = lane(0) * px + lane(1) * py + lane(2)
    cy = lane(3) * px + lane(4) * py + lane(5)
    sgn = lane(6)
    absz = lane(7)
    u = (cx * sgn) / absz
    v = (cy * sgn) / absz
    w = 1.0 - ((cx + cy) * sgn) / absz

    def interp(k):
        return (lane(k) * w + lane(k + 1) * u) + lane(k + 2) * v

    def texel(x, dim):
        x = torch.where(torch.isnan(x), 0.0, x)
        return x.clamp(min=0.0).trunc().clamp(max=float(dim - 1))

    out = []
    for mode, ln, _p, wdim, hdim, swz in planes:
        if mode == "const":
            val = lane(ln)
        elif mode == "texidx":
            cxp = texel(interp(ln) * float(wdim), wdim)
            cyp = texel(interp(ln + 3) * float(hdim), hdim)
            if swz:
                fb = float(swz)
                tx = (cxp / fb).trunc()
                ty = (cyp / fb).trunc()
                ix = cxp - tx * fb
                iy = cyp - ty * fb
                val = ((ty * float(wdim // swz) + tx) * fb + iy) * fb + ix
            else:
                val = cyp * float(wdim) + cxp
        else:  # interp / zfrag
            val = interp(ln)
        out.append(torch.where(covered, val, 0.0))
    return torch.stack(out)


def rasterize_fused_reference(rec1, tris1, starts1, rec2, tris2, starts2, *, tile_h,
                              tile_w, tiles_y, tiles_x, row_tile_offset=0):
    """Plain torch version of ``rasterize_fused``: the two passes one after
    the other through rasterize_reference."""
    grid = dict(tile_h=tile_h, tile_w=tile_w, tiles_y=tiles_y, tiles_x=tiles_x,
                row_tile_offset=row_tile_offset)
    shadow_z = rasterize_reference(rec1, tris1, starts1, emit_idx=False, **grid)[0]
    idx = rasterize_reference(rec2, tris2, starts2, emit_z=False, **grid)[1]
    return shadow_z, idx


def _edge(a, b, c, x, y):
    return a * x + b * y + c


def _exact_over(r, x1, y1):
    """csrc/raster.cu exact_over, elementwise over records r (..., lanes)."""
    lanes = r[..., [0, 1, 2, 3, 4, 5, 7]]
    ints = (lanes.trunc() == lanes).all(-1) & (r[..., 6].abs() == 1.0)
    a = r[..., :8].abs()
    span = (((a[..., 0] + a[..., 3]) * x1 + (a[..., 1] + a[..., 4]) * y1)
            + ((a[..., 2] + a[..., 5]) + a[..., 7]))
    return ints & (span <= _EXACT_SPAN)


def _may_cover(r, exact, x0, x1, y0, y1):
    """csrc/raster.cu may_cover, elementwise: False only where no pixel of
    [x0, x1] x [y0, y1] passes record r's inside test."""
    a1, b1, c1, a2, b2, c2, sgn, absz = (r[..., k] for k in range(8))
    pos = sgn > 0.0

    def corner(coef, hi, lo):
        return torch.where((coef > 0.0) == pos, hi, lo)

    xh1, yh1 = corner(a1, x1, x0), corner(b1, y1, y0)
    xh2, yh2 = corner(a2, x1, x0), corner(b2, y1, y0)
    e1 = _edge(a1, b1, c1, xh1, yh1) * sgn
    e2 = _edge(a2, b2, c2, xh2, yh2) * sgn
    x3, y3 = corner(a1 + a2, x0, x1), corner(b1 + b2, y0, y1)
    tight = absz - _edge(a1, b1, c1, x3, y3) * sgn - _edge(a2, b2, c2, x3, y3) * sgn
    loose = (absz - _edge(a1, b1, c1, x0 + x1 - xh1, y0 + y1 - yh1) * sgn
             - _edge(a2, b2, c2, x0 + x1 - xh2, y0 + y1 - yh2) * sgn)
    return (e1 >= 0.0) & (e2 >= 0.0) & (torch.where(exact, tight, loose) >= 0.0)


def rect_offsets(device=None):
    """(columns, rows) i64: the top-left of each 4x8 rect of a SUBTILE block
    within it, rect w being warp w's (csrc/raster.cu rect_col, rect_row):
    (w // C, w % C) of the sub-tile's two rows of C rects."""
    per_row = SUBTILE[1] // 8
    w = torch.arange(SUBTILE[0] // 4 * per_row, device=device)
    return 8 * (w % per_row), 4 * (w // per_row)


def cull_masks(records, tris, starts, *, tile_h, tile_w, tiles_y, tiles_x, row_tile_offset=0):
    """A model in plain torch of the kernel's cull (csrc/raster.cu
    exact_over, may_cover and the note there), for accounting and tests:
    for every CSR slot in [starts[0], starts[-1]) and every SUBTILE block
    of the slot's tile (row-major), the 4x8 rects of the block
    (rect_offsets) that the kernel walks the slot's record on (none where
    the block cull drops it).  chip_smoke.py holds it to the masks the
    kernel computes (raster_probe.kernel_masks).

    Returns (tile (S,) i64, masks (S, blocks per tile, rects per block) bool)."""
    sub_h, sub_w = SUBTILE
    dev = records.device
    nby, nbx = tile_h // sub_h, tile_w // sub_w
    tile = torch.repeat_interleave(torch.arange(tiles_y * tiles_x, device=dev),
                                   torch.diff(starts).long())
    slot = torch.arange(int(starts[0]), int(starts[-1]), device=dev)
    rec = records[slot if tris is None else tris[slot].long()][:, None, None, :]
    b = torch.arange(nby * nbx, device=dev)
    y0 = (((tile // tiles_x + row_tile_offset) * tile_h)[:, None] + b // nbx * sub_h)[..., None].float()
    x0 = ((tile % tiles_x * tile_w)[:, None] + b % nbx * sub_w)[..., None].float()
    x1, y1 = x0 + (sub_w - 1), y0 + (sub_h - 1)
    exact = _exact_over(rec, x1, y1)
    keep = _may_cover(rec, exact, x0, x1, y0, y1)
    cols, rows = rect_offsets(dev)
    rx, ry = x0 + cols.float(), y0 + rows.float()
    return tile, keep & _may_cover(rec, exact, rx, rx + 7.0, ry, ry + 3.0)
