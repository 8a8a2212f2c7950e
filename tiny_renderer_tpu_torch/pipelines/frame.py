"""The frame path: uniforms -> vertex stage -> binning -> raster -> shade
(``tiny_renderer_tpu.pipelines.frame``).

All seven pipelines on the kernel path, under every raster knob of the JAX
package (each bit-identical to the default frame):

* default: the two-pass pipelines (``shadow``, ``occlusion``) raster the
  light pass depth-only first; the others fill the shadow plane with
  F32_MIN.  The camera pass is index-only (depth + index when the caller
  wants z), then the strip-compacted shade re-derives the varyings of the
  covered strips by an attribute gather;
* ``fuse_passes``: both rasters of a two-pass pipeline in one launch (K2),
  where ``_use_fused_raster`` allows it;
* ``strip_mask``: the camera pass also emits the per-strip coverage plane;
* ``strip_planes``: the camera pass also interpolates the varying planes
  (K1 phase 2) that the strip shade then reads instead of gathering;
* ``compact_shade=False``: full-screen varying planes and a full-screen
  shade (darboux's per-triangle constants by one gather,
  ``_add_const_gather``);
* ``idx_int16``, ``csr_indirect=False``, ``strip_pack_words=False``,
  ``tex_tile``, ``shadow_tile``, ``strip_len``: layouts.

Custom pipelines join the seven through ``register_pipeline``, which
writes the same tables the built-ins live in (``PIPELINES``,
``shaders.VARYING_SPECS``, ``shaders.PIPELINE_MAPS``, ``_GATHER_KEYS``).

render_frame runs eagerly on the device of the input tensors: CUDA
tensors launch the CUDA raster kernels, CPU tensors run their plain torch
twins.  It reads no device value on the host, so on CUDA tensors
render_frame_jit / make_frame_fn and render_burst / make_burst_fn capture
it into a CUDA graph (pipelines.graphs) and replay that, as the JAX
package runs its frame and burst as one compiled program each.
``backend="dense"`` (the JAX package's "jnp") replaces the binned raster
with ``ops.raster_dense`` and the shade with the full-screen gather shade.
The raster and shade helpers also take a window of rows (``rows``, ``y0``)
for the row shards of ``parallel.sharding``.  ``row_bands = N > 1`` rasters
the frame in disjoint tile-row bands (``_band_plan``), each binned against
its own window with its share of the incidence cap, as the JAX package
does; pixels equal the one-band frame's unless a cap binds.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops import mathlib as ml
from ..ops import raster_cuda
from ..ops.binning import _round_up, bin_triangles, compact_scatter, incidence_cap
from ..ops.raster_dense import rasterize_dense
from ..ops.vertex import triangle_setup
from ..utils import timing
from . import graphs, shaders
from .graphs import CapturedGraph, GraphCache, signature
from .shaders import VARYING_SPECS, compute_varyings, kernel_varying_spec


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Declarative description of one pipeline (reference shader.rs:100-109)."""

    name: str
    needs: tuple  # vertex-stage varyings for the shading pass
    shade: object  # shading function for the final pass
    two_pass: bool = False  # shadow-buffer depth pre-pass (shader.rs:668-963)
    # A hand-written kernel for a whole strip chunk body, or None:
    # fused_body(textures, device) returns the body where the kernel
    # applies, else None, and _shade_strips runs the torch body.
    fused_body: object = None


PIPELINES = {
    "default": PipelineSpec("default", ("face_intensity",), shaders.shade_default),
    "phong": PipelineSpec("phong", ("vertex_intensity",), shaders.shade_phong),
    "normal_map": PipelineSpec("normal_map", (), shaders.shade_normal_map),
    "specular": PipelineSpec("specular", (), shaders.shade_specular),
    "darboux": PipelineSpec("darboux", ("darboux",), shaders.shade_darboux,
                            fused_body=shaders.darboux_fused_body),
    "shadow": PipelineSpec("shadow", ("vertex_intensity",), shaders.shade_shadow, two_pass=True,
                           fused_body=shaders.shadow_fused_body),
    "occlusion": PipelineSpec("occlusion", (), shaders.shade_occlusion, two_pass=True),
}

# Vertex-attribute keys the shade gathers per fragment for compute_varyings.
_GATHER_KEYS = {
    "default": ("uv", "intensity"),
    "phong": ("uv", "intensity"),
    "normal_map": ("uv",),
    "specular": ("uv",),
    "darboux": ("uv", "t_norm", "row0n", "row1n", "du", "dv"),
    "shadow": ("uv", "intensity", "zv"),
    "occlusion": ("zv",),
}

# The varying vocabulary custom pipelines may compose from: varying name ->
# (allowed modes, triangle_setup gather key, components).
_VARYING_VOCAB = {
    "uv": (("interp",), "uv", 2),
    "intensity": (("interp",), "intensity", 1),
    "local_z": (("interp",), "t_norm", 3),
    "zfrag": (("zfrag",), "zv", 1),
    "row0": (("const",), "row0n", 3),
    "row1": (("const",), "row1n", 3),
    "du": (("const",), "du", 2),
    "dv": (("const",), "dv", 2),
}
_VALID_NEEDS = ("face_intensity", "vertex_intensity", "darboux")

# Per-name registration generation, bumped when a registration is replaced
# or removed.  The eager frame path looks the name up on every call, so it
# never serves a stale shade; the counter is the key for any cache that
# holds a pipeline's shade (as the JAX package's jit caches do).
_REGISTRY_GEN = {}


def registry_generation(name):
    """Current registration generation of a pipeline name."""
    return _REGISTRY_GEN.get(name, 0)


def register_pipeline(name, shade, *, varying_spec, maps=(), needs=(),
                      two_pass=False, overwrite=False):
    """Register a custom shader pipeline under `name`.

    Once registered, the name works everywhere a built-in does: Scene,
    render_frame, render_burst, the CLI's -s (when registered before
    build_arg_parser) and the frame server.  Registration composes the
    existing vertex-stage outputs, plus any number of USER vertex
    attributes: a varying named "attr:<x>" declares a (T, 3, comps) float32
    tensor the caller supplies under that exact key in the geometry dict
    (per triangle corner, like pre-expanded uv), interpolated with the same
    barycentric accumulation order as uv.

    Args:
      name: pipeline name.
      shade: fragment shading function on tensors,
        ``shade(frag, uniforms, textures, config) -> (..., 3) u8``.  `frag`
        carries the interpolated varyings named in varying_spec plus
        "x"/"y" pixel coords (and "shadow_buffer" when two_pass; fetch it
        via shaders._shadow_fetch with shaders.plane_tile_effective).  Use
        shaders.sample_frag for texture reads so the packed, swizzled and
        texel-index paths apply.
      varying_spec: tuple of (name, components, mode) drawn from the
        vocabulary: uv(2, interp), intensity(1, interp), local_z(3,
        interp), zfrag(1, zfrag), row0/row1(3, const), du/dv(2, const) — or
        "attr:<x>"(1-8, interp) for a custom per-vertex attribute supplied
        as geom["attr:<x>"] with shape (num_triangles, 3, components).
      maps: texture-map names the shade samples (word-packed together).
      needs: vertex-stage extras, subset of {face_intensity,
        vertex_intensity, darboux}.
      two_pass: render the light-view depth pass first (the shade then
        receives "shadow_buffer" and the shadow pass 2 uniforms).
      overwrite: allow replacing an existing registration.

    Returns the PipelineSpec.  Raises ValueError on unknown varyings,
    modes, component counts or needs.
    """
    if name in PIPELINES and not overwrite:
        raise ValueError(
            f"pipeline {name!r} already registered (pass overwrite=True "
            "to replace it)"
        )
    gather = []
    for vname, comps, mode in varying_spec:
        if vname.startswith("attr:"):
            if mode != "interp":
                raise ValueError(
                    f"custom vertex attribute {vname!r} supports mode "
                    f"'interp', got {mode!r}"
                )
            if not isinstance(comps, int) or not 1 <= comps <= 8:
                raise ValueError(
                    f"custom vertex attribute {vname!r} must have 1-8 "
                    f"components, got {comps!r}"
                )
            if vname not in gather:
                gather.append(vname)
            continue
        if vname not in _VARYING_VOCAB:
            raise ValueError(
                f"unknown varying {vname!r}; available: "
                f"{', '.join(sorted(_VARYING_VOCAB))}, or 'attr:<name>' "
                "for a custom per-vertex attribute"
            )
        modes, key, want_comps = _VARYING_VOCAB[vname]
        if mode not in modes:
            raise ValueError(
                f"varying {vname!r} supports mode {modes[0]!r}, got {mode!r}"
            )
        if comps != want_comps:
            # A wrong count would misalign every later varying's planes and
            # record lanes.
            raise ValueError(
                f"varying {vname!r} has {want_comps} components, "
                f"got {comps}"
            )
        if key not in gather:
            gather.append(key)
    for n in needs:
        if n not in _VALID_NEEDS:
            raise ValueError(
                f"unknown vertex-stage need {n!r}; valid: {_VALID_NEEDS}"
            )
    # Setup keys exist only when the need that produces them is on.
    if "intensity" in gather and not (
        "face_intensity" in needs or "vertex_intensity" in needs
    ):
        raise ValueError(
            "the 'intensity' varying requires needs to include "
            "'face_intensity' or 'vertex_intensity'"
        )
    if any(k in gather for k in ("t_norm", "row0n", "row1n", "du", "dv")) \
            and "darboux" not in needs:
        raise ValueError(
            "local_z/row0/row1/du/dv varyings require needs to include "
            "'darboux'"
        )
    spec = PipelineSpec(name, tuple(needs), shade, two_pass=two_pass)
    if name in PIPELINES:
        _REGISTRY_GEN[name] = registry_generation(name) + 1
    PIPELINES[name] = spec
    VARYING_SPECS[name] = tuple(varying_spec)
    shaders.PIPELINE_MAPS[name] = tuple(maps)
    _GATHER_KEYS[name] = tuple(gather)
    return spec


def unregister_pipeline(name):
    """Remove a pipeline registered with register_pipeline (built-ins
    refuse: the reference's seven names are API surface)."""
    if name in _BUILTIN_PIPELINES:
        raise ValueError(f"cannot unregister built-in pipeline {name!r}")
    if name in PIPELINES:
        _REGISTRY_GEN[name] = registry_generation(name) + 1
    for table in (PIPELINES, VARYING_SPECS, shaders.PIPELINE_MAPS, _GATHER_KEYS):
        table.pop(name, None)


_BUILTIN_PIPELINES = frozenset(PIPELINES)

# Raster backends: "kernel", the binned tile raster (CUDA kernels on CUDA
# tensors, their twins on CPU tensors), and "dense", every triangle at every
# pixel in plain torch (the JAX package's "jnp": the correctness backend
# the sharded paths' pixel proofs run on).
BACKENDS = ("kernel", "dense")


def _check_config(config, pipeline, backend="kernel"):
    """Refuse an unknown backend, and custom "attr:" varyings under the
    kernel's full-screen shade, whose kernel records have no lanes for them
    (the JAX package fails there too, with a KeyError in
    pack_triangle_records)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    attrs = tuple(n for (n, _, _) in VARYING_SPECS[pipeline] if n.startswith("attr:"))
    if attrs and backend == "kernel" and not config.compact_shade:
        raise ValueError(
            f"pipeline {pipeline!r} declares custom vertex attributes {attrs}, which "
            "the full-screen shade (compact_shade=False) cannot interpolate: the raster "
            "kernel's records have no lanes for them; keep compact_shade=True"
        )


def _window(config, rows, y0):
    """The config of rows [y0, y0 + rows) of the frame (the frame itself
    when rows is None) and its first tile row."""
    window = config if rows is None else dataclasses.replace(config, height=rows)
    return window, y0 // config.tile_h


def _auto_row_bands(config):
    """Tile-row bands of the single-device kernel raster: min(row_bands,
    tiles_y) for an explicit row_bands >= 1, else 1.  The JAX package plans
    row_bands=0 from the TPU's SMEM id-list and VMEM record-window budgets
    (its frame.py:277-300); the CUDA kernel reads its lists from device
    memory and has neither wall, so that plan is not ported."""
    return min(config.row_bands, config.tiles_y) if config.row_bands else 1


def _banded_caps(cap_total, tiles_y, band_tiles):
    """Per-band incidence cap: the global cap's share of the band's tile
    rows, floored like incidence_cap.  Kept as the JAX package has it, so
    that both flag (and drop) the same coverage: a band can overflow where
    the global cap would not, and the other way round."""
    return max(4096, _round_up(-(-cap_total * band_tiles // tiles_y), 8))


def _band_plan(setup, config):
    """[(row_tile_offset, band_tiles, band_config)] of the kernel raster: a
    single (0, tiles_y, config) unless _auto_row_bands says R > 1, else
    ceil(tiles_y / R) tile rows per band (the last band shorter), each
    band's config its window (band_tiles * tile_h rows) with its cap.
    Shared by _rasterize and profile's binning prefix, so the profiled
    binning is the rendered one."""
    R = _auto_row_bands(config)
    ty = config.tiles_y
    if R == 1:
        return [(0, ty, config)]
    band_tiles = -(-ty // R)
    cap_total = incidence_cap(setup["a1"].shape[0], config)
    plan = []
    for t0 in range(0, ty, band_tiles):
        bt = min(band_tiles, ty - t0)
        plan.append((t0, bt, dataclasses.replace(
            config, height=bt * config.tile_h, max_incidences=_banded_caps(cap_total, ty, bt))))
    return plan


def _cat(parts, dim=0):
    """The bands' outputs joined along rows (None when absent)."""
    if parts[0] is None:
        return None
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _rasterize(setup, config, backend="kernel", spec=(), emit_idx=True, emit_z=True,
               emit_strips=0, rows=None, y0=0):
    """Raster one pass over rows [y0, y0 + rows) of the frame (all of it by
    default; a row shard of parallel.sharding otherwise, y0 a multiple of
    tile_h on the kernel backend).  The kernel backend bins against that
    window with its tile-row offset and launches the tile raster: a row
    shard in one launch, the whole frame in _band_plan's bands (one launch
    each; z, idx and strips joined on rows, the varying planes on axis 1,
    the overflow flags OR-ed).  The dense backend resolves every triangle
    at every pixel and has no bands.  Returns (z, idx, varys, strips,
    overflowed) cropped to (rows, width) (strips to (rows, width /
    emit_strips)); absent outputs are None (varys and strips always on the
    dense backend)."""
    window, row_off = _window(config, rows, y0)
    H, W = window.height, window.width
    if backend == "dense":
        z, idx = rasterize_dense(setup, H, W, config.tri_block, y_offset=y0)
        timing.mark("raster")
        return (z if emit_z else None, idx if emit_idx else None, None, None,
                torch.zeros((), dtype=torch.bool, device=z.device))
    plan = _band_plan(setup, config) if rows is None else [(row_off, window.tiles_y, window)]
    outs, flags = [], []
    for t0, _, band in plan:
        records, tris, starts, ovf = bin_triangles(setup, band, spec, row_tile_offset=t0)
        timing.mark("binning")
        outs.append(raster_cuda.rasterize(
            records, tris, starts,
            tile_h=band.tile_h, tile_w=band.tile_w,
            tiles_y=band.tiles_y, tiles_x=band.tiles_x, row_tile_offset=t0,
            spec=spec, emit_idx=emit_idx, emit_z=emit_z, emit_strips=emit_strips,
            idx_dtype=_idx_dtype(setup, band),
        ))
        timing.mark("raster")
        flags.append(ovf)
    z, idx, varys, strips = zip(*outs)
    z, idx, varys, strips = _cat(z), _cat(idx), _cat(varys, dim=1), _cat(strips)  # varys: planes first
    overflowed = flags[0] if len(flags) == 1 else torch.stack(flags).any()
    return (
        z[:H, :W] if z is not None else None,
        idx[:H, :W] if idx is not None else None,
        varys[:, :H, :W] if varys is not None else None,
        strips[:H, : W // emit_strips] if strips is not None else None,
        overflowed,
    )


def _idx_dtype(setup, config):
    """int16 index target when the triangle count fits and the tile height
    is a multiple of 16 (the JAX gate, kept so both packages pick the same
    target); int32 otherwise."""
    if config.idx_int16 and setup["a1"].shape[0] < 32768 and config.tile_h % 16 == 0:
        return "int16"
    return "int32"


def _strip_mask_len(config):
    """strip_len when the camera pass should emit the strip coverage plane
    for the strip-compacted shade, else 0.  Flat strips align with the
    (H, W/SL) plane only when width % SL == 0 (strips never cross rows)."""
    SL = config.strip_len
    if (config.strip_mask and config.compact_shade
            and config.width % SL == 0 and config.tile_w % SL == 0):
        return SL
    return 0


def _use_fused_raster(spec, config, backend, setup, pspec, needs_z):
    """The gate of the fused two-pass kernel (the JAX predicate): the kernel
    backend, a two-pass pipeline, the shade compact, fuse_passes set, the
    camera z not wanted, the index int32, no planes spec (K2 has neither a
    varying phase nor an int16 target) and one row band.  The row shards
    read it with the frame's config, so row_bands > 1 turns K2 off there
    too."""
    return (
        spec.two_pass
        and backend == "kernel"
        and config.compact_shade
        and config.fuse_passes
        and not needs_z
        and _idx_dtype(setup, config) == "int32"
        and pspec is None
        and _auto_row_bands(config) == 1
    )


def _fused_raster(setup1, setup, config, rows=None, y0=0):
    """Bin both passes (no varying lanes) over rows [y0, y0 + rows) of the
    frame (as _rasterize) and run the fused kernel.  Returns (shadow_z, idx,
    ovf1, ovf2) cropped to (rows, width), each pass's coord_overflow folded
    in."""
    window, row_off = _window(config, rows, y0)
    H, W = window.height, window.width
    r1, t1, s1, ovfb1 = bin_triangles(setup1, window, row_tile_offset=row_off)
    r2, t2, s2, ovfb2 = bin_triangles(setup, window, row_tile_offset=row_off)
    timing.mark("binning")
    shadow_z, idx = raster_cuda.rasterize_fused(
        r1, t1, s1, r2, t2, s2,
        tile_h=window.tile_h, tile_w=window.tile_w,
        tiles_y=window.tiles_y, tiles_x=window.tiles_x, row_tile_offset=row_off,
    )
    timing.mark("raster")
    return (
        shadow_z[:H, :W], idx[:H, :W],
        ovfb1 | setup1["coord_overflow"], ovfb2 | setup["coord_overflow"],
    )


def _pixel_coords(H, W, device, y_offset=0):
    py, px = torch.meshgrid(
        torch.arange(y_offset, y_offset + H, dtype=torch.int32, device=device),
        torch.arange(W, dtype=torch.int32, device=device),
        indexing="ij",
    )
    return px, py


def _unpack_planes(spec, varys):
    """Varying dict from a plane-major (n_planes, ...) tensor: scalar planes
    pass through, vector planes get the component axis moved last."""
    out = {}
    p = 0
    for name, comps, _mode in spec:
        out[name] = varys[p] if comps == 1 else torch.movedim(varys[p:p + comps], 0, -1)
        p += comps
    return out


def _fragments_from_planes(spec, varys, H, W, y_offset=0):
    """Fragment dict from the kernel's interpolated varying planes; y_offset
    is the first global row of a row slab."""
    frag = _unpack_planes(spec, varys)
    frag["x"], frag["y"] = _pixel_coords(H, W, varys.device, y_offset)
    return frag


def _planes_spec(pipeline, textures, config):
    """Kernel varying spec for the strip_planes hybrid, or None when it does
    not apply: per-triangle "const" varyings (darboux) and custom "attr:"
    planes would still need a per-fragment gather, so they keep the packed
    attribute gather."""
    if not config.strip_planes:
        return None
    if any(mode == "const" or name.startswith("attr:")
           for (name, _, mode) in VARYING_SPECS[pipeline]):
        return None
    return kernel_varying_spec(pipeline, textures, tile=config.tex_tile)


def _gather_fragments(setup, idx, keys, pixel_coords):
    """Per-fragment vertex attributes by ONE gather of a packed (T, L) f32
    table, plus barycentrics recomputed with the reference's exact f32
    expression (scene.rs:192-196).  idx: winning triangle ids of any shape;
    pixel_coords: (px, py) integer tensors of the same shape."""
    shape = idx.shape
    safe = idx.clamp(min=0).long()
    cols = [setup[k].to(torch.float32)[:, None] for k in ("a1", "b1", "c1", "a2", "b2", "c2", "cz")]
    layout = {}
    pos = 7
    for k in keys:
        if k not in setup:
            # Only reachable for custom "attr:" varyings: the built-in keys
            # exist whenever their needs are validated.
            raise ValueError(
                f"pipeline requires the custom vertex attribute {k!r}: "
                f"supply geom[{k!r}] with shape (num_triangles, 3, k)"
            )
        a = setup[k]
        flat = a.reshape(a.shape[0], -1).to(torch.float32)
        layout[k] = (pos, flat.shape[1], tuple(a.shape[1:]))
        pos += flat.shape[1]
        cols.append(flat)
    g = torch.cat(cols, dim=1)[safe]  # (*shape, L) — the one gather
    frag = {
        k: g[..., start:start + width].reshape(*shape, *kshape)
        for k, (start, width, kshape) in layout.items()
    }
    px, py = pixel_coords
    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    cxf = (g[..., 0] * pxf + g[..., 1] * pyf) + g[..., 2]
    cyf = (g[..., 3] * pxf + g[..., 4] * pyf) + g[..., 5]
    czf = g[..., 6]
    frag["bar"] = torch.stack([1.0 - (cxf + cyf) / czf, cxf / czf, cyf / czf], dim=-1)
    frag["x"] = px
    frag["y"] = py
    return frag


def _shadow_for_shade(shadow_z, spec, config):
    """The shadow plane as the shade fetches read it: tile-swizzled when
    config.shadow_tile applies, row-major otherwise."""
    if not spec.two_pass:
        return shadow_z
    t = shaders.plane_tile_effective(config, shadow_z.shape)
    return shaders.swizzle_plane(shadow_z, t) if t else shadow_z


# The strip shade's chunks: the slots are shaded in chunks that end at
# these fractions of the slot count (each end rounded up to strip_batch),
# each chunk run only where the covered count reaches into it.  Chosen on
# the H100 (PERF.md; scripts/torch_shade_device_time.py) when every chunk
# body was some 190-450 small kernels, a fixed ~0.3 ms (shadow; ~0.5
# occlusion) besides ~19 ns (~50) per slot: a frame at the stand-ins' ~12%
# strip coverage runs one body of an eighth of the slots, one up to half
# the screen runs two, and a frame covering every strip pays two fixed
# costs more than one chunk of every slot would.  Measured since (the same
# script, PERF.md §6-§7): the darboux and shadow bodies are one kernel
# each, and their shade replayed alone takes 0.089 ms at the stand-ins'
# coverage under these ends against 0.084-0.086 as one chunk of every slot
# (0.106-0.115 against 0.095-0.103 covering every strip), so the ends cost
# them a few microseconds; the occlusion and specular bodies are still
# ATen kernels, and the ends halve their shade at that coverage (0.265
# against 0.538 ms, 0.452 against 0.967).  The ends have not been chosen
# again.
SHADE_CHUNK_ENDS = (1 / 8, 1 / 2, 1)


def shade_chunks(slots, strip_batch):
    """The strip shade's chunks of `slots` slots: (start, end) pairs, each
    end a multiple of strip_batch (or `slots`) by SHADE_CHUNK_ENDS."""
    bounds, start = [], 0
    for frac in SHADE_CHUNK_ENDS:
        end = min(slots, _round_up(max(1, round(frac * slots)), strip_batch))
        if end > start:
            bounds.append((start, end))
            start = end
    return bounds


def _shade_strips(setup, idx, pipeline, uniforms, textures, config, shadow_z,
                  y_offset=0, strip_mask=None, planes=None, planes_spec=()):
    """Strip-compacted shading: the shade runs on config.strip_len-pixel
    strips, the covered ones compacted to the front.

    Static shapes and no host read, so that a frame can be captured into a
    CUDA graph: the covered strips' ids are compacted (compact_scatter)
    into ceil(n_strips / strip_batch) * strip_batch slots, JAX's batch
    quantum, and the slots past the covered count hold the n_strips fill.
    The JAX module walks the slots batch by batch in a while_loop that
    stops after the covered count.  Here the slots are cut into the chunks
    of shade_chunks (whole batches), and each chunk runs under
    graphs.device_if(count > its first slot): in a replayed graph the
    device skips the chunks past the covered count, as JAX's loop stops.
    Eagerly every chunk runs; a chunk's fill slots shade a clamped strip
    and write to a spare row that is cut off, so a skipped chunk changes
    nothing.  The per-fragment math is elementwise, so the pixels are the
    JAX module's.

    idx may be a row slab of the frame (parallel.sharding): y_offset is
    the slab's first global row, so the pixel coords the shade sees are
    global while the strips and the writeback stay slab-local.

    strip_mask (config.strip_mask): the raster's (H, W/SL) per-strip max
    index, read instead of the full idx plane to find covered strips.
    planes/planes_spec (config.strip_planes): the raster's (P, H, W)
    varying planes, whose strips replace the attribute gather and
    compute_varyings (the kernel's interpolation is expression-identical).
    The writeback is one packed RGB word per pixel (config.strip_pack_words)
    or the u8 triples.  Where the pipeline's spec has a fused_body that
    applies (darboux and shadow on CUDA tensors with their packed planes),
    each chunk body is that one kernel launch, equal to the torch body; it
    reads the setup columns, not the varying planes.  Returns the (H, W, 3)
    u8 frame, uncovered pixels black.
    """
    spec = PIPELINES[pipeline]
    H, W = idx.shape
    HW = H * W
    SL = config.strip_len
    n_strips = -(-HW // SL)
    pad = n_strips * SL - HW
    dev = idx.device

    flat = idx.reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), -1)])
    strips = flat.reshape(n_strips, SL)
    if strip_mask is not None:
        cov = strip_mask.reshape(-1) >= 0
    else:
        cov = (strips >= 0).any(dim=1)
    count = cov.sum(dtype=torch.int32)
    slots = -(-n_strips // config.strip_batch) * config.strip_batch
    ids = compact_scatter(
        cov, torch.arange(n_strips, dtype=torch.int64, device=dev), slots, n_strips
    )
    lane = torch.arange(SL, device=dev)
    if planes is not None:
        vflat = planes.reshape(planes.shape[0], -1)
        if pad:
            vflat = torch.nn.functional.pad(vflat, (0, pad))
        vstrips = vflat.reshape(-1, n_strips, SL)
    # Row n_strips is the spare the fill slots write to.
    if config.strip_pack_words:
        acc = torch.zeros((n_strips + 1, SL), dtype=torch.int32, device=dev)
    else:
        acc = torch.zeros((n_strips + 1, SL, 3), dtype=torch.uint8, device=dev)

    kernel_body = spec.fused_body(textures, dev) if spec.fused_body is not None else None

    def chunk(cids):
        if kernel_body is not None:
            kernel_body(setup, strips, cids, acc, uniforms, width=W, pixels=HW, y_offset=y_offset, config=config,
                        shadow=shadow_z)
            return
        safe = cids.clamp(max=n_strips - 1)
        sidx = strips[safe]  # (chunk, SL) winning-triangle ids
        base = (safe[:, None] * SL + lane[None, :]).clamp(max=HW - 1)
        px = base % W
        py = base // W + y_offset
        if planes is None:
            frag = _gather_fragments(setup, sidx, _GATHER_KEYS[pipeline], (px, py))
            varys = compute_varyings(frag, VARYING_SPECS[pipeline])
        else:
            varys = _unpack_planes(planes_spec, vstrips[:, safe])
        varys["x"] = px
        varys["y"] = py
        if spec.two_pass:
            varys["shadow_buffer"] = shadow_z
        colors = spec.shade(varys, uniforms, textures, config)  # (chunk, SL, 3) u8
        covered = sidx >= 0
        if config.strip_pack_words:
            c32 = colors.to(torch.int32)
            word = c32[..., 0] | (c32[..., 1] << 8) | (c32[..., 2] << 16)
            acc[cids] = torch.where(covered, word, 0)
        else:
            acc[cids] = torch.where(covered[..., None], colors, 0).to(torch.uint8)

    bounds = shade_chunks(slots, config.strip_batch)
    for start, end in bounds:
        graphs.device_if(count > start, functools.partial(chunk, ids[start:end]))
    timing.shade_count(count, [start for start, _ in bounds])
    if not config.strip_pack_words:
        return acc[:n_strips].reshape(-1, 3)[:HW].reshape(H, W, 3)
    w = acc[:n_strips].reshape(-1)[:HW].reshape(H, W)
    return torch.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF], dim=-1).to(torch.uint8)


def _pk_needed(textures, pipeline, tile=0):
    """True when the pipeline's packed plane is absent or stored in another
    layout than `tile` requests."""
    names = shaders.PIPELINE_MAPS[pipeline]
    if not names:
        return False
    dims = {tuple(textures[n].shape[:2]) for n in names}
    if "normal_map_tangent" in names:
        dims.add(tuple(textures["normal_map"].shape[:2]))
    if len(dims) == 1:
        h, w = next(iter(dims))
        tile = shaders._effective_tile(tile, h, w)
    return shaders._pk_key(names, tile) not in textures


def prepack_textures(textures, pipeline, tile=0):
    """Pack the pipeline's texture plane once (e.g. at Scene construction);
    `tile` must match the render config's tex_tile."""
    return shaders.pack_textures(textures, shaders.PIPELINE_MAPS[pipeline], tile=tile)


def _with_packed_plane(textures, pipeline, config):
    """The textures with the pipeline's packed plane in config's layout
    (packed here unless a prepack already holds it)."""
    if _pk_needed(textures, pipeline, config.tex_tile):
        return prepack_textures(textures, pipeline, tile=config.tex_tile)
    return textures


def _uniforms(spec, config, light_direction, look_from, look_at, up):
    """(light-pass uniforms or None, camera-pass uniforms) of a pipeline:
    the shadow pass 1 and 2 prepares of a two-pass pipeline (pass 2 also
    carries the light's shadow_matrix), default_prepare otherwise."""
    if not spec.two_pass:
        return None, ml.default_prepare(config, light_direction, look_from, look_at, up)
    u1 = ml.shadow_pass_1_prepare(config, light_direction, look_at, up)
    uniforms = ml.shadow_pass_2_prepare(config, light_direction, look_from, look_at, up)
    uniforms["shadow_matrix"] = u1["shadow_matrix"]
    return u1, uniforms


def _shade_dense_path(setup, idx, pipeline, y_offset=0):
    """Full-screen fragments by the attribute gather and compute_varyings:
    the shade's input on the dense backend (JAX _shade_jnp_path)."""
    H, W = idx.shape
    px, py = _pixel_coords(H, W, idx.device, y_offset)
    frag = _gather_fragments(setup, idx, _GATHER_KEYS[pipeline], (px, py))
    varys = compute_varyings(frag, VARYING_SPECS[pipeline])
    varys["x"], varys["y"] = px, py
    return varys


def _assemble_shade(setup, idx, pipeline, uniforms, textures, config, shadow_z,
                    compact, kspec, varys=None, strips=None, y_offset=0):
    """Texture pack, shadow relayout and shade of a rasterized frame, or of
    the row slab whose first global row is y_offset: the strip-compacted
    shade, or the full-screen shade of the kernel's varying planes (or of
    the dense backend's gathered fragments).  shadow_z is the whole
    row-major shadow map (ignored by one-pass pipelines).  Returns the
    (rows, W, 3) u8 frame, uncovered pixels black."""
    spec = PIPELINES[pipeline]
    # The shade reads the shadow map through its own (possibly
    # tile-swizzled) copy; callers see row-major.
    shadow_shade = _shadow_for_shade(shadow_z, spec, config)
    textures = _with_packed_plane(textures, pipeline, config)
    if compact:
        frame = _shade_strips(
            setup, idx, pipeline, uniforms, textures, config, shadow_shade, y_offset=y_offset,
            strip_mask=strips, planes=varys, planes_spec=kspec,
        )
    else:
        if varys is None:
            frag = _shade_dense_path(setup, idx, pipeline, y_offset)
        else:
            frag = _fragments_from_planes(kspec, varys, idx.shape[0], idx.shape[1], y_offset)
            _add_const_gather(frag, kspec, VARYING_SPECS[pipeline], setup, idx)
        if spec.two_pass:
            frag["shadow_buffer"] = shadow_shade
        colors = spec.shade(frag, uniforms, textures, config)
        frame = torch.where((idx >= 0)[..., None], colors, 0).to(torch.uint8)
    timing.frame_pixels(idx)
    return frame


def _light_pass(setup1, config, backend, rows=None, y0=0):
    """The light pass (depth only) of rows [y0, y0 + rows) of the frame (all
    of it by default): the light stage of render_frame and of each row
    shard of parallel.sharding.  Returns (shadow z, overflow), the overflow
    including setup1's coord_overflow."""
    z, _, _, _, ovf = _rasterize(setup1, config, backend, emit_idx=False, rows=rows, y0=y0)
    return z, ovf | setup1["coord_overflow"]


def _camera_pass_and_shade(setup, uniforms, pipeline, textures, config, backend, shadow_z,
                           needs_z, rows=None, y0=0):
    """The camera pass and the shade of rows [y0, y0 + rows) of the frame
    (all of it by default), given the whole shadow map (None for one-pass
    pipelines): the camera stage of render_frame and of each row shard of
    parallel.sharding.  The kernel raster emits the index (and z when
    wanted), plus the strip plane and/or the varying planes the shade
    reads.  Returns (frame, z, overflow)."""
    compact = backend == "kernel" and config.compact_shade
    if compact:
        kspec = _planes_spec(pipeline, textures, config) or ()
    elif backend == "kernel":
        kspec = kernel_varying_spec(pipeline, textures, tile=config.tex_tile)
    else:  # the dense raster takes no plane spec; the shade gathers
        kspec = ()
    z, idx, varys, strips, ovf = _rasterize(
        setup, config, backend, spec=kspec, emit_z=needs_z,
        emit_strips=_strip_mask_len(config) if compact else 0, rows=rows, y0=y0,
    )
    frame = _assemble_shade(setup, idx, pipeline, uniforms, textures, config, shadow_z,
                            compact, kspec, varys=varys, strips=strips, y_offset=y0)
    return frame, z, ovf | setup["coord_overflow"]


def render_frame(geom, textures, light_direction, look_from, look_at, up, *,
                 pipeline, config, needs_z=True, backend="kernel"):
    """Render one frame.  Returns dict(frame u8 (H,W,3), z f32 (H,W) or None
    unless needs_z, shadow f32 (H,W), overflow 0-d bool).

    Row 0 is raster y=0 (the reference's frame_buffer before the
    presentation flip).  Inputs are tensors on one device; the frame is
    computed there.  backend: "kernel" (the binned tile raster, default) or
    "dense" (BACKENDS; the full-screen gather shade, as the JAX package's
    "jnp": config.compact_shade and the raster knobs do not apply).
    """
    config = config.resolve(pipeline)
    _check_config(config, pipeline, backend)
    spec = PIPELINES[pipeline]
    H, W = config.height, config.width
    dev = light_direction.device

    if geom["pos_idx"].shape[0] == 0:  # empty scene: clear buffers only
        return {
            "frame": torch.zeros((H, W, 3), dtype=torch.uint8, device=dev),
            "z": torch.full((H, W), ml.F32_MIN, dtype=torch.float32, device=dev) if needs_z else None,
            "shadow": torch.full((H, W), ml.F32_MIN, dtype=torch.float32, device=dev),
            "overflow": torch.zeros((), dtype=torch.bool, device=dev),
        }

    compact = backend == "kernel" and config.compact_shade
    pspec = _planes_spec(pipeline, textures, config) if compact else None
    u1, uniforms = _uniforms(spec, config, light_direction, look_from, look_at, up)
    if spec.two_pass:
        setup1 = triangle_setup(geom, u1, config, matrix_key="shadow_matrix", cull=False)
    setup = triangle_setup(geom, uniforms, config, needs=spec.needs)
    timing.mark("vertex")

    if _use_fused_raster(spec, config, backend, setup, pspec, needs_z):
        shadow_z, idx, ovf1, ovf2 = _fused_raster(setup1, setup, config)
        frame = _assemble_shade(setup, idx, pipeline, uniforms, textures, config, shadow_z,
                                compact, ())
        z = None
    else:
        if spec.two_pass:
            shadow_z, ovf1 = _light_pass(setup1, config, backend)
        else:
            shadow_z = torch.full((H, W), ml.F32_MIN, dtype=torch.float32, device=dev)
            ovf1 = torch.zeros((), dtype=torch.bool, device=dev)
        frame, z, ovf2 = _camera_pass_and_shade(setup, uniforms, pipeline, textures, config,
                                                backend, shadow_z, needs_z)
    # overflow: a binning coverage cap was hit, or triangles beyond the
    # int32 exactness envelope were dropped.
    overflow = ovf1 | ovf2
    timing.mark("shade")
    return {"frame": frame, "z": z, "shadow": shadow_z, "overflow": overflow}


def _add_const_gather(frag, kspec, vspec, setup, idx):
    """The per-triangle constants kernel_varying_spec dropped (darboux's
    rows and uv deltas), fetched at each pixel's winner with one gather of
    a packed (T, total) table instead of as broadcast planes."""
    dropped = [e for e in vspec if e[2] == "const" and e not in kspec]
    if not dropped:
        return
    key_of = shaders._CONST_SOURCES
    table = torch.cat([setup[key_of[n]] for (n, _, _) in dropped], dim=1)
    g = table[idx.clamp(min=0).long()]  # (H, W, total)
    pos = 0
    for name, comps, _ in dropped:
        frag[name] = g[..., pos:pos + comps]
        pos += comps


# Captured frames and burst frames, keyed as JAX keys its jit caches.
_GRAPHS = GraphCache()


def _graph_key(kind, pipeline, config, backend, gen, geom, textures, inputs):
    """The key of a captured graph: what JAX's jit keys on (pipeline, the
    resolved config, backend, the registration generation), plus the
    device, shapes, strides and dtypes of the inputs, and the addresses of
    the geometry and texture tensors the graph reads in place; with the
    tracer on, "traced" at its end (a graph with the stage marks of its own,
    so that one captured with the tracer off is never altered)."""
    key = (kind, pipeline, config, backend, gen, signature(geom), signature(textures),
           signature(inputs, addresses=False))
    return key + ("traced",) if timing.tracing() else key


def _captures(device):
    """Frames and bursts on `device` are captured and replayed as CUDA
    graphs: on CUDA devices; on the CPU they run eagerly."""
    return device.type == "cuda"


@functools.cache
def _copy_stream(device):
    """The stream on CUDA `device` that copies burst frames to host memory:
    its D2H runs on a copy engine while the render stream renders on."""
    return torch.cuda.Stream(device=device)


def _capture(kind, fn, inputs, pipeline, config, backend, gen, geom, textures):
    """The cached graph of fn(*inputs) on the geometry and textures, its
    stage marks recorded when the tracer is on."""
    key = _graph_key(kind, pipeline, config, backend, gen, geom, textures, inputs)
    hold = tuple(geom.values()) + tuple(textures.values())
    return _GRAPHS.get(key, lambda: CapturedGraph(
        fn, inputs, f"the {kind} of pipeline {pipeline!r}", hold=hold, marked=True))


def render_frame_jit(geom, textures, light_direction, look_from, look_at, up, *, pipeline,
                     config, backend="kernel", gen=0):
    """render_frame (with the camera z) as one replayed CUDA graph: the
    counterpart of JAX's render_frame_jit.

    On CUDA tensors the frame is captured at its first call for a key
    (_graph_key; `gen` is the pipeline's registration generation, so a
    re-registered pipeline gets a graph of its own) and replayed after:
    the four view vectors are copied into the graph's inputs, and the
    outputs are cloned, so a later replay cannot overwrite what the caller
    holds (span frame.clone).  A capture that fails raises, naming the
    pipeline.  On CPU tensors render_frame runs eagerly: the same code."""
    views = (light_direction, look_from, look_at, up)
    config = config.resolve(pipeline)
    if not _captures(light_direction.device):
        return render_frame(geom, textures, *views, pipeline=pipeline, config=config,
                            backend=backend)

    def fn(*v):
        timing.mark("start")
        return render_frame(geom, textures, *v, pipeline=pipeline, config=config, backend=backend)

    graph = _capture("frame", fn, views, pipeline, config, backend, gen, geom, textures)
    with graph.lock:
        out = graph(*views)
        with timing.span("frame.clone"):
            return {k: None if v is None else v.clone() for k, v in out.items()}


def make_frame_fn(pipeline, config, backend="kernel"):
    """fn(geom, textures, light_direction, look_from, look_at, up) -> dict:
    render_frame_jit of the pipeline's resolved config at its current
    registration generation."""
    return functools.partial(render_frame_jit, pipeline=pipeline, config=config.resolve(pipeline),
                             backend=backend, gen=registry_generation(pipeline))


def frame_checksum(frame):
    """The sum of a frame's bytes mod 2^32 (JAX render_burst's wrapping
    uint32 sum), as a 0-d int64 tensor."""
    return frame.sum(dtype=torch.int64) & 0xFFFFFFFF


def _burst_frame(geom, textures, angles, *, pipeline, config, backend):
    """One frame of a burst at angles = (camera angle, light angle), a (2,)
    f32 tensor (src/app.rs:200-207), the camera z not emitted.  Returns its
    (checksum, overflow) as a (2,) int64 tensor, and the frame."""
    dev = angles.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    look_from = torch.stack([torch.sin(angles[0]), zero, torch.cos(angles[0])])
    light = torch.stack([torch.sin(angles[1]), zero, torch.cos(angles[1])])
    out = render_frame(
        geom, textures, light, look_from, ml.const((0.0, 0.0, 0.0), dev),
        ml.const((0.0, 1.0, 0.0), dev), pipeline=pipeline, config=config, needs_z=False,
        backend=backend,
    )
    return torch.stack([frame_checksum(out["frame"]), out["overflow"].to(torch.int64)]), out["frame"]


def _render_burst_eager(geom, textures, camera_angles, light_angles, *, pipeline, config,
                        keep_frames=False, backend="kernel", host_frames=None):
    """render_burst's frames rendered eagerly one after another (its path
    on CPU tensors; on CUDA tensors the eager side of the graph checks)."""
    angles = torch.stack([camera_angles, light_angles], dim=1)
    outs = [_burst_frame(geom, textures, a, pipeline=pipeline, config=config, backend=backend)
            for a in angles]
    stats = torch.stack([s for s, _ in outs])
    result = {"checksums": stats[:, 0], "overflow": stats[:, 1].bool()}
    if host_frames is not None:
        result["frames"] = host_frames.copy_(torch.stack([f for _, f in outs]))
    elif keep_frames:
        result["frames"] = torch.stack([f for _, f in outs])
    return result


def render_burst(geom, textures, camera_angles, light_angles, *, pipeline,
                 config, keep_frames=False, backend="kernel", gen=None, host_frames=None):
    """Render an animation burst: one frame per (camera, light) orbit angle
    (src/app.rs:200-207), camera z-buffer not emitted.

    camera_angles/light_angles: (N,) f32 tensors on the render device.
    Returns dict with per-frame checksums (frame_checksum) and (N,)
    overflow flags and, if keep_frames, the stacked (N, H, W, 3) frames.

    On CUDA tensors one frame is captured as a CUDA graph (keyed as
    render_frame_jit's; `gen` defaults to the pipeline's current
    registration generation) and replayed N times, with no host sync:
    per frame the host copies the two angles in, launches the graph and
    copies the checksum and overflow (and the frame) out, all
    asynchronously.  On CPU tensors the frames render eagerly.

    `host_frames` (Scene.render_sequence's, not a user knob): an (N, H, W,
    3) u8 host tensor, pinned, that receives the frames and is returned as
    "frames".  On CUDA each frame is copied there on the device's copy
    stream while the next frame renders, and "copied" is an event that
    completes with the last copy; the counter sequence.overlapped counts
    the frames whose copy was issued before the burst's last replay."""
    config = config.resolve(pipeline)
    if not _captures(camera_angles.device):
        return _render_burst_eager(geom, textures, camera_angles, light_angles, pipeline=pipeline,
                                   config=config, keep_frames=keep_frames, backend=backend,
                                   host_frames=host_frames)
    gen = registry_generation(pipeline) if gen is None else gen
    angles = torch.stack([camera_angles, light_angles], dim=1)
    n, dev = angles.shape[0], angles.device

    def fn(a):
        timing.mark("start")
        out = _burst_frame(geom, textures, a, pipeline=pipeline, config=config, backend=backend)
        timing.mark("shade")  # after the checksum: the frame's end
        return out

    graph = _capture("burst frame", fn, (angles[0],), pipeline, config, backend, gen, geom, textures)
    stats = torch.empty((n, 2), dtype=torch.int64, device=dev)
    frames = (torch.empty((n, config.height, config.width, 3), dtype=torch.uint8, device=dev)
              if keep_frames or host_frames is not None else None)
    copies = _copy_stream(dev) if host_frames is not None else None
    with graph.lock:
        for i in range(n):
            stat, frame = graph(angles[i])
            stats[i].copy_(stat, non_blocking=True)
            if frames is not None:
                # The graph's output is overwritten by the next replay: the
                # host copy reads this buffer instead.
                frames[i].copy_(frame, non_blocking=True)
            if copies is not None:
                copies.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(copies):
                    host_frames[i].copy_(frames[i], non_blocking=True)
    result = {"checksums": stats[:, 0], "overflow": stats[:, 1].bool()}
    if copies is not None:
        frames.record_stream(copies)  # freed here, read there until copied
        result["frames"], result["copied"] = host_frames, copies.record_event()
        timing.count("sequence.overlapped", max(n - 1, 0))  # every copy but the last
    elif keep_frames:
        result["frames"] = frames
    return result


def make_burst_fn(pipeline, config, keep_frames=False, backend="kernel"):
    """fn(geom, textures, camera_angles, light_angles) -> render_burst dict,
    at the pipeline's resolved config and current registration generation."""
    return functools.partial(
        render_burst, pipeline=pipeline, config=config.resolve(pipeline),
        keep_frames=keep_frames, backend=backend, gen=registry_generation(pipeline),
    )
