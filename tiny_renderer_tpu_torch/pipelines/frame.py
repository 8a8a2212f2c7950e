"""The frame path: uniforms -> vertex stage -> binning -> raster -> shade
(``tiny_renderer_tpu.pipelines.frame``).

Ported so far: the two-pass ``shadow`` pipeline on the kernel path, under
every raster knob of the JAX package (each bit-identical to the default
frame):

* default: the raster runs twice (the light pass depth-only, the camera
  pass index-only, or depth + index when the caller wants z), then the
  strip-compacted shade re-derives the varyings of the covered strips by an
  attribute gather;
* ``fuse_passes``: both rasters in one launch (K2), where
  ``_use_fused_raster`` allows it;
* ``strip_mask``: the camera pass also emits the per-strip coverage plane;
* ``strip_planes``: the camera pass also interpolates the varying planes
  (K1 phase 2) that the strip shade then reads instead of gathering;
* ``compact_shade=False``: full-screen varying planes and a full-screen
  shade;
* ``idx_int16``, ``csr_indirect=False``, ``strip_pack_words=False``,
  ``tex_tile``, ``shadow_tile``, ``strip_len``: layouts.

Everything runs eagerly on the device of the input tensors: CUDA tensors
launch the CUDA raster kernels, CPU tensors run their plain torch twins.
``row_bands > 1`` (the TPU's on-chip memory banding) raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops import mathlib as ml
from ..ops import raster_cuda
from ..ops.binning import bin_triangles, compact_scatter
from ..ops.vertex import triangle_setup
from . import shaders
from .shaders import VARYING_SPECS, compute_varyings, kernel_varying_spec


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Declarative description of one pipeline (reference shader.rs:100-109)."""

    name: str
    needs: tuple  # vertex-stage varyings for the shading pass
    shade: object  # shading function for the final pass
    two_pass: bool = False  # shadow-buffer depth pre-pass (shader.rs:668-963)


PIPELINES = {
    "shadow": PipelineSpec(
        "shadow", ("vertex_intensity",), shaders.shade_shadow, two_pass=True
    ),
}

# Vertex-attribute keys the shade gathers per fragment for compute_varyings.
_GATHER_KEYS = {"shadow": ("uv", "intensity", "zv")}


def _check_config(config):
    """Refuse the one setting the port does not implement."""
    if config.row_bands > 1:
        raise NotImplementedError(
            "not ported to the torch frame path: row_bands (TPU on-chip memory banding)"
        )


def _rasterize(setup, config, spec=(), emit_idx=True, emit_z=True, emit_strips=0):
    """Bin + raster one pass.  Returns (z, idx, varys, strips, overflowed)
    cropped to (height, width) (strips to (height, width / emit_strips));
    absent outputs are None."""
    H, W = config.height, config.width
    records, tris, starts, overflowed = bin_triangles(setup, config, spec)
    z, idx, varys, strips = raster_cuda.rasterize(
        records, tris, starts,
        tile_h=config.tile_h, tile_w=config.tile_w,
        tiles_y=config.tiles_y, tiles_x=config.tiles_x,
        spec=spec, emit_idx=emit_idx, emit_z=emit_z, emit_strips=emit_strips,
        idx_dtype=_idx_dtype(setup, config),
    )
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


def _use_fused_raster(spec, config, setup, pspec, needs_z):
    """The gate of the fused two-pass kernel (the JAX predicate): the
    pipeline is two-pass, the shade compact, fuse_passes set, the camera z
    not wanted, the index int32, and no planes spec (K2 has neither a
    varying phase nor an int16 target).  The JAX gate's one-band condition
    always holds here: the port has no row bands."""
    return (
        spec.two_pass
        and config.compact_shade
        and config.fuse_passes
        and not needs_z
        and _idx_dtype(setup, config) == "int32"
        and pspec is None
    )


def _fused_raster(setup1, setup, config):
    """Bin both passes (no varying lanes) and run the fused kernel.  Returns
    (shadow_z, idx, ovf1, ovf2) cropped to (height, width), each pass's
    coord_overflow folded in."""
    H, W = config.height, config.width
    r1, t1, s1, ovfb1 = bin_triangles(setup1, config)
    r2, t2, s2, ovfb2 = bin_triangles(setup, config)
    shadow_z, idx = raster_cuda.rasterize_fused(
        r1, t1, s1, r2, t2, s2,
        tile_h=config.tile_h, tile_w=config.tile_w,
        tiles_y=config.tiles_y, tiles_x=config.tiles_x,
    )
    return (
        shadow_z[:H, :W], idx[:H, :W],
        ovfb1 | setup1["coord_overflow"], ovfb2 | setup["coord_overflow"],
    )


def _pixel_coords(H, W, device):
    py, px = torch.meshgrid(
        torch.arange(H, dtype=torch.int32, device=device),
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


def _fragments_from_planes(spec, varys, H, W):
    """Fragment dict from the kernel's interpolated varying planes."""
    frag = _unpack_planes(spec, varys)
    frag["x"], frag["y"] = _pixel_coords(H, W, varys.device)
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


def _shade_strips(setup, idx, pipeline, uniforms, textures, config, shadow_z,
                  strip_mask=None, planes=None, planes_spec=()):
    """Strip-compacted shading: the shade runs only on covered
    config.strip_len-pixel strips.

    The JAX module walks the covered strips in fixed-size batches inside a
    while_loop (static shapes for the TPU).  Here every covered strip is
    shaded in one batch; the per-fragment math is elementwise, so the
    pixels are identical.  Sizing that batch costs one host sync per frame
    (the covered-strip count).

    strip_mask (config.strip_mask): the raster's (H, W/SL) per-strip max
    index, read instead of the full idx plane to find covered strips.
    planes/planes_spec (config.strip_planes): the raster's (P, H, W)
    varying planes, whose covered strips replace the attribute gather and
    compute_varyings (the kernel's interpolation is expression-identical).
    The writeback is one packed RGB word per pixel (config.strip_pack_words)
    or the u8 triples.  Returns the (H, W, 3) u8 frame, uncovered pixels
    black.
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
    count = int(cov.sum())  # the per-frame host sync
    ids = compact_scatter(
        cov, torch.arange(n_strips, dtype=torch.int64, device=dev), n_strips, n_strips
    )[:count]

    sidx = strips[ids]  # (count, SL) winning-triangle ids
    lane = torch.arange(SL, device=dev)
    base = (ids[:, None] * SL + lane[None, :]).clamp(max=HW - 1)
    px = base % W
    py = base // W
    if planes is None:
        frag = _gather_fragments(setup, sidx, _GATHER_KEYS[pipeline], (px, py))
        varys = compute_varyings(frag, VARYING_SPECS[pipeline])
    else:
        vflat = planes.reshape(planes.shape[0], -1)
        if pad:
            vflat = torch.nn.functional.pad(vflat, (0, pad))
        varys = _unpack_planes(planes_spec, vflat.reshape(-1, n_strips, SL)[:, ids])
    varys["x"] = px
    varys["y"] = py
    if spec.two_pass:
        varys["shadow_buffer"] = shadow_z
    colors = spec.shade(varys, uniforms, textures, config)  # (count, SL, 3) u8
    covered = sidx >= 0
    if not config.strip_pack_words:
        acc = torch.zeros((n_strips, SL, 3), dtype=torch.uint8, device=dev)
        acc[ids] = torch.where(covered[..., None], colors, 0).to(torch.uint8)
        return acc.reshape(-1, 3)[:HW].reshape(H, W, 3)
    c32 = colors.to(torch.int32)
    word = c32[..., 0] | (c32[..., 1] << 8) | (c32[..., 2] << 16)
    acc = torch.zeros((n_strips, SL), dtype=torch.int32, device=dev)
    acc[ids] = torch.where(covered, word, 0)
    w = acc.reshape(-1)[:HW].reshape(H, W)
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


def render_frame(geom, textures, light_direction, look_from, look_at, up, *,
                 pipeline, config, needs_z=True):
    """Render one frame.  Returns dict(frame u8 (H,W,3), z f32 (H,W) or None
    unless needs_z, shadow f32 (H,W), overflow 0-d bool).

    Row 0 is raster y=0 (the reference's frame_buffer before the
    presentation flip).  Inputs are tensors on one device; the frame is
    computed there.
    """
    config = config.resolve(pipeline)
    _check_config(config)
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

    compact = config.compact_shade
    pspec = _planes_spec(pipeline, textures, config) if compact else None
    u1 = ml.shadow_pass_1_prepare(config, light_direction, look_at, up)
    setup1 = triangle_setup(geom, u1, config, matrix_key="shadow_matrix", cull=False)
    uniforms = ml.shadow_pass_2_prepare(config, light_direction, look_from, look_at, up)
    uniforms["shadow_matrix"] = u1["shadow_matrix"]
    setup = triangle_setup(geom, uniforms, config, needs=spec.needs)

    if _use_fused_raster(spec, config, setup, pspec, needs_z):
        shadow_z, idx, ovf1, ovf2 = _fused_raster(setup1, setup, config)
        z, varys, strips, kspec = None, None, None, ()
    else:
        # Light pass: depth only.  Camera pass: index (and z when wanted),
        # plus the strip plane and/or varying planes the shade reads.
        shadow_z, _, _, _, ovf1 = _rasterize(setup1, config, emit_idx=False)
        ovf1 = ovf1 | setup1["coord_overflow"]
        if compact:
            kspec = pspec or ()
        else:
            kspec = kernel_varying_spec(pipeline, textures, tile=config.tex_tile)
        z, idx, varys, strips, ovf2 = _rasterize(
            setup, config, spec=kspec, emit_z=needs_z,
            emit_strips=_strip_mask_len(config) if compact else 0,
        )
        ovf2 = ovf2 | setup["coord_overflow"]

    # The shade reads the shadow map through its own (possibly
    # tile-swizzled) copy; callers see row-major.
    shadow_shade = _shadow_for_shade(shadow_z, spec, config)
    if _pk_needed(textures, pipeline, config.tex_tile):
        textures = prepack_textures(textures, pipeline, tile=config.tex_tile)
    if compact:
        frame = _shade_strips(
            setup, idx, pipeline, uniforms, textures, config, shadow_shade,
            strip_mask=strips, planes=varys, planes_spec=kspec,
        )
    else:
        # Full-screen shade of the kernel's varying planes.  (The JAX
        # module's per-triangle const gather serves darboux only.)
        frag = _fragments_from_planes(kspec, varys, H, W)
        if spec.two_pass:
            frag["shadow_buffer"] = shadow_shade
        colors = spec.shade(frag, uniforms, textures, config)
        frame = torch.where((idx >= 0)[..., None], colors, 0).to(torch.uint8)
    # overflow: a binning coverage cap was hit, or triangles beyond the
    # int32 exactness envelope were dropped.
    return {"frame": frame, "z": z, "shadow": shadow_z, "overflow": ovf1 | ovf2}


def make_frame_fn(pipeline, config):
    """fn(geom, textures, light_direction, look_from, look_at, up) -> dict."""
    return functools.partial(render_frame, pipeline=pipeline, config=config.resolve(pipeline))


def render_burst(geom, textures, camera_angles, light_angles, *, pipeline,
                 config, keep_frames=False):
    """Render an animation burst: one frame per (camera, light) orbit angle
    (src/app.rs:200-207), camera z-buffer not emitted.

    camera_angles/light_angles: (N,) f32 tensors on the render device.
    Returns dict with per-frame int64 checksums and (N,) overflow flags
    and, if keep_frames, the stacked (N, H, W, 3) frames.
    """
    dev = camera_angles.device
    look_at = torch.zeros(3, dtype=torch.float32, device=dev)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sums, ovfs, frames = [], [], []
    for ca, la in zip(camera_angles, light_angles):
        look_from = torch.stack([torch.sin(ca), zero, torch.cos(ca)])
        light = torch.stack([torch.sin(la), zero, torch.cos(la)])
        out = render_frame(
            geom, textures, light, look_from, look_at, up,
            pipeline=pipeline, config=config, needs_z=False,
        )
        sums.append(out["frame"].sum(dtype=torch.int64))
        ovfs.append(out["overflow"])
        if keep_frames:
            frames.append(out["frame"])
    result = {"checksums": torch.stack(sums), "overflow": torch.stack(ovfs)}
    if keep_frames:
        result["frames"] = torch.stack(frames)
    return result


def make_burst_fn(pipeline, config, keep_frames=False):
    """fn(geom, textures, camera_angles, light_angles) -> render_burst dict."""
    return functools.partial(
        render_burst, pipeline=pipeline, config=config.resolve(pipeline),
        keep_frames=keep_frames,
    )
