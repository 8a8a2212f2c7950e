"""The frame path: uniforms -> vertex stage -> binning -> raster -> strip shade
(``tiny_renderer_tpu.pipelines.frame``).

Ported so far: the two-pass ``shadow`` pipeline on the kernel path with the
strip-compacted shade — the path ``__graft_entry__.entry()`` and the bench
headline take.  A frame launches the raster twice (the light pass
depth-only, the camera pass index-only, or depth + index when the caller
wants z), then shades the covered strips.  Everything runs eagerly on the
device of the input tensors: CUDA tensors launch the CUDA raster kernel,
CPU tensors run its plain torch twin.

Config settings whose TPU kernels or layouts are not ported
(``fuse_passes``, ``idx_int16``, ``strip_mask``, ``strip_planes``,
``compact_shade=False``, ``row_bands``) raise ``NotImplementedError``.
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
from .shaders import VARYING_SPECS, compute_varyings


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

# Texture maps each pipeline samples (word-packed together).
_PIPELINE_MAPS = {"shadow": ("texture",)}

# Vertex-attribute keys the shade gathers per fragment for compute_varyings.
_GATHER_KEYS = {"shadow": ("uv", "intensity", "zv")}


def _check_config(config):
    """Refuse settings whose TPU kernels or layouts the port lacks."""
    unported = {
        "fuse_passes": config.fuse_passes,  # K2, the fused two-pass kernel
        "idx_int16": config.idx_int16,  # K1's int16 index target
        "strip_mask": config.strip_mask,  # K1's emit_strips plane
        "strip_planes": config.strip_planes,  # K1 phase 2 varying planes
        "compact_shade=False": not config.compact_shade,  # K1 phase 2 full-screen shade
        "row_bands": config.row_bands > 1,  # TPU on-chip memory banding
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported to the torch frame path: {', '.join(bad)}")


def _rasterize(setup, config, emit_idx=True, emit_z=True):
    """Bin + raster one pass.  Returns (z, idx, overflowed) cropped to
    (height, width); z/idx are None when not emitted."""
    H, W = config.height, config.width
    records, tris, starts, overflowed = bin_triangles(setup, config)
    z, idx = raster_cuda.rasterize(
        records, tris, starts,
        tile_h=config.tile_h, tile_w=config.tile_w,
        tiles_y=config.tiles_y, tiles_x=config.tiles_x,
        emit_idx=emit_idx, emit_z=emit_z,
    )
    return (
        z[:H, :W] if z is not None else None,
        idx[:H, :W] if idx is not None else None,
        overflowed,
    )


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


def _shade_strips(setup, idx, pipeline, uniforms, textures, config, shadow_z):
    """Strip-compacted shading: the gather path runs only on covered
    config.strip_len-pixel strips, and writes back one packed RGB word per
    pixel.

    The JAX module walks the covered strips in fixed-size batches inside a
    while_loop (static shapes for the TPU).  Here every covered strip is
    shaded in one batch; the per-fragment math is elementwise, so the
    pixels are identical.  Sizing that batch costs one host sync per frame
    (the covered-strip count).  Returns the (H, W, 3) u8 frame, uncovered
    pixels black.
    """
    spec = PIPELINES[pipeline]
    H, W = idx.shape
    HW = H * W
    SL = config.strip_len
    n_strips = -(-HW // SL)
    dev = idx.device

    flat = idx.reshape(-1)
    if n_strips * SL != HW:
        flat = torch.cat([flat, flat.new_full((n_strips * SL - HW,), -1)])
    strips = flat.reshape(n_strips, SL)
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
    frag = _gather_fragments(setup, sidx, _GATHER_KEYS[pipeline], (px, py))
    varys = compute_varyings(frag, VARYING_SPECS[pipeline])
    varys["x"] = px
    varys["y"] = py
    if spec.two_pass:
        varys["shadow_buffer"] = shadow_z
    colors = spec.shade(varys, uniforms, textures, config).to(torch.int32)  # (count, SL, 3)
    word = colors[..., 0] | (colors[..., 1] << 8) | (colors[..., 2] << 16)
    acc = torch.zeros((n_strips, SL), dtype=torch.int32, device=dev)
    acc[ids] = torch.where(sidx >= 0, word, 0)
    w = acc.reshape(-1)[:HW].reshape(H, W)
    return torch.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF], dim=-1).to(torch.uint8)


def _pk_needed(textures, pipeline, tile=0):
    """True when the pipeline's packed plane is absent or stored in another
    layout than `tile` requests."""
    names = _PIPELINE_MAPS[pipeline]
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
    return shaders.pack_textures(textures, _PIPELINE_MAPS[pipeline], tile=tile)


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

    u1 = ml.shadow_pass_1_prepare(config, light_direction, look_at, up)
    setup1 = triangle_setup(geom, u1, config, matrix_key="shadow_matrix", cull=False)
    uniforms = ml.shadow_pass_2_prepare(config, light_direction, look_from, look_at, up)
    uniforms["shadow_matrix"] = u1["shadow_matrix"]
    setup = triangle_setup(geom, uniforms, config, needs=spec.needs)

    # Light pass: depth only.  Camera pass: index (and z when wanted).
    shadow_z, _, ovf1 = _rasterize(setup1, config, emit_idx=False)
    ovf1 = ovf1 | setup1["coord_overflow"]
    z, idx, ovf2 = _rasterize(setup, config, emit_z=needs_z)
    ovf2 = ovf2 | setup["coord_overflow"]

    if _pk_needed(textures, pipeline, config.tex_tile):
        textures = prepack_textures(textures, pipeline, tile=config.tex_tile)
    frame = _shade_strips(
        setup, idx, pipeline, uniforms, textures, config,
        _shadow_for_shade(shadow_z, spec, config),
    )
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
