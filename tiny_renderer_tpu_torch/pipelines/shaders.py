"""The seven shader pipelines' fragment stages (``tiny_renderer_tpu.pipelines.shaders``).

Shading is split as in the JAX module: varying interpolation — from
gathered per-fragment triangle attributes (``VARYING_SPECS`` +
``compute_varyings``) or by the raster kernel (``kernel_varying_spec``) —
then a pure ``shade_*`` function over any leading batch shape: flat
(``default``), Gouraud (``phong``), world-space normal map
(``normal_map``), normal map + Phong specular (``specular``), tangent-space
normal map (``darboux``), shadow map (``shadow``) and ambient occlusion
(``occlusion``).

Textures are sampled through the word-packed plane of ``pack_textures``:
each texel's RGB in one int32 word, optionally tile-swizzled
(config.tex_tile), keyed ``_pk:<names>[@tile]`` exactly like the JAX
package, so packed planes cross between the two unchanged.  A map set whose
dimensions differ cannot be packed; it is sampled map by map
(``sample_maps``' fallback).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import mathlib as ml
from ..ops import darboux_cuda, occlusion_cuda
from ..utils import timing
from . import graphs

# Each pipeline's varyings: (name, components, mode) with mode "interp"
# (barycentric interpolation of 3 per-vertex values), "const" (per-triangle
# constant) or "zfrag" (bar . vertex z values, shader.rs:174).
VARYING_SPECS = {
    "default": (("uv", 2, "interp"), ("intensity", 1, "interp")),
    "phong": (("uv", 2, "interp"), ("intensity", 1, "interp")),
    "normal_map": (("uv", 2, "interp"),),
    "specular": (("uv", 2, "interp"),),
    "darboux": (
        ("uv", 2, "interp"),
        ("local_z", 3, "interp"),
        ("row0", 3, "const"),
        ("row1", 3, "const"),
        ("du", 2, "const"),
        ("dv", 2, "const"),
    ),
    "shadow": (("uv", 2, "interp"), ("intensity", 1, "interp"), ("zfrag", 1, "zfrag")),
    "occlusion": (("zfrag", 1, "zfrag"),),
}

# Setup key of each "interp" varying, (T, 3[, comps]) per vertex (the record
# lanes of pack_triangle_records, and the fragment key compute_varyings reads).
_INTERP_SOURCES = {"uv": "uv", "intensity": "intensity", "local_z": "t_norm"}
# Setup key of each "const" varying, (T, comps) per triangle (the record
# lanes of pack_triangle_records, and the fragment key compute_varyings reads).
_CONST_SOURCES = {"row0": "row0n", "row1": "row1n", "du": "du", "dv": "dv"}

# Texture maps each pipeline samples (word-packed together).
PIPELINE_MAPS = {
    "default": ("texture",),
    "phong": ("texture",),
    "normal_map": ("texture", "normal_map"),
    "specular": ("texture", "normal_map", "specular_map"),
    "darboux": ("texture", "normal_map_tangent"),
    "shadow": ("texture",),
    "occlusion": (),
}

BLACK = (0, 0, 0)
WHITE = (255, 255, 255)


def _color(rgb, device):
    return ml.const(rgb, device, torch.uint8)


def num_planes(spec) -> int:
    return sum(comps for (_, comps, _) in spec)


def kernel_varying_spec(pipeline, textures, tile: int = 0):
    """The varying spec the raster kernel emits planes for.

    When the pipeline's maps share dimensions, the interpolated uv (whose
    only consumer is texture sampling) becomes one texel-index plane
    ("texidx:W:H[:tile]", indices into the packed plane's layout for
    config.tex_tile) instead of two uv planes, and darboux's per-triangle
    constants are dropped (the full-screen shade fetches them with one
    small gather, frame._add_const_gather).  Falls back to the reference
    spec when texture dims are mixed.
    """
    spec = VARYING_SPECS[pipeline]
    names = PIPELINE_MAPS.get(pipeline, ())
    if not names:
        return spec
    dims = {tuple(textures[n].shape[:2]) for n in names}
    if "normal_map_tangent" in names:
        dims.add(tuple(textures["normal_map"].shape[:2]))
    if len(dims) != 1:
        return spec
    h, w = next(iter(dims))
    tile = _effective_tile(tile, h, w)
    out = []
    for name, comps, mode in spec:
        if name == "uv":
            m = f"texidx:{w}:{h}:{tile}" if tile else f"texidx:{w}:{h}"
            out.append(("texidx", 1, m))
        elif mode == "const" and pipeline == "darboux":
            continue
        else:
            out.append((name, comps, mode))
    return tuple(out)


def compute_varyings(frag, spec):
    """Varyings from per-fragment vertex attributes and "bar", in nalgebra's
    accumulation order (a0*b0 + a1*b1) + a2*b2."""
    bar = frag["bar"]
    b0, b1, b2 = bar[..., 0], bar[..., 1], bar[..., 2]
    out = {}
    for name, comps, mode in spec:
        if mode == "zfrag":
            zv = frag["zv"]
            out[name] = (zv[..., 0] * b0 + zv[..., 1] * b1) + zv[..., 2] * b2
        elif mode == "interp":
            a = frag[_INTERP_SOURCES.get(name, name)]  # (..., 3v[, comps])
            if a.ndim == bar.ndim:  # scalar varying: (..., 3)
                out[name] = (a[..., 0] * b0 + a[..., 1] * b1) + a[..., 2] * b2
            else:
                out[name] = torch.stack(
                    [(a[..., 0, c] * b0 + a[..., 1, c] * b1) + a[..., 2, c] * b2
                     for c in range(comps)],
                    dim=-1,
                )
        else:  # const
            out[name] = frag[_CONST_SOURCES[name]]
    return out


# ---------------------------------------------------------------------------
# Texture sampling (src/scene/util.rs:34-83)
# ---------------------------------------------------------------------------


def _tex_coords(uv, w, h):
    """(uv * dims) as u32, clamped into range (int64 texel coords).  The
    reference would panic out of range (util.rs:35-40); the clamp is the
    JAX package's documented divergence."""
    cx = ml.rust_f32_to_u32(uv[..., 0] * ml.f32(w)).clamp(max=w - 1)
    cy = ml.rust_f32_to_u32(uv[..., 1] * ml.f32(h)).clamp(max=h - 1)
    return cx, cy


def _decode_normal(rgb):
    """byte/255 - 0.5 per channel, then normalize (util.rs:51-56)."""
    v = rgb.to(torch.float32) / 255.0 - 0.5
    return ml.normalize3(v)


def sample_color(textures, uv):
    """get_color_at_uv (util.rs:34-41): nearest-neighbour RGB fetch."""
    tex = textures["texture"]
    cx, cy = _tex_coords(uv, tex.shape[1], tex.shape[0])
    return tex[cy, cx]


def sample_normal(textures, uv):
    """get_normal_at_uv (util.rs:44-57)."""
    tex = textures["normal_map"]
    cx, cy = _tex_coords(uv, tex.shape[1], tex.shape[0])
    return _decode_normal(tex[cy, cx])


def sample_normal_tangent(textures, uv):
    """get_normal_tangent_at_uv (util.rs:60-73).  The reference's quirk is
    kept: texel coordinates come from the *normal_map* dims, the fetch reads
    *normal_map_tangent* (clamped into its range, the JAX package's
    divergence from the reference's panic)."""
    nm = textures["normal_map"]
    tex = textures["normal_map_tangent"]
    cx, cy = _tex_coords(uv, nm.shape[1], nm.shape[0])
    cx = cx.clamp(max=tex.shape[1] - 1)
    cy = cy.clamp(max=tex.shape[0] - 1)
    return _decode_normal(tex[cy, cx])


def sample_specular(textures, uv):
    """get_specular_value_at_uv (util.rs:76-83): the RAW byte 0..255, used
    directly as the specular exponent (shader.rs:521-525)."""
    tex = textures["specular_map"]
    cx, cy = _tex_coords(uv, tex.shape[1], tex.shape[0])
    return tex[cy, cx, 0].to(torch.float32)


_SAMPLERS = {
    "texture": sample_color,
    "normal_map": sample_normal,
    "normal_map_tangent": sample_normal_tangent,
    "specular_map": sample_specular,
}


def _pk_key(names, tile: int = 0) -> str:
    return "_pk:" + ",".join(names) + (f"@{tile}" if tile else "")


def _effective_tile(tile, h, w) -> int:
    """The swizzle tile applied: `tile` when it divides both texture dims,
    else 0 (row-major)."""
    if tile and h % tile == 0 and w % tile == 0:
        return int(tile)
    return 0


def _find_pk(textures, names):
    """Locate the packed plane for `names` -> (plane, tile) or (None, 0)."""
    base = _pk_key(names)
    pk = textures.get(base)
    if pk is not None:
        return pk, 0
    prefix = base + "@"
    for k in textures:
        if k.startswith(prefix):
            return textures[k], int(k[len(prefix):])
    return None, 0


def _swizzle_index(cx, cy, w, tile):
    """Row-major texel coords -> flat index in the tile-swizzled layout
    (a permutation of [0, h*w): each tile x tile block is contiguous)."""
    tx, ix = cx // tile, cx % tile
    ty, iy = cy // tile, cy % tile
    return ((ty * (w // tile) + tx) * tile + iy) * tile + ix


def pack_textures(textures, names, tile: int = 0):
    """Copy of `textures` with an (H, W, n) i32 packed plane for `names`
    (one word per map per texel) when all relevant dims match, stored
    tile-swizzled under ``_pk:...@tile`` when `tile` applies.  Any stale
    other-layout variant is dropped."""
    if not names:
        return textures
    texs = [textures[n] for n in names]
    dims = {tuple(t.shape[:2]) for t in texs}
    if "normal_map_tangent" in names:
        dims.add(tuple(textures["normal_map"].shape[:2]))
    if len(dims) != 1:
        return textures
    h, w = next(iter(dims))
    tile = _effective_tile(tile, h, w)
    words = []
    for t in texs:
        ti = t.to(torch.int32)
        words.append(ti[..., 0] | (ti[..., 1] << 8) | (ti[..., 2] << 16))
    pk = torch.stack(words, dim=-1)
    if tile:
        pk = (
            pk.reshape(h // tile, tile, w // tile, tile, -1)
            .permute(0, 2, 1, 3, 4)
            .reshape(h, w, -1)
        )
    out = {
        k: v for k, v in textures.items()
        if not (k == _pk_key(names) or k.startswith(_pk_key(names) + "@"))
    }
    out[_pk_key(names, tile)] = pk.contiguous()
    return out


def _unpack_rgb(word):
    """(...,) i32 word -> (..., 3) u8."""
    return torch.stack(
        [(word & 0xFF), ((word >> 8) & 0xFF), ((word >> 16) & 0xFF)], dim=-1
    ).to(torch.uint8)


def sample_maps(textures, uv, names):
    """Fetch the maps `names` at uv.  Returns {name: decoded sample}, equal
    to the per-map samplers.  With the packed plane of pack_textures: ONE
    gather of its words.  Without it: one gather of the maps concatenated
    along channels when they share dims, else the per-map samplers (a set
    whose dims differ, where the tangent map's quirk matters)."""
    pk, tile = _find_pk(textures, names)
    if pk is not None:
        h, w = pk.shape[:2]
        cx, cy = _tex_coords(uv, w, h)
        flat = pk.reshape(-1, pk.shape[-1])
        idx = _swizzle_index(cx, cy, w, tile) if tile else cy * w + cx
        g = flat[idx]  # (..., n) i32 words
        return {n: _decode_map(n, _unpack_rgb(g[..., i])) for i, n in enumerate(names)}

    texs = [textures[n] for n in names]
    dims = {tuple(t.shape[:2]) for t in texs}
    if "normal_map_tangent" in names:
        dims.add(tuple(textures["normal_map"].shape[:2]))
    if len(names) == 1 or len(dims) != 1:
        return {n: _SAMPLERS[n](textures, uv) for n in names}
    h, w = texs[0].shape[:2]
    cx, cy = _tex_coords(uv, w, h)
    g = torch.cat(texs, dim=-1)[cy, cx]  # (..., 3 * len(names)) u8
    return {n: _decode_map(n, g[..., 3 * i:3 * i + 3]) for i, n in enumerate(names)}


def _decode_map(name, raw):
    """A map's sample from its (..., 3) u8 texel."""
    if name in ("normal_map", "normal_map_tangent"):
        return _decode_normal(raw)
    if name == "specular_map":
        return raw[..., 0].to(torch.float32)
    return raw


def sample_frag(textures, frag, names):
    """Sample the pipeline's maps for a fragment batch: through the kernel's
    texel-index plane frag["texidx"] when present (one gather, no
    coordinate math; the index is already in the packed plane's layout),
    else at frag["uv"] through sample_maps."""
    texidx = frag.get("texidx")
    if texidx is None:
        return sample_maps(textures, frag["uv"], names)
    pk, _ = _find_pk(textures, names)
    if pk is None:
        raise KeyError(f"no packed texture plane {_pk_key(names)!r}; call pack_textures")
    g = pk.reshape(-1, len(names))[texidx.long()]  # (..., n) i32 words
    return {n: _decode_map(n, _unpack_rgb(g[..., i])) for i, n in enumerate(names)}


def mat3_vec(m, v):
    """Matrix3 * Vector3 with nalgebra accumulation order."""
    return torch.stack(
        [(m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]) + m[..., i, 2] * v[..., 2]
         for i in range(3)],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# Shadow map fetch (shader.rs:774-778)
# ---------------------------------------------------------------------------


def shadow_flat_indices(sxs, sys, shadow_shape, width, tile: int = 0):
    """Rounded, saturated, clamped FLAT shadow-buffer indices.

    The reference computes `round(x) as u32 + round(y) as u32 * width` in
    u32, which wraps; that is emulated in int64 with `& 0xFFFFFFFF` before
    the clamp to the buffer (the clamp is the JAX package's divergence from
    the reference's panic).  With `tile` the row-major index is re-encoded
    for the swizzled buffer after the clamp (swizzle_plane)."""
    ix = ml.rust_f32_to_u32(ml.rust_round(sxs))
    iy = ml.rust_f32_to_u32(ml.rust_round(sys))
    flat = (ix + iy * width) & 0xFFFFFFFF
    flat = flat.clamp(max=shadow_shape[0] * shadow_shape[1] - 1)
    if tile:
        y2 = flat // width
        x2 = flat - y2 * width
        flat = _swizzle_index(x2, y2, width, tile)
    return flat


def _shadow_fetch(shadow_buffer, sx, sy, width, tile: int = 0):
    """shadow_buffer[round(x) as u32 + round(y) as u32 * width]."""
    flat = shadow_flat_indices(sx, sy, shadow_buffer.shape, width, tile)
    return shadow_buffer.reshape(-1)[flat]


def plane_tile_effective(config, shape) -> int:
    """The shadow-plane swizzle tile applied for this buffer: shadow_tile
    when it divides both dims and the stride equals config.width, else 0.
    The plane's producer and the fetches both call here."""
    t = config.shadow_tile
    h, w = shape[0], shape[1]
    if t and h % t == 0 and w % t == 0 and w == config.width:
        return int(t)
    return 0


def swizzle_plane(plane, tile):
    """(H, W) plane with each tile x tile block contiguous in flat order."""
    h, w = plane.shape
    return (
        plane.reshape(h // tile, tile, w // tile, tile).permute(0, 2, 1, 3).reshape(h, w)
    )


# ---------------------------------------------------------------------------
# Pipelines.  Each shade consumes the interpolated varyings of its
# VARYING_SPECS entry, plus "x"/"y" pixel coords and, for the two-pass
# pipelines, "shadow_buffer".
# ---------------------------------------------------------------------------


def shade_default(frag, uniforms, textures, config):
    """Flat shading (shader.rs:318-333): texture * face diffuse."""
    color = sample_frag(textures, frag, ("texture",))["texture"]
    return ml.color_blend(color, _color(BLACK, color.device), frag["intensity"])


def shade_phong(frag, uniforms, textures, config):
    """Gouraud-interpolated intensity (shader.rs:386-401)."""
    color = sample_frag(textures, frag, ("texture",))["texture"]
    return ml.color_blend(color, _color(BLACK, color.device), frag["intensity"])


def shade_normal_map(frag, uniforms, textures, config):
    """World-space normal map lookup (shader.rs:439-457)."""
    s = sample_frag(textures, frag, ("texture", "normal_map"))
    color, n = s["texture"], s["normal_map"]
    t_n = ml.normalize3(ml.mat4_transform_vector(uniforms["it_m"], n))
    diff = ml.dot3(uniforms["t_light_direction"], t_n)
    return ml.color_blend(color, _color(BLACK, color.device), diff)


def shade_specular(frag, uniforms, textures, config):
    """Normal-map diffuse + Phong specular (shader.rs:498-534).  torch.pow
    may differ from XLA's pow in the last ulp."""
    s = sample_frag(textures, frag, ("texture", "normal_map", "specular_map"))
    color = s["texture"].to(torch.float32)
    t_n = ml.normalize3(ml.mat4_transform_vector(uniforms["it_m"], s["normal_map"]))
    light = uniforms["t_light_direction"]
    d = ml.dot3(light, t_n)
    reflected = ml.normalize3(2.0 * (t_n * d[..., None]) - light)
    # Only the reflection's z matters: the camera looks down -z in its own
    # frame (shader.rs:520-525).
    spec = ml.f32(config.specular_scale) * torch.pow(
        reflected[..., 2].clamp(min=0.0), s["specular_map"]
    )
    coef = (d + spec)[..., None]
    return ml.rust_f32_to_u8((coef * color).clamp(max=255.0))


def shade_darboux(frag, uniforms, textures, config):
    """Tangent-space (Darboux) normal mapping (shader.rs:597-654).  Traced,
    it is the stage `darboux` of its frame (the stage up to it keeps
    `shade`) and the frame counts its covered pixels (timing.frame_pixels,
    counter darboux.pixels)."""
    timing.mark("shade")
    timing.shade_pixels("darboux.pixels")
    s = sample_frag(textures, frag, ("texture", "normal_map_tangent"))
    color, tn_sample = s["texture"], s["normal_map_tangent"]

    local_z = frag["local_z"]
    basis = torch.stack([frag["row0"], frag["row1"], ml.normalize3(local_z)], dim=-2)
    i_basis = ml.mat3_inverse(basis)
    du, dv = frag["du"], frag["dv"]
    zeros = torch.zeros_like(du[..., 0])
    local_x = mat3_vec(i_basis, torch.stack([du[..., 0], du[..., 1], zeros], dim=-1))
    local_y = mat3_vec(i_basis, torch.stack([dv[..., 0], dv[..., 1], zeros], dim=-1))

    # The transform's columns (x, y, z), applied to the sampled normal.
    col_x = ml.normalize3(local_x)
    col_y = ml.normalize3(local_y)
    col_z = ml.normalize3(local_z)
    t_fragment_normal = ml.normalize3(
        col_x * tn_sample[..., 0:1] + col_y * tn_sample[..., 1:2] + col_z * tn_sample[..., 2:3]
    )
    diff = ml.dot3(uniforms["t_light_direction"], t_fragment_normal)
    out = ml.color_blend(color, _color(BLACK, color.device), diff)
    timing.mark("darboux")
    return out


def darboux_fused_body(textures, device):
    """The darboux pipeline's strip chunk body as one launch of the kernel
    of ops/darboux_cuda.py, where it applies: on a CUDA device, with the
    packed plane of the pipeline's maps (maps of mixed dimensions have
    none).  Returns body(setup, strips, cids, acc, uniforms, *, width,
    pixels, y_offset), which does what frame._shade_strips' torch body does
    for the slots `cids` (darboux_cuda.chunk_body), or None where the torch
    body runs.  Traced, the body is the stage `darboux` of its frame, the
    gather and varyings included, and counts the frame's covered pixels, as
    shade_darboux does."""
    pk, tile = _find_pk(textures, PIPELINE_MAPS["darboux"])
    if device.type != "cuda" or pk is None:
        return None

    def body(setup, strips, cids, acc, uniforms, *, width, pixels, y_offset):
        timing.mark("shade")
        timing.shade_pixels("darboux.pixels")
        darboux_cuda.chunk_body(setup, strips, cids, acc, pk, tile, uniforms["t_light_direction"],
                                width=width, pixels=pixels, y_offset=y_offset)
        timing.mark("darboux")

    return body


def shade_shadow(frag, uniforms, textures, config):
    """Shadow pass 2 (shader.rs:749-788): phong + shadow-map depth compare."""
    x = frag["x"].to(torch.float32)
    y = frag["y"].to(torch.float32)
    sm = ml.mat4_mul(uniforms["shadow_matrix"], uniforms["i_vpmv"])
    sc = ml.mat4_transform_point(sm, torch.stack([x, y, frag["zfrag"]], dim=-1))
    shadow_val = _shadow_fetch(
        frag["shadow_buffer"], sc[..., 0], sc[..., 1], config.width,
        tile=plane_tile_effective(config, frag["shadow_buffer"].shape),
    )
    shadow_coef = torch.where(
        sc[..., 2] + ml.f32(config.shadow_bias) < shadow_val,
        ml.f32(config.shadow_dim),
        1.0,
    )
    color = sample_frag(textures, frag, ("texture",))["texture"]
    return ml.color_blend(color, _color(BLACK, color.device), frag["intensity"] * shadow_coef)


def occlusion_directions(n, device):
    """The probe's n sample directions (sin a, 0, cos a) at a = i * 2 pi / n,
    an (n, 3) float32 constant on `device` (mathlib.const): numpy float32
    sin/cos of float32 angles, the bits the JAX module uses."""
    angle_coef = np.float32(2.0 * np.pi) / np.float32(n)
    ang = [np.float32(angle_coef * np.float32(i)) for i in range(n)]
    dirs = np.array([[np.sin(a), 0.0, np.cos(a)] for a in ang], dtype=np.float32)
    return ml.const(tuple(map(tuple, dirs.tolist())), device)


def occlusion_sample_coords(xf, yf, zfrag, uniforms, config):
    """Float shadow-space coords of the occlusion probe (shader.rs:882-933).

    Returns (sxs, sys), each (n+1, ...) f32: rows 0..n-1 are the n circular
    samples in the plane perpendicular to the light, row n the fragment's
    own shadow coord.  The sample directions are numpy float32 sin/cos of
    float32 angles, the bits the JAX module uses."""
    p = torch.stack([xf, yf, zfrag], dim=-1)
    light = ml.mat4_transform_vector(uniforms["i_m"], uniforms["t_light_direction"])
    world = ml.mat4_transform_point(uniforms["i_vpmv"], p)
    sm = ml.mat4_mul(uniforms["shadow_matrix"], uniforms["i_vpmv"])
    fsc = ml.mat4_transform_point(sm, p)
    rot = ml.rotation_between(ml.const((0.0, 0.0, 1.0), light.device), light)

    n = config.occlusion_samples
    dirs = occlusion_directions(n, light.device)
    # All n samples at once: the same elementwise arithmetic per sample.
    step = mat3_vec(rot, dirs) * ml.f32(config.occlusion_step)
    sample = world + step.reshape(n, *([1] * (world.ndim - 1)), 3)  # (n, ..., 3)
    ssc = ml.mat4_transform_point(uniforms["shadow_matrix"], sample)
    return (torch.cat([ssc[..., 0], fsc[None, ..., 0]]),
            torch.cat([ssc[..., 1], fsc[None, ..., 1]]))


def occlusion_update(svals, fval, config):
    """The occlusion accumulation loop (shader.rs:934-941): svals (n, ...)
    sampled shadow values, fval the fragment's own shadow value."""
    n = config.occlusion_samples
    inv_n = ml.f32(np.float32(1.0) / np.float32(n))
    threshold = ml.f32(config.occlusion_threshold)
    depth_scale = ml.f32(config.occlusion_depth_scale)
    occ = torch.ones_like(fval)
    for i in range(n):
        sval = svals[i]
        occluded = (sval - threshold) > fval
        strength = ((sval - fval) / depth_scale).clamp(max=1.0)
        occ = torch.where(occluded, occ - inv_n * strength, occ)
    return occ


def dedup_gather(table, flat_idx, cap_shift=3):
    """table[flat_idx] with equal indices fetched once (the JAX module's
    dedup_gather, shaders.py:642-685).

    The indices are sorted with their positions; the head of each run of
    equal indices goes to one of cap = max(M >> cap_shift, 256) unique
    slots (M indices), the table is read at those slots only, and each
    position takes its run's value back through the sort permutation.
    Where more than cap indices are unique, the plain gather's values are
    taken instead.  JAX's lax.cond on that flag is two graphs.device_if
    bodies writing one output: in a replayed graph the device runs one
    side.  Eagerly both run, the deduplicated side first, so the plain
    gather's values stand.  Equal values either way."""
    shape = flat_idx.shape
    flat = flat_idx.reshape(-1).to(torch.int32)
    M = flat.shape[0]
    cap = max(M >> cap_shift, 256)
    keys, pos = torch.sort(flat, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=flat.device), keys[1:] != keys[:-1]])
    rank = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    overflow = rank[-1] >= cap
    out = torch.empty((M,), dtype=table.dtype, device=table.device)

    def deduped():
        uniq = torch.zeros((cap + 1,), dtype=torch.int32, device=flat.device)
        uniq[torch.where(first, rank, cap).clamp(max=cap).long()] = keys  # runs past the cap: the spare slot
        fetched = table[uniq[:cap].long()]  # the one table-sized gather: cap rows
        out[pos] = fetched[rank.clamp(max=cap - 1).long()]

    def plain():
        torch.index_select(table, 0, flat, out=out)

    graphs.device_if(~overflow, deduped)
    graphs.device_if(overflow, plain)
    return out.reshape(shape)


def occlusion_reference(xf, yf, zfrag, shadow_buffer, uniforms, config):
    """The occlusion core (shader.rs:882-941) in plain torch, for any batch
    of fragments: all n+1 shadow-buffer indices computed elementwise, then
    ONE gather (dedup_gather under config.occlusion_dedup: the same
    values), then the update.  occlusion_coefficient runs it on CPU
    tensors; on CUDA tensors the kernel of ops/occlusion_cuda.py equals it
    bit for bit."""
    n = config.occlusion_samples
    sxs, sys = occlusion_sample_coords(xf, yf, zfrag, uniforms, config)
    flat = shadow_flat_indices(
        sxs, sys, shadow_buffer.shape, config.width,
        tile=plane_tile_effective(config, shadow_buffer.shape),
    )
    table = shadow_buffer.reshape(-1)
    vals = dedup_gather(table, flat) if config.occlusion_dedup else table[flat]  # (n+1, ...)
    return occlusion_update(vals[:n], vals[n], config)


def occlusion_coefficient(xf, yf, zfrag, shadow_buffer, uniforms, config):
    """The occlusion coefficient of any batch of fragments: on CUDA tensors
    one launch of the kernel of ops/occlusion_cuda.py (either setting of
    config.occlusion_dedup: the values are the same), on CPU tensors
    occlusion_reference.  Traced, the probe is the stage `probe` of its
    frame (the stage up to it keeps `shade`) and the frame counts its
    covered pixels (timing.frame_pixels, counter occlusion.pixels)."""
    timing.mark("shade")
    timing.shade_pixels("occlusion.pixels")
    if xf.is_cuda:
        occ = occlusion_cuda.coefficient(
            xf.contiguous(), yf.contiguous(), zfrag.contiguous(), shadow_buffer.contiguous(), uniforms,
            occlusion_directions(config.occlusion_samples, xf.device), config,
            tile=plane_tile_effective(config, shadow_buffer.shape),
        )
    else:
        occ = occlusion_reference(xf, yf, zfrag, shadow_buffer, uniforms, config)
    timing.mark("probe")
    return occ


def shade_occlusion(frag, uniforms, textures, config):
    """Occlusion pass 2 (shader.rs:872-947): white * the coefficient."""
    occ = occlusion_coefficient(
        frag["x"].to(torch.float32), frag["y"].to(torch.float32), frag["zfrag"],
        frag["shadow_buffer"], uniforms, config,
    )
    return ml.color_blend(_color(WHITE, occ.device), _color(BLACK, occ.device), occ)
