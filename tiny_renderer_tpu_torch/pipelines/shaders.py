"""Fragment-stage functions of the shadow pipeline (``tiny_renderer_tpu.pipelines.shaders``).

Shading is split as in the JAX module: varying interpolation
(``VARYING_SPECS`` + ``compute_varyings``) from gathered per-fragment
triangle attributes, then a pure ``shade_*`` function over any leading batch
shape.  Only the shadow pipeline's shade is ported so far; the other six
wait (ROADMAP Queue 1 item 8).

Textures are sampled through the word-packed plane of ``pack_textures``:
each texel's RGB in one int32 word, optionally tile-swizzled
(config.tex_tile), keyed ``_pk:<names>[@tile]`` exactly like the JAX
package, so packed planes cross between the two unchanged.
"""

from __future__ import annotations

import torch

from ..ops import mathlib as ml

# Each pipeline's varyings: (name, components, mode) with mode "interp"
# (barycentric interpolation of 3 per-vertex values), "const" (per-triangle
# constant) or "zfrag" (bar . vertex z values, shader.rs:174).
VARYING_SPECS = {
    "shadow": (("uv", 2, "interp"), ("intensity", 1, "interp"), ("zfrag", 1, "zfrag")),
}

# Setup-dict source of each "interp" varying, values[v][c] per vertex (used
# by binning.pack_triangle_records).  The darboux pipeline's local_z and
# "const" varyings arrive with that pipeline.
_INTERP_SOURCES = {
    "uv": lambda s, c, v: s["uv"][:, v, c],
    "intensity": lambda s, c, v: s["intensity"][:, v],
}


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
            a = frag[name]  # (..., 3v[, comps])
            if a.ndim == bar.ndim:  # scalar varying: (..., 3)
                out[name] = (a[..., 0] * b0 + a[..., 1] * b1) + a[..., 2] * b2
            else:
                out[name] = torch.stack(
                    [(a[..., 0, c] * b0 + a[..., 1, c] * b1) + a[..., 2, c] * b2
                     for c in range(comps)],
                    dim=-1,
                )
        else:
            raise NotImplementedError(f"varying mode {mode!r} ({name}) is not ported")
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
    """Fetch the maps `names` at uv with ONE gather of the packed plane
    (pack_textures must have packed it).  Returns {name: decoded sample}.
    The JAX module's unpacked fallbacks serve mixed-dimension map sets,
    which no ported pipeline has."""
    pk, tile = _find_pk(textures, names)
    if pk is None:
        raise KeyError(f"no packed texture plane {_pk_key(names)!r}; call pack_textures")
    h, w = pk.shape[:2]
    cx, cy = _tex_coords(uv, w, h)
    flat = pk.reshape(-1, pk.shape[-1])
    idx = _swizzle_index(cx, cy, w, tile) if tile else cy * w + cx
    g = flat[idx]  # (..., n) i32 words

    def decode(n, raw):
        if n in ("normal_map", "normal_map_tangent"):
            return _decode_normal(raw)
        if n == "specular_map":
            return raw[..., 0].to(torch.float32)
        return raw

    return {n: decode(n, _unpack_rgb(g[..., i])) for i, n in enumerate(names)}


def sample_frag(textures, frag, names):
    """Sample the pipeline's maps for a fragment batch at frag["uv"].  (The
    JAX module's kernel texel-index plane arrives with K1 phase 2.)"""
    return sample_maps(textures, frag["uv"], names)


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
    black = torch.zeros(3, dtype=torch.uint8, device=color.device)
    return ml.color_blend(color, black, frag["intensity"] * shadow_coef)
