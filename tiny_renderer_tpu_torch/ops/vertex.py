"""Batched vertex stage: all triangles at once (``tiny_renderer_tpu.ops.vertex``).

Gathers per-triangle attributes, culls back faces (shader.rs:116-124),
transforms and truncates to integer raster coordinates (shader.rs:150-165),
flips uv v (shader.rs:136-147) and computes the int32 edge-function
coefficients that make the raster's coverage tests exact
(src/scene.rs:174-197).  For CUDA tensors the setup kernel of
``csrc/vertex.cu`` (``ops/vertex_cuda.py``) computes all of it but
darboux's pieces and the "attr:*" pass-through; ``setup_reference`` is its
torch code, on any device.
"""

from __future__ import annotations

import torch

from ..utils import timing
from . import mathlib as ml
from . import vertex_cuda

# Largest |raster coord| for which the int32 edge-coefficient arithmetic is
# exact: products <= 2^29, per-pixel evaluations <= 2^30.
EXACT_COORD_MAX = 1 << 14


def gather_triangles(geom):
    """Per-triangle positions (T,3,3), uvs (T,3,2), normals (T,3,3); uses the
    pre-expanded arrays of expand_geometry when present."""
    if "pos_tri" in geom:
        return {"pos": geom["pos_tri"], "uv_raw": geom["uv_tri"], "normal": geom["normal_tri"]}
    return {
        "pos": geom["positions"][geom["pos_idx"].long()],
        "uv_raw": geom["tex_coords"][geom["tex_idx"].long()],
        "normal": geom["normals"][geom["normal_idx"].long()],
    }


def expand_geometry(geom):
    """Geometry dict plus the pre-expanded per-triangle attribute arrays
    (a one-time cost at scene construction instead of one per frame)."""
    out = dict(geom)
    tris = gather_triangles(geom)
    out["pos_tri"] = tris["pos"]
    out["uv_tri"] = tris["uv_raw"]
    out["normal_tri"] = tris["normal"]
    return out


def face_normals(pos):
    """Untransformed face normal: (p1-p0) x (p2-p0) (shader.rs:117-118)."""
    return ml.cross3(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])


def triangle_setup(geom, uniforms, config, *, matrix_key="vpmv", cull=True, needs=()):
    """Per-triangle raster + varying setup.

    matrix_key: "vpmv" for camera passes, "shadow_matrix" for the light-view
    depth pass (which does not cull, shader.rs:679).  needs: subset of
    {"face_intensity", "vertex_intensity", "darboux"}.

    Returns a dict of (T, ...) tensors with the JAX module's keys: valid,
    rx/ry (T,3) i32, zv (T,3) f32, a1,b1,c1,a2,b2,c2,cz (T,) i32, the
    screen-clamped inclusive bbox x0,x1,y0,y1 (T,) i32, uv (T,3,2) with v
    flipped, coord_overflow (0-d bool), plus the requested varyings.
    CUDA tensors launch the setup kernel (ops/vertex_cuda.py) for all of it
    but darboux's pieces and the "attr:*" planes; CPU tensors run
    setup_reference.
    """
    tris = gather_triangles(geom)
    pos = tris["pos"]
    T = pos.shape[0]
    if pos.is_cuda:
        out = vertex_cuda.setup(tris, uniforms, config, matrix_key=matrix_key, cull=cull, needs=needs,
                               exact_max=EXACT_COORD_MAX)
    else:
        out = setup_reference(tris, uniforms, config, matrix_key=matrix_key, cull=cull, needs=needs)

    # User vertex attributes ("attr:*"): (T, 3, k) planes passed through.
    for key, val in geom.items():
        if key.startswith("attr:"):
            a = torch.as_tensor(val, dtype=torch.float32, device=pos.device)
            if a.ndim != 3 or a.shape[0] != T or a.shape[1] != 3:
                raise ValueError(
                    f"custom vertex attribute {key!r} must have shape "
                    f"(num_triangles={T}, 3, k); got {tuple(a.shape)}"
                )
            out[key] = a

    if "darboux" in needs:
        # Per-triangle Darboux basis pieces (shader.rs:561-643).  Traced,
        # they are the stage `darboux_setup` of the frame; the rest of the
        # layer stays the stage `vertex`.
        timing.mark("vertex")
        uv = out["uv"]
        t_pos = ml.mat4_transform_point(uniforms["m"], pos)
        out["t_norm"] = ml.normalize3(
            ml.mat4_transform_vector(uniforms["it_m"], tris["normal"])
        )
        out["row0n"] = ml.normalize3(t_pos[:, 1] - t_pos[:, 0])
        out["row1n"] = ml.normalize3(t_pos[:, 2] - t_pos[:, 0])
        out["du"] = torch.stack(
            [uv[:, 1, 0] - uv[:, 0, 0], uv[:, 2, 0] - uv[:, 0, 0]], dim=-1
        )
        out["dv"] = torch.stack(
            [uv[:, 1, 1] - uv[:, 0, 1], uv[:, 2, 1] - uv[:, 0, 1]], dim=-1
        )
        timing.mark("darboux_setup")
    return out


def setup_reference(tris, uniforms, config, *, matrix_key="vpmv", cull=True, needs=()):
    """The plain torch version of the setup kernel, on any device: the
    outputs of triangle_setup but for darboux's pieces and the "attr:*"
    planes, from gather_triangles' `tris`."""
    pos = tris["pos"]
    T = pos.shape[0]

    tp = ml.mat4_transform_point(uniforms[matrix_key], pos)  # (T, 3, 3)
    rx = ml.rust_f32_to_i32(tp[..., 0])
    ry = ml.rust_f32_to_i32(tp[..., 1])
    zv = tp[..., 2]

    # Exactness envelope (range compare, not abs: abs(INT32_MIN) wraps).
    in_exact = (
        (rx >= -EXACT_COORD_MAX) & (rx <= EXACT_COORD_MAX)
        & (ry >= -EXACT_COORD_MAX) & (ry <= EXACT_COORD_MAX)
    ).all(dim=1)

    x1, x2, x3 = rx[:, 0], rx[:, 1], rx[:, 2]
    y1, y2, y3 = ry[:, 0], ry[:, 1], ry[:, 2]
    a1 = y3 - y1
    b1 = -(x3 - x1)
    c1 = x3 * y1 - x1 * y3
    a2 = -(y2 - y1)
    b2 = x2 - x1
    c2 = x1 * y2 - x2 * y1
    cz = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)

    keep = torch.ones((T,), dtype=torch.bool, device=pos.device)
    if cull:
        keep = ml.dot3(uniforms["camera_direction"], face_normals(pos)) > 0.0
    # Degenerate: |cross.z| < 1 over integers <=> cz == 0 (scene.rs:188-191).
    keep = keep & (cz != 0)

    # Screen-clamped inclusive bbox (scene.rs:160-171, :236-239).
    xmin = torch.minimum(torch.minimum(x1, x2), x3)
    xmax = torch.maximum(torch.maximum(x1, x2), x3)
    ymin = torch.minimum(torch.minimum(y1, y2), y3)
    ymax = torch.maximum(torch.maximum(y1, y2), y3)
    x0 = xmin.clamp(min=0)
    x1c = xmax.clamp(max=config.width - 1)
    y0 = ymin.clamp(min=0)
    y1c = ymax.clamp(max=config.height - 1)
    keep = keep & (x0 <= x1c) & (y0 <= y1c)

    # On-screen triangles beyond the exactness envelope are dropped and
    # reported.
    coord_overflow = (keep & ~in_exact).any()
    keep = keep & in_exact

    uv_raw = tris["uv_raw"]
    uv = torch.stack([uv_raw[..., 0], 1.0 - uv_raw[..., 1]], dim=-1)

    out = {
        "valid": keep, "rx": rx, "ry": ry, "zv": zv,
        "a1": a1, "b1": b1, "c1": c1, "a2": a2, "b2": b2, "c2": c2, "cz": cz,
        "x0": x0, "x1": x1c, "y0": y0, "y1": y1c,
        "uv": uv, "coord_overflow": coord_overflow,
    }
    if "face_intensity" in needs:
        # Flat shading: face normal through it_m (shader.rs:297-305).
        t_fn = ml.normalize3(ml.mat4_transform_vector(uniforms["it_m"], face_normals(pos)))
        diff = ml.dot3(uniforms["t_light_direction"], t_fn)
        out["intensity"] = diff[:, None].expand(T, 3)
    if "vertex_intensity" in needs:
        # Per-vertex Gouraud/Phong intensities (shader.rs:362-373).
        t_n = ml.normalize3(ml.mat4_transform_vector(uniforms["it_m"], tris["normal"]))
        out["intensity"] = ml.dot3(uniforms["t_light_direction"], t_n)
    return out
