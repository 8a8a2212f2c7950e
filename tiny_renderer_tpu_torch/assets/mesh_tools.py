"""Mesh utilities beyond the reference's loader
(``tiny_renderer_tpu.assets.mesh_tools``): scale meshes up for stress and
capacity testing.

The reference scenes top out at 5,022 triangles (SURVEY.md §2 #11); the
renderer's dense (T, ...) design has no per-triangle serialization, so
its practical ceiling is set by the binning caps and the int32 raster
exactness envelope.  subdivide_mesh makes the workloads that exercise
them (chip_smoke.py's capacity phase: the flagship stand-in subdivided
twice, 81,536 triangles).
"""

from __future__ import annotations

import numpy as np

from .obj import ObjMesh


def subdivide_mesh(mesh: ObjMesh, levels: int = 1) -> ObjMesh:
    """Midpoint (1:4) subdivision applied `levels` times: 4^levels x the
    triangle count, identical silhouette.

    Each attribute stream (positions / uvs / normals) is subdivided along
    its OWN index topology, preserving the OBJ PTN structure.  Midpoints
    are not deduplicated across edges — shared edge midpoints compute the
    same f32 coordinates from the same endpoints, so rendering (and the
    exact-integer coverage tests) see a watertight mesh; the vertex
    arrays just carry ~2x duplicates, which only matters for memory.
    Normals are midpoint-averaged WITHOUT renormalization — the fragment
    shaders normalize where the reference does, nowhere else.
    """
    pos, uv, nrm = mesh.positions, mesh.tex_coords, mesh.normals
    pidx, tidx, nidx = mesh.pos_idx, mesh.tex_idx, mesh.normal_idx
    for _ in range(levels):
        pos, pidx = _subdivide_stream(pos, pidx)
        uv, tidx = _subdivide_stream(uv, tidx)
        nrm, nidx = _subdivide_stream(nrm, nidx)
    return ObjMesh(
        positions=pos, tex_coords=uv, normals=nrm,
        pos_idx=pidx, tex_idx=tidx, normal_idx=nidx,
    )


def _subdivide_stream(values: np.ndarray, idx: np.ndarray):
    """One 1:4 split of an attribute stream.

    New values = old values + per-triangle edge midpoints (3 per
    triangle, appended in triangle order — deterministic).  New triangles
    per old (a, b, c) with midpoints (ab, bc, ca):
    (a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca).
    """
    T = idx.shape[0]
    V = values.shape[0]
    a, b, c = idx[:, 0], idx[:, 1], idx[:, 2]
    ab = (values[a] + values[b]) * np.float32(0.5)
    bc = (values[b] + values[c]) * np.float32(0.5)
    ca = (values[c] + values[a]) * np.float32(0.5)
    new_values = np.concatenate(
        [values, ab, bc, ca], axis=0
    ).astype(values.dtype)
    i_ab = V + np.arange(T, dtype=idx.dtype)
    i_bc = i_ab + T
    i_ca = i_bc + T
    tris = np.stack(
        [
            np.stack([a, i_ab, i_ca], axis=1),
            np.stack([i_ab, b, i_bc], axis=1),
            np.stack([i_ca, i_bc, c], axis=1),
            np.stack([i_ab, i_bc, i_ca], axis=1),
        ],
        axis=1,
    ).reshape(-1, 3)
    return new_values, np.ascontiguousarray(tris, dtype=idx.dtype)
