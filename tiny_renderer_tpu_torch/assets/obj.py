"""Wavefront OBJ parser producing dense NumPy geometry arrays.

The reference parses OBJ with the obj-rs crate's raw interface
(reference: src/app.rs:94) and requires every polygon to carry
position/texture/normal index triplets (`Polygon::PTN`), panicking otherwise
(src/scene.rs:216-219).  It then reads only the *first three* vertices of
each polygon (src/scene.rs:224-226), i.e. quads would be silently truncated,
never fan-triangulated — both asset models are pure triangle meshes.

This parser returns struct-of-arrays geometry ready for the batched vertex
stage: positions (V, 3) f32, tex_coords (VT, 2) f32, normals (VN, 3) f32 and
per-triangle index arrays (T, 3) i32 for each attribute.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ObjMesh:
    positions: np.ndarray    # (V, 3) f32
    tex_coords: np.ndarray   # (VT, 2) f32 — raw (u, v), no flip applied here
    normals: np.ndarray      # (VN, 3) f32
    pos_idx: np.ndarray      # (T, 3) i32
    tex_idx: np.ndarray      # (T, 3) i32
    normal_idx: np.ndarray   # (T, 3) i32

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.pos_idx.shape[0])


def _resolve(idx: int, count: int) -> int:
    """OBJ indices are 1-based; negative indices are relative to the end."""
    return idx - 1 if idx > 0 else count + idx


def parse_obj(text: str) -> ObjMesh:
    positions: list[tuple[float, float, float]] = []
    tex_coords: list[tuple[float, float]] = []
    normals: list[tuple[float, float, float]] = []
    pos_idx: list[tuple[int, int, int]] = []
    tex_idx: list[tuple[int, int, int]] = []
    normal_idx: list[tuple[int, int, int]] = []

    for line_no, line in enumerate(text.splitlines(), 1):
        if "#" in line:
            line = line[: line.index("#")]
        tokens = line.split()
        if not tokens:
            continue
        kind, args = tokens[0], tokens[1:]
        if kind == "v":
            positions.append((float(args[0]), float(args[1]), float(args[2])))
        elif kind == "vt":
            u = float(args[0])
            v = float(args[1]) if len(args) > 1 else 0.0
            tex_coords.append((u, v))
        elif kind == "vn":
            normals.append((float(args[0]), float(args[1]), float(args[2])))
        elif kind == "f":
            if len(args) < 3:
                raise ValueError(f"line {line_no}: face with fewer than 3 vertices")
            corners = []
            # Like the reference (src/scene.rs:224-226), use only the first
            # three corners of each polygon.
            for corner in args[:3]:
                parts = corner.split("/")
                if len(parts) != 3 or not parts[1] or not parts[2]:
                    raise ValueError(
                        f"line {line_no}: face corner {corner!r} is not a "
                        "position/texture/normal triplet — the reference "
                        "renderer only supports PTN polygons (src/scene.rs:218)"
                    )
                corners.append(
                    (
                        _resolve(int(parts[0]), len(positions)),
                        _resolve(int(parts[1]), len(tex_coords)),
                        _resolve(int(parts[2]), len(normals)),
                    )
                )
            pos_idx.append(tuple(c[0] for c in corners))
            tex_idx.append(tuple(c[1] for c in corners))
            normal_idx.append(tuple(c[2] for c in corners))

    mesh = ObjMesh(
        positions=np.asarray(positions, dtype=np.float32).reshape(-1, 3),
        tex_coords=np.asarray(tex_coords, dtype=np.float32).reshape(-1, 2),
        normals=np.asarray(normals, dtype=np.float32).reshape(-1, 3),
        pos_idx=np.asarray(pos_idx, dtype=np.int32).reshape(-1, 3),
        tex_idx=np.asarray(tex_idx, dtype=np.int32).reshape(-1, 3),
        normal_idx=np.asarray(normal_idx, dtype=np.int32).reshape(-1, 3),
    )
    for name, idx, count in (
        ("position", mesh.pos_idx, mesh.positions.shape[0]),
        ("texture", mesh.tex_idx, mesh.tex_coords.shape[0]),
        ("normal", mesh.normal_idx, mesh.normals.shape[0]),
    ):
        if idx.size and (idx.min() < 0 or idx.max() >= count):
            raise ValueError(f"{name} index out of range")
    return mesh


def read_obj(path: str) -> ObjMesh:
    with open(path, "r") as f:
        return parse_obj(f.read())
