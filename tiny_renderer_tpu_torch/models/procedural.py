"""Procedural test/demo meshes.

The reference ships exactly two OBJ assets (diablo, african_head —
SURVEY.md §2.9) and supports any asset directory with the same file set.
These generators produce meshes with the identical geometry contract
(positions / tex_coords / normals + PTN triangle indices, unit-sphere scale
to suit the fixed orbit camera at radius 1 and projection distance 5) for
tests, demos and benchmarking without external assets.
"""

from __future__ import annotations

import numpy as np

from ..assets.obj import ObjMesh


def _mesh(positions, tex_coords, normals, pos_idx, tex_idx, normal_idx) -> ObjMesh:
    return ObjMesh(
        positions=np.asarray(positions, np.float32).reshape(-1, 3),
        tex_coords=np.asarray(tex_coords, np.float32).reshape(-1, 2),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        pos_idx=np.asarray(pos_idx, np.int32).reshape(-1, 3),
        tex_idx=np.asarray(tex_idx, np.int32).reshape(-1, 3),
        normal_idx=np.asarray(normal_idx, np.int32).reshape(-1, 3),
    )


def make_plane(size: float = 0.8) -> ObjMesh:
    """Two CCW triangles in the z=0 plane facing +z."""
    s = size / 2
    positions = [[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]]
    tex_coords = [[0, 0], [1, 0], [1, 1], [0, 1]]
    normals = [[0, 0, 1]]
    pos_idx = [[0, 1, 2], [0, 2, 3]]
    tex_idx = pos_idx
    normal_idx = [[0, 0, 0], [0, 0, 0]]
    return _mesh(positions, tex_coords, normals, pos_idx, tex_idx, normal_idx)


def make_grid(half: float = 1.5, n: int = 24) -> ObjMesh:
    """A flat n x n grid of quads over [-half, half]^2 in the z=0 plane,
    facing +z, uv following x and y: at half=1.5 it fills the frame of
    the orbit camera near angle 0 (every strip covered), in triangles
    small enough for the binning's span caps."""
    xs = np.linspace(-half, half, n + 1, dtype=np.float32)
    px, py = np.meshgrid(xs, xs)
    positions = np.stack([px.ravel(), py.ravel(), np.zeros(px.size, np.float32)], -1)
    tex_coords = (positions[:, :2] + half) / (2 * half)
    v = np.arange((n + 1) ** 2, dtype=np.int32).reshape(n + 1, n + 1)
    a, b, c, d = v[:-1, :-1].ravel(), v[:-1, 1:].ravel(), v[1:, :-1].ravel(), v[1:, 1:].ravel()
    pos_idx = np.concatenate([np.stack([a, b, d], -1), np.stack([a, d, c], -1)])
    return _mesh(positions, tex_coords, [[0, 0, 1]], pos_idx, pos_idx, np.zeros_like(pos_idx))


def make_cube(size: float = 0.6) -> ObjMesh:
    """Axis-aligned cube with per-face normals and uv per face."""
    s = size / 2
    faces = [
        # (normal, four corners CCW as seen from outside)
        ([0, 0, 1], [[-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]]),
        ([0, 0, -1], [[s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]]),
        ([1, 0, 0], [[s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]]),
        ([-1, 0, 0], [[-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]]),
        ([0, 1, 0], [[-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]]),
        ([0, -1, 0], [[-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]]),
    ]
    positions, normals, pos_idx, normal_idx = [], [], [], []
    tex_coords = [[0, 0], [1, 0], [1, 1], [0, 1]]
    tex_idx = []
    for normal, corners in faces:
        base = len(positions)
        positions.extend(corners)
        normals.append(normal)
        ni = len(normals) - 1
        pos_idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        normal_idx += [[ni] * 3, [ni] * 3]
        tex_idx += [[0, 1, 2], [0, 2, 3]]
    return _mesh(positions, tex_coords, normals, pos_idx, tex_idx, normal_idx)


def make_uv_sphere(radius: float = 0.45, stacks: int = 16, slices: int = 32) -> ObjMesh:
    """Latitude/longitude sphere with smooth normals and equirect uvs."""
    positions, normals, tex_coords = [], [], []
    for i in range(stacks + 1):
        theta = np.pi * i / stacks
        for j in range(slices + 1):
            phi = 2 * np.pi * j / slices
            n = [
                np.sin(theta) * np.cos(phi),
                np.cos(theta),
                np.sin(theta) * np.sin(phi),
            ]
            normals.append(n)
            positions.append([radius * c for c in n])
            tex_coords.append([j / slices, 1.0 - i / stacks])
    idx = []
    cols = slices + 1
    for i in range(stacks):
        for j in range(slices):
            a = i * cols + j
            b = a + cols
            if i != 0:
                idx.append([a, a + 1, b])
            if i != stacks - 1:
                idx.append([a + 1, b + 1, b])
    idx = np.asarray(idx, np.int32)
    return _mesh(positions, tex_coords, normals, idx, idx, idx)


def checker_texture(size: int = 256, cells: int = 8,
                    c0=(40, 40, 200), c1=(230, 230, 230)) -> np.ndarray:
    """(size, size, 3) u8 checkerboard for demo texturing."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cell = size // cells
    mask = ((xx // cell) + (yy // cell)) % 2 == 0
    out = np.where(mask[..., None], np.array(c0, np.uint8), np.array(c1, np.uint8))
    return out.astype(np.uint8)


def flat_normal_texture(size: int = 256) -> np.ndarray:
    """Normal map encoding the +z normal (value 0.5 -> byte 127/128ish)."""
    out = np.empty((size, size, 3), np.uint8)
    out[..., 0] = 128
    out[..., 1] = 128
    out[..., 2] = 255
    return out


def to_geom(mesh: ObjMesh) -> dict:
    """Geometry dict in the frame-function input format."""
    return {
        "positions": mesh.positions,
        "tex_coords": mesh.tex_coords,
        "normals": mesh.normals,
        "pos_idx": mesh.pos_idx,
        "tex_idx": mesh.tex_idx,
        "normal_idx": mesh.normal_idx,
    }


def make_textures(size: int = 256) -> dict:
    """Full texture set (diffuse/normal/tangent-normal/specular) for demos."""
    return {
        "texture": checker_texture(size),
        "normal_map": flat_normal_texture(size),
        "normal_map_tangent": flat_normal_texture(size),
        "specular_map": np.full((size, size, 3), 8, np.uint8),
    }
