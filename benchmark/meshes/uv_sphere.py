"""The ``uv_sphere`` mesh generator: a frozen copy of
``tiny_renderer_tpu_torch.models.procedural.make_uv_sphere`` (radius, stacks,
slices; the same vertex order, uvs and normals), a latitude/longitude
sphere with smooth normals and equirect uvs."""

import numpy as np


def make(spec: dict) -> dict:
    radius, stacks, slices = spec["radius"], spec["stacks"], spec["slices"]
    positions, normals, tex_coords = [], [], []
    for i in range(stacks + 1):
        theta = np.pi * i / stacks
        for j in range(slices + 1):
            phi = 2 * np.pi * j / slices
            n = [np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)]
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
    idx = np.asarray(idx, np.int32).reshape(-1, 3)
    return {
        "positions": np.asarray(positions, np.float32).reshape(-1, 3),
        "tex_coords": np.asarray(tex_coords, np.float32).reshape(-1, 2),
        "normals": np.asarray(normals, np.float32).reshape(-1, 3),
        "pos_idx": idx, "tex_idx": idx.copy(), "normal_idx": idx.copy(),
    }
