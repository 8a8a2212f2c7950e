"""Screen-space triangle scenes that stress the raster kernel.

Test data for ``ops.raster_cuda``: the triangles are given in screen
pixels, so a scene set up through a matrix that keeps x and y (the identity,
or x and y swapped) lands exactly where the kernel's tile, sub-tile and warp
borders are.  Everything is made from a seed with numpy.
"""

from __future__ import annotations

import numpy as np


def screen_scene(tris, seed):
    """Triangles given in screen space, (T, 3, 3) of (x, y, depth), as a
    geometry dict with seeded uv and normals (set up through a matrix that
    maps them onto the screen as they are)."""
    rng = np.random.default_rng(seed)
    n = len(tris)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    nrm = rng.normal(size=(3 * n, 3)).astype(np.float32)
    return {"positions": np.asarray(tris, np.float32).reshape(-1, 3),
            "tex_coords": rng.uniform(-0.1, 1.1, (3 * n, 2)).astype(np.float32),
            "normals": nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
            "pos_idx": idx, "tex_idx": idx, "normal_idx": idx}


def adversarial(w, h, seed=0, n_hot=2000):
    """Seeded screen-space scenes, name -> (T, 3, 3) f32 of (x, y, depth),
    that stress the raster kernel's cull and block split on a w x h screen
    of 32x128 bin tiles, 8x32 sub-tiles and 4x8 rects (csrc/raster.cu).
    Ties between different triangles sit at depth 0, where every evaluation
    order gives exactly 0; "signed0" is meant to have its depth lanes set to
    -0.0 and +0.0 after binning, pair by pair (triangles 2k and 2k + 1 are
    equal).  n_hot: triangles in the hot bin tile."""
    rng = np.random.default_rng(seed)

    def with_z(xy, z=None):
        z = rng.uniform(-0.9, 0.9, xy.shape[:2]) if z is None else np.broadcast_to(z, xy.shape[:2])
        return np.concatenate([xy, z[..., None]], -1).astype(np.float32)

    # Whole-tile triangles, and four around the screen with vertices 12,000
    # px out (beyond the kernel's exact range: the cull's bound path).
    big = rng.uniform(0, [w, h], (40, 1, 2)) + rng.uniform(-250, 250, (40, 3, 2))
    ang = rng.uniform(0, 2 * np.pi, (4, 1)) + 2 * np.pi / 3 * np.arange(3)
    huge = np.stack([w / 2 + 12000 * np.cos(ang), h / 2 + 12000 * np.sin(ang)], -1)
    large = with_z(np.round(np.concatenate([big, huge])))
    # One-pixel triangles and slivers across bin-tile, sub-tile and rect
    # borders (a border and the pixel before it), both windings.
    bx = np.concatenate([np.arange(0, w, 128), np.arange(0, w, 16), np.arange(0, w, 8)])
    by = np.concatenate([np.arange(0, h, 32), np.arange(0, h, 8), np.arange(0, h, 4)])
    n = 900
    x = rng.choice(bx, n) - rng.integers(0, 2, n)
    y = rng.choice(by, n) - rng.integers(0, 2, n)
    h2 = rng.integers(1, 100, n)
    pt = lambda a, b: np.stack([a, b], -1)  # noqa: E731
    v = np.stack([  # (kind, triangle, vertex, xy)
        np.stack([pt(x, y), pt(x + 1, y), pt(x, y + 1)], 1),  # one pixel
        np.stack([pt(x - h2, y), pt(x + h2, y + 1), pt(x + h2, y)], 1),  # horizontal sliver
        np.stack([pt(x, y - h2), pt(x + 1, y + h2), pt(x, y + h2)], 1),  # vertical sliver
        np.stack([pt(x - h2, y - h2), pt(x + h2, y + h2 + 1), pt(x + h2, y + h2)], 1),  # diagonal
    ])[rng.integers(0, 4, n), np.arange(n)]
    flip = rng.integers(0, 2, n).astype(bool)
    v[flip] = v[flip][:, ::-1]
    borders = with_z(np.clip(v, 0, [w - 1, h - 1]).astype(np.float64))
    # Small triangles inside one bin tile, half of them at depth 0 (exact
    # ties between different triangles, across record chunks).
    x0, y0 = w // 2 // 128 * 128, h // 2 // 32 * 32
    c = rng.uniform([x0 + 4, y0 + 4], [x0 + 123, y0 + 27], (n_hot, 1, 2))
    z = rng.uniform(-0.9, 0.9, (n_hot, 3))
    z[::2] = 0.0
    hot = with_z(np.round(c + rng.uniform(-3, 3, (n_hot, 3, 2))), z)
    # Exact ties across sub-tile and bin-tile borders: 60 triangles centred
    # on borders, half of them at depth 0, each three times (slots i,
    # i + 60, i + 120).
    c = np.stack([rng.choice(np.arange(0, w, 32), 60), rng.choice(np.arange(8, h, 8), 60)], -1)
    z = rng.uniform(-0.9, 0.9, (60, 3))
    z[::2] = 0.0
    t = with_z(np.round(c[:, None] + rng.uniform(-30, 30, (60, 3, 2))), z)
    ties = np.concatenate([t, t, t])
    # Pairs of identical triangles apart from each other, on a 52 x 50 px
    # grid, whose depth lanes the caller sets to -0.0 and +0.0 after binning.
    cols, rows = max(1, (w - 8) // 52), max(1, (h - 8) // 50)
    p = np.arange(min(150, cols * rows))
    c = np.stack([24 + 52 * (p % cols), 24 + 50 * (p // cols)], -1)[:, None]
    pairs = with_z(np.round(c + rng.uniform(-20, 20, (len(p), 3, 2))), 0.0)
    return {"large": large, "borders": borders, "hot": hot, "ties": ties,
            "signed0": np.repeat(pairs, 2, axis=0)}
