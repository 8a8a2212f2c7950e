"""The dense raster: every triangle at every pixel
(``tiny_renderer_tpu.ops.raster_jnp``).

For every pixel the winner is the fragment the reference's serial loop
leaves in the buffer: the strictly greatest interpolated z, ties keeping the
earliest polygon (shader.rs:169-180).  That is a scan over blocks of
``tri_block`` triangles in ascending index order: within a block ``argmax``
picks the first maximal z, across blocks a strict ``>`` keeps the earlier
block on ties.  No atomics and no scatter, so the result is the same run to
run.

Coverage tests are exact: the edge functions are int32 with |.| < 2^22
(scene.rs:174-197), so their sign tests equal the reference's f32
comparisons after its division.  z is the reference's f32 expression
((w*z1 + u*z2) + v*z3) with u = cx/cz, v = cy/cz, w = 1 - (cx+cy)/cz: by
division, where the tile raster multiplies by the reciprocal (DESIGN.md
divergence #3), so the two may pick different winners at exact-z ties.

The work is O(T * H * W) in (tri_block, H, W) blocks.  It is the
correctness backend (``render_frame(..., backend="dense")``) and plain torch
on any device: the JAX function runs outside any Pallas kernel, so there is
no kernel to port.
"""

from __future__ import annotations

import torch

from .mathlib import F32_MIN


def rasterize_dense(setup, height, width, tri_block=64, y_offset=0):
    """Dense raster over all triangles of a triangle_setup.

    height, width: the rows and columns to resolve; a row slab of a taller
    frame starts at global row y_offset (parallel.sharding).

    Returns z (height, width) f32, the winning depth (F32_MIN where
    uncovered, the reference's clear value, scene.rs:131), and idx
    (height, width) i32, the winning triangle (-1 where uncovered).
    """
    T = setup["a1"].shape[0]
    B = int(tri_block)
    dev = setup["a1"].device
    py, px = torch.meshgrid(
        torch.arange(y_offset, y_offset + height, dtype=torch.int32, device=dev),
        torch.arange(width, dtype=torch.int32, device=dev),
        indexing="ij",
    )
    z_cur = torch.full((height, width), F32_MIN, dtype=torch.float32, device=dev)
    i_cur = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    for t0 in range(0, T, B):
        blk = slice(t0, min(t0 + B, T))

        def col(k):
            return setup[k][blk, None, None]

        # (B, H, W) integer edge functions: exact.
        cx = col("a1") * px + col("b1") * py + col("c1")
        cy = col("a2") * px + col("b2") * py + col("c2")
        cz = col("cz")
        rest = cz - cx - cy
        pos = cz > 0
        inside = (
            torch.where(pos, cx >= 0, cx <= 0)
            & torch.where(pos, cy >= 0, cy <= 0)
            & torch.where(pos, rest >= 0, rest <= 0)
            & col("valid")
        )
        # The reference's f32 interpolation (scene.rs:192-196, shader.rs:174).
        cxf, cyf, czf = cx.to(torch.float32), cy.to(torch.float32), cz.to(torch.float32)
        u = cxf / czf
        v = cyf / czf
        w = 1.0 - (cxf + cyf) / czf
        zv = setup["zv"][blk, :, None, None]
        z = (w * zv[:, 0] + u * zv[:, 1]) + v * zv[:, 2]
        z = torch.where(inside, z, float("-inf"))
        # Within the block the first maximum (the lowest index) wins.
        k = torch.argmax(z, dim=0, keepdim=True)
        bz = torch.gather(z, 0, k)[0]
        bi = (k[0] + t0).to(torch.int32)
        # Across blocks a strict > keeps the earlier block on exact ties.
        better = bz > z_cur
        z_cur = torch.where(better, bz, z_cur)
        i_cur = torch.where(better, bi, i_cur)
    return z_cur, i_cur
