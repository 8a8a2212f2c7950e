"""Screen-tile triangle binning into a CSR incidence list
(``tiny_renderer_tpu.ops.binning``).

Each triangle is binned into every (tile_h x tile_w) tile its screen-clamped
bbox overlaps, up to max_span_y x max_span_x tiles.  The packed keys
``tile_id * K + tri_id`` are sorted, per-tile ranges come from
``searchsorted``, and within each tile triangle indices ascend — the
reference's polygon-order depth tie-break (shader.rs:169-180).  Coverage
caps (span clamp, global incidence cap) drop deterministically and are
reported through ``overflowed``.

With ``config.csr_indirect`` (the default) the result is the indirect
layout: the compact (T, lanes) record table plus the (cap,) sorted
triangle-id list the raster kernel indirects through.  Without it, the
records are gathered into CSR order, (cap, lanes), and the id list is None.
The JAX module also falls back to the gathered layout above SMEM/VMEM
budgets (binning.py:137-161, :277-281); those guard TPU on-chip memory walls
that a CUDA kernel reading device memory does not have, and are not ported.
"""

from __future__ import annotations

import torch

# Packed per-triangle base record layout (f32 lanes) for the raster kernel.
#   0: a1   1: b1   2: c1   3: a2   4: b2   5: c2
#   6: sgn (sign of cz, +-1)   7: |cz|   8: 1/cz
#   9: z1  10: z2  11: z3  12: global triangle index (exact in f32, T < 2^24)
# Varying lanes of a VARYING_SPECS entry follow (see record_lanes).
BASE_LANES = 13

_SENTINEL = 2**31 - 1


def _round_up(x, m):
    return -(-x // m) * m


def compact_scatter(mask, values, out_len, fill):
    """Front-compact values[mask] into an (out_len,) tensor, fill elsewhere.

    Positions come from a cumsum; entries that do not fit (or are masked
    out) go to one spare slot past the end, which is cut off — the JAX
    ``.at[].set(mode="drop")`` without a host sync."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask, pos, out_len).clamp(max=out_len)
    out = torch.full((out_len + 1,), fill, dtype=values.dtype, device=values.device)
    out[tgt] = values
    return out[:out_len]


def record_lanes(spec) -> int:
    n = BASE_LANES
    for _name, comps, mode in spec or ():
        if mode == "interp":
            n += 3 * comps
        elif mode == "const":
            n += comps
        elif mode.startswith("texidx"):
            n += 6
    return _round_up(max(n, 16), 8)


def pack_triangle_records(setup, spec=()):
    """(T, record_lanes(spec)) f32 record per triangle."""
    from ..pipelines.shaders import _CONST_SOURCES, _INTERP_SOURCES

    cz = setup["cz"]
    czf = cz.to(torch.float32)
    safe = torch.where(cz == 0, 1.0, czf)
    sgn = torch.where(czf < 0, -1.0, 1.0)
    T = cz.shape[0]
    cols = [
        setup[k].to(torch.float32) for k in ("a1", "b1", "c1", "a2", "b2", "c2")
    ] + [
        sgn,
        torch.abs(czf),
        1.0 / safe,
        setup["zv"][:, 0],
        setup["zv"][:, 1],
        setup["zv"][:, 2],
        torch.arange(T, dtype=torch.float32, device=cz.device),
    ]
    for name, comps, mode in spec or ():
        if mode == "interp":
            for c in range(comps):
                for v in range(3):
                    cols.append(_INTERP_SOURCES[name](setup, c, v))
        elif mode == "const":
            for c in range(comps):
                cols.append(setup[_CONST_SOURCES[name]][:, c])
        elif mode.startswith("texidx"):
            for c in range(2):
                for v in range(3):
                    cols.append(_INTERP_SOURCES["uv"](setup, c, v))
    rec = torch.stack(cols, dim=-1)
    pad = record_lanes(spec) - rec.shape[-1]
    return torch.nn.functional.pad(rec, (0, pad))


def incidence_cap(T: int, config) -> int:
    """Static CSR capacity: generous vs the typical ~1.3 incidences/triangle."""
    if config.max_incidences is not None:
        cap = config.max_incidences
    else:
        cap = max(4 * T, 4096)
    cap = min(cap, T * config.max_span_y * config.max_span_x)
    return _round_up(cap, 8)


def bin_triangles(setup, config, spec=(), row_tile_offset=0):
    """Bin triangles into screen tiles as a CSR incidence list.

    row_tile_offset: first global tile-row this bin covers (config then
    describes the local band); 0 for the full frame.

    Returns (records, tris, starts, overflowed):
      records: (T, record_lanes(spec)) f32 per-triangle table, or with
        config.csr_indirect=False the (cap, record_lanes(spec)) rows of that
        table in CSR order
      tris: (cap,) i32 triangle ids in (tile, triangle) order; slots past
        the real incidences hold T-1 (never read: they lie outside every
        tile's range).  None with config.csr_indirect=False.
      starts: (num_tiles + 1,) i32; tile t owns slots [starts[t], starts[t+1])
      overflowed: 0-d bool, a coverage cap was hit
    """
    th, tw = config.tile_h, config.tile_w
    n_tx, n_ty = config.tiles_x, config.tiles_y
    num_tiles = config.num_tiles
    msy, msx = config.max_span_y, config.max_span_x

    valid = setup["valid"]
    dev = valid.device
    T = valid.shape[0]
    # Key packing: key = tile_id * K + tri_id must fit in i32.
    K = 1 << int(T).bit_length()
    if num_tiles * K >= 2**31:
        raise ValueError(
            f"binning key overflow: {num_tiles} tiles x {T} triangles; "
            "use larger tiles or shard the screen"
        )
    cap = incidence_cap(T, config)

    tx0 = setup["x0"] // tw
    tx1 = setup["x1"] // tw
    ty0 = setup["y0"] // th - row_tile_offset
    ty1 = setup["y1"] // th - row_tile_offset
    valid = valid & (ty1 >= 0) & (ty0 <= n_ty - 1)
    ty0 = ty0.clamp(0, n_ty - 1)
    ty1 = ty1.clamp(0, n_ty - 1)
    span_x = tx1 - tx0
    span_y = ty1 - ty0
    span_clamped = (valid & ((span_x > msx - 1) | (span_y > msy - 1))).any()

    dy = torch.arange(msy, dtype=torch.int32, device=dev)
    dx = torch.arange(msx, dtype=torch.int32, device=dev)
    tile = (ty0[:, None, None] + dy[None, :, None]) * n_tx + (
        tx0[:, None, None] + dx[None, None, :]
    )  # (T, msy, msx) candidate tiles
    ok = (
        valid[:, None, None]
        & (dy[None, :, None] <= span_y[:, None, None])
        & (dx[None, None, :] <= span_x[:, None, None])
    )
    tri_ids = torch.arange(T, dtype=torch.int32, device=dev)
    key = torch.where(
        ok, tile * K + tri_ids[:, None, None],
        torch.tensor(_SENTINEL, dtype=torch.int32, device=dev),
    )
    total = ok.sum()
    if config.binning_compact:
        # Compact the real incidences (triangle-major; tail dropped on cap
        # overflow) before a cap-sized sort.
        sy = torch.clamp(span_y + 1, max=msy)
        sx = torch.clamp(span_x + 1, max=msx)
        counts = torch.where(valid, sy * sx, 0)
        base = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        local = dy[None, :, None] * sx[:, None, None] + dx[None, None, :]
        tgt = torch.where(ok, base[:, None, None] + local, cap).reshape(-1)
        compacted = torch.full((cap + 1,), _SENTINEL, dtype=torch.int32, device=dev)
        compacted[tgt.clamp(max=cap).long()] = key.reshape(-1)
        keys_sorted = torch.sort(compacted[:cap]).values
    else:
        keys_sorted = torch.sort(key.reshape(-1)).values

    boundaries = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev) * K
    starts = torch.searchsorted(keys_sorted, boundaries, right=False).to(torch.int32)
    starts = starts.clamp(max=cap)
    overflowed = (total > cap) | span_clamped

    csr_tris = (keys_sorted[:cap] & (K - 1)).clamp(max=T - 1).to(torch.int32)
    records = pack_triangle_records(setup, spec)
    if config.csr_indirect:
        return records, csr_tris, starts, overflowed
    return records[csr_tris.long()], None, starts, overflowed
