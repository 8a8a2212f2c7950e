"""Scale-out over screen-row shards, frame batches and the two passes
(``tiny_renderer_tpu.parallel.sharding``).

* "rows": the screen's y axis is sharded.  Triangles are replicated, so
  each shard bins, rasterizes and shades only its own row slab.  The one
  cross-shard dependency is the shadow map of two-pass pipelines: each
  shard's light-pass slab is all-gathered before the shade, whose shadow
  lookups may land on any row.
* "batch": a batch of camera/light states is split over groups of row
  shards (render_batch_sharded).
* the triangle axis (config.shard_triangles): each row shard transforms a
  contiguous T/n slice of the triangles and the setups are all-gathered
  before binning.
* "stage": the light pass of frame t runs on one row group while the other
  shades frame t-1 (render_sequence_pipelined).

Execution is single-controller, as with JAX's shard_map: a Mesh holds one
torch.device per shard, this process runs each shard's work in a Python
loop on that shard's device, and the collectives are plain data movement
(all_gather over "rows" is a torch.cat of the slabs moved to the consumer's
device; the handoff from stage 0 to stage 1 is a .to()).  A device may
repeat: ``[torch.device("cuda", 0)] * 5`` is five shards on one card,
``[torch.device("cpu")] * 8`` eight on the CPU.  The results are gathered
on the mesh's first device.

Every sharded output equals the single-device render bit for bit: the row
shards bin against their own window with its tile-row offset, which gives
each tile the same candidates in the same order as the full-frame bin.
config.row_bands bands only the single-device raster: each shard bins its
window in one launch, as in the JAX package, and K2's gate reads the
frame's row_bands, so row_bands > 1 keeps the shards on K1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import mathlib as ml
from ..ops.vertex import triangle_setup
from ..pipelines.frame import (
    PIPELINES,
    _assemble_shade,
    _camera_pass_and_shade,
    _check_config,
    _fused_raster,
    _light_pass,
    _planes_spec,
    _uniforms,
    _use_fused_raster,
    _with_packed_plane,
)

# Per-triangle geometry arrays that shard_triangles slices (plus "attr:*").
_TRI_KEYS = ("pos_idx", "tex_idx", "normal_idx", "pos_tri", "uv_tri", "normal_tri")


class Mesh:
    """Devices laid out along named axes: ``devices`` is an object array of
    torch.device with one dimension per name in ``axis_names``."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for axes {self.axis_names}")

    @property
    def shape(self):
        """{axis name: size}."""
        return dict(zip(self.axis_names, self.devices.shape))


def _devices(devices):
    """torch.devices from `devices`, or every visible CUDA device."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible; pass devices explicitly, e.g. "
                "[torch.device('cpu')] * 8"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    return [torch.device(d) for d in devices]


def _mesh(devices, groups, axis_names):
    """Mesh of `devices` split into `groups` rows along the first axis."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(groups, -1), axis_names)


def make_row_mesh(devices=None, batch: int = 1):
    """Mesh over ("batch", "rows"); batch=1 gives a pure row mesh.  devices
    defaults to every visible CUDA device."""
    devices = _devices(devices)
    if len(devices) % batch != 0:
        raise ValueError(f"{len(devices)} devices not divisible by batch={batch}")
    return _mesh(devices, batch, ("batch", "rows"))


def make_pp_mesh(devices=None):
    """Mesh over ("stage", "rows") for two-pass pipeline parallelism
    (render_sequence_pipelined): stage 0 rasterizes the light pass of frame
    t while stage 1 shades frame t-1.  Needs an even device count; each
    stage's group row-shards its own pass over "rows"."""
    devices = _devices(devices)
    if len(devices) % 2 != 0:
        raise ValueError(f"pipeline mesh needs an even device count, have {len(devices)}")
    return _mesh(devices, 2, ("stage", "rows"))


def _to(value, device):
    """A tensor, or a dict of tensors, on `device` (no copy when already
    there)."""
    if isinstance(value, dict):
        return {k: v.to(device) for k, v in value.items()}
    return value.to(device)


def _all_gather(parts, device):
    """all_gather over "rows" as the shard on `device` sees it: the shards'
    parts in shard order, concatenated along the first axis."""
    return torch.cat([p.to(device) for p in parts])


def _rows_per_shard(config, n_rows, backend):
    if config.height % n_rows != 0:
        raise ValueError(f"height {config.height} not divisible by rows axis {n_rows}")
    rows = config.height // n_rows
    if backend == "kernel" and rows % config.tile_h != 0:
        raise ValueError(f"shard height {rows} not divisible by tile_h {config.tile_h}")
    return rows


def _tri_sharded_setup(geoms, uniforms, config, devices, *, matrix_key="vpmv", cull=True,
                       needs=()):
    """The vertex stage sharded over the triangle axis: shard d transforms
    originals [d*Tp, (d+1)*Tp) of the triangles (the array edge-padded to
    n*Tp, the padding marked invalid) on its device, then the setups are
    all-gathered in shard order, so the original triangle order (the depth
    tie-break) is kept.  Returns each shard's full setup, n*Tp rows, with
    coord_overflow any-reduced."""
    n = len(devices)
    T = geoms[0]["pos_idx"].shape[0]
    Tp = -(-T // n)
    parts, ovfs = [], []
    for d, (geom, u) in enumerate(zip(geoms, uniforms)):
        local = dict(geom)
        for k, a in geom.items():
            if k in _TRI_KEYS or k.startswith("attr:"):
                padded = torch.cat([a, a[-1:].expand(n * Tp - T, *a.shape[1:])])
                local[k] = padded[d * Tp:(d + 1) * Tp]
        s = triangle_setup(local, u, config, matrix_key=matrix_key, cull=cull, needs=needs)
        gid = d * Tp + torch.arange(Tp, device=s["valid"].device)
        s["valid"] = s["valid"] & (gid < T)
        ovfs.append(s.pop("coord_overflow"))
        parts.append(s)
    out = []
    for dev in devices:
        s = {k: _all_gather([p[k] for p in parts], dev) for k in parts[0]}
        s["coord_overflow"] = _all_gather([o.reshape(1) for o in ovfs], dev).any()
        out.append(s)
    return out


def _render_rows(geom, textures, light_direction, look_from, look_at, up, *, pipeline, config,
                 devices, backend, needs_z):
    """One frame over a group of row shards, one per entry of `devices`
    (JAX _render_shard under shard_map, every shard in turn).  Returns the
    shards' outputs: lists of frame slabs, z slabs (None unless needs_z),
    shadow slabs and (1,) overflow flags, each on its shard's device."""
    spec = PIPELINES[pipeline]
    n = len(devices)
    rows = _rows_per_shard(config, n, backend)
    W = config.width
    ins = [dict(geom=_to(geom, dev), textures=_to(textures, dev),
                view=[v.to(dev) for v in (light_direction, look_from, look_at, up)])
           for dev in devices]

    # Uniforms and vertex stage of every shard.
    u1s, uniforms = zip(*(_uniforms(spec, config, *x["view"]) for x in ins))

    def setups_of(us, **kw):
        if config.shard_triangles and n > 1:
            return _tri_sharded_setup([x["geom"] for x in ins], us, config, devices, **kw)
        return [triangle_setup(x["geom"], u, config, **kw) for x, u in zip(ins, us)]

    setup1 = setups_of(u1s, matrix_key="shadow_matrix", cull=False) if spec.two_pass else None
    setup = setups_of(uniforms, needs=spec.needs)

    compact = backend == "kernel" and config.compact_shade
    pspec = _planes_spec(pipeline, textures, config) if compact else None
    frames, zs, shadows, ovfs = [], [], [], []
    # replicate_pass1 needs the full-height light pass: not the fused
    # per-window kernel.
    if (not (spec.two_pass and config.replicate_pass1)
            and _use_fused_raster(spec, config, backend, setup[0], pspec, needs_z)):
        fused = [_fused_raster(setup1[d], setup[d], config, rows=rows, y0=d * rows)
                 for d in range(n)]
        shadows = [f[0] for f in fused]
        for d, (dev, x) in enumerate(zip(devices, ins)):
            _, idx, ovf1, ovf2 = fused[d]
            frames.append(_assemble_shade(setup[d], idx, pipeline, uniforms[d], x["textures"],
                                          config, _all_gather(shadows, dev), compact, (),
                                          y_offset=d * rows))
            zs.append(None)
            ovfs.append((ovf1 | ovf2).reshape(1))
        return frames, zs, shadows, ovfs

    # Light pass of every shard, then the one collective: the whole map.
    ovf1s, full = [], []
    for d, dev in enumerate(devices):
        if not spec.two_pass:
            shadows.append(torch.full((rows, W), ml.F32_MIN, dtype=torch.float32, device=dev))
            ovf1s.append(torch.zeros((), dtype=torch.bool, device=dev))
            continue
        if config.replicate_pass1:
            # The full-height light pass on every shard: no collective, n
            # times the pass-1 work, the same map as the all_gather.  As a
            # window of all the rows it is one launch (row shards take no
            # row bands).
            shadow_full, ovf1 = _light_pass(setup1[d], config, backend, rows=config.height)
            full.append(shadow_full)
            shadows.append(shadow_full[d * rows:(d + 1) * rows])
        else:
            slab, ovf1 = _light_pass(setup1[d], config, backend, rows=rows, y0=d * rows)
            shadows.append(slab)
        ovf1s.append(ovf1)
    if spec.two_pass and not config.replicate_pass1:
        full = [_all_gather(shadows, dev) for dev in devices]
    for d, x in enumerate(ins):
        frame, z, ovf2 = _camera_pass_and_shade(
            setup[d], uniforms[d], pipeline, x["textures"], config, backend,
            full[d] if spec.two_pass else None, needs_z, rows=rows, y0=d * rows,
        )
        frames.append(frame)
        zs.append(z)
        ovfs.append((ovf1s[d] | ovf2).reshape(1))
    return frames, zs, shadows, ovfs


def render_frame_sharded(geom, textures, light_direction, look_from, look_at, up, *, pipeline,
                         config, mesh, backend="kernel", needs_z=True):
    """Row-sharded single frame over the mesh's "rows" axis.  Returns
    dict(frame (H,W,3) u8, z (H,W) f32 or None unless needs_z, shadow (H,W)
    f32, overflow 0-d bool), the single-device render_frame's outputs, on
    the mesh's first device.

    config.height must be divisible by the "rows" axis size and, on the
    kernel backend, each shard's rows by tile_h.  backend: "kernel" (the
    default; the JAX function defaults to its dense "jnp", which served its
    CPU demo) or "dense".  needs_z=False skips the camera pass's z target.
    """
    config = config.resolve(pipeline)
    _check_config(config, pipeline, backend)
    row_devices = list(mesh.devices.reshape(-1, mesh.shape["rows"])[0])
    out_dev = row_devices[0]
    frames, zs, shadows, ovfs = _render_rows(
        geom, _with_packed_plane(textures, pipeline, config), light_direction, look_from, look_at, up,
        pipeline=pipeline, config=config, devices=row_devices, backend=backend, needs_z=needs_z,
    )
    # Any shard hitting a binning cap or the coord exactness envelope is
    # surfaced, as in render_frame.
    return {
        "frame": _all_gather(frames, out_dev),
        "z": _all_gather(zs, out_dev) if needs_z else None,
        "shadow": _all_gather(shadows, out_dev),
        "overflow": _all_gather(ovfs, out_dev).any(),
    }


def render_batch_sharded(geom, textures, light_directions, look_froms, look_at, up, *, pipeline,
                         config, mesh, backend="kernel", needs_z=True):
    """A batch of frames on a ("batch", "rows") mesh.

    light_directions/look_froms: (B, 3), split over "batch" (group g renders
    frames [g*B/n, (g+1)*B/n)); each frame's rows are sharded over "rows".
    Returns frames (B, H, W, 3), z (B, H, W) or None unless needs_z, and a
    per-frame (B,) overflow flag, on the mesh's first device.  backend as
    render_frame_sharded.
    """
    config = config.resolve(pipeline)
    _check_config(config, pipeline, backend)
    n_batch, n_rows = mesh.shape["batch"], mesh.shape["rows"]
    B = light_directions.shape[0]
    if B % n_batch != 0:
        raise ValueError(f"batch {B} not divisible by batch axis {n_batch}")
    _rows_per_shard(config, n_rows, backend)
    per_group = B // n_batch
    out_dev = mesh.devices.flat[0]
    textures = _with_packed_plane(textures, pipeline, config)
    frames, zs, ovfs = [], [], []
    for b in range(B):
        f, z, _, o = _render_rows(
            geom, textures, light_directions[b], look_froms[b], look_at, up, pipeline=pipeline,
            config=config, devices=list(mesh.devices[b // per_group]), backend=backend,
            needs_z=needs_z,
        )
        frames.append(_all_gather(f, out_dev))
        zs.append(_all_gather(z, out_dev) if needs_z else None)
        ovfs.append(_all_gather(o, out_dev).any())
    return {
        "frame": torch.stack(frames),
        "z": torch.stack(zs) if needs_z else None,
        "overflow": torch.stack(ovfs),
    }


def render_sequence_pipelined(geom, textures, light_directions, look_froms, look_at, up, *,
                              pipeline, config, mesh, backend="kernel"):
    """Two-pass pipeline parallelism over a ("stage", "rows") mesh.

    The passes are split across the "stage" axis and pipelined over the
    frame sequence: at step t, stage 0 rasterizes the light view of frame t
    (row-sharded over its "rows" group) while stage 1 runs the camera pass
    and shade of frame t-1 with the shadow map handed over at the end of
    step t-1.  B+1 steps; the gates t < B and t >= 1 skip the fill and
    drain work.  The handoff (the map, its overflow flag and the light's
    shadow_matrix, which the JAX function recomputes on stage 1) is a pure
    permutation, and the slab raster and shade are render_frame_sharded's,
    so every frame equals its single-device render.

    Only two-pass pipelines apply (ValueError otherwise); shard_triangles
    and replicate_pass1, pass-1 strategies that contradict the stage split,
    are refused.  The burst posture (no z targets).  Returns {"frame": (B,
    H, W, 3), "overflow": (B,)} on the mesh's first device.  backend as
    render_frame_sharded.
    """
    config = config.resolve(pipeline)
    _check_config(config, pipeline, backend)
    spec = PIPELINES[pipeline]
    if not spec.two_pass:
        raise ValueError(
            f"pipeline {pipeline!r} is single-pass; pipeline parallelism "
            "splits the shadow pre-pass from the shade — use "
            "render_batch_sharded instead"
        )
    if config.shard_triangles or config.replicate_pass1:
        raise ValueError(
            "shard_triangles / replicate_pass1 are pass-1 strategies "
            "incompatible with the stage split"
        )
    if mesh.shape.get("stage") != 2 or "rows" not in mesh.shape:
        raise ValueError(f'mesh must have axes ("stage"=2, "rows"); got {mesh.shape}')
    n = mesh.shape["rows"]
    rows = _rows_per_shard(config, n, backend)
    stage0, stage1 = list(mesh.devices[0]), list(mesh.devices[1])
    out_dev = mesh.devices.flat[0]
    B = light_directions.shape[0]
    # Pack the texture plane once, then place each stage-1 shard's inputs.
    textures = _with_packed_plane(textures, pipeline, config)
    ins0 = [(_to(geom, dev), look_at.to(dev), up.to(dev)) for dev in stage0]
    ins1 = [(_to(geom, dev), _to(textures, dev), look_at.to(dev), up.to(dev)) for dev in stage1]

    # Frame t-1's map, pass-1 flag and light matrix, on stage 1.
    carry, carry_ovf, carry_matrix = None, None, None
    frames, ovfs = [], []
    for t in range(B + 1):
        # Stage 1: camera pass + shade of frame t-1 with the carried map.
        if t >= 1:
            slabs, flags = [], []
            for d, (g, tex, at, upv) in enumerate(ins1):
                dev = stage1[d]
                u = ml.shadow_pass_2_prepare(config, light_directions[t - 1].to(dev),
                                             look_froms[t - 1].to(dev), at, upv)
                u["shadow_matrix"] = carry_matrix[d]
                setup = triangle_setup(g, u, config, needs=spec.needs)
                frame, _, ovf2 = _camera_pass_and_shade(
                    setup, u, pipeline, tex, config, backend, carry[d], False, rows=rows,
                    y0=d * rows,
                )
                slabs.append(frame)
                flags.append((carry_ovf[d] | ovf2).reshape(1))
            frames.append(_all_gather(slabs, out_dev))
            ovfs.append(_all_gather(flags, out_dev).any())
        # Stage 0: the light-view slabs of frame t, the all_gather within
        # its group, and the handoff to stage 1 shard by shard.
        # The light matrix travels with the map, so stage 1 does not
        # recompute the pass-1 uniforms.
        if t < B:
            slabs, flags, matrices = [], [], []
            for d, (g, at, upv) in enumerate(ins0):
                light = light_directions[t].to(stage0[d])
                u1 = ml.shadow_pass_1_prepare(config, light, at, upv)
                setup1 = triangle_setup(g, u1, config, matrix_key="shadow_matrix", cull=False)
                slab, ovf1 = _light_pass(setup1, config, backend, rows=rows, y0=d * rows)
                slabs.append(slab)
                flags.append(ovf1.reshape(1))
                matrices.append(u1["shadow_matrix"])
            carry = [_all_gather(slabs, stage0[d]).to(stage1[d]) for d in range(n)]
            carry_ovf = [_all_gather(flags, stage0[d]).any().to(stage1[d]) for d in range(n)]
            carry_matrix = [matrices[d].to(stage1[d]) for d in range(n)]
    return {"frame": torch.stack(frames), "overflow": torch.stack(ovfs)}
