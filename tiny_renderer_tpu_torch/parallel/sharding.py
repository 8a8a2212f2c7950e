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
torch.device per shard and this process issues every shard's work on that
shard's device.  A device may repeat: ``[torch.device("cuda", 0)] * 5`` is
five shards on one card, ``[torch.device("cpu")] * 8`` eight on the CPU.
The results are gathered on the mesh's first device.

A render is cut into segments at its collectives: a segment is the work of
every shard between two collectives, and a collective (all_gather over
"rows", the stage handoff, the final gather) is a copy of the shards'
outputs into the buffers the next segment reads.  On CUDA devices each
segment is captured once per device, for all the shards on that device, as
a CUDA graph (pipelines.graphs) and replayed after; the collectives run as
copies between the replays, since a graph lives on one device.  That is the
port's counterpart of JAX's one compiled program per sharded jit, keyed as
JAX keys it (the pipeline's registration generation included) plus the
mesh.  On CPU devices the same segments and collectives run eagerly.

The geometry and textures are placed on each device once, outside any
capture, and cached by the source tensors' addresses (_placed): the graphs
read the copies in place, so a copy made per call would defeat the key.
A texture plane the pipeline packs is packed there too, once per source.

Every sharded output equals the single-device render bit for bit: the row
shards bin against their own window with its tile-row offset, which gives
each tile the same candidates in the same order as the full-frame bin.
config.row_bands bands only the single-device raster: each shard bins its
window in one launch, as in the JAX package, and K2's gate reads the
frame's row_bands, so row_bands > 1 keeps the shards on K1.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from ..ops import mathlib as ml
from ..ops.vertex import triangle_setup
from ..pipelines import shaders
from ..pipelines.frame import (
    PIPELINES,
    _assemble_shade,
    _camera_pass_and_shade,
    _check_config,
    _fused_raster,
    _graph_key,
    _light_pass,
    _planes_spec,
    _uniforms,
    _use_fused_raster,
    _with_packed_plane,
    registry_generation,
)
from ..pipelines.graphs import GRAPH_CACHE_SIZE, CapturedGraph, GraphCache, signature

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

    def key(self):
        """The mesh as a graph key sees it: its devices, their layout and
        the axis names."""
        return tuple(self.devices.flat), self.devices.shape, self.axis_names


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
    """A dict of tensors on `device` (no copy when already there)."""
    return {k: v.to(device) for k, v in value.items()}


# Placed copies of geometry and textures: (source signature, device,
# packing) -> (source, copy), least recently used evicted first.  An entry
# holds its source, so the source's addresses cannot be reused by other
# tensors while the entry lives.
_PLACED = collections.OrderedDict()
_PLACED_SIZE = 64
_PLACED_LOCK = threading.Lock()


def _placed(tensors, device, pipeline=None, config=None):
    """`tensors` (a dict) on `device`, made once per source (by address),
    device and, for textures (`pipeline` given), the pipeline's packed plane
    in config's layout: packed on the source's device, then copied."""
    pack = None if pipeline is None else (shaders.PIPELINE_MAPS[pipeline], config.tex_tile)
    key = (signature(tensors), torch.device(device), pack)
    with _PLACED_LOCK:
        hit = _PLACED.get(key)
        if hit is None:
            src = tensors if pipeline is None else _with_packed_plane(tensors, pipeline, config)
            hit = _PLACED[key] = (tensors, _to(src, device))
            while len(_PLACED) > _PLACED_SIZE:
                _PLACED.popitem(last=False)
        else:
            _PLACED.move_to_end(key)
        return hit[1]


def _all_gather(parts, device, out=None):
    """all_gather over "rows" as the shard on `device` sees it: the shards'
    parts in shard order, concatenated along the first axis, copied into
    `out` (a buffer the next segment reads in place) or a new tensor."""
    if out is None:
        rows = sum(p.shape[0] for p in parts)
        out = torch.empty((rows, *parts[0].shape[1:]), dtype=parts[0].dtype, device=device)
    r = 0
    for p in parts:
        out[r:r + p.shape[0]].copy_(p, non_blocking=True)
        r += p.shape[0]
    return out


def _rows_per_shard(config, n_rows, backend):
    if config.height % n_rows != 0:
        raise ValueError(f"height {config.height} not divisible by rows axis {n_rows}")
    rows = config.height // n_rows
    if backend == "kernel" and rows % config.tile_h != 0:
        raise ValueError(f"shard height {rows} not divisible by tile_h {config.tile_h}")
    return rows


def _captures(devices):
    """Whether the segments on `devices` are captured as CUDA graphs: on
    CUDA devices; on the CPU they run eagerly."""
    return all(torch.device(d).type == "cuda" for d in devices)


class _Program:
    """A sharded render's segments on its shards: one state dict per shard
    ("d": its index in its row group, "dev": its device, its placed "geom"
    and "textures", and whatever its segments and collectives store).

    run() runs a segment on a list of shards, device by device: eagerly, or
    (capture) as that device's CUDA graph of the segment, captured at its
    first run and replayed after.  `hold`: the source tensors whose
    addresses key the program, kept alive with it (the states hold their
    placed copies).  A captured segment leaves its outputs in
    the shards' states as the graph's static tensors, which each replay
    overwrites.  gather() is a collective's copy: into a new tensor when
    eager, into the buffer the first run allocated when captured, so that
    the next segment's graph reads it in place.  Callers hold `lock` around
    a render and their reads of its outputs."""

    def __init__(self, kind, pipeline, capture, states, hold=()):
        self.kind, self.pipeline, self.capture = kind, pipeline, capture
        self.states = states
        self.hold = tuple(hold)
        self.graphs = {}  # (segment name, device) -> CapturedGraph
        self.lock = threading.Lock()

    def run(self, name, segment, shards, inputs=()):
        groups = collections.defaultdict(list)
        for st in shards:
            groups[st["dev"]].append(st)
        for dev, group in groups.items():
            def fn(*ins, group=group):
                for st in group:
                    segment(st, *ins)

            if not self.capture:
                fn(*(x.to(dev) for x in inputs))
                continue
            graph = self.graphs.get((name, dev))
            if graph is None:
                graph = self.graphs[name, dev] = CapturedGraph(
                    fn, inputs, f"the {name} segment of the {self.kind} of pipeline "
                    f"{self.pipeline!r} on {dev}", device=dev)
            graph(*inputs)

    def gather(self, st, key, parts):
        """st[key] = the all_gather of `parts` on st's device."""
        st[key] = _all_gather(parts, st["dev"], st.get(key) if self.capture else None)


# Sharded programs by key (_program_key), as JAX keeps its sharded jits'
# executables.
_PROGRAMS = GraphCache(size=GRAPH_CACHE_SIZE)


def _program_key(kind, pipeline, config, backend, gen, geom, textures, inputs, mesh, devices):
    """frame._graph_key (the pipeline, the resolved config, the backend,
    `gen`, the geometry's and textures' addresses, the per-frame inputs'
    signature) plus the mesh and the devices of the program's shards."""
    return (_graph_key(kind, pipeline, config, backend, gen, geom, textures, inputs), mesh.key(),
            tuple(devices))


def _program(kind, pipeline, config, backend, geom, textures, inputs, mesh, shards, eager):
    """The program of `kind` on `shards` ([(row index d, device)]): from the
    cache when captured (a new one on a miss), a new eager one otherwise.
    Each shard's state holds the geometry and packed textures placed on
    its device."""
    devices = [dev for _, dev in shards]
    capture = not eager and _captures(devices)

    def make():
        states = [dict(d=d, dev=dev, geom=_placed(geom, dev),
                       textures=_placed(textures, dev, pipeline, config)) for d, dev in shards]
        return _Program(kind, pipeline, capture, states, hold=[*geom.values(), *textures.values()])

    if not capture:
        return make()
    key = _program_key(kind, pipeline, config, backend, registry_generation(pipeline), geom, textures,
                       inputs, mesh, devices)
    return _PROGRAMS.get(key, make)


def _frame_segments(pipeline, config, backend, needs_z, n, rows):
    """One frame over a group of n row shards of `rows` rows (JAX
    _render_shard under shard_map) as [(name, segment, collective)]: each
    segment runs on one shard's state, the first on the four view vectors;
    a collective (or None) runs after it on the program and the group's
    states.  Segments with no collective between them are one segment.
    The last leaves each shard's "frame", "z" (None unless needs_z),
    "shadow" slab and (1,) "ovf" flag."""
    spec = PIPELINES[pipeline]
    two_pass = spec.two_pass
    tri = config.shard_triangles and n > 1
    replicate = two_pass and config.replicate_pass1
    compact = backend == "kernel" and config.compact_shade
    # (setup key, triangle_setup keywords) of the passes' vertex stages.
    passes = ([("setup1", dict(matrix_key="shadow_matrix", cull=False))] if two_pass else []) + [
        ("setup", dict(needs=spec.needs))]

    def vertex(st, *view):
        u1, st["uniforms"] = _uniforms(spec, config, *view)
        us = {"setup1": u1, "setup": st["uniforms"]}
        for key, kw in passes:
            if tri:
                st[key + " part"] = _triangle_part(st["geom"], us[key], config, st["d"], n, **kw)
            else:
                st[key] = triangle_setup(st["geom"], us[key], config, **kw)

    def gather_setups(prog, states):
        # The setups' all_gather over the triangle axis, in shard order (the
        # depth tie-break's triangle order); coord_overflow any-reduced by
        # the next segment.
        for st in states:
            for key, _ in passes:
                for k in states[0][key + " part"]:
                    prog.gather(st, (key, k), [s[key + " part"][k] for s in states])

    def light(st):
        if tri:
            for key, _ in passes:
                setup = {k: st[key, k] for k in st[key + " part"]}
                setup["coord_overflow"] = setup["coord_overflow"].any()
                st[key] = setup
        setup1, setup = st.get("setup1"), st["setup"]
        y0 = st["d"] * rows
        pspec = _planes_spec(pipeline, st["textures"], config) if compact else None
        # replicate_pass1 needs the full-height light pass: not the fused
        # per-window kernel.
        st["fused"] = not replicate and _use_fused_raster(spec, config, backend, setup, pspec, needs_z)
        if st["fused"]:
            # Both passes' rasters in one launch: their flags go together.
            st["shadow"], st["idx"], ovf1, ovf2 = _fused_raster(setup1, setup, config, rows=rows, y0=y0)
            st["ovf1"] = ovf1 | ovf2
        elif replicate:
            # The full-height light pass on every shard: no collective, n
            # times the pass-1 work, the same map as the all_gather.  As a
            # window of all the rows it is one launch (row shards take no
            # row bands).
            st["map"], st["ovf1"] = _light_pass(setup1, config, backend, rows=config.height)
            st["shadow"] = st["map"][y0:y0 + rows]
        elif two_pass:
            st["shadow"], st["ovf1"] = _light_pass(setup1, config, backend, rows=rows, y0=y0)
        else:
            st["shadow"] = torch.full((rows, config.width), ml.F32_MIN, dtype=torch.float32,
                                      device=st["dev"])
            st["ovf1"] = torch.zeros((), dtype=torch.bool, device=st["dev"])

    def gather_map(prog, states):
        # The one collective of a two-pass frame: the whole shadow map.
        for st in states:
            prog.gather(st, "map", [s["shadow"] for s in states])

    def camera(st):
        y0 = st["d"] * rows
        if st["fused"]:
            st["frame"] = _assemble_shade(st["setup"], st["idx"], pipeline, st["uniforms"],
                                          st["textures"], config, st["map"], compact, (), y_offset=y0)
            st["z"], ovf = None, st["ovf1"]
        else:
            st["frame"], st["z"], ovf2 = _camera_pass_and_shade(
                st["setup"], st["uniforms"], pipeline, st["textures"], config, backend,
                st["map"] if two_pass else None, needs_z, rows=rows, y0=y0,
            )
            ovf = st["ovf1"] | ovf2
        st["ovf"] = ovf.reshape(1)

    steps = [("vertex", vertex, gather_setups if tri else None),
             ("light", light, gather_map if two_pass and not replicate else None),
             ("camera", camera, None)]
    return _merged(steps)


def _merged(steps):
    """[(name, segment, collective)] with each run of segments that has no
    collective between them joined into one segment (the first of a run
    takes the inputs)."""
    out, run = [], []
    for i, (name, seg, coll) in enumerate(steps):
        run.append((name, seg))
        if coll is None and i < len(steps) - 1:
            continue
        segs = [s for _, s in run]

        def joined(st, *ins, segs=segs):
            segs[0](st, *ins)
            for s in segs[1:]:
                s(st)

        out.append(("+".join(n for n, _ in run), joined, coll))
        run = []
    return out


def _triangle_part(geom, uniforms, config, d, n, **kw):
    """Shard d's part of the vertex stage sharded over the triangle axis:
    originals [d*Tp, (d+1)*Tp) of the triangles (the arrays edge-padded to
    n*Tp, the padding marked invalid), with its coord_overflow as a (1,)
    flag under the same key."""
    T = geom["pos_idx"].shape[0]
    Tp = -(-T // n)
    local = dict(geom)
    for k, a in geom.items():
        if k in _TRI_KEYS or k.startswith("attr:"):
            padded = torch.cat([a, a[-1:].expand(n * Tp - T, *a.shape[1:])])
            local[k] = padded[d * Tp:(d + 1) * Tp]
    s = triangle_setup(local, uniforms, config, **kw)
    gid = d * Tp + torch.arange(Tp, device=s["valid"].device)
    s["valid"] = s["valid"] & (gid < T)
    s["coord_overflow"] = s["coord_overflow"].reshape(1)
    return s


def _render_group(prog, segments, shards, view):
    """One frame's segments and collectives on one row group's shards."""
    for i, (name, segment, collective) in enumerate(segments):
        prog.run(name, segment, shards, view if i == 0 else ())
        if collective is not None:
            collective(prog, shards)


def render_frame_sharded(geom, textures, light_direction, look_from, look_at, up, *, pipeline,
                         config, mesh, backend="kernel", needs_z=True):
    """Row-sharded single frame over the mesh's "rows" axis.  Returns
    dict(frame (H,W,3) u8, z (H,W) f32 or None unless needs_z, shadow (H,W)
    f32, overflow 0-d bool), the single-device render_frame's outputs, on
    the mesh's first device: new tensors, which no later call overwrites.

    On CUDA devices the frame's segments are captured at the first call for
    a key (_program_key: the pipeline, the resolved config, backend,
    needs_z, the pipeline's registration generation, the geometry's and
    textures' addresses, the mesh) and replayed after, the four view
    vectors copied in; a capture that fails raises, naming the segment and
    the pipeline.  On CPU devices they run eagerly.

    config.height must be divisible by the "rows" axis size and, on the
    kernel backend, each shard's rows by tile_h.  backend: "kernel" (the
    default; the JAX function defaults to its dense "jnp", which served its
    CPU demo) or "dense".  needs_z=False skips the camera pass's z target.
    """
    return _frame_sharded(geom, textures, (light_direction, look_from, look_at, up),
                          pipeline=pipeline, config=config, mesh=mesh, backend=backend,
                          needs_z=needs_z, eager=False)


def _frame_sharded(geom, textures, view, *, pipeline, config, mesh, backend, needs_z, eager):
    """render_frame_sharded; eager=True runs the segments eagerly on any
    device (the eager side of the checks on the card)."""
    config = config.resolve(pipeline)
    _check_config(config, pipeline, backend)
    row_devices = list(mesh.devices.reshape(-1, mesh.shape["rows"])[0])
    rows = _rows_per_shard(config, len(row_devices), backend)
    out_dev = row_devices[0]
    prog = _program(f"sharded frame (needs_z={needs_z})", pipeline, config, backend, geom, textures,
                    view, mesh, list(enumerate(row_devices)), eager)
    segments = _frame_segments(pipeline, config, backend, needs_z, len(row_devices), rows)
    with prog.lock:
        _render_group(prog, segments, prog.states, view)
        states = prog.states
        # Any shard hitting a binning cap or the coord exactness envelope
        # is surfaced, as in render_frame.
        return {
            "frame": _all_gather([st["frame"] for st in states], out_dev),
            "z": _all_gather([st["z"] for st in states], out_dev) if needs_z else None,
            "shadow": _all_gather([st["shadow"] for st in states], out_dev),
            "overflow": _all_gather([st["ovf"] for st in states], out_dev).any(),
        }


def render_batch_sharded(geom, textures, light_directions, look_froms, look_at, up, *, pipeline,
                         config, mesh, backend="kernel", needs_z=True):
    """A batch of frames on a ("batch", "rows") mesh.

    light_directions/look_froms: (B, 3), split over "batch" (group g renders
    frames [g*B/n, (g+1)*B/n)); each frame's rows are sharded over "rows".
    Returns frames (B, H, W, 3), z (B, H, W) or None unless needs_z, and a
    per-frame (B,) overflow flag, on the mesh's first device.  backend as
    render_frame_sharded.

    On CUDA devices each group's frame segments are captured once (a group
    on the same devices as another shares its graphs) and replayed per
    frame with that frame's light and camera copied in; the frames, z and
    flags are copied into the outputs asynchronously, with no host sync.
    On CPU devices the segments run eagerly.
    """
    return _batch_sharded(geom, textures, light_directions, look_froms, look_at, up,
                          pipeline=pipeline, config=config, mesh=mesh, backend=backend,
                          needs_z=needs_z, eager=False)


def _batch_sharded(geom, textures, light_directions, look_froms, look_at, up, *, pipeline, config,
                   mesh, backend, needs_z, eager):
    """render_batch_sharded; eager as _frame_sharded."""
    config = config.resolve(pipeline)
    _check_config(config, pipeline, backend)
    n_batch, n_rows = mesh.shape["batch"], mesh.shape["rows"]
    B = light_directions.shape[0]
    if B % n_batch != 0:
        raise ValueError(f"batch {B} not divisible by batch axis {n_batch}")
    rows = _rows_per_shard(config, n_rows, backend)
    per_group = B // n_batch
    out_dev = mesh.devices.flat[0]
    H, W = config.height, config.width
    frames = torch.empty((B, H, W, 3), dtype=torch.uint8, device=out_dev)
    zs = torch.empty((B, H, W), dtype=torch.float32, device=out_dev) if needs_z else None
    flags = torch.empty((B, n_rows), dtype=torch.bool, device=out_dev)
    segments = _frame_segments(pipeline, config, backend, needs_z, n_rows, rows)
    view0 = (light_directions[0], look_froms[0], look_at, up)
    progs = [_program(f"batch-sharded frame (needs_z={needs_z})", pipeline, config, backend, geom,
                      textures, view0, mesh, list(enumerate(mesh.devices[g])), eager)
             for g in range(n_batch)]
    for b in range(B):
        prog = progs[b // per_group]
        with prog.lock:
            _render_group(prog, segments, prog.states, (light_directions[b], look_froms[b], look_at, up))
            _all_gather([st["frame"] for st in prog.states], out_dev, frames[b])
            if needs_z:
                _all_gather([st["z"] for st in prog.states], out_dev, zs[b])
            _all_gather([st["ovf"] for st in prog.states], out_dev, flags[b])
    return {"frame": frames, "z": zs, "overflow": flags.any(1)}


def render_sequence_pipelined(geom, textures, light_directions, look_froms, look_at, up, *,
                              pipeline, config, mesh, backend="kernel"):
    """Two-pass pipeline parallelism over a ("stage", "rows") mesh.

    The passes are split across the "stage" axis and pipelined over the
    frame sequence: at step t, stage 0 rasterizes the light view of frame t
    (row-sharded over its "rows" group) while stage 1 runs the camera pass
    and shade of frame t-1 with the shadow map handed over at the end of
    step t-1.  B+1 steps; the gates t < B and t >= 1 skip the fill and
    drain work.  The handoff (the map, its overflow flags and the light's
    shadow_matrix, which the JAX function recomputes on stage 1) is a pure
    permutation, and the slab raster and shade are render_frame_sharded's,
    so every frame equals its single-device render.

    On CUDA devices stage 0's segment (the light slabs of a frame) and
    stage 1's (the camera pass and shade) are captured once per device and
    replayed at each step; the carry (map, flags, light matrix) lives in
    buffers that the handoff's copies fill between the replays.  On CPU
    devices the segments run eagerly.

    Only two-pass pipelines apply (ValueError otherwise); shard_triangles
    and replicate_pass1, pass-1 strategies that contradict the stage split,
    are refused.  The burst posture (no z targets).  Returns {"frame": (B,
    H, W, 3), "overflow": (B,)} on the mesh's first device.  backend as
    render_frame_sharded.
    """
    return _sequence_pipelined(geom, textures, light_directions, look_froms, look_at, up,
                               pipeline=pipeline, config=config, mesh=mesh, backend=backend,
                               eager=False)


def _sequence_pipelined(geom, textures, light_directions, look_froms, look_at, up, *, pipeline,
                        config, mesh, backend, eager):
    """render_sequence_pipelined; eager as _frame_sharded."""
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
    out_dev = mesh.devices.flat[0]
    B = light_directions.shape[0]
    H, W = config.height, config.width
    shards = [(d, dev) for stage in mesh.devices for d, dev in enumerate(stage)]
    prog = _program("pipelined sequence", pipeline, config, backend, geom, textures,
                    (light_directions[0], look_froms[0], look_at, up), mesh, shards, eager)
    stage0, stage1 = prog.states[:n], prog.states[n:]

    def light(st, light_direction, at, upv):
        # Stage 0: the light-view slab of frame t.  The light matrix
        # travels with the map, so stage 1 does not recompute the pass-1
        # uniforms.
        u1 = ml.shadow_pass_1_prepare(config, light_direction, at, upv)
        setup1 = triangle_setup(st["geom"], u1, config, matrix_key="shadow_matrix", cull=False)
        st["shadow"], ovf1 = _light_pass(setup1, config, backend, rows=rows, y0=st["d"] * rows)
        st["ovf1"] = ovf1.reshape(1)
        st["matrix"] = u1["shadow_matrix"]

    def shade(st, light_direction, look_from, at, upv):
        # Stage 1: the camera pass and shade of frame t-1 with the carry.
        u = ml.shadow_pass_2_prepare(config, light_direction, look_from, at, upv)
        u["shadow_matrix"] = st["carry matrix"]
        setup = triangle_setup(st["geom"], u, config, needs=spec.needs)
        st["frame"], _, ovf2 = _camera_pass_and_shade(
            setup, u, pipeline, st["textures"], config, backend, st["carry"], False, rows=rows,
            y0=st["d"] * rows,
        )
        st["ovf"] = (st["carry ovf"].any() | ovf2).reshape(1)

    frames = torch.empty((B, H, W, 3), dtype=torch.uint8, device=out_dev)
    flags = torch.empty((B, n), dtype=torch.bool, device=out_dev)
    with prog.lock:
        for t in range(B + 1):
            if t >= 1:
                prog.run("stage 1", shade, stage1,
                         (light_directions[t - 1], look_froms[t - 1], look_at, up))
                _all_gather([st["frame"] for st in stage1], out_dev, frames[t - 1])
                _all_gather([st["ovf"] for st in stage1], out_dev, flags[t - 1])
            if t < B:
                prog.run("stage 0", light, stage0, (light_directions[t], look_at, up))
                # The all_gather within stage 0's group and the handoff to
                # stage 1, shard by shard.
                for st in stage1:
                    prog.gather(st, "carry", [s["shadow"] for s in stage0])
                    prog.gather(st, "carry ovf", [s["ovf1"] for s in stage0])
                    prog.gather(st, "carry matrix", [stage0[st["d"]]["matrix"]])
    return {"frame": frames, "overflow": flags.any(1)}
