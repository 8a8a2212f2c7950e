"""One run of one benchmark cell.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``; its configuration in the file that entry names
(``configs/<config>.json``), whose mesh comes from the generator it names
(``meshes/<generator>.py``); its traffic mix in ``traffic/<mix>.json``, run
by the loop it names (``loops/<loop>.py``); each per-layer metric's reader
in ``metrics/<metric>.py``; the configuration's plain reference in
``reference/<reference>.py``.  This module names none of them.

A run: set-up (import, CUDA init, build, scene, capture, the loop's
warm-up), the measured window, then with ``trace`` the traced parts (host
spans, a profiled stretch of the same loop, and whatever the metric readers
ask for), then the comparison of the window's sampled frames with the
reference.  The program is driven only through its public API.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tiny_renderer_tpu")
# Frames of a window compared with the reference (a sample drawn from the seed).
SAMPLE = 16


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path = BENCH_DIR


def _reports(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def find_cell(name, root=ROOT):
    """The cell `name` of root/BENCHMARK.json, with its configuration,
    traffic mix and the metrics it reports."""
    bench = load_json(Path(root) / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(Path(root) / configs[entry["config"]]["file"])
    bench_dir = Path(root) / BENCH_DIR.name
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in reported]
    return Cell(name, entry, config, traffic, e2e, per_layer, bench_dir)


def _load(path, name):
    """The module of the file `path` (loaded by path: metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name, bench_dir=BENCH_DIR):
    """metrics/<name>.py: UNIT and read(readings) -> value or None."""
    return _load(Path(bench_dir) / "metrics" / f"{name}.py", f"benchmark_metric_{name.replace('.', '_')}")


def loop_module(kind, bench_dir=BENCH_DIR):
    """loops/<kind>.py: Loop(scene, traffic, seed) (see orbit.Loop) and
    reference_pose(device)."""
    path = Path(bench_dir) / "loops" / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"no traffic loop {kind!r}: {path} does not exist")
    return _load(path, f"benchmark_loop_{kind}")


def make_mesh(spec, bench_dir=BENCH_DIR):
    """The mesh a configuration's "mesh" entry names: meshes/<generator>.py's
    make(spec), a frozen generator, as a dict of numpy arrays with the keys
    of the program's ObjMesh (positions, tex_coords, normals, pos_idx,
    tex_idx, normal_idx)."""
    path = Path(bench_dir) / "meshes" / f"{spec['generator']}.py"
    if not path.is_file():
        raise ValueError(f"no mesh generator {spec['generator']!r}: {path} does not exist")
    return _load(path, f"benchmark_mesh_{spec['generator']}").make(spec)


def reference_module(name, bench_dir=BENCH_DIR):
    """reference/<name>.py: make(config, mesh, maps, device, dtype) -> an
    object whose frame(light, look_from) gives (presented frame, overflow)."""
    return _load(Path(bench_dir) / "reference" / f"{name}.py", f"benchmark_reference_{name}")


class Readings:
    """What a traced run hands the metric readers: host spans (seconds by
    name), the profiled stretch (tracing.Trace or None), the configuration,
    the triangles rendered, and the program's stage breakdown on demand
    (``stages()``, pipelines.profile.stage_breakdown of the run's Scene)."""

    def __init__(self, scene, config, triangles, spans, trace):
        self.config, self.triangles = config, triangles
        self.spans, self.trace = spans, trace
        self._scene, self._stages = scene, None

    def stages(self):
        if self._stages is None:
            from tiny_renderer_tpu_torch.pipelines.profile import stage_breakdown

            self._stages = stage_breakdown(self._scene)
        return self._stages


def _stamp(parts, name, t0):
    t = time.perf_counter()
    parts[name] = t - t0
    return t


def build_scene(config, seed, device, bench_dir=BENCH_DIR):
    """(Scene, mesh arrays, maps tensors) of a configuration."""
    from tiny_renderer_tpu_torch import Model, RenderConfig, Scene
    from tiny_renderer_tpu_torch.assets.obj import ObjMesh

    from . import scenes

    mesh = make_mesh(config["mesh"], bench_dir)
    maps = scenes.maps(config["maps"]["size"], seed, device)
    model = Model(mesh=ObjMesh(**mesh), **{k: v.cpu().numpy() for k, v in maps.items()})
    rc = RenderConfig(width=config["width"], height=config["height"], **config.get("render_config", {}))
    return Scene(model, config["pipeline"], config=rc, device=device), mesh, maps


def _compare(frame, ref):
    """Share of pixels (%) whose RGB differs from the reference's."""
    import numpy as np

    if frame.shape != ref.shape:
        return 100.0
    return 100.0 * float(np.any(frame != ref, axis=-1).mean())


def check(cell, sample, mesh, maps, device, pose):
    """Compare the sampled frames with the configuration's reference.

    sample: [(frame, pose)]; pose(p) -> (light, look_from).  Returns
    (worst mismatch %, frames over the limit, frames the reference flags
    as overflowed)."""
    import torch

    ref = reference_module(cell.config["reference"], cell.bench_dir).make(cell.config, mesh, maps, device)
    limit = cell.config["limits"]["mismatch_pct"]
    worst, over, ref_overflow = 0.0, 0, 0
    for frame, p in sample:
        light, look_from = pose(p)
        want, ovf = ref.frame(light, look_from)
        m = _compare(frame, want)
        worst = max(worst, m)
        over += m > limit
        ref_overflow += bool(ovf)
    del ref
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return worst, over, ref_overflow


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded in the process."""


def _forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit():
    """nvidia-smi's name and power limit of the card, or "not read"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def control_reading(cell, sample, mesh, maps, device, dtype):
    """The control's number: the worst mismatch (%) of the configuration's
    reference computed in `dtype`, put in the program's place, against the
    reference in its own precision, at the poses of the sampled frames."""
    ref_mod = reference_module(cell.config["reference"], cell.bench_dir)
    ref = ref_mod.make(cell.config, mesh, maps, device)
    low = ref_mod.make(cell.config, mesh, maps, device, dtype=dtype)
    pose = loop_module(cell.traffic["loop"], cell.bench_dir).reference_pose(device)
    worst = 0.0
    for _, p in sample:
        light, look_from = pose(p)
        worst = max(worst, _compare(low.frame(light, look_from)[0], ref.frame(light, look_from)[0]))
    return worst


def run(cell, seed, seconds, trace, device, t_start, log=print, keep=None):
    """One run of `cell` on `device`; returns the result dict (the line the
    benchmark prints).  t_start: perf_counter at the process's start.
    keep: a dict that receives the sampled frames, mesh and maps (for the
    control).  Raises ForbiddenModules when JAX or the JAX package was
    loaded."""
    import torch

    from . import orbit, tracing

    seed = int(seed) % (1 << 63)
    parts = {}
    cuda = torch.device(device).type == "cuda"
    t = _stamp(parts, "import", t_start)
    if cuda:
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    t = _stamp(parts, "cuda_init", t)
    if cuda:
        from tiny_renderer_tpu_torch.ops import raster_cuda
        from tiny_renderer_tpu_torch.pipelines import graphs

        raster_cuda.build()
        raster_cuda.build(source=graphs.IF_SOURCE)
    t = _stamp(parts, "build", t)
    scene, mesh, maps = build_scene(cell.config, seed, device, cell.bench_dir)
    t = _stamp(parts, "scene", t)

    loop_mod = loop_module(cell.traffic["loop"], cell.bench_dir)
    loop = loop_mod.Loop(scene, cell.traffic, seed)
    sample = orbit.Reservoir(SAMPLE, seed)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        loop.step()  # the first call captures the graph
        loop.sync()
        t = _stamp(parts, "capture", t)
        for _ in range(cell.traffic["warmup_steps"] - 1):
            loop.step()
        # Then the loop itself until warmup_seconds have passed: an H100
        # runs a new process's small kernels about a fifth slower for its
        # first 13 to 36 s, which the window has to miss.
        while time.perf_counter() - t < cell.traffic.get("warmup_seconds", 0.0):
            loop.step()
        loop.sync()
        t = _stamp(parts, "warm_up", t)
        setup_s = t - t_start
        log("setup: " + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items())
            + f"; setup_s {setup_s:.4f}")
        attempted, e2e = loop.window(seconds, sample)
        loop.sync()
    overflowed = sum("coverage cap" in str(w.message) for w in warned)
    found = _forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules of JAX or the JAX package were loaded: {found}")

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    if cuda:
        device_info["power"] = power_limit()
    e2e["setup_s"] = setup_s
    missing = [m["name"] for m in cell.end_to_end if m["name"] not in e2e]
    if missing:
        raise KeyError(f"the {cell.traffic['loop']!r} loop measures no {missing}")
    metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}

    breakdown = None
    if trace:
        spans = loop.spans()
        traced = None
        if cuda:
            events, frames = tracing.profile(loop.traced, device)
            traced = tracing.summarize(events, frames)
        readings = Readings(scene, cell.config, mesh["pos_idx"].shape[0], spans, traced)
        metrics = {}
        for m in cell.per_layer:
            reader = metric_reader(m["name"], cell.bench_dir)
            if reader.UNIT != m["unit"]:
                raise ValueError(f"metrics/{m['name']}.py gives {reader.UNIT!r}, "
                                 f"BENCHMARK.json says {m['unit']!r}")
            value = reader.read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if traced:
            device_info["busy_s"] = traced.busy_s
            device_info["window_s"] = traced.window_s
            breakdown = {"device_ops": traced.device_ops, "idle_gaps": traced.idle_gaps}
        del readings

    del loop, scene
    worst, over, ref_overflow = check(cell, sample.items, mesh, maps, device,
                                      loop_mod.reference_pose(device))
    if keep is not None:
        keep.update(sample=sample.items, mesh=mesh, maps=maps)
    failed = over + (overflowed > 0) + ref_overflow
    result = {"correct": failed == 0 and attempted > 0 and len(sample.items) > 0,
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown:
        result["breakdown"] = breakdown
    # The numbers compared, each beside its limit: the line's last key.
    result["compared"] = {
        "mismatch_pct": {"value": worst, "limit": cell.config["limits"]["mismatch_pct"]},
        "overflow_warnings": {"value": overflowed, "limit": 0},
        "reference_overflow": {"value": ref_overflow, "limit": 0}}
    return result
