"""The diablo-specular configuration: its plain reference against the
program's CPU frames at a small size, its bfloat16 control over the limit,
the reference's reflection and pow checked by hand on one texel, the
shade's least work, and its cell found by name with its two metrics read
from a stand-in snapshot."""

import json
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from benchmark import harness, orbit, roofline_specular, scenes

CELL = "diablo-specular.orbit-burst"
REF = harness.reference_module("specular")
METRICS = ("specular_span_ms.specular", "specular_roofline.specular")


def small():
    cell = harness.find_cell(CELL)
    cell.config.update(width=128, height=96)
    cell.config["mesh"].update(stacks=14, slices=18)
    cell.config["maps"]["size"] = 64
    return cell


def test_reference_equals_program_cpu():
    """The program's CPU frames, through the cell's own burst loop, against
    the reference: within the limit, no overflow on either side, and some
    covered pixels lit by a nonzero specular term (the reference without
    it differs from the program there)."""
    cell = small()
    seed = 2**31 + 37
    scene, mesh, maps = harness.build_scene(cell.config, seed, "cpu")
    loop_mod = harness.loop_module(cell.traffic["loop"])
    loop = loop_mod.Loop(scene, dict(cell.traffic, frames_per_call=6), seed)
    sample = orbit.Reservoir(64, seed)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        loop.window(0.0, sample)
        loop.window(0.0, sample)
    assert not any("coverage cap" in str(w.message) for w in warned)
    worst, over, ref_overflow = harness.check(cell, sample.items, mesh, maps, "cpu",
                                              loop_mod.reference_pose("cpu"))
    assert len(sample.items) == 12 and over == 0 and ref_overflow == 0
    assert worst <= cell.config["limits"]["mismatch_pct"]
    frame, pose = sample.items[0]
    light, look_from = loop_mod.reference_pose("cpu")(pose)
    dark = REF.SpecularReference(mesh, maps, 128, 96, specular_scale=0.0)
    no_spec, _ = dark.frame(light, look_from)
    lit = np.any(frame != no_spec, axis=-1) & frame.any(-1)
    assert lit.sum() >= 0.02 * frame.any(-1).sum()
    assert np.all(frame[lit].astype(int) >= no_spec[lit].astype(int))


def test_control_fails_the_limit():
    """The control, the reference in bfloat16, reads over the limit at
    every pose of a short orbit."""
    cell = small()
    mesh = harness.make_mesh(cell.config["mesh"])
    maps = scenes.maps(64, 9, "cpu")
    ref = REF.make(cell.config, mesh, maps, "cpu")
    low = REF.make(cell.config, mesh, maps, "cpu", dtype=torch.bfloat16)
    limit = cell.config["limits"]["mismatch_pct"]
    for i in range(6):
        light, look_from = orbit.device_vectors(*np.array([0.4 + 0.3 * i, 0.5 - 0.2 * i], np.float32), "cpu")
        assert harness._compare(low.frame(light, look_from)[0], ref.frame(light, look_from)[0]) > limit


@pytest.mark.parametrize("exponent", [1.0, 7.0, 40.0])
def test_reflection_and_pow_by_hand(exponent):
    """One texel under an identity it_m, in float64 by hand: the normal n
    (its decoded, normalized value), d = l . n, r = normalize(2 d n - l),
    spec = 0.6 max(r.z, 0)^e, and each channel (d + spec) c clamped at 255
    and truncated."""
    n = np.array([0.2, -0.3, 0.9])
    n /= np.linalg.norm(n)
    light = np.array([0.1, 0.25, 0.7])
    light /= np.linalg.norm(light)
    color = np.array([200.0, 90.0, 17.0])
    d = light @ n
    r = 2.0 * d * n - light
    r /= np.linalg.norm(r)
    spec = 0.6 * max(r[2], 0.0) ** exponent
    want = np.trunc(np.clip((d + spec) * color, 0.0, 255.0))
    got = REF.specular_shade(torch.tensor(color, dtype=torch.float32)[None],
                             torch.tensor(n, dtype=torch.float32)[None], torch.tensor([exponent]),
                             torch.eye(4), torch.tensor(light, dtype=torch.float32), torch.tensor(0.6))
    assert got.dtype == torch.uint8 and got.shape == (1, 3)
    assert np.abs(got[0].numpy().astype(int) - want).max() <= 1
    # The reflection about the normal keeps its angle: r . n = l . n.
    assert r @ n == pytest.approx(d)


def test_reflection_saturates_and_darkens():
    """A light behind the normal gives a negative diffuse term and no
    specular (r.z < 0 where the reflection points away from the camera):
    black; a light along the normal facing the camera, a spec of 0.6 that
    pushes a bright texel past 255: saturated."""
    n = torch.tensor([[0.0, 0.0, 1.0]])
    color = torch.tensor([[250.0, 100.0, 0.0]])
    black = REF.specular_shade(color, n, torch.tensor([3.0]), torch.eye(4), torch.tensor([0.0, 0.0, -1.0]),
                               torch.tensor(0.6))
    assert black.tolist() == [[0, 0, 0]]
    bright = REF.specular_shade(color, n, torch.tensor([3.0]), torch.eye(4), torch.tensor([0.0, 0.0, 1.0]),
                                torch.tensor(0.6))
    assert bright.tolist() == [[255, 160, 0]]


def test_roofline_count():
    """The least work of the shade at a known pixel count: 10 B and 72 f32
    operations a covered pixel, bound by bytes at the H100's peaks."""
    assert roofline_specular.FLOPS_PER_PIXEL == 72
    assert roofline_specular.specular_bytes(70_000) == 700_000
    assert roofline_specular.specular_flops(70_000) == 5_040_000
    assert roofline_specular.least_seconds(800, 800, 70_000) == pytest.approx(700_000 / 3.35e12)
    assert 5_040_000 / 67e12 < 700_000 / 3.35e12


def _frame(specular, pixels):
    stages = {"vertex": 0.03, "binning": 0.2, "raster": 0.02, "shade": 0.25, "specular": specular}
    return {"stages": stages, "span_ms": sum(stages.values()), "chunks": 1, "covered": 9000,
            "pixels": pixels, "pixels_counter": "specular.pixels"}


def test_cell_found_and_its_metrics():
    """The cell reports burst_fps, setup_s and the two specular metrics, no
    other; the readers give the median of a stand-in stretch's frames, and
    nothing where the frames hold no specular stage (the parent's)."""
    cell = harness.find_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"burst_fps", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert cell.config["pipeline"] == cell.config["reference"] == "specular"
    assert cell.config["render_config"] == {} and cell.entry["chips"] == 1 and cell.entry["traffic"] == "orbit-burst"
    assert (cell.config["width"], cell.config["height"], cell.config["maps"]["size"]) == (800, 800, 1024)
    r = harness.Readings(None, cell.config, 5096, {}, None)
    frames = [_frame(0.20, 70_000), _frame(0.25, 72_000), _frame(0.22, 71_000)]
    snap = {"spans": [], "frames": frames, "counters": {}, "dropped": {"spans": 0, "frames": 0}, "launches": {}}
    r.program_trace = {"orbit-burst": {"snapshot": snap, "window_s": 1.0, "steps": 1}}
    got = {name: harness.metric_reader(name).read(r) for name in METRICS}
    share = 100.0 * roofline_specular.least_seconds(800, 800, 71_000) / 0.22e-3
    assert got == pytest.approx({METRICS[0]: 0.22, METRICS[1]: share})
    assert 0.0 < got[METRICS[1]] <= 100.0
    parent = [{"stages": {"vertex": 0.03, "shade": 0.7}, "span_ms": 0.73, "chunks": 1, "covered": 9000,
               "pixels": None}]
    r.program_trace = {"orbit-burst": {"snapshot": dict(snap, frames=parent), "window_s": 1.0, "steps": 1}}
    assert all(harness.metric_reader(name).read(r) is None for name in METRICS)


@pytest.mark.card
def test_control_at_cell_size(card):
    """On the GPU at the cell's own size, three seeds: the program reads
    under the limit, the bfloat16 control over it (benchmark/control.py)."""
    out = subprocess.run([sys.executable, str(harness.BENCH_DIR / "control.py"), "--workload", CELL,
                          "--seconds", "3", "--seeds", "2147483931", "2147483932", "2147483933"],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    limit = harness.find_cell(CELL).config["limits"]["mismatch_pct"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        print(CELL, r["seed"], "program", r["program_mismatch_pct"], "control", r["control_bf16_mismatch_pct"])
        assert r["correct"] and r["program_mismatch_pct"] <= limit < r["control_bf16_mismatch_pct"]
