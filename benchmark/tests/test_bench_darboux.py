"""The diablo-darboux configuration: its plain reference against the
program's CPU frames at a small size, its bfloat16 control over the limit,
the reference's basis solve checked by hand, the shade's least work, and
its cell found by name with its three metrics read from a stand-in
snapshot."""

import json
import math
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from benchmark import harness, orbit, roofline_darboux, scenes

CELL = "diablo-darboux.orbit-burst"
REF = harness.reference_module("darboux")
METRICS = ("darboux_span_ms.darboux", "darboux_setup_ms.darboux", "darboux_roofline.darboux")


def small():
    cell = harness.find_cell(CELL)
    cell.config.update(width=128, height=96)
    cell.config["mesh"].update(stacks=14, slices=18)
    cell.config["maps"]["size"] = 64
    return cell


def test_reference_equals_program_cpu():
    """The program's CPU frames, through the cell's own burst loop, against
    the reference: within the limit, no overflow on either side, and the
    diffuse term both lights and blackens covered pixels."""
    cell = small()
    seed = 2**31 + 29
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
    ref = REF.make(cell.config, mesh, maps, "cpu")
    u = ref.uniforms(light, look_from, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    covered = torch.unique(ref._fragments(ref._setup(u["vpmv"], u["camera_direction"])[0])[0]).numel()
    assert 0.2 < frame.any(-1).sum() / covered < 0.8


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


def _rotation(axis, angle):
    """Rodrigues' rotation about a unit axis, in float64."""
    x, y, z = axis
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + math.sin(angle) * k + (1.0 - math.cos(angle)) * (k @ k)


@pytest.mark.parametrize("axis, angle", [((0.0, 0.0, 1.0), 0.0), ((0.0, 1.0, 0.0), 0.7),
                                         ((0.6, 0.0, 0.8), -1.9), ((0.48, 0.6, 0.64), 2.6)])
def test_basis_solve_by_hand(axis, angle):
    """One fragment on an orthonormal basis (the rows of a rotation): the
    inverse is the transpose; the solves give the tangent and bitangent as
    the transpose times (du, 0) and (dv, 0); a tangent-space (0, 0, 1)
    sample gives back the interpolated normal, and (1, 0, 0) the normalized
    tangent."""
    rot = _rotation(axis, angle)
    basis = torch.tensor(rot, dtype=torch.float32)
    np.testing.assert_allclose(REF.inverse3(basis).double().numpy(), rot.T, atol=3e-7)
    row0, row1, normal = basis[0], basis[1], basis[2] * 2.5  # the normal need not be unit
    du, dv = torch.tensor([0.03, -0.01]), torch.tensor([0.02, 0.05])
    got = REF.darboux_normal(normal, row0, row1, du, dv, torch.tensor([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(got.numpy(), rot[2], atol=3e-7)
    tangent = rot.T @ [0.03, -0.01, 0.0]
    got = REF.darboux_normal(normal, row0, row1, du, dv, torch.tensor([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(got.numpy(), tangent / np.linalg.norm(tangent), atol=3e-7)


def test_singular_basis_renders_black():
    """A basis whose determinant is exactly zero (nalgebra: None, the
    upstream panics) gives NaN, which `as u8` makes black."""
    row = torch.tensor([1.0, 0.0, 0.0])
    got = REF.darboux_normal(torch.tensor([0.0, 1.0, 0.0]), row, row, torch.tensor([0.1, 0.2]),
                             torch.tensor([0.3, 0.1]), torch.tensor([0.0, 0.6, 0.8]))
    assert torch.isnan(got).all()
    assert int(REF._cast_int(got[0] * 200.0 + (1.0 - got[0]) * 0.0, 0.0, 255.0)) == 0


def test_roofline_count():
    """The least work of the shade at a known pixel count: 9 B and 142 f32
    operations a covered pixel, bound by bytes at the H100's peaks."""
    assert roofline_darboux.FLOPS_PER_PIXEL == 142
    assert roofline_darboux.darboux_bytes(70_000) == 630_000
    assert roofline_darboux.darboux_flops(70_000) == 9_940_000
    assert roofline_darboux.least_seconds(800, 800, 70_000) == pytest.approx(630_000 / 3.35e12)
    assert 9_940_000 / 67e12 < 630_000 / 3.35e12


def _frame(darboux, setup, pixels):
    stages = {"vertex": 0.03, "darboux_setup": setup, "binning": 0.3, "raster": 0.03, "shade": 0.3,
              "darboux": darboux}
    return {"stages": stages, "span_ms": sum(stages.values()), "chunks": 1, "covered": 9000,
            "pixels": pixels, "pixels_counter": "darboux.pixels"}


def test_cell_found_and_its_metrics():
    """The cell reports burst_fps, setup_s and the three darboux metrics, no
    other; the readers give the median of a stand-in stretch's frames, and
    nothing where the frames hold no darboux stage (the parent's)."""
    cell = harness.find_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"burst_fps", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert cell.config["pipeline"] == cell.config["reference"] == "darboux"
    assert cell.config["render_config"] == {} and cell.entry["chips"] == 1 and cell.entry["traffic"] == "orbit-burst"
    r = harness.Readings(None, cell.config, 5096, {}, None)
    frames = [_frame(0.40, 0.06, 70_000), _frame(0.50, 0.05, 72_000), _frame(0.45, 0.07, 71_000)]
    snap = {"spans": [], "frames": frames, "counters": {}, "dropped": {"spans": 0, "frames": 0}, "launches": {}}
    r.program_trace = {"orbit-burst": {"snapshot": snap, "window_s": 1.0, "steps": 1}}
    got = {name: harness.metric_reader(name).read(r) for name in METRICS}
    share = 100.0 * roofline_darboux.least_seconds(800, 800, 71_000) / 0.45e-3
    assert got == pytest.approx({METRICS[0]: 0.45, METRICS[1]: 0.06, METRICS[2]: share})
    assert 0.0 < got[METRICS[2]] <= 100.0
    parent = [{"stages": {"vertex": 0.03, "shade": 0.7}, "span_ms": 0.73, "chunks": 1, "covered": 9000,
               "pixels": None}]
    r.program_trace = {"orbit-burst": {"snapshot": dict(snap, frames=parent), "window_s": 1.0, "steps": 1}}
    assert all(harness.metric_reader(name).read(r) is None for name in METRICS)


@pytest.mark.card
def test_control_at_cell_size(card):
    """On the GPU at the cell's own size, three seeds: the program reads
    under the limit, the bfloat16 control over it (benchmark/control.py)."""
    out = subprocess.run([sys.executable, str(harness.BENCH_DIR / "control.py"), "--workload", CELL,
                          "--seconds", "3", "--seeds", "2147483921", "2147483922", "2147483923"],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    limit = harness.find_cell(CELL).config["limits"]["mismatch_pct"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        print(CELL, r["seed"], "program", r["program_mismatch_pct"], "control", r["control_bf16_mismatch_pct"])
        assert r["correct"] and r["program_mismatch_pct"] <= limit < r["control_bf16_mismatch_pct"]
