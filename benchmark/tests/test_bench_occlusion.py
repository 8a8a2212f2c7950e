"""The diablo-occlusion configuration: its plain reference against the
program's CPU frames at a small size, its bfloat16 control over the limit,
the reference's probe checked by hand, and its cell found by name."""

import json
import math
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from benchmark import harness, orbit, roofline_probe, scenes

CELL = "diablo-occlusion.orbit-burst"
REF = harness.reference_module("occlusion")


def small():
    cell = harness.find_cell(CELL)
    cell.config.update(width=128, height=96)
    cell.config["mesh"].update(stacks=14, slices=18)
    cell.config["maps"]["size"] = 64
    return cell


def test_reference_equals_program_cpu():
    """The program's CPU frames, through the cell's own burst loop, against
    the reference: within the limit, no overflow on either side, and the
    probe darkens some covered pixels."""
    cell = small()
    seed = 2**31 + 23
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
    frame = sample.items[0][0]
    covered = frame.sum(-1) > 0
    assert (frame[covered][:, 0] < 255).any() and (frame[covered][:, 0] == 255).any()
    assert (frame[..., 0] == frame[..., 1]).all() and (frame[..., 1] == frame[..., 2]).all()


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


def _axis_angle(axis, angle):
    """Rodrigues' rotation about a unit axis, in float64."""
    x, y, z = axis
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + math.sin(angle) * k + (1.0 - math.cos(angle)) * (k @ k)


@pytest.mark.parametrize("b, want", [
    ((0.0, 0.0, 2.0), np.eye(3)),                                   # aligned: the identity
    ((0.0, 0.0, -1.0), np.diag([1.0, -1.0, -1.0])),                 # opposite: 180 degrees about x
    ((1.0, 0.0, 0.0), _axis_angle((0.0, 1.0, 0.0), math.pi / 2)),   # +z to +x: 90 degrees about +y
    ((0.0, 3.0, 0.0), _axis_angle((-1.0, 0.0, 0.0), math.pi / 2)),  # +z to +y: 90 degrees about -x
    ((1.0, 0.0, 1.0), _axis_angle((0.0, 1.0, 0.0), math.pi / 4)),
    ((0.3, 0.0, -0.95), _axis_angle((0.0, 1.0, 0.0), math.atan2(0.3, -0.95))),
])
def test_rotation_between_closed_forms(b, want):
    """rotation_between(+z, b) against closed-form rotations; it takes +z
    onto b's direction, except where b is opposite (nalgebra: None)."""
    z = torch.tensor([0.0, 0.0, 1.0])
    got = REF.rotation_between(z, torch.tensor(b, dtype=torch.float32)).double().numpy()
    np.testing.assert_allclose(got, want, atol=2e-7)
    if b[2] != -1.0:
        np.testing.assert_allclose(got @ [0.0, 0.0, 1.0], np.array(b) / np.linalg.norm(b), atol=2e-7)


@pytest.mark.parametrize("k", [0, 1, 5, 16])
@pytest.mark.parametrize("delta", [0.5, 1.5, 10.0, 40.0])
def test_probe_update_on_a_depth_buffer(k, delta):
    """A synthetic depth buffer holding the fragment's depth f at its own
    texel and f + delta at the texels of exactly k of the 16 samples (the
    rest at f - 3): the coefficient is 1 - (k / 16) min(delta / 20, 1)
    where delta passes the threshold 1.0, else 1."""
    W = H = 8
    mesh = {"positions": np.zeros((3, 3), np.float32), "pos_idx": np.array([[0, 1, 2]])}
    ref = REF.OcclusionReference(mesh, W, H)
    f = 100.0
    buffer = torch.full((H * W,), f - 3.0)
    buffer[0] = f
    buffer[1:1 + k] = f + delta
    # Shadow coordinates rounding to texels 0 (the fragment) and 1..16.
    texel = torch.arange(17, dtype=torch.float32)
    sc = torch.stack([texel % W + 0.3, torch.div(texel, W, rounding_mode="floor") - 0.4, torch.zeros(17)], -1)
    vals = ref._read(buffer, sc)
    occ = REF.occlusion_update(vals[1:], vals[0], ref.threshold, ref.scale)
    want = 1.0 - k / 16 * min(delta / 20, 1.0) if delta > 1.0 else 1.0
    assert float(occ) == pytest.approx(want, abs=1e-6)


def test_cell_found_and_its_metrics():
    """The cell reports burst_fps, setup_s and the probe's two metrics, no
    other; the probe's least work at the cell's size is bound by bytes."""
    cell = harness.find_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"burst_fps", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"probe_span_ms.occlusion", "probe_roofline.occlusion"}
    assert cell.config["pipeline"] == cell.config["reference"] == "occlusion"
    assert cell.config["render_config"] == {} and cell.entry["chips"] == 1
    assert roofline_probe.FLOPS_PER_PIXEL == 702
    nbytes, flops = roofline_probe.probe_bytes(800, 800, 70_000), roofline_probe.probe_flops(70_000)
    assert roofline_probe.least_seconds(800, 800, 70_000) == pytest.approx(nbytes / 3.35e12)
    assert flops / 67e12 < nbytes / 3.35e12


@pytest.mark.card
def test_control_at_cell_size(card):
    """On the GPU at the cell's own size, three seeds: the program reads
    under the limit, the bfloat16 control over it (benchmark/control.py)."""
    out = subprocess.run([sys.executable, str(harness.BENCH_DIR / "control.py"), "--workload", CELL,
                          "--seconds", "3", "--seeds", "2147483911", "2147483912", "2147483913"],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    limit = harness.find_cell(CELL).config["limits"]["mismatch_pct"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        print(CELL, r["seed"], "program", r["program_mismatch_pct"], "control", r["control_bf16_mismatch_pct"])
        assert r["correct"] and r["program_mismatch_pct"] <= limit < r["control_bf16_mismatch_pct"]
