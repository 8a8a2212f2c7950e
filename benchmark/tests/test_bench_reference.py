"""The plain reference against the program's CPU frames at a small size, its
control (the same reference in bfloat16) against the limit, and the
benchmark's scenes."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, orbit, scenes

REF = harness.reference_module("shadow")


def small(cell_name):
    cell = harness.find_cell(cell_name)
    cell.config.update(width=128, height=96)
    cell.config["mesh"].update(stacks=14, slices=18)
    cell.config["maps"]["size"] = 64
    return cell


def test_scenes_sizes():
    mesh = harness.make_mesh({"generator": "uv_sphere", "radius": 0.45, "stacks": 50, "slices": 52})
    assert mesh["pos_idx"].shape == (5096, 3) and mesh["tex_idx"].shape == (5096, 3)
    with pytest.raises(ValueError):
        harness.make_mesh({"generator": "no_such_generator"})
    maps = scenes.maps(16, 2**31 + 5, "cpu")
    assert maps["texture"].shape == (16, 16, 3) and maps["texture"].dtype == torch.uint8
    again = scenes.maps(16, 2**31 + 5, "cpu")
    assert all(torch.equal(maps[k], again[k]) for k in maps)
    n = maps["normal_map"].float() / 255 - 0.5
    assert (n.norm(dim=-1) > 0.3).all()  # encoded unit vectors, not flat


@pytest.mark.parametrize("cell_name", ["diablo-shadow.interactive", "diablo-shadow.orbit-burst"])
def test_reference_equals_program_cpu(cell_name):
    """The program's CPU frames (its torch twins of the kernels), through the
    cell's own loop, against the reference: within the limit, and equal on
    most frames."""
    cell = small(cell_name)
    seed = 2**31 + 11
    scene, mesh, maps = harness.build_scene(cell.config, seed, "cpu")
    loop_mod = harness.loop_module(cell.traffic["loop"])
    loop = loop_mod.Loop(scene, dict(cell.traffic, frames_per_call=6), seed)
    sample = orbit.Reservoir(64, seed)
    loop.window(0.0, sample)
    loop.window(0.0, sample)
    worst, over, ref_overflow = harness.check(cell, sample.items, mesh, maps, "cpu",
                                              loop_mod.reference_pose("cpu"))
    assert over == 0 and ref_overflow == 0
    assert worst <= cell.config["limits"]["mismatch_pct"]


def test_reference_pixels():
    """Frames are lit, textured and flipped for presentation: a pixel lit in
    the frame is the texture's texel scaled by the light."""
    cell = small("diablo-shadow.interactive")
    mesh = harness.make_mesh(cell.config["mesh"])
    maps = scenes.maps(64, 3, "cpu")
    ref = REF.make(cell.config, mesh, maps, "cpu")
    light, look_from = orbit.host_vectors(0.3, 0.2)
    frame, overflow = ref.frame(light, look_from)
    assert frame.shape == (96, 128, 3) and frame.dtype == np.uint8 and not overflow
    lit = frame.sum(-1) > 0
    assert 0.02 < lit.mean() < 0.5
    texels = maps["texture"].reshape(-1, 3).numpy()
    scale = frame[lit].astype(float) / np.maximum(texels.max(0), 1)
    assert (scale <= 1.0 + 1e-6).all()


def test_control_fails_the_limit():
    """The control, the reference in bfloat16, reads far over the limit
    at every pose of a short orbit (at this size as at the cell's)."""
    cell = small("diablo-shadow.orbit-burst")
    mesh = harness.make_mesh(cell.config["mesh"])
    maps = scenes.maps(64, 9, "cpu")
    sample = [(None, tuple(float(a) for a in np.array([0.4 + 0.3 * i, 0.5 - 0.2 * i], np.float32)))
              for i in range(6)]
    reading = harness.control_reading(cell, sample, mesh, maps, "cpu", torch.bfloat16)
    assert reading > 3 * cell.config["limits"]["mismatch_pct"]


@pytest.mark.card
@pytest.mark.parametrize("cell_name", ["diablo-shadow.orbit-burst", "diablo-shadow.interactive"])
def test_control_at_cell_size(card, cell_name):
    """On the GPU at the cell's own size, three seeds: the program reads
    under the limit, the bfloat16 control over it (benchmark/control.py)."""
    out = subprocess.run([sys.executable, str(harness.BENCH_DIR / "control.py"), "--workload", cell_name,
                          "--seconds", "3", "--seeds", "2147483901", "2147483902", "2147483903"],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    limit = harness.find_cell(cell_name).config["limits"]["mismatch_pct"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        print(cell_name, r["seed"], "program", r["program_mismatch_pct"], "control", r["control_bf16_mismatch_pct"])
        assert r["correct"] and r["program_mismatch_pct"] <= limit < r["control_bf16_mismatch_pct"]
