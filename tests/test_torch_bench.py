"""Torch port: the bench harness (tiny_renderer_tpu_torch.bench) against
the JAX package's (the root bench.py).

The configs, the angle tracks and the JSON line's keys are bench.py's (its
four TPU-only keys dropped, `device` added); --knob is checked before any
device op, and --backend cuda without a card raises instead of running on
the CPU.  bench_config runs on the CPU at 64x64 on a small sphere: its
times are finite and positive, its checksums are those of the port's
render_burst on the same angles, and the burst's frames lie within the
repo's tie-flip budget (fewer than 0.5% of pixels differ) of the JAX
package's burst on the jnp backend.  A spawned child returns what the
same call returns in process.
"""

import json
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_renderer_tpu import RenderConfig as JRenderConfig
from tiny_renderer_tpu.pipelines import frame as jframe
from tiny_renderer_tpu.scene import Scene as JScene
from tiny_renderer_tpu_torch import Model, RenderConfig, Scene
from tiny_renderer_tpu_torch import bench as tbench
from tiny_renderer_tpu_torch.convert import to_tensor
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.pipelines import frame as tframe

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import bench as jbench  # noqa: E402  (the root bench.py; numpy only at import)

SIZE = 64
TPU_KEYS = ("chip_mxu_tflops", "chip_gather_ns_per_row", "chip_health", "probe_note")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def sphere():
    return Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))


def test_configs_are_jax_benchs():
    assert tbench.CONFIGS == jbench.CONFIGS
    assert tbench.STRESS == ("diablo", "phong", True, 2)  # bench.py:391


@pytest.mark.parametrize("orbit", [False, True])
@pytest.mark.parametrize("n", [9, 64])
def test_angle_tracks_are_jax_expression(orbit, n):
    base = tbench.track_base(3)
    assert 0.0 <= base < 1e-2 and base == tbench.track_base(3) != tbench.track_base(4)
    # bench.py:135-139, with `base` given.
    step = 0.05 if orbit else 1e-4
    cam = (0.37 + base + step * np.arange(n)).astype(np.float32)
    lig = (-0.6 + base + (0.03 if orbit else 1e-4) * np.arange(n)).astype(np.float32)
    got = tbench.angle_tracks(n, orbit, base)
    for g, w in zip(got, (cam, lig)):
        assert g.dtype == np.float32 and g.shape == (n,)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("knobs", [(), ("tex_tile=16", "fuse_passes=true")])
def test_payload_keys_are_jax_minus_tpu_plus_device(knobs):
    headline = {"ms_per_frame": 5.0, "asset": "diablo", "pipeline": "shadow",
                "scene": "uv-sphere stand-in for diablo, 5096 triangles"}
    want = jbench.headline_payload(headline, {"mxu_tflops": None, "gather_ns_per_row": 7.3}, knobs)
    got = json.loads(json.dumps(tbench.headline_payload(headline, "NVIDIA H100, 700.00 W", 800, knobs)))
    assert list(got) == [k for k in want if k not in TPU_KEYS] + ["device"]
    assert got["value"] == want["value"] == 5.0 and got["unit"] == "ms"
    assert got["vs_baseline"] is None and got["device"] == "NVIDIA H100, 700.00 W"
    assert got["metric"].startswith("ms/frame diablo (uv-sphere stand-in for diablo, 5096 triangles) "
                                    "800x800 phong+shadow")
    if knobs:
        assert got["knobs"] == want["knobs"] == list(knobs)


def _no_device(*_a, **_k):
    raise AssertionError("a config ran")


def test_bad_knob_raises_before_any_device_op(monkeypatch):
    monkeypatch.setattr(tbench, "bench_config", _no_device)
    monkeypatch.setattr(tbench, "bench_in_child", _no_device)
    monkeypatch.setattr(torch.cuda, "is_available", _no_device)
    with pytest.raises(ValueError, match="tex_tle"):
        tbench.main(["--knob", "tex_tle=16"])


def test_cuda_backend_without_card_raises(monkeypatch):
    monkeypatch.setattr(tbench, "bench_config", _no_device)
    monkeypatch.setattr(tbench, "bench_in_child", _no_device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--backend cuda"):
        tbench.main(["--size", str(SIZE), "--frames", "9"])
    with pytest.raises(RuntimeError, match="--backend cuda"):
        tbench.main(["--all", "--stress", "--backend", "cuda"])


@pytest.mark.parametrize("asset,subdivide,tris", [
    ("african_head", 0, 2496), ("diablo", 0, 5096), ("diablo", 2, 81536)])
def test_stand_in_scenes(asset, subdivide, tris):
    if asset == "african_head":
        assert tbench.head_standin().num_triangles == 2496
    model, name = tbench.bench_scene(asset, subdivide)
    assert model.num_triangles == tris
    assert name.startswith(f"uv-sphere stand-in for {asset}") and name.endswith(f"{tris} triangles")
    assert model.texture.shape == (1024, 1024, 3)


def test_main_times_each_config_in_a_child(monkeypatch, capsys):
    jobs = []

    def fake_child(**job):
        jobs.append(job)
        asset = job["asset"] + (f"_x{4 ** job['subdivide']}" if job["subdivide"] else "")
        ms = 10.0 + len(jobs)
        return {"asset": asset, "pipeline": job["pipeline"], "scene": "s", "ms_per_frame": ms,
                "ms_per_frame_hostloop": ms, "blit_ms": 0.5, "fps": 1e3 / ms, "mtri_per_s": 1.0,
                "mpix_per_s": 1.0, "overflow": np.arange(job["frames"]) < len(jobs) - 1}

    monkeypatch.setattr(tbench, "bench_in_child", fake_child)
    monkeypatch.setattr(tbench, "bench_config", _no_device)
    assert tbench.main(["--all", "--stress", "--backend", "cpu", "--seed", "7", "--frames", "32",
                        "--knob", "tex_tile=16"]) == 0
    out, err = capsys.readouterr()
    assert [(j["asset"], j["pipeline"], j["orbit"], j["subdivide"]) for j in jobs] == (
        [c + (0,) for c in jbench.CONFIGS] + [tbench.STRESS])
    assert {(j["seed"], j["frames"], j["device"], j["size"], j["knobs"]) for j in jobs} == {
        (7, 32, "cpu", 800, ("tex_tile=16",))}
    lines = [ln for ln in err.splitlines() if ln.startswith("# ")]
    assert len(lines) == 6 and "diablo_x16" in lines[-1] and "shadow" in lines[3]
    assert all(f"overflow {i}/32 [s]" in ln for i, ln in enumerate(lines))
    payload = json.loads(out.splitlines()[-1])
    assert payload["value"] == 14.0  # the headline is diablo/shadow, the fourth config
    assert payload["device"] == "cpu" and payload["knobs"] == ["tex_tile=16"]


def _port_burst(model, pipeline, angles, keep_frames):
    scene = Scene(model, pipeline, RenderConfig(width=SIZE, height=SIZE), device="cpu")
    burst = tframe.make_burst_fn(pipeline, scene.config, keep_frames=keep_frames)
    return burst(scene._geom, scene._textures, *(to_tensor(a, "cpu") for a in angles))


@pytest.mark.parametrize("pipeline,orbit", [("shadow", False), ("occlusion", True)])
def test_bench_config_on_cpu(pipeline, orbit):
    model = sphere()
    r = tbench.bench_config("diablo", pipeline, orbit, frames=8, device="cpu", size=SIZE, seed=1,
                            model=model)
    assert (r["asset"], r["pipeline"]) == ("diablo", pipeline)
    assert r["scene"] == f"given model, {model.num_triangles} triangles"
    for key in ("ms_per_frame", "ms_per_frame_hostloop", "blit_ms", "fps", "mtri_per_s", "mpix_per_s"):
        assert math.isfinite(r[key]) and r[key] > 0, key
    n = 9  # frames=8: one frame past the 8-frame burst
    cam, lig = tbench.angle_tracks(n, orbit, tbench.track_base(1))
    np.testing.assert_array_equal(r["angles"][0], cam + np.float32(1e-5))
    np.testing.assert_array_equal(r["angles"][1], lig)
    assert r["checksums"].shape == (n,) and not r["overflow"].any()

    # The checksums are render_burst's on the same angles.
    port = _port_burst(model, pipeline, r["angles"], keep_frames=True)
    np.testing.assert_array_equal(r["checksums"], port["checksums"].numpy())
    frames = port["frames"].numpy()
    np.testing.assert_array_equal(
        r["checksums"], frames.reshape(n, -1).sum(1, dtype=np.int64) % 2**32)

    # The frames against the JAX package's burst (jnp backend).
    jscene = JScene(model, pipeline, JRenderConfig(width=SIZE, height=SIZE), backend="jnp")
    jburst = jframe.make_burst_fn(pipeline, jscene.config, backend="jnp", keep_frames=True)
    want = jburst(jscene._geom, jscene._textures, *(jnp.asarray(a) for a in r["angles"]))
    want_frames = np.asarray(want["frames"])
    assert not np.asarray(want["overflow"]).any()
    for i in range(n):
        assert (frames[i] > 0).any(-1).mean() > 0.05, i
        assert (frames[i] != want_frames[i]).any(-1).mean() < 0.005, i


def test_child_returns_what_the_process_returns(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    job = dict(asset="diablo", pipeline="phong", orbit=False, frames=9, device="cpu", size=32,
               seed=2, model=sphere())
    child = tbench.bench_in_child(**job)
    here = tbench.bench_config(**job)
    np.testing.assert_array_equal(child["checksums"], here["checksums"])
    for a, b in zip(child["angles"], here["angles"]):
        np.testing.assert_array_equal(a, b)
    assert child["scene"] == here["scene"] and math.isfinite(child["ms_per_frame"])
    with pytest.raises(RuntimeError, match="bench child for diablo/nope failed"):
        tbench.bench_in_child(**{**job, "pipeline": "nope"})
