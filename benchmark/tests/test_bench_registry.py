"""BENCHMARK.json against the benchmark's contract, and everything a cell
needs found by name: a new cell is files and entries alone."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(harness.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        allowed = {"name", "unit", "better", "bound", "source", "workloads"} if m in BENCH["end_to_end"] \
            else {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    """Each cell's configuration, mix, metrics and reference resolve; every
    cell reports setup_s, another end-to-end metric and a per-layer metric,
    and each metric's reader gives the unit BENCHMARK.json gives."""
    c = harness.find_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    loop = harness.loop_module(c.traffic["loop"])
    assert hasattr(loop, "Loop") and hasattr(loop, "reference_pose")
    assert harness.make_mesh(c.config["mesh"])["pos_idx"].shape[0] == c.config["triangles"]
    for m in c.per_layer:
        assert harness.metric_reader(m["name"]).UNIT == m["unit"]
        assert m["moves"] in e2e
    assert hasattr(harness.reference_module(c.config["reference"]), "make")
    assert c.config["limits"]["mismatch_pct"] > 0


def test_per_layer_layers_are_perf_md_layers():
    """Each metric's layer is a row of PERF.md's table of layers, letter for letter."""
    perf = (ROOT / "PERF.md").read_text().split("## 3. Layers", 1)[1].split("\n## ", 1)[0]
    rows = {line.split("|")[1].strip() for line in perf.splitlines() if line.startswith("| ")}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert m["layer"] in rows, m["layer"]


def test_harness_names_no_cell():
    """run.py and the harness name no cell, configuration, mix or metric."""
    words = {w["name"] for w in BENCH["workloads"]} | {c["name"] for c in BENCH["configs"]}
    words |= {w["traffic"] for w in BENCH["workloads"]}
    words |= {m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"] if m["name"] != "setup_s"}
    for f in ("run.py", "harness.py"):
        text = (ROOT / "benchmark" / f).read_text()
        assert not [w for w in words if w in text], f


# A loop kind of its own, as a later PR would add it: each frame set and
# rendered twice (a second view), the second one fetched.
NEW_LOOP = """
import time

import numpy as np

from benchmark.orbit import Loop as _Base
from benchmark.orbit import host_vectors

AT, UP = np.zeros(3, np.float32), np.array([0.0, 1.0, 0.0], np.float32)


class Loop(_Base):
    def frame(self):
        cams, ligs = self.orbit.angles(self.n, 1)
        self.n += 1
        light, look_from = host_vectors(float(cams[0]), float(ligs[0]))
        self.scene.set_light_direction(light)
        self.scene.set_camera(-look_from, AT, UP)
        self.scene.render()
        self.scene.set_camera(look_from, AT, UP)
        self.scene.render()
        return self.scene.get_frame_buffer(), (light, look_from)

    def step(self):
        self.frame()

    def window(self, seconds, sample):
        n, t0 = 0, time.perf_counter()
        while True:
            frame, pose = self.frame()
            n += 1
            sample.offer(lambda: (frame, pose))
            t = time.perf_counter()
            if t - t0 >= seconds:
                return n, {"frame_ms": 1e3 * (t - t0) / n}

    def spans(self):
        return {"blit": [1e-3]}

    def traced(self):
        self.frame()
        return 1


def reference_pose(device):
    return lambda vectors: vectors
"""

# A mesh generator of its own: an octahedron.
NEW_MESH = """
import numpy as np


def make(spec):
    r = spec["radius"]
    p = np.array([[r, 0, 0], [-r, 0, 0], [0, r, 0], [0, -r, 0], [0, 0, r], [0, 0, -r]], np.float32)
    idx = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                    [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    uv = (p[:, :2] / (2 * r) + 0.5).astype(np.float32)
    n = p / r
    return {"positions": p, "tex_coords": uv, "normals": n,
            "pos_idx": idx, "tex_idx": idx.copy(), "normal_idx": idx.copy()}
"""


def test_new_cell_as_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration with a mesh generator
    of its own, a traffic mix with a loop kind of its own, a per-layer
    metric and a cell by new files and entries only; the cell then runs
    (on the CPU, small) and reports the new metric."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    (b / "meshes" / "octahedron.py").write_text(NEW_MESH)
    (b / "loops" / "two_views.py").write_text(NEW_LOOP)
    config = json.loads((b / "configs" / "diablo-shadow.json").read_text())
    config.update(mesh={"generator": "octahedron", "radius": 0.6}, triangles=8)
    config["maps"]["size"] = 512
    (b / "configs" / "octa-shadow.json").write_text(json.dumps(config))
    mix = json.loads((b / "traffic" / "interactive.json").read_text())
    mix.update(loop="two_views", camera_step_rad=0.1, light_step_rad=0.02)
    (b / "traffic" / "spin.json").write_text(json.dumps(mix))
    (b / "metrics" / "blit_max_ms.spin.py").write_text(
        'UNIT = "ms"\n\n\ndef read(r):\n    b = r.spans.get("blit")\n    return 1e3 * max(b) if b else None\n')
    bench["configs"].append({"name": "octa-shadow", "source": "https://example.org/cfg",
                             "file": "benchmark/configs/octa-shadow.json", "reduced": [],
                             "why": "an octahedron, maps at 512^2"})
    bench["workloads"].append({"name": "octa-shadow.spin", "config": "octa-shadow",
                               "traffic": "spin", "chips": 1, "why": "two views a frame"})
    for m in bench["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append("octa-shadow.spin")
    bench["per_layer"].append({"name": "blit_max_ms.spin", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "entry",
                               "moves": "frame_ms", "workloads": ["octa-shadow.spin"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # no file that was there changed
    cell = harness.find_cell("octa-shadow.spin", tmp_path)
    assert cell.config["maps"]["size"] == 512 and cell.traffic["loop"] == "two_views"
    assert harness.make_mesh(cell.config["mesh"], cell.bench_dir)["pos_idx"].shape == (8, 3)
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "tests" / "drive_run.py"),
                          "octa-shadow.spin", "--root", str(tmp_path), "--trace", "--seconds", "0.5"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"blit_max_ms.spin"}
