"""Torch port: the native C++ asset loader (assets/native.py) against NumPy and JAX.

The port builds its own copy of the loader source (csrc/asset_loader.cpp)
with g++ into tiny_renderer_tpu_torch/_build/ and never touches the JAX
package's native/ build.  Held here: identical bytes and dtypes to the
port's NumPy parsers and to the JAX package's read_*_native, for OBJ (PTN
faces of a procedural mesh) and TGA (uncompressed and RLE, both origins);
load_model's native path equal to its NumPy path; the library under
_build/; six concurrent first builds into one directory without a
collision."""

import os
import struct
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from tiny_renderer_tpu.assets import native as jnative
from tiny_renderer_tpu_torch.assets import model as tmodel
from tiny_renderer_tpu_torch.assets import native
from tiny_renderer_tpu_torch.assets.obj import read_obj
from tiny_renderer_tpu_torch.assets.tga import read_tga
from tiny_renderer_tpu_torch.models.procedural import make_uv_sphere

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("positions", "tex_coords", "normals", "pos_idx", "tex_idx", "normal_idx")
MAPS = ("texture", "normal_map", "normal_map_tangent", "specular_map")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def write_obj(path, mesh):
    """PTN faces (1-based v/vt/vn), floats written so f32 round-trips."""
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.positions]
    lines += [f"vt {u:.9g} {v:.9g}" for u, v in mesh.tex_coords]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.normals]
    for p, t, n in zip(mesh.pos_idx + 1, mesh.tex_idx + 1, mesh.normal_idx + 1):
        lines.append("f " + " ".join(f"{a}/{b}/{c}" for a, b, c in zip(p, t, n)))
    Path(path).write_text("\n".join(lines) + "\n")


def _rle(pixels, bpp):
    """Run packets for repeated pixels, raw packets of one pixel otherwise."""
    out, n, i = bytearray(), len(pixels) // bpp, 0
    while i < n:
        px = pixels[i * bpp:(i + 1) * bpp]
        run = 1
        while i + run < n and run < 128 and pixels[(i + run) * bpp:(i + run + 1) * bpp] == px:
            run += 1
        out += bytes([0x80 | (run - 1) if run > 1 else 0]) + px
        i += run
    return bytes(out)


def write_tga(path, rgb, rle=False, top=False):
    """24-bit TGA, type 2 (raw) or 10 (RLE), bottom-left or top-left origin."""
    h, w, _ = rgb.shape
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 10 if rle else 2, 0, 0, 0, 0, 0, w, h, 24,
                         0x20 if top else 0)
    rows = rgb if top else rgb[::-1]
    data = np.ascontiguousarray(rows[:, :, ::-1]).tobytes()
    Path(path).write_bytes(header + (_rle(data, 3) if rle else data))


def image(seed, h=24, w=20):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[: h // 3] = img[0, 0]  # runs for the RLE packets
    return img


def write_assets(d):
    write_obj(d / "model.obj", make_uv_sphere(0.45, 6, 8))
    for i, name in enumerate(MAPS):
        write_tga(d / f"{name}.tga", image(i), rle=(i == 1), top=(i == 2))
    return d


def test_library_is_the_ports_own_build():
    assert native.native_available()
    lib = native.library_path()
    assert lib.parent == ROOT / "tiny_renderer_tpu_torch" / "_build" and lib.is_file()
    assert native._lib._name == str(lib)
    assert "libasset_loader" not in lib.name and not str(lib).startswith(str(ROOT / "native"))


def test_obj_matches_numpy_and_jax(tmp_path):
    path = tmp_path / "model.obj"
    write_obj(path, make_uv_sphere(0.45, 6, 8))
    got, want, jgot = native.read_obj_native(str(path)), read_obj(str(path)), jnative.read_obj_native(str(path))
    assert got is not None and jgot is not None
    assert got.num_triangles == 6 * 8 * 2 - 2 * 8
    for f in FIELDS:
        a = getattr(got, f)
        for b in (getattr(want, f), getattr(jgot, f)):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("top", [False, True], ids=["bottom-left", "top-left"])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
def test_tga_matches_numpy_and_jax(tmp_path, rle, top):
    path = tmp_path / "t.tga"
    img = image(5)
    write_tga(path, img, rle=rle, top=top)
    got = native.read_tga_native(str(path))
    assert got is not None and got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, read_tga(str(path)))
    np.testing.assert_array_equal(got, jnative.read_tga_native(str(path)))


def test_failures_return_none(tmp_path):
    bad = tmp_path / "bad.tga"
    bad.write_bytes(b"\x00" * 5)
    assert native.read_tga_native(str(bad)) is None
    assert native.read_tga_native(str(tmp_path / "missing.tga")) is None
    assert native.read_obj_native(str(tmp_path / "missing.obj")) is None


def test_load_model_takes_the_native_path(tmp_path):
    """With the NumPy parsers made to fail, load_model still loads (the
    native path), and its arrays equal the NumPy path's byte for byte."""
    d = write_assets(tmp_path)
    fail = mock.Mock(side_effect=AssertionError("the NumPy parser ran"))
    with mock.patch.object(tmodel, "read_obj", fail), mock.patch.object(tmodel, "read_tga", fail):
        nat = tmodel.load_model(str(d), verbose=False)
    with mock.patch.object(native, "read_obj_native", return_value=None), \
            mock.patch.object(native, "read_tga_native", return_value=None):
        ref = tmodel.load_model(str(d), verbose=False)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(nat.mesh, f), getattr(ref.mesh, f), err_msg=f)
        assert getattr(nat.mesh, f).dtype == getattr(ref.mesh, f).dtype
    for m in MAPS:
        np.testing.assert_array_equal(getattr(nat, m), getattr(ref, m), err_msg=m)


def test_load_model_falls_back_without_the_library(tmp_path):
    d = write_assets(tmp_path)
    with mock.patch.object(native, "_get_lib", return_value=None):
        assert not native.native_available()
        m = tmodel.load_model(str(d), verbose=False)
    np.testing.assert_array_equal(m.texture, image(0))


_BUILD = """
import sys
from pathlib import Path
from tiny_renderer_tpu_torch.assets import native
native.BUILD_DIR = Path(sys.argv[1])
assert native.native_available()
assert native._lib._name == str(native.library_path()), native._lib._name
img = native.read_tga_native(sys.argv[2])
assert img is not None and img.shape == (24, 20, 3)
maps = Path("/proc/self/maps").read_text()
assert str(native.library_path()) in maps and "libasset_loader.so" not in maps
print("OK")
"""


def test_concurrent_first_builds(tmp_path):
    """Six processes build into one empty directory at once: each loads a
    complete library, one .so is left, no temporary file."""
    build = tmp_path / "build"
    tga = tmp_path / "t.tga"
    write_tga(tga, image(7), rle=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build), str(tga)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "OK", err
    files = sorted(f.name for f in build.iterdir())
    assert [f for f in files if f.endswith(".so")] == [native.library_path().name]
    assert set(files) == {native.library_path().name, "asset_loader.lock"}
