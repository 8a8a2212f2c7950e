"""ctypes bindings to the native C++ asset loader (``tiny_renderer_tpu.assets.native``).

The reference's asset path is native code (the obj-rs and image Rust crates,
Cargo.toml:8-10); its equivalent here is a small C++ shared library, the
port's own copy of the loader source (``csrc/asset_loader.cpp``), that
decodes TGA (RLE included) and parses OBJ.  The NumPy parsers in tga.py and
obj.py stay the reference semantics and the fallback; the tests hold both
to identical bytes.

The library is built at first use with g++ (no other dependency) into
``_build/`` beside the package, named by a hash of the source and the
flags.  Concurrent first builds (several processes) serialize on a file
lock, and each build goes to a temporary name renamed into place, so no
process loads a half-written library.  When g++ or the build is
unavailable, every entry point returns None and callers fall back to NumPy.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "asset_loader.cpp"
BUILD_DIR = _PKG / "_build"
# The JAX package's native/Makefile flags.
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib = None
_load_failed = False


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + "\0".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{SOURCE.stem}_{digest}.so"


def build(force: bool = False):
    """Compile csrc/asset_loader.cpp with g++ into BUILD_DIR unless a build
    of the same source and flags is there (or `force`).  Returns (library
    path, seconds spent compiling).  Raises RuntimeError with g++'s stderr
    if the build fails, OSError if g++ is missing."""
    lib = library_path()
    if lib.exists() and not force:
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{SOURCE.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists() and not force:  # another process built it meanwhile
            return lib, 0.0
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            t0 = time.perf_counter()
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True, timeout=120)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib, seconds


def _get_lib():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()[0]))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _load_failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        vpp = ctypes.POINTER(ctypes.c_void_p)
        lib.trt_decode_tga.restype = ctypes.c_int
        lib.trt_decode_tga.argtypes = [ctypes.c_char_p, i32p, i32p, vpp]  # path -> h, w, rgb
        lib.trt_free.restype = None
        lib.trt_free.argtypes = [ctypes.c_void_p]
        lib.trt_parse_obj.restype = ctypes.c_int
        lib.trt_parse_obj.argtypes = [
            ctypes.c_char_p,
            i32p, vpp,  # positions
            i32p, vpp,  # tex_coords
            i32p, vpp,  # normals
            i32p, vpp, vpp, vpp,  # faces: pos/tex/norm index arrays
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def _take_array(lib, ptr, count, ctype, np_dtype):
    arr = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,))
    out = arr.copy().astype(np_dtype, copy=False)
    lib.trt_free(ptr)
    return out


def read_obj_native(path: str):
    """Parse an OBJ file with the native library; an ObjMesh, or None when
    the library is unavailable or the parse fails."""
    lib = _get_lib()
    if lib is None:
        return None
    nv, nvt, nvn, nf = (ctypes.c_int32() for _ in range(4))
    bufs = [ctypes.c_void_p() for _ in range(6)]
    rc = lib.trt_parse_obj(
        os.fsencode(path),
        ctypes.byref(nv), ctypes.byref(bufs[0]),
        ctypes.byref(nvt), ctypes.byref(bufs[1]),
        ctypes.byref(nvn), ctypes.byref(bufs[2]),
        ctypes.byref(nf), ctypes.byref(bufs[3]),
        ctypes.byref(bufs[4]), ctypes.byref(bufs[5]),
    )
    if rc != 0:
        for b in bufs:
            if b.value:
                lib.trt_free(b)
        return None
    from .obj import ObjMesh

    V, VT, VN, T = int(nv.value), int(nvt.value), int(nvn.value), int(nf.value)
    return ObjMesh(
        positions=_take_array(lib, bufs[0], V * 3, ctypes.c_float, np.float32).reshape(V, 3),
        tex_coords=_take_array(lib, bufs[1], VT * 2, ctypes.c_float, np.float32).reshape(VT, 2),
        normals=_take_array(lib, bufs[2], VN * 3, ctypes.c_float, np.float32).reshape(VN, 3),
        pos_idx=_take_array(lib, bufs[3], T * 3, ctypes.c_int32, np.int32).reshape(T, 3),
        tex_idx=_take_array(lib, bufs[4], T * 3, ctypes.c_int32, np.int32).reshape(T, 3),
        normal_idx=_take_array(lib, bufs[5], T * 3, ctypes.c_int32, np.int32).reshape(T, 3),
    )


def read_tga_native(path: str) -> np.ndarray | None:
    """Decode a TGA file with the native library; (H, W, 3) u8, or None when
    the library is unavailable or the decode fails."""
    lib = _get_lib()
    if lib is None:
        return None
    h, w = ctypes.c_int32(), ctypes.c_int32()
    buf = ctypes.c_void_p()
    rc = lib.trt_decode_tga(os.fsencode(path), ctypes.byref(h), ctypes.byref(w), ctypes.byref(buf))
    if rc != 0 or not buf.value:
        return None
    try:
        n = int(h.value) * int(w.value) * 3
        arr = np.ctypeslib.as_array(ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), shape=(n,))
        out = arr.copy().reshape(int(h.value), int(w.value), 3)
    finally:
        lib.trt_free(buf)
    return out
