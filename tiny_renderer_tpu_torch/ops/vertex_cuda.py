"""The vertex layer as CUDA kernels (``csrc/vertex.cu``): two launches a pass.

``prepare`` computes the uniforms of ``mathlib.default_prepare`` (with
``inverses``, of ``shadow_pass_2_prepare``) in one launch, into one packed
float32 buffer, and returns them as views into it (``unpack``).  ``setup``
computes ``vertex.triangle_setup``'s base outputs and intensity in one
launch, one thread a triangle.  ``mathlib`` and ``vertex`` dispatch here for
CUDA tensors; for CPU tensors they run their plain torch versions,
``mathlib.prepare_reference`` and ``vertex.setup_reference``, which the
kernels equal bit for bit (see the note at the top of vertex.cu).

The kernels are built at first use with nvcc into ``_build/`` like the
raster (``raster_cuda.build``).  ``LAUNCHES`` counts launches by kernel
(``prepare``, ``setup``); a launch made while a CUDA graph is captured is
counted at each replay (``recording``, ``replayed``), as raster_cuda counts
its own.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import mathlib as ml
from . import raster_cuda

# Kernel launches by kernel (not counting the plain versions).
LAUNCHES = dict.fromkeys(("prepare", "setup"), 0)

SOURCE = raster_cuda.SOURCE.parent / "vertex.cu"

# The prepare kernel's buffer: (key, shape) in order; INVERSES follow
# UNIFORMS in shadow_pass_2_prepare's.
UNIFORMS = (("vpmv", (4, 4)), ("m", (4, 4)), ("it_m", (4, 4)), ("camera_direction", (3,)),
            ("t_light_direction", (3,)))
INVERSES = (("i_vpmv", (4, 4)), ("i_m", (4, 4)))

# The setup kernel's buffers: (key, shape a triangle) in order; the
# intensity follows the floats, by needs: (kernel mode, floats a triangle).
SETUP_INTS = (("rx", (3,)), ("ry", (3,)), ("a1", ()), ("b1", ()), ("c1", ()), ("a2", ()), ("b2", ()),
              ("c2", ()), ("cz", ()), ("x0", ()), ("x1", ()), ("y0", ()), ("y1", ()))
SETUP_FLOATS = (("zv", (3,)), ("uv", (3, 2)))
_INTENSITY = {None: (0, 0), "face_intensity": (1, 1), "vertex_intensity": (2, 3)}


def reset_launches():
    """Set every LAUNCHES count to 0."""
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))


def recording():
    """raster_cuda.recording for this module's LAUNCHES."""
    return raster_cuda.recording(LAUNCHES)


def replayed(counts):
    """raster_cuda.replayed for this module's LAUNCHES."""
    raster_cuda.replayed(counts, LAUNCHES)


@functools.cache
def _library():
    """csrc/vertex.cu, built with nvcc at first use, its functions'
    argument types set."""
    lib = ctypes.CDLL(str(raster_cuda.build(source=SOURCE)[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vertex_prepare.argtypes = [p, p, p, p, f, f, f, f, i, p, p]
    lib.vertex_setup.argtypes = [p, p, p, i, p, p, p, p, i, i, i, i, p, p, p, p, p]
    for fn in (lib.vertex_prepare, lib.vertex_setup):
        fn.restype = i
    lib.vertex_error_string.argtypes = [i]
    lib.vertex_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: {_library().vertex_error_string(err).decode()}")


def check_float32(args, device):
    """Raise unless each (name, tensor, shape) of `args` is a contiguous
    float32 tensor of `shape` (None: any shape; None first: any number of
    rows), and then unless each lies on `device`, a CUDA device."""
    for name, t, shape in args:
        got = tuple(t.shape) if shape is None or shape[0] is not None else (None, *t.shape[1:])
        if t.dtype != torch.float32 or got != (shape or got) or not t.is_contiguous():
            want = "any" if shape is None else "x".join("T" if s is None else str(s) for s in shape)
            raise ValueError(f"{name}: expected a contiguous ({want}) float32 tensor, got "
                             f"{'' if t.is_contiguous() else 'a non-contiguous '}{tuple(t.shape)} {t.dtype}")
    for name, t, _ in args:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: expected a tensor on a CUDA device ({device}), got one on {t.device}")


def uniform_layout(inverses=False):
    """(key, shape) of each uniform in the prepare kernel's buffer, in order."""
    return UNIFORMS + (INVERSES if inverses else ())


def unpack(buf, inverses=False):
    """The uniforms of a prepare buffer, as views into it."""
    out, at = {}, 0
    for key, shape in uniform_layout(inverses):
        n = math.prod(shape)
        out[key] = buf[at:at + n].view(shape)
        at += n
    return out


def pack(uniforms, inverses=False):
    """The prepare buffer holding `uniforms` (the inverse of unpack)."""
    return torch.cat([uniforms[k].reshape(-1) for k, _ in uniform_layout(inverses)])


def prepare(config, light_direction, look_from, look_at, up, inverses=False):
    """default_prepare's uniforms (with `inverses`, shadow_pass_2_prepare's)
    from (3,) float32 CUDA vectors, in one launch on the current stream:
    unpack's views into a new buffer."""
    dev = look_from.device
    check_float32([(name, v, (3,)) for name, v in (("light_direction", light_direction), ("look_from", look_from),
                                             ("look_at", look_at), ("up", up))], dev)
    viewport, projection = ml.viewport_projection(config.width, config.height, config.depth,
                                                  config.projection_coef)
    buf = torch.empty((_size(uniform_layout(inverses)),), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.vertex_prepare(
            light_direction.data_ptr(), look_from.data_ptr(), look_at.data_ptr(), up.data_ptr(),
            float(viewport[0, 0]), float(viewport[1, 1]), float(viewport[2, 2]), float(projection[3, 2]),
            int(inverses), buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "vertex_prepare")
    raster_cuda.launch_counts(LAUNCHES)["prepare"] += 1
    return unpack(buf, inverses)


def setup(tris, uniforms, config, *, matrix_key="vpmv", cull=True, needs=(), exact_max):
    """vertex.setup_reference's outputs for CUDA tensors, in one launch on
    the current stream: gather_triangles' `tris`, the uniforms the pass
    reads (uniforms[matrix_key]; camera_direction under `cull`; it_m and
    t_light_direction for an intensity), each a contiguous float32 tensor on
    the device.  exact_max: vertex.EXACT_COORD_MAX."""
    pos = tris["pos"]
    dev = pos.device
    T = pos.shape[0]
    intensity = ("vertex_intensity" if "vertex_intensity" in needs
                 else "face_intensity" if "face_intensity" in needs else None)
    matrix = uniforms[matrix_key]
    camera_direction = uniforms["camera_direction"] if cull else None
    it_m = uniforms["it_m"] if intensity else None
    light = uniforms["t_light_direction"] if intensity else None
    normal = tris["normal"] if intensity == "vertex_intensity" else None
    args = [("pos", pos, (None, 3, 3)), ("uv_raw", tris["uv_raw"], (T, 3, 2)), (matrix_key, matrix, (4, 4)),
            ("camera_direction", camera_direction, (3,)), ("it_m", it_m, (4, 4)),
            ("t_light_direction", light, (3,)), ("normal", normal, (T, 3, 3))]
    check_float32([a for a in args if a[1] is not None], dev)

    mode, per_tri = _INTENSITY[intensity]
    ints = torch.empty((_size(SETUP_INTS) * T,), dtype=torch.int32, device=dev)
    floats = torch.empty(((_size(SETUP_FLOATS) + per_tri) * T,), dtype=torch.float32, device=dev)
    valid = torch.empty((T,), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if T:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.vertex_setup(
                pos.data_ptr(), tris["uv_raw"].data_ptr(), _ptr(normal), T, matrix.data_ptr(),
                _ptr(camera_direction), _ptr(it_m), _ptr(light), mode, config.width, config.height,
                exact_max, ints.data_ptr(), floats.data_ptr(), valid.data_ptr(), overflow.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "vertex_setup")
        raster_cuda.launch_counts(LAUNCHES)["setup"] += 1

    return setup_outputs(ints, floats, valid, overflow, intensity)


def setup_outputs(ints, floats, valid, overflow, intensity):
    """vertex.setup_reference's dict as views into the setup kernel's
    buffers (the layouts SETUP_INTS, SETUP_FLOATS and the intensity after)."""
    T = valid.shape[0]
    out = {"valid": valid, **_views(ints, SETUP_INTS, T), **_views(floats, SETUP_FLOATS, T),
           "coord_overflow": overflow}
    rest = floats[_size(SETUP_FLOATS) * T:]
    if intensity == "face_intensity":
        out["intensity"] = rest.view(T)[:, None].expand(T, 3)
    elif intensity == "vertex_intensity":
        out["intensity"] = rest.view(T, 3)
    return out


def _size(layout):
    return sum(math.prod(shape) for _, shape in layout)


def _views(buf, layout, T):
    """{key: (T, *shape) view} of a setup buffer laid out by `layout`."""
    out, at = {}, 0
    for key, shape in layout:
        n = math.prod(shape) * T
        out[key] = buf[at:at + n].view(T, *shape)
        at += n
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()
