"""The occlusion probe as a CUDA kernel (``csrc/occlusion.cu``): one launch, one thread a fragment.

``coefficient`` computes ``shaders.occlusion_reference`` for CUDA tensors:
each fragment's world point and shadow coordinates, the plane read there,
the n samples' coordinates and reads, and the update, with the
frame-constant rotation computed in the kernel.  ``shaders`` dispatches here
for CUDA tensors; for CPU tensors it runs ``occlusion_reference``, which the
kernel equals bit for bit (see the note at the top of occlusion.cu).

The kernel is built at first use with nvcc into ``_build/`` like the raster
(``raster_cuda.build``).  ``LAUNCHES`` counts the launches issued: eager
ones once, and a launch made while a CUDA graph is captured at each replay
(``recording``, ``replayed``), as raster_cuda counts its own.  So it counts
the launches a replayed graph holds, one a chunk body of the strip shade
whether the body's IF node runs it or skips it; which bodies ran only the
device knows (a profiler trace, or the tracer's ``shade.chunks``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import mathlib as ml
from . import raster_cuda
from .vertex_cuda import check_float32

# Kernel launches issued (see above; the plain version counts none).
LAUNCHES = {"coefficient": 0}

SOURCE = raster_cuda.SOURCE.parent / "occlusion.cu"

# The uniforms the kernel reads, with their shapes.
UNIFORMS = (("i_vpmv", (4, 4)), ("shadow_matrix", (4, 4)), ("i_m", (4, 4)), ("t_light_direction", (3,)))

_INT_MAX = 2**31 - 1


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
    """csrc/occlusion.cu, built with nvcc at first use, its functions'
    argument types set."""
    lib = ctypes.CDLL(str(raster_cuda.build(source=SOURCE)[0]))
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.occlusion_coefficient.argtypes = [p, p, p, i, p, i, u, i, p, p, p, p, p, i, f, f, f, f, p, p]
    lib.occlusion_coefficient.restype = i
    lib.occlusion_error_string.argtypes = [i]
    lib.occlusion_error_string.restype = ctypes.c_char_p
    return lib


def _reciprocal(x):
    """float32(1) / float32(x): occlusion_update's 1 / n, and the factor
    by which torch divides a CUDA tensor by the Python scalar x."""
    return ml.f32(np.float32(1.0) / np.float32(x))


def _raise_on(err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: {_library().occlusion_error_string(err).decode()}")


def coefficient(xf, yf, zfrag, shadow_buffer, uniforms, directions, config, tile=0):
    """shaders.occlusion_reference for CUDA tensors, in one launch on the
    current stream: xf, yf, zfrag contiguous float32 fragments of one shape,
    the (H, W) shadow plane (tile-swizzled by `tile`, 0: row-major), the
    uniforms of UNIFORMS and the (n, 3) sample directions
    (shaders.occlusion_directions), all on one CUDA device.  Returns the
    occlusion coefficient, float32 of the fragments' shape."""
    dev = xf.device
    n = config.occlusion_samples
    if yf.shape != xf.shape or zfrag.shape != xf.shape:
        raise ValueError(f"fragments of different shapes: xf {tuple(xf.shape)}, yf {tuple(yf.shape)}, "
                         f"zfrag {tuple(zfrag.shape)}")
    if shadow_buffer.dim() != 2:
        raise ValueError(f"shadow_buffer: expected an (H, W) plane, got {tuple(shadow_buffer.shape)}")
    args = [("xf", xf, None), ("yf", yf, None), ("zfrag", zfrag, None),
            ("shadow_buffer", shadow_buffer, None), ("directions", directions, (n, 3))]
    args += [(key, uniforms[key], shape) for key, shape in UNIFORMS]
    check_float32(args, dev)
    if xf.numel() > _INT_MAX or shadow_buffer.numel() > _INT_MAX:
        raise ValueError(f"{xf.numel()} fragments or a plane of {shadow_buffer.numel()} floats: "
                         f"the kernel takes at most {_INT_MAX} of each")

    occ = torch.empty_like(xf)
    if xf.numel():
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.occlusion_coefficient(
                xf.data_ptr(), yf.data_ptr(), zfrag.data_ptr(), xf.numel(), shadow_buffer.data_ptr(),
                config.width, shadow_buffer.numel(), tile, *(uniforms[key].data_ptr() for key, _ in UNIFORMS),
                directions.data_ptr(), n, ml.f32(config.occlusion_step), ml.f32(config.occlusion_threshold),
                _reciprocal(config.occlusion_depth_scale), _reciprocal(n), occ.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "occlusion_coefficient")
        raster_cuda.launch_counts(LAUNCHES)["coefficient"] += 1
    return occ
