"""The reference's math in torch, op for op as ``tiny_renderer_tpu.ops.mathlib``.

Every product and sum is written out in nalgebra's left-to-right
accumulation order, exactly as the JAX module writes it, and never through
``@``/``torch.matmul``: eager torch rounds each op separately (no mul+add
fusion, no TF32), so these functions equal the JAX module run with
``xp=numpy`` bit for bit, apart from transcendental functions.

* Rust cast semantics: ``f32 as i32/u32/u8`` truncate toward zero,
  saturate, NaN -> 0; ``f32::round`` rounds half away from zero.  NaN is
  mapped and the value clamped BEFORE the integer conversion, since an
  out-of-range float-to-int conversion is undefined in torch.  ``as u32``
  results are int64 tensors (``torch.uint32`` supports few ops).
* the camera matrix stack of ``default_prepare`` (src/scene/shader.rs:183-230),
  the two-pass pipelines' two prepares (shader.rs:234-279) and the
  occlusion probe's ``rotation_between``.

Functions take tensors and compute on their device; matrices are (4, 4)
row-major float32 tensors.  The prepares launch the prepare kernel of
``csrc/vertex.cu`` (``ops/vertex_cuda.py``) for CUDA tensors;
``prepare_reference`` is their torch code, on any device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

F32_MIN = float(np.float32(-3.4028235e38))  # f32::MIN, the z/shadow clear value

# Largest f32 values not exceeding the integer type's max.
_I32_LO = -2147483648.0
_I32_HI = 2147483520.0
_U32_HI = 4294967040.0


def f32(x) -> float:
    """A Python float holding the float32 rounding of x (a scalar operand
    that torch applies to a float32 tensor without further rounding)."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=256)
def const(values, device, dtype=torch.float32):
    """A constant tensor of `values` (nested tuples of Python numbers) on
    `device`, copied there once and shared by every caller, who must not
    write to it.  A copy from host memory cannot be captured into a CUDA
    graph; a constant that a warm-up run built is only read there."""
    return torch.tensor(values, dtype=dtype).to(device)


# ---------------------------------------------------------------------------
# Rust cast semantics
# ---------------------------------------------------------------------------


def rust_f32_to_i32(x):
    """`x as i32`: truncate toward zero, saturate, NaN -> 0."""
    x = torch.where(torch.isnan(x), 0.0, x).clamp(_I32_LO, _I32_HI)
    return torch.trunc(x).to(torch.int32)


def rust_f32_to_u32(x):
    """`x as u32` as an int64 tensor: truncate, saturate at [0, u32::MAX]
    (one f32 ulp early, like the JAX module), NaN -> 0."""
    x = torch.where(torch.isnan(x), 0.0, x).clamp(0.0, _U32_HI)
    return torch.trunc(x).to(torch.int64)


def rust_f32_to_u8(x):
    """`x as u8`: truncate toward zero, saturate at [0, 255], NaN -> 0."""
    x = torch.where(torch.isnan(x), 0.0, x).clamp(0.0, 255.0)
    return torch.trunc(x).to(torch.uint8)


def rust_round(x):
    """`f32::round`: half away from zero (torch.round is half-to-even)."""
    f = torch.floor(x)
    frac = x - f
    up = f + 1.0
    return torch.where(
        frac > 0.5, up, torch.where(frac < 0.5, f, torch.where(x >= 0.0, up, f))
    )


# ---------------------------------------------------------------------------
# Vector helpers (shape (..., 3)), nalgebra accumulation order
# ---------------------------------------------------------------------------


def dot3(a, b):
    """nalgebra Vector3 dot: ((x1*x2 + y1*y2) + z1*z2)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross3(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def norm3(a):
    # torch's vectorized float32 sqrt on the CPU is not correctly rounded;
    # the float64 sqrt rounded back to float32 is, on every device.
    return torch.sqrt(dot3(a, a).double()).to(a.dtype)


def normalize3(a):
    return a / norm3(a)[..., None]


# ---------------------------------------------------------------------------
# 4x4 / 3x3 matrices
# ---------------------------------------------------------------------------


def mat4_mul(a, b):
    """a @ b with nalgebra's left-to-right row-column accumulation."""
    return (
        a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
    ) + (a[..., :, 2:3] * b[..., 2:3, :] + a[..., :, 3:4] * b[..., 3:4, :])


def mat4_transform_point(m, p):
    """Point3::from_homogeneous(m * p.to_homogeneous()): w=1, divide by w'.
    p: (..., 3) -> (..., 3)  (src/scene/shader.rs:157-158)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    out = [((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3] for i in range(4)]
    w = out[3]
    return torch.stack([out[0] / w, out[1] / w, out[2] / w], dim=-1)


def mat4_transform_vector(m, v):
    """Vector3::from_homogeneous(m * v.to_homogeneous()): w=0, no divide."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [(m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z for i in range(3)], dim=-1
    )


def mat4_inverse(m):
    """Cofactor-expansion 4x4 inverse (nalgebra try_inverse / MESA)."""
    (m00, m01, m02, m03) = (m[0, j] for j in range(4))
    (m10, m11, m12, m13) = (m[1, j] for j in range(4))
    (m20, m21, m22, m23) = (m[2, j] for j in range(4))
    (m30, m31, m32, m33) = (m[3, j] for j in range(4))

    s0 = m00 * m11 - m10 * m01
    s1 = m00 * m12 - m10 * m02
    s2 = m00 * m13 - m10 * m03
    s3 = m01 * m12 - m11 * m02
    s4 = m01 * m13 - m11 * m03
    s5 = m02 * m13 - m12 * m03

    c5 = m22 * m33 - m32 * m23
    c4 = m21 * m33 - m31 * m23
    c3 = m21 * m32 - m31 * m22
    c2 = m20 * m33 - m30 * m23
    c1 = m20 * m32 - m30 * m22
    c0 = m20 * m31 - m30 * m21

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    invdet = 1.0 / det

    rows = [
        [
            (m11 * c5 - m12 * c4 + m13 * c3) * invdet,
            (-m01 * c5 + m02 * c4 - m03 * c3) * invdet,
            (m31 * s5 - m32 * s4 + m33 * s3) * invdet,
            (-m21 * s5 + m22 * s4 - m23 * s3) * invdet,
        ],
        [
            (-m10 * c5 + m12 * c2 - m13 * c1) * invdet,
            (m00 * c5 - m02 * c2 + m03 * c1) * invdet,
            (-m30 * s5 + m32 * s2 - m33 * s1) * invdet,
            (m20 * s5 - m22 * s2 + m23 * s1) * invdet,
        ],
        [
            (m10 * c4 - m11 * c2 + m13 * c0) * invdet,
            (-m00 * c4 + m01 * c2 - m03 * c0) * invdet,
            (m30 * s4 - m31 * s2 + m33 * s0) * invdet,
            (-m20 * s4 + m21 * s2 - m23 * s0) * invdet,
        ],
        [
            (-m10 * c3 + m11 * c1 - m12 * c0) * invdet,
            (m00 * c3 - m01 * c1 + m02 * c0) * invdet,
            (-m30 * s3 + m31 * s1 - m32 * s0) * invdet,
            (m20 * s3 - m21 * s1 + m22 * s0) * invdet,
        ],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def mat3_inverse(m):
    """Batched cofactor 3x3 inverse; a singular input gives inf/nan."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    invdet = 1.0 / det

    row0 = torch.stack([c00, m02 * m21 - m01 * m22, m01 * m12 - m02 * m11], dim=-1)
    row1 = torch.stack([c01, m00 * m22 - m02 * m20, m02 * m10 - m00 * m12], dim=-1)
    row2 = torch.stack([c02, m01 * m20 - m00 * m21, m00 * m11 - m01 * m10], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * invdet[..., None, None]


# ---------------------------------------------------------------------------
# The reference's frame-constant preparers (src/scene/shader.rs:183-279)
# ---------------------------------------------------------------------------


def viewport_projection(width, height, depth, projection_coef):
    """The constant viewport and projection matrices of `default_prepare`
    (shader.rs:183-230), float32 numpy (4, 4)."""
    projection = np.eye(4, dtype=np.float32)
    projection[3, 2] = np.float32(projection_coef)

    w = np.float32(width - 1)
    h = np.float32(height - 1)
    d = np.float32(depth)
    two = np.float32(2.0)
    viewport = np.array(
        [
            [w / two, 0.0, 0.0, w / two],
            [0.0, h / two, 0.0, h / two],
            [0.0, 0.0, d / two, d / two],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )
    return viewport, projection


def camera_matrices(width, height, depth, projection_coef, look_from, look_at, up):
    """The matrix stack of `default_prepare` (shader.rs:183-230).

    Returns dict with vpmv, m (model matrix), it_m, camera_direction, on
    look_from's device."""
    dev = look_from.device
    new_z = normalize3(look_from - look_at)
    new_y = normalize3(up - (dot3(new_z, up) * new_z))
    new_x = normalize3(cross3(new_y, new_z))

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    def row(v, w):
        return torch.stack([v[0], v[1], v[2], w])

    model = torch.stack(
        [row(new_x, zero), row(new_y, zero), row(new_z, zero),
         torch.stack([zero, zero, zero, one])]
    )
    view = torch.stack(
        [
            torch.stack([one, zero, zero, -look_from[0]]),
            torch.stack([zero, one, zero, -look_from[1]]),
            torch.stack([zero, zero, one, -look_from[2]]),
            torch.stack([zero, zero, zero, one]),
        ]
    )
    viewport, projection = viewport_projection(width, height, depth, projection_coef)
    projection = const(tuple(map(tuple, projection.tolist())), dev)
    viewport = const(tuple(map(tuple, viewport.tolist())), dev)

    # nalgebra evaluates viewport * projection * model * view left-to-right.
    vpmv = mat4_mul(mat4_mul(mat4_mul(viewport, projection), model), view)
    it_m = mat4_inverse(model.transpose(-1, -2))
    return {"vpmv": vpmv, "m": model, "it_m": it_m, "camera_direction": new_z}


def _vertex_cuda():
    # Imported at the call: vertex_cuda imports raster_cuda, which imports
    # this module.
    from . import vertex_cuda

    return vertex_cuda


def default_prepare(config, light_direction, look_from, look_at, up):
    """Full `default_prepare` (shader.rs:183-230): matrices + transformed light.
    CUDA tensors launch the prepare kernel (ops/vertex_cuda.py), whose
    uniforms are views into one buffer; CPU tensors run prepare_reference."""
    if look_from.is_cuda:
        return _vertex_cuda().prepare(config, light_direction, look_from, look_at, up)
    return prepare_reference(config, light_direction, look_from, look_at, up)


def shadow_pass_1_prepare(config, light_direction, look_at, up):
    """shadow_pass_prepare_1 (shader.rs:234-255): the camera sits at the
    light direction point; its vpmv is the shadow matrix."""
    u = default_prepare(config, light_direction, light_direction, look_at, up)
    u["shadow_matrix"] = u["vpmv"]
    return u


def shadow_pass_2_prepare(config, light_direction, look_from, look_at, up):
    """shadow_pass_prepare_2 (shader.rs:259-279): default + i_vpmv, i_m.
    CUDA tensors launch the prepare kernel, as default_prepare."""
    if look_from.is_cuda:
        return _vertex_cuda().prepare(config, light_direction, look_from, look_at, up, inverses=True)
    return prepare_reference(config, light_direction, look_from, look_at, up, inverses=True)


def prepare_reference(config, light_direction, look_from, look_at, up, inverses=False):
    """The plain torch version of the prepare kernel, on any device:
    default_prepare's uniforms, with `inverses` also shadow_pass_2_prepare's
    i_vpmv and i_m."""
    u = camera_matrices(
        config.width, config.height, config.depth, config.projection_coef,
        look_from, look_at, up,
    )
    u["t_light_direction"] = normalize3(mat4_transform_vector(u["m"], light_direction))
    if inverses:
        u["i_vpmv"] = mat4_inverse(u["vpmv"])
        u["i_m"] = mat4_inverse(u["m"])
    return u


# ---------------------------------------------------------------------------
# Rotation3::rotation_between (occlusion sampling, shader.rs:921)
# ---------------------------------------------------------------------------


def rotation_between(a, b):
    """(..., 3, 3) rotation taking direction a to direction b (nalgebra:
    normalize both, axis = cross, angle = acos(dot)).  The identity when
    they are aligned; for exactly opposite vectors nalgebra returns None and
    the reference panics (shader.rs:921 unwrap), where this returns the
    180-degree rotation about x, like the JAX module.  The dot is clamped
    into [-1, 1] before acos (the JAX module's divergence: an unclamped
    rounding past 1 would give NaN)."""
    na_ = normalize3(a)
    nb_ = normalize3(b)
    c = cross3(na_, nb_)
    norm_c = norm3(c)
    d = dot3(na_, nb_)
    eps = f32(1.19209290e-7)  # f32::EPSILON, nalgebra's default_epsilon

    axis = c / torch.where(norm_c > eps, norm_c, 1.0)[..., None]
    angle = torch.arccos(d.clamp(-1.0, 1.0))
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    s = torch.sin(angle)
    cth = torch.cos(angle)
    one_m = 1.0 - cth
    rot = torch.stack(
        [
            torch.stack([ax * ax * one_m + cth, ax * ay * one_m - az * s, ax * az * one_m + ay * s], dim=-1),
            torch.stack([ax * ay * one_m + az * s, ay * ay * one_m + cth, ay * az * one_m - ax * s], dim=-1),
            torch.stack([ax * az * one_m - ay * s, ay * az * one_m + ax * s, az * az * one_m + cth], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=torch.float32, device=a.device)
    flip_x = const(((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0)), a.device)
    aligned = torch.where((d >= 0.0)[..., None, None], eye, flip_x)
    return torch.where((norm_c > eps)[..., None, None], rot, aligned)


# ---------------------------------------------------------------------------
# Color blend (src/scene/util.rs:7-13)
# ---------------------------------------------------------------------------


def color_blend(color_1, color_2, t):
    """Per-channel t*c1 + (1-t)*c2 with Rust's saturating `as u8` cast.
    color_1/color_2: (..., 3) u8; t: (...) f32, deliberately unclamped."""
    c1 = color_1.to(torch.float32)
    c2 = color_2.to(torch.float32)
    t = t[..., None]
    return rust_f32_to_u8(t * c1 + (1.0 - t) * c2)
