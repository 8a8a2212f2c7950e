"""Torch port: mathlib against tiny_renderer_tpu.ops.mathlib (xp=numpy).

Every function here is elementwise IEEE f32 arithmetic written in the same
order in both packages (no transcendental functions), so results must be
bit-exact.
"""

import numpy as np
import pytest
import torch

from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.ops import mathlib as jml
from tiny_renderer_tpu.pipelines import shaders as jsh
from tiny_renderer_tpu_torch.convert import config_from
from tiny_renderer_tpu_torch.ops import mathlib as tml
from tiny_renderer_tpu_torch.pipelines import shaders as tsh


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cast_inputs(seed):
    rng = np.random.default_rng(seed)
    special = np.array(
        [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.5,
         -2.5, 254.9, 255.0, 255.5, 256.0, -1.0, 2.0**31, -(2.0**31), 2.0**32,
         4294967040.0, 4294967296.0, 3.4e38, -3.4e38, 1e-30],
        np.float32,
    )
    return np.concatenate([special, rng.normal(0, 1e3, 500).astype(np.float32),
                           rng.uniform(-3e9, 5e9, 500).astype(np.float32)])


@pytest.mark.parametrize("seed", [0, 1])
def test_rust_casts_match(seed):
    x = _cast_inputs(seed)
    np.testing.assert_array_equal(tml.rust_f32_to_i32(_t(x)).numpy(), jml.rust_f32_to_i32(x, np))
    np.testing.assert_array_equal(
        tml.rust_f32_to_u32(_t(x)).numpy(), jml.rust_f32_to_u32(x, np).astype(np.int64)
    )
    np.testing.assert_array_equal(tml.rust_f32_to_u8(_t(x)).numpy(), jml.rust_f32_to_u8(x, np))


def test_rust_casts_nan_and_range():
    x = _t(np.array([np.nan, -1e30, 1e30, -0.7, 300.0], np.float32))
    assert tml.rust_f32_to_i32(x).tolist() == [0, -(2**31), 2147483520, 0, 300]
    assert tml.rust_f32_to_u32(x).tolist() == [0, 0, 4294967040, 0, 300]
    assert tml.rust_f32_to_u8(x).tolist() == [0, 0, 255, 0, 255]


@pytest.mark.parametrize("seed", [0, 1])
def test_rust_round_half_away_from_zero(seed):
    x = _cast_inputs(seed)
    x = x[np.isfinite(x)]
    np.testing.assert_array_equal(tml.rust_round(_t(x)).numpy(), jml.rust_round(x, np))
    halves = _t(np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32))
    assert tml.rust_round(halves).tolist() == [1.0, 2.0, 3.0, -1.0, -2.0, -3.0]


def _random_view(rng):
    light = rng.normal(size=3).astype(np.float32)
    look_from = rng.normal(size=3).astype(np.float32)
    look_at = rng.normal(0, 0.1, 3).astype(np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32) + rng.normal(0, 0.2, 3).astype(np.float32)
    return light, look_from, look_at, up


def _assert_uniforms_equal(tu, ju):
    assert set(tu) == set(ju)
    for k in ju:
        np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("size", [(800, 800), (256, 128)])
def test_prepares_match(seed, size):
    cfg = RenderConfig(width=size[0], height=size[1], projection_coef=-1.0 / (4.0 + seed))
    tcfg = config_from(cfg)
    light, look_from, look_at, up = _random_view(np.random.default_rng(seed))
    tl, tf, ta, tu = map(_t, (light, look_from, look_at, up))
    _assert_uniforms_equal(
        tml.default_prepare(tcfg, tl, tf, ta, tu),
        jml.default_prepare(cfg, light, look_from, look_at, up, np),
    )
    _assert_uniforms_equal(
        tml.shadow_pass_1_prepare(tcfg, tl, ta, tu),
        jml.shadow_pass_1_prepare(cfg, light, look_at, up, np),
    )
    _assert_uniforms_equal(
        tml.shadow_pass_2_prepare(tcfg, tl, tf, ta, tu),
        jml.shadow_pass_2_prepare(cfg, light, look_from, look_at, up, np),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matrix_ops_match(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    b = rng.normal(size=(4, 4)).astype(np.float32)
    p = rng.normal(size=(50, 3)).astype(np.float32)
    m3 = rng.normal(size=(20, 3, 3)).astype(np.float32)
    v3 = rng.normal(size=(20, 3)).astype(np.float32)
    np.testing.assert_array_equal(tml.mat4_mul(_t(a), _t(b)).numpy(), jml.mat4_mul(a, b))
    np.testing.assert_array_equal(tml.mat4_inverse(_t(a)).numpy(), jml.mat4_inverse(a, np))
    np.testing.assert_array_equal(tml.mat3_inverse(_t(m3)).numpy(), jml.mat3_inverse(m3, np))
    np.testing.assert_array_equal(
        tml.mat4_transform_point(_t(a), _t(p)).numpy(), jml.mat4_transform_point(a, p, np)
    )
    np.testing.assert_array_equal(
        tml.mat4_transform_vector(_t(a), _t(p)).numpy(), jml.mat4_transform_vector(a, p, np)
    )
    np.testing.assert_array_equal(tml.normalize3(_t(p)).numpy(), jml.normalize3(p, np))
    np.testing.assert_array_equal(tml.cross3(_t(p), _t(p[::-1])).numpy(), jml.cross3(p, p[::-1], np))
    np.testing.assert_array_equal(tsh.mat3_vec(_t(m3), _t(v3)).numpy(), jsh.mat3_vec(m3, v3, np))


def test_color_blend_matches():
    rng = np.random.default_rng(7)
    c1 = rng.integers(0, 256, (300, 3), dtype=np.uint8)
    c2 = rng.integers(0, 256, (300, 3), dtype=np.uint8)
    t = np.concatenate([rng.uniform(-0.5, 1.5, 297), [np.nan, np.inf, -np.inf]]).astype(np.float32)
    with np.errstate(invalid="ignore"):  # the inf rows make inf - inf
        want = jml.color_blend(c1, c2, t, np)
    np.testing.assert_array_equal(tml.color_blend(_t(c1), _t(c2), _t(t)).numpy(), want)
