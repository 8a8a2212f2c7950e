"""Torch port: the occlusion probe's CUDA wrapper (ops/occlusion_cuda.py) on the CPU.

No nvcc and no card here, so the kernel itself is held to the plain version
by chip_smoke.py's occlusion phase.  Here the plain version
(shaders.occlusion_reference, which occlusion_coefficient runs on CPU
tensors) is held to the JAX module's occlusion_coefficient (numpy path) on
seeded fragments with NaN, +-inf, far-off-plane and exact-half
coordinates, the swizzled plane on and off, occlusion_dedup on and off and
1, 16 and 33 samples: bit for bit under identity uniforms, and within the
ulps of rotation_between's acos/sin/cos under a scene's.  The sample
directions the wrapper passes are read back from the JAX module's sample
coordinates.  The wrapper refuses a wrong dtype, shape, contiguity or
device before any launch; CPU tensors take the plain path and never reach
the library; launches made under a capture count at each replay, apart
from raster_cuda's and vertex_cuda's."""

import dataclasses

import numpy as np
import pytest
import torch

from tiny_renderer_tpu import RenderConfig as JaxConfig
from tiny_renderer_tpu.ops import mathlib as jml
from tiny_renderer_tpu.pipelines import shaders as jsh
from tiny_renderer_tpu_torch import Model, RenderConfig, Scene
from tiny_renderer_tpu_torch.convert import config_from
from tiny_renderer_tpu_torch.models.procedural import make_textures, make_uv_sphere
from tiny_renderer_tpu_torch.ops import mathlib as ml
from tiny_renderer_tpu_torch.ops import occlusion_cuda, raster_cuda, vertex_cuda
from tiny_renderer_tpu_torch.pipelines import shaders
from tiny_renderer_tpu_torch.utils import timing

CFG = RenderConfig(width=64, height=32)
VIEW = ([0.4, 0.2, 0.9], [0.2, 0.1, 0.98], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
N_FRAG = 1500
# Fragment values beside the seeded ones: off the plane, non-finite, and
# coordinates on exact halves (rounded away from zero).
SPECIAL = (float("nan"), float("inf"), float("-inf"), 1e30, -1e30, 4e9, -0.0, 0.5, 1.5, 2.5, -0.5, -2.5,
           31.5, 63.5, 64.5, 1e-30)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_library(monkeypatch):
    """Any use of the kernel's library raises."""

    def refuse():
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(occlusion_cuda, "_library", refuse)


def views():
    return [torch.tensor(v, dtype=torch.float32) for v in VIEW]


def scene_uniforms(cfg, m=ml, view=None):
    """The camera pass's uniforms with the light's shadow_matrix, as a frame
    hands them to the shade: the port's (m = mathlib), or with m the JAX
    module's mathlib on numpy vectors."""
    light, look_from, look_at, up = views() if view is None else view
    xp = () if m is ml else (np,)
    u1 = m.shadow_pass_1_prepare(cfg, light, look_at, up, *xp)
    u = m.shadow_pass_2_prepare(cfg, light, look_from, look_at, up, *xp)
    u["shadow_matrix"] = u1["shadow_matrix"]
    return u


def identity_uniforms():
    """Every matrix the identity and the light along +z: the rotation is the
    identity (the aligned case) and a fragment's shadow coordinates are its
    own, so exact-half coordinates reach the rounding unchanged; its samples
    lie (step sin a, 0, step cos a) away.  numpy arrays."""
    eye = np.eye(4, dtype=np.float32)
    return {"i_vpmv": eye, "shadow_matrix": eye.copy(), "i_m": eye.copy(),
            "t_light_direction": np.float32([0.0, 0.0, 1.0])}


def fragments(seed, cfg):
    """Seeded fragments over and around the screen, a share of them set to
    SPECIAL values in each coordinate."""
    rng = np.random.default_rng(seed)
    xf = rng.uniform(-8, cfg.width + 8, N_FRAG).astype(np.float32)
    yf = rng.uniform(-8, cfg.height + 8, N_FRAG).astype(np.float32)
    zf = rng.uniform(-10, 265, N_FRAG).astype(np.float32)
    for a in (xf, yf, zf):
        at = rng.choice(N_FRAG, size=N_FRAG // 5, replace=False)
        a[at] = rng.choice(np.float32(SPECIAL), size=at.size)
    halves = np.arange(N_FRAG // 10, dtype=np.float32) % np.float32(cfg.width) - np.float32(0.5)
    xf[:halves.size] = halves
    yf[:halves.size] = halves[::-1] % np.float32(cfg.height)
    return xf, yf, zf


def plane(seed, cfg, tile):
    """A seeded shadow plane (numpy) with uncovered (F32_MIN) texels,
    swizzled by the JAX module's swizzle_plane when `tile` applies."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-5, 260, (cfg.height, cfg.width)).astype(np.float32)
    p[rng.random(p.shape) < 0.2] = ml.F32_MIN
    return jsh.swizzle_plane(p, tile, np) if tile else p


def jax_probe(xf, yf, zf, shadow_buffer, uniforms, cfg):
    """The JAX module's occlusion_coefficient on numpy arrays (its numpy
    path gathers without dedup_gather: the same values)."""
    with np.errstate(all="ignore"):  # inf * 0 and the like in the NaN cases
        return jsh.occlusion_coefficient(xf, yf, zf, shadow_buffer, uniforms, cfg, np)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_same_bits(got, want):
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.parametrize("n", (1, 16, 33))
@pytest.mark.parametrize("tile", (0, 8))
@pytest.mark.parametrize("dedup", (False, True))
@pytest.mark.parametrize("uniforms", ("scene", "identity"))
def test_plain_version_equals_jax_module(n, tile, dedup, uniforms, no_library):
    """occlusion_reference and occlusion_coefficient on CPU tensors against
    the JAX module's occlusion_coefficient on the same fragments and plane:
    bit for bit (NaN where it is NaN) under identity uniforms; under a
    scene's, each package's own uniforms, equal on all but the fragments
    whose probe index moved by the ulps of rotation_between's acos/sin/cos
    (the budget of test_torch_pipelines_units)."""
    jcfg = JaxConfig(width=CFG.width, height=CFG.height, occlusion_samples=n, shadow_tile=tile,
                     occlusion_dedup=dedup, occlusion_step=0.02 if uniforms == "scene" else 3.0)
    cfg = config_from(jcfg)
    seed = 100 * n + 10 * tile + dedup
    xf, yf, zf = fragments(seed, cfg)
    if uniforms == "scene":  # fragments over the shadow plane as well as off it
        ju = scene_uniforms(jcfg, jml, [np.float32(v) for v in VIEW])
        u = scene_uniforms(cfg)
        xf, yf, zf = (a.reshape(30, 50) for a in (xf, yf, zf))
    else:
        ju = identity_uniforms()
        u = {k: _t(v) for k, v in ju.items()}
    sb = plane(seed, cfg, tile)
    want = jax_probe(xf, yf, zf, sb, ju, jcfg)
    assert want.dtype == np.float32 and want.shape == xf.shape
    want = _t(want)
    for fn in (shaders.occlusion_reference, shaders.occlusion_coefficient):
        got = fn(_t(xf), _t(yf), _t(zf), _t(sb), u, cfg)
        if uniforms == "identity":
            assert_same_bits(got, want)
        else:
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            assert ((got != want) & ~torch.isnan(want)).double().mean() < 0.005
    assert (want == 1).any()
    # One sample along the light's own axis never leaves the identity's texel.
    assert (want < 1).any() or (uniforms, n) == ("identity", 1)


@pytest.mark.parametrize("n", (1, 16, 33))
def test_directions_are_the_jax_modules(n):
    """The (n, 3) directions the wrapper passes the kernel, and that
    occlusion_sample_coords uses, read back from the JAX module's sample
    coordinates: with the light along +z (no rotation), i_vpmv the
    identity, a unit step, a fragment at the origin and a shadow_matrix
    that swaps y and z, sample i's shadow coordinates are (sin a_i, cos a_i)
    exactly."""
    u = identity_uniforms()
    u["shadow_matrix"] = u["shadow_matrix"][[0, 2, 1, 3]]
    zero = np.zeros(1, np.float32)
    sx, sy = jsh.occlusion_sample_coords(zero, zero, zero, u, JaxConfig(occlusion_samples=n, occlusion_step=1.0), np)
    want = np.stack([sx[:n, 0], np.zeros(n, np.float32), sy[:n, 0]], axis=-1)
    got = shaders.occlusion_directions(n, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.shape == (n, 3) and got.is_contiguous()
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert shaders.occlusion_directions(n, torch.device("cpu")) is got  # made once a device


def _args(**change):
    cfg = RenderConfig(width=64, height=32)
    xf, yf, zf = (_t(a) for a in fragments(0, cfg))
    args = dict(xf=xf, yf=yf, zfrag=zf, shadow_buffer=_t(plane(0, cfg, 0)), uniforms=scene_uniforms(cfg),
                directions=shaders.occlusion_directions(cfg.occlusion_samples, torch.device("cpu")), config=cfg)
    args.update(change)
    return args


@pytest.mark.parametrize("case,match", [
    ("xf dtype", "xf: .*float32"),
    ("zfrag shape", "different shapes"),
    ("plane shape", r"shadow_buffer: expected an \(H, W\) plane"),
    ("directions shape", r"directions: .*\(16x3\)"),
    ("matrix shape", r"i_vpmv: .*\(4x4\)"),
    ("yf contiguity", "yf: .*non-contiguous"),
    ("matrix contiguity", "shadow_matrix: .*non-contiguous"),
    ("light missing", "t_light_direction"),
    ("device", "on cpu"),
])
def test_coefficient_refuses(case, match, no_library):
    a = _args()
    u = dict(a["uniforms"])
    if case == "xf dtype":
        a["xf"] = a["xf"].double()
    elif case == "zfrag shape":
        a["zfrag"] = a["zfrag"][:-1]
    elif case == "plane shape":
        a["shadow_buffer"] = a["shadow_buffer"].reshape(-1)
    elif case == "directions shape":
        a["directions"] = a["directions"][:-1]
    elif case == "matrix shape":
        u["i_vpmv"] = u["i_vpmv"][:3]
    elif case == "yf contiguity":
        a["yf"] = torch.stack([a["yf"], a["yf"]], dim=-1)[..., 0]
    elif case == "matrix contiguity":
        u["shadow_matrix"] = u["shadow_matrix"].t()
    elif case == "light missing":
        del u["t_light_direction"]
    a["uniforms"] = u
    occlusion_cuda.reset_launches()
    with pytest.raises((ValueError, KeyError), match=match):
        occlusion_cuda.coefficient(**a)
    assert occlusion_cuda.LAUNCHES == {"coefficient": 0}


@pytest.mark.parametrize("compact", (True, False))
def test_cpu_tensors_take_the_plain_path(compact, no_library):
    """An occlusion frame on the CPU, strip shade or full screen, renders
    through the plain version: no launch is counted, the library is never
    loaded, and the tracer's snapshot shows no occlusion launch."""
    occlusion_cuda.reset_launches()
    model = Model(mesh=make_uv_sphere(0.45, 8, 10), **make_textures(16))
    s = Scene(model, "occlusion", dataclasses.replace(CFG, compact_shade=compact), device="cpu")
    s.set_light_direction(VIEW[0])
    s.set_camera(*VIEW[1:])
    s.render()
    frame = s.get_frame_buffer()
    assert (frame > 0).any() and (frame < 255).any()
    assert occlusion_cuda.LAUNCHES == {"coefficient": 0}
    assert timing.snapshot()["occlusion_launches"] == {"coefficient": 0}


def test_launches_count_at_each_replay():
    """A launch under a capture counts into the capture's dict of occlusion
    launches, none into raster_cuda's, vertex_cuda's or LAUNCHES; each
    replay adds them to occlusion_cuda.LAUNCHES."""
    occlusion_cuda.reset_launches()
    raster_before, vertex_before = dict(raster_cuda.LAUNCHES), dict(vertex_cuda.LAUNCHES)
    with raster_cuda.recording() as raster, vertex_cuda.recording() as vertex, \
            occlusion_cuda.recording() as occlusion:
        for _ in range(3):  # one launch a chunk body
            raster_cuda.launch_counts(occlusion_cuda.LAUNCHES)["coefficient"] += 1
    assert occlusion == {"coefficient": 3} and not any(raster.values()) and not any(vertex.values())
    assert occlusion_cuda.LAUNCHES == {"coefficient": 0}
    for _ in range(4):
        occlusion_cuda.replayed(occlusion)
    assert occlusion_cuda.LAUNCHES == {"coefficient": 12}
    assert raster_cuda.LAUNCHES == raster_before and vertex_cuda.LAUNCHES == vertex_before
    raster_cuda.launch_counts(occlusion_cuda.LAUNCHES)["coefficient"] += 1  # outside a capture
    assert occlusion_cuda.LAUNCHES == {"coefficient": 13}
    occlusion_cuda.reset_launches()
