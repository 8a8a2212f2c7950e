"""Torch port: assets.mesh_tools.subdivide_mesh against the JAX package's.

The same numpy arithmetic on the port's own ObjMesh: each attribute stream
split 1:4 along its own index topology, midpoints not deduplicated, normals
not renormalized.  Held array for array (values, dtypes, shapes) at levels
1 and 2, plus the capacity scene's size (the flagship stand-in subdivided
twice: 81,536 triangles) and the silhouette a subdivision must keep."""

import numpy as np
import pytest
import torch

from tiny_renderer_tpu.assets.mesh_tools import subdivide_mesh as j_subdivide
from tiny_renderer_tpu.models import procedural as jproc
from tiny_renderer_tpu_torch import Model, RenderConfig, Scene
from tiny_renderer_tpu_torch.assets.mesh_tools import subdivide_mesh
from tiny_renderer_tpu_torch.models import procedural as tproc

FIELDS = ("positions", "tex_coords", "normals", "pos_idx", "tex_idx", "normal_idx")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("mesh", ["sphere", "cube", "plane"])
def test_subdivide_matches_jax(mesh, levels):
    make = {"sphere": lambda m: m.make_uv_sphere(0.45, 6, 8), "cube": lambda m: m.make_cube(),
            "plane": lambda m: m.make_plane()}[mesh]
    src = make(tproc)
    got, want = subdivide_mesh(src, levels), j_subdivide(make(jproc), levels)
    assert got.num_triangles == src.num_triangles * 4 ** levels
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_subdivide_structure():
    src = tproc.make_uv_sphere(0.45, 6, 8)
    m = subdivide_mesh(src, 1)
    assert m.pos_idx.max() < m.positions.shape[0] and m.tex_idx.max() < m.tex_coords.shape[0]
    assert m.normal_idx.max() < m.normals.shape[0]
    # Corner vertices of each original triangle are kept exactly, first of
    # its four children.
    np.testing.assert_array_equal(m.positions[m.pos_idx[0::4, 0]], src.positions[src.pos_idx[:, 0]])
    assert subdivide_mesh(src, 0).num_triangles == src.num_triangles


def test_capacity_scene_size():
    """The capacity phase's scene: the flagship stand-in (5,096 triangles)
    subdivided twice."""
    flagship = tproc.make_uv_sphere(0.45, 50, 52)
    assert flagship.num_triangles == 5096
    assert subdivide_mesh(flagship, 2).num_triangles == 81536


def test_subdivided_render_keeps_the_silhouette():
    """Midpoint subdivision does not move the surface: z coverage of the
    subdivided render equals the original's almost everywhere (edge pixels
    may flip by the exact-integer coverage rules at the new edges)."""
    tex = tproc.make_textures(16)
    cfg = RenderConfig(width=128, height=64)
    cov = []
    for levels in (0, 1):
        mesh = subdivide_mesh(tproc.make_uv_sphere(0.45, 8, 10), levels)
        scene = Scene(Model(mesh=mesh, **tex), "phong", cfg, device="cpu")
        scene.set_light_direction([0.3, 0.0, 0.95])
        cov.append(scene.render()["z"] > -1e38)
    assert cov[0].float().mean() > 0.05
    assert (cov[0] != cov[1]).float().mean() < 0.01
