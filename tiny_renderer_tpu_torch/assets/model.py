"""Model bundle: geometry + the four texture maps (``tiny_renderer_tpu.assets.model``).

Mirrors the reference's `Model` (src/scene/util.rs:16-22) and the asset
directory layout the app requires (src/app.rs:87-91): model.obj,
texture.tga, normal_map.tga, normal_map_tangent.tga, specular_map.tga.
load_model prefers the native C++ loader (assets/native.py: the port's copy
of the loader source, csrc/asset_loader.cpp, built with g++ at first use
into tiny_renderer_tpu_torch/_build/) and falls back to the NumPy parsers
(obj.py, tga.py) when g++ or the build is unavailable; both give the same
bytes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import native
from .obj import ObjMesh, read_obj
from .tga import read_tga

REQUIRED_FILES = (
    "model.obj",
    "texture.tga",
    "normal_map.tga",
    "normal_map_tangent.tga",
    "specular_map.tga",
)


@dataclasses.dataclass
class Model:
    mesh: ObjMesh
    texture: np.ndarray             # (Ht, Wt, 3) u8
    normal_map: np.ndarray          # (Hn, Wn, 3) u8
    normal_map_tangent: np.ndarray  # (Hnt, Wnt, 3) u8
    specular_map: np.ndarray        # (Hs, Ws, 3) u8

    @property
    def num_triangles(self) -> int:
        return self.mesh.num_triangles


def load_model(asset_path: str, verbose: bool = True) -> Model:
    """Load a model from an asset directory, validating the file set first."""
    missing = [f for f in REQUIRED_FILES if not os.path.isfile(os.path.join(asset_path, f))]
    if missing:
        raise FileNotFoundError(
            f"asset directory {asset_path!r} is missing required files: {missing}; "
            f"expected the full set {list(REQUIRED_FILES)}"
        )
    # Prefer the native C++ loader when it builds; fall back to NumPy.
    obj_path = os.path.join(asset_path, "model.obj")
    if verbose:
        print(f"loading model from: {obj_path}")
    mesh = native.read_obj_native(obj_path)
    if mesh is None:
        mesh = read_obj(obj_path)
    if verbose:
        print(f"number of vertices in a model: {mesh.num_vertices}")
        print(f"number of polygons in a model: {mesh.num_triangles}")

    maps = {}
    for key in ("texture", "normal_map", "normal_map_tangent", "specular_map"):
        path = os.path.join(asset_path, f"{key}.tga")
        if verbose:
            print(f"loading {key.replace('_', ' ')} from: {path}")
        img = native.read_tga_native(path)
        if img is None:
            img = read_tga(path)
        maps[key] = img
        if verbose:
            h, w = img.shape[:2]
            print(f"dimensions of loaded {key.replace('_', ' ')} are: {w} x {h}")
    return Model(mesh=mesh, **maps)
