"""Carry the JAX package's state across to the port.

Both packages use the same config fields and the same geometry / texture
dict keys (packed ``_pk:<maps>[@tile]`` planes included), so conversion is a
dtype-preserving copy of every array onto a torch device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import RenderConfig


def config_from(cfg) -> RenderConfig:
    """The port's RenderConfig from any dataclass with the same fields (e.g.
    ``tiny_renderer_tpu.RenderConfig``)."""
    return RenderConfig(**dataclasses.asdict(cfg))


def to_tensor(value, device) -> torch.Tensor:
    """A copy of a numpy array, or of anything ``np.array`` accepts (jax
    arrays), as a tensor of the same dtype on `device`."""
    return torch.from_numpy(np.array(value, order="C", copy=True)).to(device)


def scene_arrays(geom, textures, device):
    """(geom, textures) dicts of arrays -> the same dicts of tensors on
    `device`, keys and dtypes unchanged (custom ``attr:<name>`` vertex
    attributes included)."""
    return (
        {k: to_tensor(v, device) for k, v in geom.items()},
        {k: to_tensor(v, device) for k, v in textures.items()},
    )
