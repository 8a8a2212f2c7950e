"""tiny_renderer_tpu_torch — the renderer on PyTorch and CUDA.

A port of ``tiny_renderer_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA GPU, slice by slice; the JAX package stays the reference the port is
tested against.  This package imports torch and numpy only, never jax.

Ported so far: all seven shader pipelines end to end (``default``,
``phong``, ``normal_map``, ``specular``, ``darboux``, ``shadow``,
``occlusion``) — assets, the matrix stack, the batched vertex stage, CSR
tile binning, the tile raster as hand-written CUDA kernels
(``csrc/raster.cu``, with plain torch twins for CPU tensors), the
strip-compacted and full-screen shades — and the entry points around them:
``register_pipeline`` for custom shaders, Scene, the CLI
(``python -m tiny_renderer_tpu_torch``) with its interactive window and
per-stage profile, the dense raster backend (``backend="dense"`` of
render_frame and ``Scene``, ``--raster dense`` of the CLI and the frame
server), explicit row bands (``RenderConfig(row_bands=N)``, ``--knob
row_bands=N``), the native C++ asset loader (``assets.native``, built with
g++ at first use into ``_build/``), mesh subdivision
(``assets.mesh_tools``), the scale-out paths of ``parallel`` (row shards,
frame batches, the two passes pipelined over a mesh of devices, run from
one process), and the examples (``examples.custom_pipeline``,
``examples.serve_http``, ``examples.sharded_render``).  Tensor conventions at the public functions are
the JAX package's (dict keys, shapes, dtypes), so ``convert`` carries its
state across unchanged.
"""

from .assets.model import Model, load_model
from .config import RenderConfig
from .pipelines.frame import PIPELINES, register_pipeline, unregister_pipeline
from .scene import Scene

__version__ = "0.1.0"

# The seven built-ins; the live registry is pipelines.frame.PIPELINES.
PIPELINE_NAMES = tuple(PIPELINES)

__all__ = ["RenderConfig", "Scene", "Model", "load_model", "PIPELINE_NAMES",
           "register_pipeline", "unregister_pipeline", "__version__"]
