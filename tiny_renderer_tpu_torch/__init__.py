"""tiny_renderer_tpu_torch — the renderer on PyTorch and CUDA.

A port of ``tiny_renderer_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA GPU, slice by slice; the JAX package stays the reference the port is
tested against.  This package imports torch and numpy only, never jax.

Ported so far: all seven shader pipelines end to end (``default``,
``phong``, ``normal_map``, ``specular``, ``darboux``, ``shadow``,
``occlusion``) — assets, the matrix stack, the batched vertex stage, CSR
tile binning, the tile raster as hand-written CUDA kernels
(``csrc/raster.cu``, with plain torch twins for CPU tensors), the
strip-compacted and full-screen shades, Scene and a headless CLI.  Tensor conventions at the public functions are the JAX
package's (dict keys, shapes, dtypes), so ``convert`` carries its state
across unchanged.
"""

from .assets.model import Model, load_model
from .config import RenderConfig
from .pipelines.frame import PIPELINES
from .scene import Scene

__version__ = "0.1.0"

PIPELINE_NAMES = tuple(PIPELINES)

__all__ = ["RenderConfig", "Scene", "Model", "load_model", "PIPELINE_NAMES", "__version__"]
