"""CUDA graphs of the frame path: the port's counterpart of ``jax.jit``.

An eager frame is hundreds of small launches issued one by one from Python,
so the host sets its pace.  ``CapturedGraph`` captures a function of a few
static input tensors once, on their CUDA device, and then runs it as one
graph launch per call: the inputs are copied into the static inputs, the
graph is replayed, and the caller reads the static outputs (which the next
replay overwrites).  ``GraphCache`` keeps captured graphs under a key, as
JAX's jit keeps its executables, and bounds how many stay alive: each holds
a private memory pool of its intermediates.

A captured function may not read device values on the host or copy from
pageable host memory: either makes the capture fail, and the failure is
raised, never replaced by an eager run.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from ..ops import raster_cuda

# Captured graphs kept alive at once by a GraphCache (least recently used
# evicted first).
GRAPH_CACHE_SIZE = 16


class CapturedGraph:
    """fn(*inputs) captured as one CUDA graph on `device` (by default the
    inputs' device).

    `inputs` are tensors; their copies on the device become the static
    inputs (a segment of a sharded frame may have none: it reads its
    inputs in place).  fn runs once eagerly on a side stream first (the
    warm-up: it builds the raster library and fills the constant caches
    and the allocator), then once under capture on that stream.  `hold`: tensors whose addresses
    the graph reads (geometry, textures), kept alive with it.  `name` says
    what was captured in the error raised when the capture fails.

    Calling it copies new inputs into the static inputs, replays the graph
    and returns fn's outputs from the capture, which the next replay
    overwrites: callers hold `lock` around the call and the reads of the
    outputs.  Each replay adds the raster launches the capture recorded to
    raster_cuda.LAUNCHES.  Attributes: outputs, launches (by mode, per
    replay), capture_s (warm-up + capture seconds), pool_bytes (device
    memory the capture reserved).
    """

    def __init__(self, fn, inputs, name, hold=(), device=None):
        self.lock = threading.Lock()
        self.hold = tuple(hold)
        self.device = dev = torch.device(device) if device is not None else inputs[0].device
        self.inputs = [x.to(dev, copy=True) for x in inputs]
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()  # as the capture's own entry does: the pool's growth is then its size
            reserved = torch.cuda.memory_reserved(dev)
            self.graph = torch.cuda.CUDAGraph()
            try:
                # The side stream is on `dev`; the default capture stream is
                # made once, on whichever device was current then.
                with raster_cuda.recording() as self.launches, \
                        torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                    self.outputs = fn(*self.inputs)
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing {name} as a CUDA graph failed; a captured frame may not read "
                    f"device values on the host or copy from pageable host memory: {e}") from e
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def __call__(self, *inputs):
        with torch.cuda.device(self.device):
            for static, x in zip(self.inputs, inputs):
                static.copy_(x, non_blocking=True)
            self.graph.replay()
        raster_cuda.replayed(self.launches)
        return self.outputs


class GraphCache:
    """Captured graphs by key, at most `size` alive (least recently used
    evicted first).  Thread-safe: captures run one at a time."""

    def __init__(self, size=GRAPH_CACHE_SIZE):
        self.size = size
        self._graphs = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, capture):
        """The graph under `key`, captured by capture() on a miss."""
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None:
                graph = capture()
                self._graphs[key] = graph
                while len(self._graphs) > self.size:
                    self._graphs.popitem(last=False)
            else:
                self._graphs.move_to_end(key)
            return graph

    def graphs(self):
        """The graphs alive, least recently used first."""
        with self._lock:
            return list(self._graphs.values())


def signature(tensors, addresses=True):
    """A hashable key of a dict (or sequence) of tensors: device, shape,
    stride and dtype of each, and with `addresses` its data pointer."""
    items = tensors.items() if isinstance(tensors, dict) else enumerate(tensors)
    return tuple(sorted(
        (k, t.device, tuple(t.shape), t.stride(), t.dtype, t.data_ptr() if addresses else 0)
        for k, t in items))
