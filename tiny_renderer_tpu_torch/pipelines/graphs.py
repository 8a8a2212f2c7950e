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
raised, never replaced by an eager run.  Where JAX branches on a device
value (``lax.cond``, the bounded ``lax.while_loop``), the captured function
calls ``device_if``: under capture the branch becomes a conditional node of
the graph, which the device decides at each replay.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import sys
import threading
import time
import weakref

import torch

from ..ops import darboux_cuda, occlusion_cuda, raster_cuda, vertex_cuda
from ..utils import timing

# Captured graphs kept alive at once by a GraphCache (least recently used
# evicted first).
GRAPH_CACHE_SIZE = 16
# Every CapturedGraph alive (pool_bytes).
_ALIVE = weakref.WeakSet()


def pool_bytes():
    """Device memory the captures of the graphs alive reserved."""
    return sum(g.pool_bytes for g in list(_ALIVE))


# csrc/graph_if.cu: the IF nodes behind device_if.
IF_SOURCE = raster_cuda.SOURCE.parent / "graph_if.cu"
# .pooled: this thread's allocations go to the pool of the graph it captures;
# .streams, .depth: device_if's body streams and nesting depth.
_CAPTURE = threading.local()


@functools.cache
def _if_library():
    """csrc/graph_if.cu, built with nvcc at first use, its functions'
    argument types set."""
    lib = ctypes.CDLL(str(raster_cuda.build(source=IF_SOURCE)[0]))
    p = ctypes.c_void_p
    lib.graph_if_begin.argtypes = [p, p, p]
    lib.graph_if_end.argtypes = [p]
    lib.graph_stream_create.argtypes = [ctypes.POINTER(p)]
    lib.graph_if_load.argtypes = []
    for f in (lib.graph_if_begin, lib.graph_if_end, lib.graph_stream_create, lib.graph_if_load):
        f.restype = ctypes.c_int
    lib.graph_error_string.argtypes = [ctypes.c_int]
    lib.graph_error_string.restype = ctypes.c_char_p
    return lib


def _if_check(err, what):
    if err:
        raise RuntimeError(f"device_if: {what} failed: {_if_library().graph_error_string(err).decode()}")


# Body streams made before each capture: one per nesting depth of device_if.
IF_DEPTHS = 3


def _body_stream(dev, depth):
    """This thread's stream for device_if's bodies at nesting `depth` on
    `dev`, made by the library (never a stream a capture already uses)."""
    streams = _CAPTURE.__dict__.setdefault("streams", {})
    if (dev.index, depth) not in streams:
        ptr = ctypes.c_void_p()
        with torch.cuda.device(dev):
            _if_check(_if_library().graph_stream_create(ctypes.byref(ptr)), "creating a body stream")
        streams[dev.index, depth] = torch.cuda.ExternalStream(ptr.value, device=dev)
    return streams[dev.index, depth]


def _if_ready(dev):
    """Build and load the IF-node library and make the body streams on
    `dev` before a capture, so that none of it happens inside one."""
    with torch.cuda.device(dev):
        _if_check(_if_library().graph_if_load(), "loading the IF-node kernel")
    for depth in range(IF_DEPTHS):
        _body_stream(dev, depth)


def device_if(pred, body):
    """Run body() where the 0-d bool tensor `pred` is true, deciding on the
    device: the counterpart of one branch of JAX's lax.cond, or of one
    bounded iteration of a lax.while_loop.

    Under the capture of a CapturedGraph on pred's device, body is recorded
    into an IF node of the graph (csrc/graph_if.cu; CUDA 12.4+), so each
    replay runs it only when pred holds then; nothing is read on the host.
    The body is captured on a stream of its own; CapturedGraph makes its
    allocations in the graph's memory pool.  Outside capture (CPU tensors,
    or eagerly on the card) body runs unconditionally, so a caller's body
    must leave its outputs right when it runs with pred false: it writes
    in place into tensors made before the call (what a skipped body
    leaves), and its work where pred is false goes where it is discarded.
    A tensor allocated inside body holds garbage after a skipped replay
    and may not be read after it.  pred must be its own 0-d bool tensor on
    the device.  Raises RuntimeError when no conditional node can be made:
    nothing falls back to running body unconditionally in a graph.
    """
    if not (pred.is_cuda and torch.cuda.is_current_stream_capturing()):
        body()
        return
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"device_if: pred must be a 0-d bool tensor, got {pred.dtype} {tuple(pred.shape)}")
    if not getattr(_CAPTURE, "pooled", False):
        raise RuntimeError(
            "device_if: cannot capture a conditional graph node here: the body's allocations must go to "
            "the graph's memory pool, as CapturedGraph routes them (torch._C."
            f"_cuda_beginAllocateCurrentThreadToPool, torch {torch.__version__})")
    lib = _if_library()
    dev = pred.device
    stream = _body_stream(dev, _CAPTURE.__dict__.get("depth", 0))
    _if_check(lib.graph_if_begin(torch.cuda.current_stream(dev).cuda_stream, stream.cuda_stream,
                                 pred.data_ptr()), "adding an IF node to the graph")
    _CAPTURE.depth = _CAPTURE.__dict__.get("depth", 0) + 1
    try:
        with torch.cuda.stream(stream):
            body()
    finally:
        _CAPTURE.depth -= 1
        err = lib.graph_if_end(stream.cuda_stream)
    _if_check(err, "ending the capture of an IF node's body")


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
    outputs.  Each replay adds the raster, vertex, occlusion and darboux
    launches the capture recorded to raster_cuda.LAUNCHES,
    vertex_cuda.LAUNCHES, occlusion_cuda.LAUNCHES and darboux_cuda.LAUNCHES.
    The capture's allocations go to a private pool released with the
    graph; fn may branch with device_if.  `marked`: a frame graph, whose
    timing.mark calls record stage stamps when the tracer is on at the
    capture.  Attributes: outputs, launches (raster, by mode, per replay),
    vertex_launches (by kernel, per replay), occlusion_launches and
    darboux_launches (per replay), marks (timing.FrameMarks, or None),
    capture_s (warm-up + capture seconds), pool_bytes (device memory the
    capture reserved).
    Spans: graph.capture (warm-up and capture), graph.replay (the input
    copies and the launch).
    """

    _pool = None  # (device index, id) of the pool the capture allocated in
    marks = None

    def __init__(self, fn, inputs, name, hold=(), device=None, marked=False):
        with timing.span("graph.capture"):
            self._capture(fn, inputs, name, hold, device, marked)
        _ALIVE.add(self)

    def _capture(self, fn, inputs, name, hold, device, marked):
        self.lock = threading.Lock()
        self.hold = tuple(hold)
        dev = torch.device(device) if device is not None else inputs[0].device
        self.device = dev = dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())
        self.inputs = [x.to(dev, copy=True) for x in inputs]
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            _if_ready(dev)
            ring = timing.frame_ring(dev) if marked else None
            torch.cuda.empty_cache()  # as the capture's own entry does: the pool's growth is then its size
            reserved = torch.cuda.memory_reserved(dev)
            self.graph = torch.cuda.CUDAGraph()
            # Every allocation this thread makes during the capture, on the
            # capture stream and on device_if's body streams alike, goes to
            # a private pool kept with the graph (ahead of the graph's own
            # pool, which routes the capture stream only).
            to_pool = getattr(torch._C, "_cuda_beginAllocateCurrentThreadToPool", None)
            if to_pool is not None:
                self._pool = (dev.index, torch.cuda.graph_pool_handle())
                to_pool(*self._pool)
            _CAPTURE.pooled = self._pool is not None
            try:
                # The side stream is on `dev`; the default capture stream is
                # made once, on whichever device was current then.
                with raster_cuda.recording() as self.launches, \
                        vertex_cuda.recording() as self.vertex_launches, \
                        occlusion_cuda.recording() as self.occlusion_launches, \
                        darboux_cuda.recording() as self.darboux_launches, timing.marking(ring) as self.marks, \
                        torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                    self.outputs = fn(*self.inputs)
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing {name} as a CUDA graph failed; a captured frame may not read "
                    f"device values on the host or copy from pageable host memory: {e}") from e
            finally:
                _CAPTURE.pooled = False
                if self._pool is not None:
                    torch._C._cuda_endAllocateToPool(*self._pool)
        if self.marks is not None and not self.marks.labels:
            self.marks = None
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def __del__(self, _finalizing=sys.is_finalizing, _release=getattr(torch._C, "_cuda_releasePool", None)):
        if self._pool is not None and not _finalizing():
            _release(*self._pool)

    def __call__(self, *inputs):
        with timing.span("graph.replay"):
            if self.marks is None:
                self._launch(inputs)
            else:
                self.marks.ring.issue(self.marks, lambda: self._launch(inputs))
        raster_cuda.replayed(self.launches)
        vertex_cuda.replayed(self.vertex_launches)
        occlusion_cuda.replayed(self.occlusion_launches)
        darboux_cuda.replayed(self.darboux_launches)
        return self.outputs

    def _launch(self, inputs):
        """Copy `inputs` into the static inputs and replay the graph."""
        with torch.cuda.device(self.device):
            for static, x in zip(self.inputs, inputs):
                static.copy_(x, non_blocking=True)
            self.graph.replay()


class GraphCache:
    """Captured graphs by key, at most `size` alive (least recently used
    evicted first).  Thread-safe: captures run one at a time."""

    def __init__(self, size=GRAPH_CACHE_SIZE):
        self.size = size
        self._graphs = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, capture):
        """The graph under `key`, captured by capture() on a miss.  Counts
        (timing.count) graph.captures, graph.hits and graph.evictions."""
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None:
                timing.count("graph.captures")
                graph = capture()
                self._graphs[key] = graph
                while len(self._graphs) > self.size:
                    timing.count("graph.evictions")
                    self._graphs.popitem(last=False)
            else:
                timing.count("graph.hits")
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
