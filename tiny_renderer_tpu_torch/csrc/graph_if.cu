// Conditional (IF) nodes for CUDA graphs captured from PyTorch streams: the
// device-side branch behind pipelines/graphs.py::device_if, the port's
// counterpart of a lax.cond and of the bounded lax.while_loop of the JAX
// frame (tiny_renderer_tpu/pipelines/frame.py _shade_strips, shaders.py
// dedup_gather).  Plain C entry points, loaded with ctypes.
//
// graph_if_begin, called while `stream` is being captured into a graph:
//  1. makes a conditional handle in the graph the stream captures into;
//  2. records a one-thread kernel that sets the handle from *pred (a bool
//     in device memory) when the graph runs;
//  3. adds an IF node after the stream's capture dependencies (that
//     kernel), and makes the node the stream's only dependency, so what the
//     stream captures next runs after the node;
//  4. starts capturing `body_stream` into the node's body graph.
// What is then issued on body_stream runs, at each launch of the graph, only
// where *pred holds.  graph_if_end ends the body's capture.  The nodes nest:
// a body may call graph_if_begin on its own stream.  Needs CUDA 12.4+.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The stream's capture status, graph and dependencies (the capture-info
// signature gained edge data in CUDA 13).
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr, n_deps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n_deps);
#endif
}

}  // namespace

extern "C" {

// cudaErrorStreamCaptureImplicit is returned when `stream` is not capturing.
int graph_if_begin(void* stream, void* body_stream, const void* pred) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(s, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(s, &status, &graph, &deps, &n_deps);  // now: the kernel
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

int graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

// Loads the kernel's module now, so that no capture loads it.
int graph_if_load() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, set_conditional_kernel);
}

// A non-blocking stream of the current device for bodies to be captured on.
int graph_stream_create(void** out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return err;
}

const char* graph_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
