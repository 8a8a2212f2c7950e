// Stage stamps of a replayed frame: the device side of utils/timing.py's
// mark().  It replaces no TPU kernel: the JAX package has no tracing inside
// its compiled frame.  Plain C entry points, loaded with ctypes.
//
// trace_mark records one one-thread kernel on `stream` (a frame graph's
// capture stream) that reads %globaltimer (ns) and writes it into a ring of
// frames in device memory, int64 words, `stride` a row:
//   row 0, word 0:   the frame counter f (frames started so far);
//   row 1 + (f - 1) % frames: frame f, word `slot` the stamp of mark `slot`
//   (-1 where that mark did not run: a mark in an IF node's body that the
//   replay skipped), word stride - 3 the frame's covered pixels, word
//   stride - 2 the frame number f, word stride - 1 the strip shade's covered
//   count (-1 where the frame has none).
// The frame's first mark (advance) moves the counter on, claims its row and
// clears it; the later marks write into the row the counter points to, so
// the frames of one stream never share a row until the ring wraps.
// `covered` and `pixels`, where not null, are counts (int32) on the device,
// copied into the row.  Bound by its launch (~2 us in a graph), not by
// bytes: one thread writes a row.  utils/timing.py's mark_reference is its
// plain version.

#include <cuda_runtime.h>

namespace {

__global__ void mark_kernel(long long* ring, int frames, int stride, int slot, int advance, const int* covered,
                            const int* pixels) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long f = ring[0] + (advance ? 1 : 0);
  if (f <= 0) return;  // a mark before any frame started: nowhere to write
  long long* row = ring + (1 + (f - 1) % frames) * stride;
  if (advance) {
    ring[0] = f;
    for (int i = 0; i < stride - 2; ++i) row[i] = -1;
    row[stride - 2] = f;
    row[stride - 1] = -1;
  }
  row[slot] = static_cast<long long>(now);
  if (covered) row[stride - 1] = *covered;
  if (pixels) row[stride - 3] = *pixels;
}

}  // namespace

extern "C" {

int trace_mark(void* stream, void* ring, int frames, int stride, int slot, int advance, const void* covered,
               const void* pixels) {
  mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), frames, stride, slot, advance, static_cast<const int*>(covered),
      static_cast<const int*>(pixels));
  return cudaGetLastError();
}

// Loads the kernel's module now, so that no capture loads it.
int trace_mark_load() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, mark_kernel);
}

const char* trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
