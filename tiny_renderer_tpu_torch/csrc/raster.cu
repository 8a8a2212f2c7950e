// K1 phase 1 — the tile raster's depth resolve, hand-written for Hopper (sm_90a).
//
// Replaces: tiny_renderer_tpu/ops/raster_pallas.py, rasterize_pallas ->
// _raster_kernel, phase 1 (_depth_resolve, raster_pallas.py:85-152), in its
// three output modes: depth only (the shadow map's light pass), index only
// (the camera pass of a burst frame) and depth + index (Scene.render's
// camera pass).
//
// What it computes.  One thread block per tile_h x tile_w screen tile.  The
// block walks the tile's CSR slice [starts[t], starts[t+1]) of the binned
// incidence list in ascending slot (= ascending triangle) order, reads
// record rec[tris[k]] and, for every pixel of the tile, evaluates the
// integer edge functions (exact in f32), the sign tests and the
// interpolated depth, and keeps the candidate only if its z is strictly
// greater than the stored one.  So equal depths keep the earliest triangle,
// exactly like the reference's serial `z <= stored -> reject`
// (shader.rs:169-180).  Every pixel is owned by one thread, which keeps its
// z and index in registers for the whole walk: no atomics, so the result is
// deterministic and bit-stable.  Clear values are f32::MIN and -1.
//
// Arithmetic.  Each expression is evaluated in the order the Pallas kernel
// writes it (raster_pallas.py:109-127), with the reciprocal multiply
// u = cx * rcz (not a division), and the file is compiled with -fmad=false:
// no mul+add is contracted into an FMA, so the kernel equals its eager torch
// twin (raster_cuda.rasterize_reference) bit for bit on the card.
//
// What bounds it on this card.  Per-pixel ALU work over the record stream:
// about 25 flops per (pixel, candidate) for every pixel of the tile, for
// each of the tile's ~1.3x-mean incidences; the records themselves are a
// few hundred KB read from L2, the outputs one write per pixel.  The design
// keeps the per-pixel state in registers (16 pixels per thread), stages the
// records through shared memory in chunks so a block reads each record once
// from L2 and all threads read it as a shared-memory broadcast, and has
// no per-candidate global traffic.  What it does not do yet (later work):
// 800x800 makes only 175 blocks for 132 SMs, there is no cp.async/TMA
// double buffering of the record chunks, and the tile shape is the TPU's.

#include <cuda_runtime.h>

namespace {

constexpr int kPix = 16;      // pixels per thread (registers)
constexpr int kChunk = 128;   // records staged per shared-memory chunk
constexpr int kLanes = 13;    // record lanes the depth loop reads
constexpr float kF32Min = -3.40282347e+38f;

template <bool kEmitZ, bool kEmitIdx>
__global__ void raster_depth_kernel(const float* __restrict__ rec, int rec_stride,
                                    const int* __restrict__ tris,
                                    const int* __restrict__ starts, int tiles_x,
                                    int tile_h, int tile_w, int row_off, int out_w,
                                    float* __restrict__ z_out,
                                    int* __restrict__ idx_out) {
  __shared__ float s_rec[kChunk][16];

  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int start = starts[tile];
  const int end = starts[tile + 1];

  float px[kPix], py[kPix], best[kPix];
  int bidx[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    const int row = p / tile_w;
    const int col = p - row * tile_w;
    px[j] = (float)(tx * tile_w + col);
    py[j] = (float)((ty + row_off) * tile_h + row);
    best[j] = kF32Min;
    bidx[j] = -1;
  }

  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n * kLanes; i += blockDim.x) {
      const int r = i / kLanes;
      const int l = i - r * kLanes;
      s_rec[r][l] = rec[(size_t)tris[c0 + r] * rec_stride + l];
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float a1 = s_rec[r][0], b1 = s_rec[r][1], c1 = s_rec[r][2];
      const float a2 = s_rec[r][3], b2 = s_rec[r][4], c2 = s_rec[r][5];
      const float sgn = s_rec[r][6], absz = s_rec[r][7], rcz = s_rec[r][8];
      const float z1 = s_rec[r][9], z2 = s_rec[r][10], z3 = s_rec[r][11];
      const int gidx = (int)s_rec[r][12];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const float cx = a1 * px[j] + b1 * py[j] + c1;
        const float cy = a2 * px[j] + b2 * py[j] + c2;
        const float cxs = cx * sgn;
        const float cys = cy * sgn;
        const bool inside = (cxs >= 0.0f) & (cys >= 0.0f) & (absz - cxs - cys >= 0.0f);
        const float u = cx * rcz;
        const float v = cy * rcz;
        const float w = 1.0f - (cx + cy) * rcz;
        const float z = (w * z1 + u * z2) + v * z3;
        if (inside && z > best[j]) {
          best[j] = z;
          bidx[j] = gidx;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    const int row = p / tile_w;
    const int col = p - row * tile_w;
    const size_t o = (size_t)(ty * tile_h + row) * out_w + tx * tile_w + col;
    if (kEmitZ) z_out[o] = best[j];
    if (kEmitIdx) idx_out[o] = bidx[j];
  }
}

}  // namespace

extern "C" {

// Pixels each thread owns; the wrapper launches tile_h * tile_w / this
// many threads per block.
int raster_pixels_per_thread() { return kPix; }

// Launch the depth resolve on `stream`.  z_out and/or idx_out may be null
// (not emitted); both are (tiles_y * tile_h, tiles_x * tile_w) row-major.
// Returns cudaGetLastError() after the launch.
int raster_depth(const float* rec, int rec_stride, const int* tris, const int* starts,
                 int num_tiles, int tiles_x, int tile_h, int tile_w, int row_off,
                 float* z_out, int* idx_out, void* stream) {
  const int threads = tile_h * tile_w / kPix;
  const int out_w = tiles_x * tile_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_out && idx_out) {
    raster_depth_kernel<true, true><<<num_tiles, threads, 0, s>>>(
        rec, rec_stride, tris, starts, tiles_x, tile_h, tile_w, row_off, out_w, z_out,
        idx_out);
  } else if (z_out) {
    raster_depth_kernel<true, false><<<num_tiles, threads, 0, s>>>(
        rec, rec_stride, tris, starts, tiles_x, tile_h, tile_w, row_off, out_w, z_out,
        idx_out);
  } else if (idx_out) {
    raster_depth_kernel<false, true><<<num_tiles, threads, 0, s>>>(
        rec, rec_stride, tris, starts, tiles_x, tile_h, tile_w, row_off, out_w, z_out,
        idx_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* raster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
