// The darboux pipeline's strip chunk body, hand-written for Hopper (sm_90a):
// one thread a fragment, from a chunk's slot ids to the words in the strip
// shade's accumulator.
//
// Replaces no Pallas kernel: the JAX package leaves the strip shade's batch
// body to XLA's fusion (tiny_renderer_tpu/pipelines/frame.py, the
// while_loop of the strip shade, and pipelines/shaders.py shade_darboux).
// The port's plain torch body (pipelines/frame.py _shade_strips' chunk:
// _gather_fragments, compute_varyings, shaders.shade_darboux and the word
// pack) issues ~220 small kernels a chunk body, each streaming a chunk-sized
// float32 intermediate (a 32-float gather table row a fragment among them)
// through device memory for a few flops; replayed as graph nodes they cost
// ~0.6 ms of a ~1.0 ms frame on the H100.  So this file exists to keep the
// per-fragment values in registers and cut the nodes to one.
//
// What bounds it on this card: benchmark/roofline_darboux.py counts the
// shade's least work from the interpolated varyings to the colour, 9 B and
// 142 f32 operations a covered pixel, ~0.2 us at the stand-in scene's
// ~71,000 covered pixels (bytes bound).  This kernel also reads each
// fragment's winner id and its triangle's setup columns (32 words of a
// triangle: 5,096 triangles, ~650 KB, which stay resident in the 50 MB L2),
// so a launch is bound by its latency and those dependent reads, not by
// either peak.
//
// Design.  One launch over the chunk's slots x strip_len lanes, 256 threads
// a block, neighbouring lanes on neighbouring pixels, so the id reads and the
// accumulator writes coalesce.  A thread finds its strip (the slot id, or
// past the last strip a fill slot, which writes nothing: the torch body's
// writes there go to a spare row that is cut off) and its pixel, reads the
// winner id (an uncovered lane writes 0), reads the winner's setup columns
// in place (no gather table is built), recomputes the barycentrics,
// interpolates uv and the normal, samples both maps with one read of the
// word-packed plane (row-major, or tile-swizzled), and does the basis, its
// inverse, the two solves, the normalizes, the diffuse dot and the blend
// toward black in registers.  It writes one packed RGB word, or the u8
// triple when the accumulator holds triples (strip_pack_words off).  The
// per-pixel 3x3 matrix is no tensor-core shape: FP32 CUDA-core work.
//
// Exactness.  Built with -fmad=false and IEEE division and square root
// (nvcc's defaults without --use_fast_math), every expression is written in
// ops/mathlib.py's, pipelines/frame.py's and pipelines/shaders.py's order,
// operation for operation, so the words equal the torch body's bit for bit
// on the same device:
//  * the edge coefficients as int32 -> float32 (round to nearest), the
//    pixel as float32 of its int64 coordinates (exact), the barycentrics
//    1 - (cx + cy) / cz, cx / cz, cy / cz;
//  * interpolation and dots in nalgebra's order (a0 b0 + a1 b1) + a2 b2;
//  * norm3: torch takes the float64 square root of the float32 dot and
//    rounds it to float32, which equals the correctly rounded float32
//    square root (__fsqrt_rn);
//  * the texel coordinates: uv * dims, NaN -> 0, saturated to [0,
//    4294967040], truncated, clamped to dims - 1 (mathlib.rust_f32_to_u32,
//    shaders._tex_coords), re-encoded for the tile-swizzled plane when
//    `tile` is not 0 (shaders._swizzle_index);
//  * the decoded normal: byte * (1 / 255) - 0.5, since ATen divides a CUDA
//    tensor by a Python scalar as a product with the scalar's float32
//    reciprocal, then normalized (a division by the norm);
//  * mat3_inverse: the cofactors, det = (m00 c00 + m01 c01) + m02 c02, and
//    1 / det as torch computes it (a reciprocal, then a product with 1,
//    which changes nothing), times each cofactor;
//  * the solves against (du, 0) and (dv, 0): the third product is taken,
//    so an infinite or NaN inverse from a singular basis gives NaN;
//  * color_blend toward black: t c + (1 - t) * 0 a channel, the second term
//    kept (an infinite t gives NaN), then `as u8`: NaN -> 0, saturate at
//    [0, 255], truncate.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads a block, one fragment each
constexpr float kInv255 = 1.0f / 255.0f;  // torch's x / 255.0 on the card: x * float32(1 / 255)

struct Setup {
  const int* a1;  // (T,) int32 edge coefficients
  const int* b1;
  const int* c1;
  const int* a2;
  const int* b2;
  const int* c2;
  const int* cz;
  const float* uv;  // (T, 3, 2)
  const float* t_norm;  // (T, 3, 3)
  const float* row0n;  // (T, 3)
  const float* row1n;  // (T, 3)
  const float* du;  // (T, 2)
  const float* dv;  // (T, 2)
};

struct Args {
  Setup s;
  const void* strips;  // (n_strips, strip_len) winner ids, int32 or int16
  const long long* cids;  // (n_slots,) strip ids of the chunk's slots
  const int* plane;  // (h, w, 2) packed texture and tangent-map words
  const float* light;  // t_light_direction (3,)
  void* acc;  // (n_strips + 1, strip_len) int32 words, or (n_strips + 1, strip_len, 3) u8
  bool acc_words;  // acc holds packed words
  int n_slots, n_strips, strip_len, pixels, width, y_offset;
  int tex_w, tex_h, tile;
};

__device__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ void normalize3(const float* a, float* out) {
  const float n = __fsqrt_rn(dot3(a, a));
  for (int i = 0; i < 3; ++i) out[i] = a[i] / n;
}

// mathlib.rust_f32_to_u32, then the clamp of shaders._tex_coords.
__device__ long long tex_coord(float x, int dim) {
  if (isnan(x)) x = 0.0f;
  x = fminf(fmaxf(x, 0.0f), 4294967040.0f);
  const long long c = static_cast<long long>(static_cast<unsigned int>(x));
  return c < dim - 1 ? c : dim - 1;
}

// mathlib.rust_f32_to_u8.
__device__ unsigned int to_u8(float x) {
  if (isnan(x)) x = 0.0f;
  return static_cast<unsigned int>(fminf(fmaxf(x, 0.0f), 255.0f));
}

// shaders._decode_normal of one packed word's RGB.
__device__ void decode_normal(int word, float* n) {
  float v[3];
  for (int c = 0; c < 3; ++c) v[c] = static_cast<float>((word >> (8 * c)) & 0xFF) * kInv255 - 0.5f;
  normalize3(v, n);
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads) darboux_kernel(Args a) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.n_slots * a.strip_len) return;
  const int slot = t / a.strip_len, lane = t - slot * a.strip_len;
  const long long cid = a.cids[slot];
  if (cid >= a.n_strips) return;  // a fill slot: the torch body writes the spare row
  const long long at = cid * a.strip_len + lane;  // strips[cid][lane], and acc's row cid
  const int id = static_cast<int>(static_cast<const Idx*>(a.strips)[at]);

  int word = 0;
  if (id >= 0) {
    const Setup& s = a.s;
    // The pixel (frame._shade_strips: base clamped to the last pixel).
    const long long base = at < a.pixels - 1 ? at : a.pixels - 1;
    const float px = static_cast<float>(base % a.width);
    const float py = static_cast<float>(base / a.width + a.y_offset);
    // Barycentrics (frame._gather_fragments).
    const float cx = (static_cast<float>(s.a1[id]) * px + static_cast<float>(s.b1[id]) * py) +
                     static_cast<float>(s.c1[id]);
    const float cy = (static_cast<float>(s.a2[id]) * px + static_cast<float>(s.b2[id]) * py) +
                     static_cast<float>(s.c2[id]);
    const float cz = static_cast<float>(s.cz[id]);
    const float b[3] = {1.0f - (cx + cy) / cz, cx / cz, cy / cz};
    // Varyings (shaders.compute_varyings): uv and local_z interpolated.
    const float* uv = s.uv + 6 * id;
    const float* tn = s.t_norm + 9 * id;
    float u[2], local_z[3];
    for (int c = 0; c < 2; ++c) u[c] = (uv[c] * b[0] + uv[2 + c] * b[1]) + uv[4 + c] * b[2];
    for (int c = 0; c < 3; ++c) local_z[c] = (tn[c] * b[0] + tn[3 + c] * b[1]) + tn[6 + c] * b[2];

    // The two maps at one texel of the packed plane (shaders.sample_maps).
    const long long tx = tex_coord(u[0] * static_cast<float>(a.tex_w), a.tex_w);
    const long long ty = tex_coord(u[1] * static_cast<float>(a.tex_h), a.tex_h);
    long long texel = ty * a.tex_w + tx;
    if (a.tile) {
      const long long tl = a.tile;
      texel = ((ty / tl * (a.tex_w / tl) + tx / tl) * tl + ty % tl) * tl + tx % tl;
    }
    const int color = __ldg(a.plane + 2 * texel);
    float sample[3];
    decode_normal(__ldg(a.plane + 2 * texel + 1), sample);

    // shaders.shade_darboux: the basis, its inverse (mathlib.mat3_inverse),
    // the two solves and the tangent-space normal.
    float m0[3], m1[3], m2[3];
    for (int c = 0; c < 3; ++c) {
      m0[c] = s.row0n[3 * id + c];
      m1[c] = s.row1n[3 * id + c];
    }
    normalize3(local_z, m2);
    const float c00 = m1[1] * m2[2] - m1[2] * m2[1];
    const float c01 = m1[2] * m2[0] - m1[0] * m2[2];
    const float c02 = m1[0] * m2[1] - m1[1] * m2[0];
    const float det = (m0[0] * c00 + m0[1] * c01) + m0[2] * c02;
    const float invdet = (1.0f / det) * 1.0f;
    const float inv[9] = {
        c00 * invdet, (m0[2] * m2[1] - m0[1] * m2[2]) * invdet, (m0[1] * m1[2] - m0[2] * m1[1]) * invdet,
        c01 * invdet, (m0[0] * m2[2] - m0[2] * m2[0]) * invdet, (m0[2] * m1[0] - m0[0] * m1[2]) * invdet,
        c02 * invdet, (m0[1] * m2[0] - m0[0] * m2[1]) * invdet, (m0[0] * m1[1] - m0[1] * m1[0]) * invdet,
    };
    const float du0 = s.du[2 * id], du1 = s.du[2 * id + 1];
    const float dv0 = s.dv[2 * id], dv1 = s.dv[2 * id + 1];
    float local_x[3], local_y[3];
    for (int r = 0; r < 3; ++r) {
      local_x[r] = (inv[3 * r] * du0 + inv[3 * r + 1] * du1) + inv[3 * r + 2] * 0.0f;
      local_y[r] = (inv[3 * r] * dv0 + inv[3 * r + 1] * dv1) + inv[3 * r + 2] * 0.0f;
    }
    float col_x[3], col_y[3], col_z[3], sum[3], normal[3];
    normalize3(local_x, col_x);
    normalize3(local_y, col_y);
    normalize3(local_z, col_z);
    for (int c = 0; c < 3; ++c) sum[c] = (col_x[c] * sample[0] + col_y[c] * sample[1]) + col_z[c] * sample[2];
    normalize3(sum, normal);
    const float diff = dot3(a.light, normal);

    // mathlib.color_blend(texel, black, diff), then the word.
    const float black = (1.0f - diff) * 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float texel_c = static_cast<float>((color >> (8 * c)) & 0xFF);
      word |= static_cast<int>(to_u8(diff * texel_c + black) << (8 * c));
    }
  }
  if (a.acc_words) {
    static_cast<int*>(a.acc)[at] = word;
  } else {
    unsigned char* out = static_cast<unsigned char*>(a.acc) + 3 * at;
    for (int c = 0; c < 3; ++c) out[c] = static_cast<unsigned char>((word >> (8 * c)) & 0xFF);
  }
}

}  // namespace

extern "C" {

// Launch darboux_kernel on `stream` over the n_slots > 0 slots of one chunk
// (cids: their strip ids, n_strips for a fill slot), each strip_len lanes:
// strips holds the winner ids (idx_bytes 4: int32, 2: int16) of n_strips
// strips over `pixels` pixels of rows `width` wide, whose first row is
// y_offset; the setup columns of the winners (see Setup); the packed plane
// of tex_h x tex_w texels of two words, tile-swizzled by `tile` (0:
// row-major); the light (3 floats); and acc, n_strips + 1 rows of strip_len
// int32 words (acc_words) or u8 triples.  Returns cudaGetLastError() after
// the launch.
int darboux_chunk_body(const int* a1, const int* b1, const int* c1, const int* a2, const int* b2, const int* c2,
                       const int* cz, const float* uv, const float* t_norm, const float* row0n,
                       const float* row1n, const float* du, const float* dv, const void* strips, int idx_bytes,
                       const long long* cids, int n_slots, int n_strips, int strip_len, int pixels, int width,
                       int y_offset, const int* plane, int tex_w, int tex_h, int tile, const float* light,
                       void* acc, int acc_words, void* stream) {
  if (n_slots <= 0 || n_strips <= 0 || strip_len <= 0 || pixels <= 0 || width <= 0 || tex_w <= 0 ||
      tex_h <= 0 || tile < 0 || (idx_bytes != 4 && idx_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const Args a{{a1, b1, c1, a2, b2, c2, cz, uv, t_norm, row0n, row1n, du, dv},
               strips, cids, plane, light, acc, acc_words != 0,
               n_slots, n_strips, strip_len, pixels, width, y_offset, tex_w, tex_h, tile};
  const long long threads = static_cast<long long>(n_slots) * strip_len;
  const unsigned int blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) {
    darboux_kernel<int32_t><<<blocks, kThreads, 0, s>>>(a);
  } else {
    darboux_kernel<int16_t><<<blocks, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* darboux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
