// The shadow pipeline's strip chunk body, hand-written for Hopper (sm_90a):
// one thread a fragment, from a chunk's slot ids to the words in the strip
// shade's accumulator.
//
// Replaces no Pallas kernel: the JAX package leaves the strip shade's batch
// body to XLA's fusion (tiny_renderer_tpu/pipelines/frame.py, the
// while_loop of the strip shade, and pipelines/shaders.py shade_shadow).
// The port's plain torch body (pipelines/frame.py _shade_strips' chunk:
// _gather_fragments, compute_varyings, shaders.shade_shadow and the word
// pack) issues ~190 small kernels a chunk body, each streaming a
// chunk-sized intermediate (a 19-float gather table row a fragment among
// them) through device memory for a few flops; replayed as graph nodes
// they cost ~0.39 ms of the shadow frame's ~0.55 ms shade on the H100.  So
// this file exists to keep the per-fragment values in registers and cut the
// nodes to one.
//
// What bounds it on this card: the least traffic is ~16 B a covered pixel
// (its winner id, its shadow-map value, its texel word and its output
// word) plus the winners' setup columns once a triangle (the 7 int32 edge
// coefficients, 6 uv, 3 intensity and 3 depth floats: 76 B), ~0.4 us at
// the stand-in scene's ~71,000 covered pixels and 5,096 triangles at 3.35
// TB/s (bytes bound; ~80 f32 operations a pixel are ~0.1 us at 67
// TFLOP/s).  The setup columns (~390 KB), the shadow plane (2.56 MB) and
// the packed texture (4 MB) all stay resident in the 50 MB L2, so a launch
// is bound by its latency and the dependent reads of a thread (id, columns,
// shadow value, texel), not by either peak.
//
// Design.  One launch over the chunk's slots x strip_len lanes, 256 threads
// a block, neighbouring lanes on neighbouring pixels, so the id reads and
// the accumulator writes coalesce.  The first 16 threads of a block form
// shadow_matrix * i_vpmv, one entry each, into shared memory (what the
// torch body's mat4_mul computes once a chunk: a few flops a block cost
// less than a second launch).  A thread then finds its strip (the slot id,
// or past the last strip a fill slot, which writes nothing: the torch
// body's writes there go to a spare row that is cut off) and its pixel,
// reads the winner id (an uncovered lane writes 0), reads the winner's
// setup columns in place (no gather table is built), recomputes the
// barycentrics, interpolates uv, the intensity and the depth, transforms
// the pixel into the light's view, reads the shadow map there (in place:
// the raster's depth plane is a view whose rows are padded), compares,
// reads the texel from the word-packed plane (row-major or tile-swizzled)
// and blends toward black.  It writes one packed RGB word, or the u8
// triple when the accumulator holds triples (strip_pack_words off).  Under
// strip_planes the raster's varying planes are not read: they equal what
// the setup columns give here.
//
// Exactness.  Built with -fmad=false and IEEE division (nvcc's defaults
// without --use_fast_math), every expression is written in ops/mathlib.py's,
// pipelines/frame.py's and pipelines/shaders.py's order, operation for
// operation (the pieces shared with the other shade kernels in
// shade_common.cuh), so the words equal the torch body's bit for bit on the
// same device:
//  * the edge coefficients as int32 -> float32 (round to nearest), the
//    pixel as float32 of its int64 coordinates (exact), the barycentrics
//    1 - (cx + cy) / cz, cx / cz, cy / cz;
//  * uv, intensity and zfrag interpolated as (a0 b0 + a1 b1) + a2 b2;
//  * mathlib.mat4_mul(shadow_matrix, i_vpmv): (a0 b0 + a1 b1) + (a2 b2 +
//    a3 b3) an entry; mat4_transform_point: ((m0 x + m1 y) + m2 z) + m3 a
//    row, the first three divided by the fourth;
//  * shaders.shadow_flat_indices: rust_round, `as u32`, (ix + iy * width)
//    mod 2^32, clamped to the map's size - 1, swizzled when the map's tile
//    (plane_tile_effective) is not 0;
//  * the compare: sc.z + shadow_bias < value ? shadow_dim : 1, false for a
//    NaN on either side, with the config's floats rounded to float32 as
//    ml.f32 rounds them;
//  * the texel: uv * dims `as u32`, clamped to dims - 1, row-major or
//    swizzled by the packed plane's tile;
//  * color_blend(texel, black, intensity * coefficient): t c + (1 - t) * 0
//    a channel, the second term kept, then `as u8`.

#include "shade_common.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block, one fragment each

struct Setup {
  shade::Edges e;  // (T,) int32 edge coefficients
  const float* uv;  // (T, 3, 2)
  const float* intensity;  // (T, 3)
  const float* zv;  // (T, 3)
};

struct Args {
  Setup s;
  shade::Chunk c;
  const int* plane;  // (h, w, 1) packed texture words
  int tex_w, tex_h, tile;
  const float* shadow;  // the (h, w) shadow map, tile-swizzled when shadow_tile != 0
  int shadow_width;  // config.width: the rows of the index
  unsigned int shadow_size;  // h * w
  int shadow_tile;
  unsigned int shadow_cols;  // w
  long long shadow_stride;  // floats from one of the map's rows to the next
  const float* shadow_matrix;  // 4x4
  const float* i_vpmv;  // 4x4
  float bias, dim;  // config.shadow_bias, config.shadow_dim as float32
};

template <typename Idx>
__global__ void __launch_bounds__(kThreads) shadow_kernel(Args a) {
  __shared__ float sm[16];  // shadow_matrix * i_vpmv, row-major
  if (threadIdx.x < 16) sm[threadIdx.x] = shade::mat4_mul_entry(a.shadow_matrix, a.i_vpmv, threadIdx.x / 4,
                                                                 threadIdx.x % 4);
  __syncthreads();
  long long at;
  int id;
  if (!shade::chunk_fragment<Idx>(a.c, blockIdx.x * kThreads + threadIdx.x, &at, &id)) return;

  int word = 0;
  if (id >= 0) {
    const Setup& s = a.s;
    float px, py, b[3];
    shade::pixel_barycentrics(a.c, s.e, at, id, &px, &py, b);
    // Varyings (shaders.compute_varyings).
    float u[2];
    for (int c = 0; c < 2; ++c) u[c] = shade::interpolate(s.uv + 6 * id + c, 2, b);
    const float intensity = shade::interpolate(s.intensity + 3 * id, 1, b);
    const float zfrag = shade::interpolate(s.zv + 3 * id, 1, b);

    // shaders.shade_shadow: the light-view point, the map's value there and
    // the compare.
    const float w = shade::mat4_row(sm, 3, px, py, zfrag);
    const float sx = shade::mat4_row(sm, 0, px, py, zfrag) / w;
    const float sy = shade::mat4_row(sm, 1, px, py, zfrag) / w;
    const float sz = shade::mat4_row(sm, 2, px, py, zfrag) / w;
    // The map's flat index f (its reshape(-1)), read in place: row f / w,
    // column f % w of rows shadow_stride floats apart.
    const unsigned int f = shade::shadow_index(sx, sy, a.shadow_width, a.shadow_size, a.shadow_tile);
    const float value = __ldg(a.shadow + (f / a.shadow_cols) * a.shadow_stride + f % a.shadow_cols);
    const float coef = sz + a.bias < value ? a.dim : 1.0f;

    // The texel (shaders.sample_frag), then color_blend toward black.
    const int color = __ldg(a.plane + shade::texel_index(u, a.tex_w, a.tex_h, a.tile));
    word = shade::blend_black_word(color, intensity * coef);
  }
  shade::store(a.c, at, word);
}

}  // namespace

extern "C" {

// Launch shadow_kernel on `stream` over the n_slots > 0 slots of one chunk
// (cids: their strip ids, n_strips for a fill slot), each strip_len lanes:
// strips holds the winner ids (idx_bytes 4: int32, 2: int16) of n_strips
// strips over `pixels` pixels of rows `width` wide, whose first row is
// y_offset; the setup columns of the winners (see Setup); the packed plane
// of tex_h x tex_w texture words, tile-swizzled by `tile` (0: row-major);
// the shadow map of shadow_size floats, indexed in rows shadow_width wide
// and tile-swizzled by shadow_tile, laid out in rows of shadow_cols floats
// shadow_stride floats apart; the row-major 4x4 shadow_matrix and i_vpmv;
// the float32 bias and dim; and acc, n_strips + 1 rows of strip_len int32
// words (acc_words) or u8 triples.  Returns cudaGetLastError() after the
// launch.
int shadow_chunk_body(const int* a1, const int* b1, const int* c1, const int* a2, const int* b2, const int* c2,
                      const int* cz, const float* uv, const float* intensity, const float* zv, const void* strips,
                      int idx_bytes, const long long* cids, int n_slots, int n_strips, int strip_len, int pixels,
                      int width, int y_offset, const int* plane, int tex_w, int tex_h, int tile,
                      const float* shadow, int shadow_width, unsigned int shadow_size, int shadow_tile,
                      unsigned int shadow_cols, long long shadow_stride, const float* shadow_matrix,
                      const float* i_vpmv, float bias, float dim, void* acc, int acc_words, void* stream) {
  if (n_slots <= 0 || n_strips <= 0 || strip_len <= 0 || pixels <= 0 || width <= 0 || tex_w <= 0 ||
      tex_h <= 0 || tile < 0 || shadow_width <= 0 || shadow_size == 0 || shadow_tile < 0 || shadow_cols == 0 ||
      shadow_stride < shadow_cols || (idx_bytes != 4 && idx_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const Args a{{{a1, b1, c1, a2, b2, c2, cz}, uv, intensity, zv},
               {strips, cids, acc, acc_words != 0, n_slots, n_strips, strip_len, pixels, width, y_offset},
               plane, tex_w, tex_h, tile,
               shadow, shadow_width, shadow_size, shadow_tile, shadow_cols, shadow_stride,
               shadow_matrix, i_vpmv, bias, dim};
  const long long threads = static_cast<long long>(n_slots) * strip_len;
  const unsigned int blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) {
    shadow_kernel<int32_t><<<blocks, kThreads, 0, s>>>(a);
  } else {
    shadow_kernel<int16_t><<<blocks, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* shadow_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
