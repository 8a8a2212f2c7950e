// Device helpers shared by the hand-written shade kernels (darboux.cu,
// occlusion.cu, shadow.cu): one copy of each piece of arithmetic that more
// than one of them repeats from the torch code.
//
// Every helper is written in the order of the torch expression it stands
// for, operation for operation, and the files that include it are built
// with -fmad=false and IEEE division and square root (raster_cuda's
// NVCC_FLAGS), so a kernel's values equal the torch code's bit for bit on
// the same device.  Each kernel's own note says which torch functions it
// follows; here, what each helper computes.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace shade {

// ((a0 b0 + a1 b1) + a2 b2): nalgebra's dot, mathlib.dot3.
__device__ inline float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// Row i of the row-major 4x4 m times (x, y, z, 1): ((m0 x + m1 y) + m2 z) +
// m3, as mathlib.mat4_transform_point sums each row before dividing by w.
__device__ inline float mat4_row(const float* m, int i, float x, float y, float z) {
  return ((m[4 * i] * x + m[4 * i + 1] * y) + m[4 * i + 2] * z) + m[4 * i + 3];
}

// Entry (i, j) of a * b, row-major 4x4 (mathlib.mat4_mul's pairwise sum).
__device__ inline float mat4_mul_entry(const float* a, const float* b, int i, int j) {
  return (a[4 * i] * b[j] + a[4 * i + 1] * b[4 + j]) + (a[4 * i + 2] * b[8 + j] + a[4 * i + 3] * b[12 + j]);
}

// mathlib.rust_round: f32::round, half away from zero (floor, then a
// three-way compare on the fraction; NaN stays NaN, +-inf stay +-inf).
__device__ inline float rust_round(float x) {
  const float f = floorf(x);
  const float frac = x - f;
  const float up = f + 1.0f;
  return frac > 0.5f ? up : (frac < 0.5f ? f : (x >= 0.0f ? up : f));
}

// mathlib.rust_f32_to_u32 (`as u32`): NaN -> 0, saturate at [0,
// 4294967040], truncate.
__device__ inline unsigned long long f32_to_u32(float x) {
  if (isnan(x)) x = 0.0f;
  x = fminf(fmaxf(x, 0.0f), 4294967040.0f);
  return static_cast<unsigned long long>(static_cast<unsigned int>(x));
}

// mathlib.rust_f32_to_u8 (`as u8`): NaN -> 0, saturate at [0, 255],
// truncate.
__device__ inline unsigned int to_u8(float x) {
  if (isnan(x)) x = 0.0f;
  return static_cast<unsigned int>(fminf(fmaxf(x, 0.0f), 255.0f));
}

// shaders._swizzle_index: the row-major cell (cx, cy) of a plane `w` wide
// in the layout whose tile x tile blocks are contiguous.
template <typename I>
__device__ inline I swizzle(I cx, I cy, I w, I tile) {
  return ((cy / tile * (w / tile) + cx / tile) * tile + cy % tile) * tile + cx % tile;
}

// shaders.shadow_flat_indices for one coordinate pair: rust_round, `as
// u32`, (ix + iy * width) mod 2^32, clamped to the plane's size - 1, then
// re-encoded for the tile-swizzled plane when `tile` is not 0.
__device__ inline unsigned int shadow_index(float sx, float sy, int width, unsigned int size, int tile) {
  const unsigned long long ix = f32_to_u32(rust_round(sx));
  const unsigned long long iy = f32_to_u32(rust_round(sy));
  unsigned long long flat = (ix + iy * static_cast<unsigned long long>(width)) & 0xFFFFFFFFull;
  if (flat > size - 1) flat = size - 1;
  unsigned int f = static_cast<unsigned int>(flat);
  if (tile) {
    const unsigned int w = width, cy = f / w, cx = f - cy * w;
    f = swizzle<unsigned int>(cx, cy, w, tile);
  }
  return f;
}

// shaders._tex_coords and the packed plane's texel index (sample_maps):
// uv * dims `as u32`, clamped to dims - 1, row-major or tile-swizzled.
__device__ inline long long texel_index(const float* uv, int tex_w, int tex_h, int tile) {
  const long long cw = static_cast<long long>(f32_to_u32(uv[0] * static_cast<float>(tex_w)));
  const long long ch = static_cast<long long>(f32_to_u32(uv[1] * static_cast<float>(tex_h)));
  const long long tx = cw < tex_w - 1 ? cw : tex_w - 1;
  const long long ty = ch < tex_h - 1 ? ch : tex_h - 1;
  if (tile) return swizzle<long long>(tx, ty, tex_w, tile);
  return ty * tex_w + tx;
}

// mathlib.color_blend(texel, black, t) of one packed RGB word, then the
// pack of frame._shade_strips: t c + (1 - t) * 0 a channel, the second
// term kept (an infinite t gives NaN), `as u8`, one byte a channel.
__device__ inline int blend_black_word(int color, float t) {
  const float black = (1.0f - t) * 0.0f;
  int word = 0;
  for (int c = 0; c < 3; ++c) {
    const float texel_c = static_cast<float>((color >> (8 * c)) & 0xFF);
    word |= static_cast<int>(to_u8(t * texel_c + black) << (8 * c));
  }
  return word;
}

// The winners' edge coefficients, (T,) int32 columns of triangle_setup.
struct Edges {
  const int* a1;
  const int* b1;
  const int* c1;
  const int* a2;
  const int* b2;
  const int* c2;
  const int* cz;
};

// One chunk body of frame._shade_strips: the slots `cids` of the strip
// plane `strips` and the accumulator they write.
struct Chunk {
  const void* strips;  // (n_strips, strip_len) winner ids, int32 or int16
  const long long* cids;  // (n_slots,) strip ids of the chunk's slots
  void* acc;  // (n_strips + 1, strip_len) int32 words, or (n_strips + 1, strip_len, 3) u8
  bool acc_words;  // acc holds packed words
  int n_slots, n_strips, strip_len, pixels, width, y_offset;
};

// Thread t's fragment of the chunk: `at`, its place in the strip plane and
// in acc (strips[cid][lane]), and its winner id (< 0: uncovered).  False
// past the chunk's threads and on a fill slot (a cid of n_strips), whose
// torch-body writes go to a spare row that is cut off: write nothing there.
template <typename Idx>
__device__ inline bool chunk_fragment(const Chunk& c, int t, long long* at, int* id) {
  if (t >= c.n_slots * c.strip_len) return false;
  const int slot = t / c.strip_len, lane = t - slot * c.strip_len;
  const long long cid = c.cids[slot];
  if (cid >= c.n_strips) return false;
  *at = cid * c.strip_len + lane;
  *id = static_cast<int>(static_cast<const Idx*>(c.strips)[*at]);
  return true;
}

// The pixel of `at` (frame._shade_strips: clamped to the last pixel, its
// row offset by the slab's first row) as float32 coordinates, and the
// barycentrics of triangle `id` there (frame._gather_fragments: the int32
// coefficients rounded to float32, 1 - (cx + cy) / cz, cx / cz, cy / cz).
__device__ inline void pixel_barycentrics(const Chunk& c, const Edges& e, long long at, int id, float* px,
                                          float* py, float* b) {
  const long long base = at < c.pixels - 1 ? at : c.pixels - 1;
  *px = static_cast<float>(base % c.width);
  *py = static_cast<float>(base / c.width + c.y_offset);
  const float cx = (static_cast<float>(e.a1[id]) * *px + static_cast<float>(e.b1[id]) * *py) +
                   static_cast<float>(e.c1[id]);
  const float cy = (static_cast<float>(e.a2[id]) * *px + static_cast<float>(e.b2[id]) * *py) +
                   static_cast<float>(e.c2[id]);
  const float cz = static_cast<float>(e.cz[id]);
  b[0] = 1.0f - (cx + cy) / cz;
  b[1] = cx / cz;
  b[2] = cy / cz;
}

// (a0 b0 + a1 b1) + a2 b2 of three per-vertex values `stride` floats
// apart (shaders.compute_varyings' interpolation).
__device__ inline float interpolate(const float* a, int stride, const float* b) {
  return (a[0] * b[0] + a[stride] * b[1]) + a[2 * stride] * b[2];
}

// The writeback of frame._shade_strips at `at`: the packed word, or its
// three bytes when acc holds u8 triples.
__device__ inline void store(const Chunk& c, long long at, int word) {
  if (c.acc_words) {
    static_cast<int*>(c.acc)[at] = word;
  } else {
    unsigned char* out = static_cast<unsigned char*>(c.acc) + 3 * at;
    for (int k = 0; k < 3; ++k) out[k] = static_cast<unsigned char>((word >> (8 * k)) & 0xFF);
  }
}

}  // namespace shade
