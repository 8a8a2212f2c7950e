// The ambient-occlusion coefficient, hand-written for Hopper (sm_90a): one
// thread a fragment.
//
// Replaces no Pallas kernel: the JAX package leaves this function to XLA's
// fusion (tiny_renderer_tpu/pipelines/shaders.py occlusion_coefficient).
// The port's plain torch version of it (pipelines/shaders.py
// occlusion_reference: occlusion_sample_coords, shadow_flat_indices, one
// gather, occlusion_update) issues ~385 small kernels a chunk body, each
// streaming an (n + 1) x fragments int64 or float32 intermediate through
// device memory for a few flops; replayed as graph nodes they cost ~0.84 ms
// of a ~1.34 ms frame on the H100.  So this file exists to keep the
// intermediates in registers and cut the nodes to one.
//
// What bounds it on this card: at the upstream's 800x800, the least work is
// the light's depth plane read once (2.56 MB) plus 7 B a covered pixel
// (its depth in, its colour out), ~0.9 us at 3.35 TB/s, and ~700 f32
// operations a covered pixel, ~0.7 us at 67 TFLOP/s.  At the stand-in
// scene's ~71,000 covered pixels a launch is bound by its latency and the
// 17 plane reads a thread makes, not by either peak.
//
// Design.  One launch over the N fragments, 256 threads a block.  Thread 0
// of each block computes the frame-constant part (the light in model space,
// rotation_between((0, 0, 1), light), shadow_matrix * i_vpmv) into shared
// memory; every block does the same few hundred flops, which costs less
// than a second launch would.  Each thread then computes its fragment's
// world point and shadow coordinates, reads the plane there, and for each
// of the n samples its rotated, scaled direction (from the n float32
// directions the wrapper passes, built as the torch code builds them), the
// sample's shadow coordinates, the plane value there, and the update.  The
// plane (2.56 MB at 800x800) stays in device memory and is read through
// the read-only path: it fits the 50 MB L2, so after the first touches the
// reads are L2 hits.  n is a runtime argument: the directions are read
// from global memory, so any n >= 1 runs.
//
// Exactness.  Built with -fmad=false and IEEE division and square root
// (nvcc's defaults without --use_fast_math), every expression is written in
// ops/mathlib.py's and pipelines/shaders.py's order, operation for
// operation (the pieces shared with the other shade kernels in
// shade_common.cuh), so the result equals the torch version bit for bit on
// the same device (acosf, sinf and cosf are the CUDA math library's, as torch's
// kernels call them):
//  * mathlib.mat4_transform_point: ((m0 x + m1 y) + m2 z) + m3 per row, each
//    row divided by w; mat4_mul and mat3_vec in nalgebra's order; norm3 as
//    the float64 square root of the float32 dot rounded back to float32;
//  * rotation_between: the dot clamped into [-1, 1] with NaN kept (as
//    torch.clamp does), the axis divided by the cross's norm only where it
//    exceeds f32::EPSILON, the aligned/opposite cases as torch.where picks;
//  * rust_round: floor, then a three-way compare on the fraction (half away
//    from zero; NaN stays NaN and +-inf stay +-inf, as the torch code);
//    `as u32`: NaN -> 0, clamp to [0, 4294967040], truncate;
//  * the index: (ix + iy * width) mod 2^32, clamped to the plane's size - 1,
//    then re-encoded for the tile-swizzled plane when `tile` is not 0
//    (shaders._swizzle_index);
//  * occlusion_update: occluded = (sval - threshold) > fval; strength =
//    (sval - fval) / depth_scale, computed as torch computes it on the
//    card: ATen divides a CUDA tensor by a Python scalar as a product with
//    the scalar's float32 reciprocal, so the wrapper passes
//    float32(1) / float32(depth_scale) and the kernel multiplies; then
//    min(strength, 1) with NaN kept (as torch.clamp(max=) does; fminf
//    would drop it); occ = occluded ? occ - inv_n * strength : occ, in
//    sample order from 1.  (On the CPU torch divides; the CPU twin is
//    held to JAX there, the kernel to the twin on the card.)

#include "shade_common.cuh"

namespace {

using shade::dot3;
using shade::mat4_row;

constexpr int kThreads = 256;  // threads a block, one fragment each

struct Constants {
  float rot[9];  // rotation_between((0, 0, 1), light), row-major
  float sm[16];  // shadow_matrix * i_vpmv, row-major
};

__device__ float norm3(const float* a) {
  return static_cast<float>(sqrt(static_cast<double>(dot3(a, a))));
}

__device__ void normalize3(const float* a, float* out) {
  const float n = norm3(a);
  for (int i = 0; i < 3; ++i) out[i] = a[i] / n;
}

// mathlib.rotation_between(a, b) for one pair of vectors.
__device__ void rotation_between(const float* a, const float* b, float* rot) {
  float na[3], nb[3], c[3];
  normalize3(a, na);
  normalize3(b, nb);
  c[0] = na[1] * nb[2] - na[2] * nb[1];
  c[1] = na[2] * nb[0] - na[0] * nb[2];
  c[2] = na[0] * nb[1] - na[1] * nb[0];
  const float norm_c = norm3(c);
  const float d = dot3(na, nb);
  const float eps = 1.1920928955078125e-7f;  // f32::EPSILON
  const bool turn = norm_c > eps;
  const float by = turn ? norm_c : 1.0f;
  const float ax = c[0] / by, ay = c[1] / by, az = c[2] / by;
  const float dc = d < -1.0f ? -1.0f : (d > 1.0f ? 1.0f : d);  // clamp, NaN kept
  const float angle = acosf(dc);
  const float s = sinf(angle);
  const float cth = cosf(angle);
  const float one_m = 1.0f - cth;
  if (turn) {
    rot[0] = ax * ax * one_m + cth;
    rot[1] = ax * ay * one_m - az * s;
    rot[2] = ax * az * one_m + ay * s;
    rot[3] = ax * ay * one_m + az * s;
    rot[4] = ay * ay * one_m + cth;
    rot[5] = ay * az * one_m - ax * s;
    rot[6] = ax * az * one_m - ay * s;
    rot[7] = ay * az * one_m + ax * s;
    rot[8] = az * az * one_m + cth;
  } else {
    const float flip = d >= 0.0f ? 1.0f : -1.0f;  // the identity, or 180 degrees about x
    const float eye[9] = {1.0f, 0.0f, 0.0f, 0.0f, flip, 0.0f, 0.0f, 0.0f, flip};
    for (int i = 0; i < 9; ++i) rot[i] = eye[i];
  }
}

// The frame-constant part of the probe (occlusion_sample_coords).
__device__ void constants(const float* i_m, const float* light_dir, const float* shadow_matrix,
                          const float* i_vpmv, Constants* k) {
  float light[3];
  for (int i = 0; i < 3; ++i) {
    light[i] = (i_m[4 * i] * light_dir[0] + i_m[4 * i + 1] * light_dir[1]) + i_m[4 * i + 2] * light_dir[2];
  }
  const float z[3] = {0.0f, 0.0f, 1.0f};
  rotation_between(z, light, k->rot);
  const float* a = shadow_matrix;
  const float* b = i_vpmv;
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) k->sm[4 * i + j] = shade::mat4_mul_entry(a, b, i, j);
  }
}

struct Args {
  const float* xf;  // (N,) fragment coordinates and depths
  const float* yf;
  const float* zfrag;
  const float* plane;  // the shadow plane, `size` floats (tile-swizzled when tile != 0)
  const float* i_vpmv;  // 4x4
  const float* shadow_matrix;  // 4x4
  const float* i_m;  // 4x4
  const float* light;  // t_light_direction (3,)
  const float* dirs;  // (n, 3) sample directions
  int n_frag;
  int n;
  int width;
  unsigned int size;
  int tile;
  float step, threshold, inv_depth_scale, inv_n;
  float* occ;  // (N,)
};

// shaders.shadow_flat_indices for one coordinate pair.
__device__ unsigned int plane_index(const Args& a, float sx, float sy) {
  return shade::shadow_index(sx, sy, a.width, a.size, a.tile);
}

__global__ void __launch_bounds__(kThreads) occlusion_kernel(Args a) {
  __shared__ Constants k;
  if (threadIdx.x == 0) constants(a.i_m, a.light, a.shadow_matrix, a.i_vpmv, &k);
  __syncthreads();
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.n_frag) return;
  const float x = a.xf[t], y = a.yf[t], z = a.zfrag[t];

  const float* m = a.i_vpmv;
  const float w = mat4_row(m, 3, x, y, z);
  const float world[3] = {mat4_row(m, 0, x, y, z) / w, mat4_row(m, 1, x, y, z) / w,
                          mat4_row(m, 2, x, y, z) / w};
  const float fw = mat4_row(k.sm, 3, x, y, z);
  const float fval =
      __ldg(a.plane + plane_index(a, mat4_row(k.sm, 0, x, y, z) / fw, mat4_row(k.sm, 1, x, y, z) / fw));

  float rot[9];
  for (int i = 0; i < 9; ++i) rot[i] = k.rot[i];
  const float* s = a.shadow_matrix;
  float occ = 1.0f;
#pragma unroll 4
  for (int i = 0; i < a.n; ++i) {
    const float d[3] = {__ldg(a.dirs + 3 * i), __ldg(a.dirs + 3 * i + 1), __ldg(a.dirs + 3 * i + 2)};
    float p[3];
    for (int c = 0; c < 3; ++c) {
      // mat3_vec(rot, dirs) * step, then world + step.
      const float step = ((rot[3 * c] * d[0] + rot[3 * c + 1] * d[1]) + rot[3 * c + 2] * d[2]) * a.step;
      p[c] = world[c] + step;
    }
    const float sw = mat4_row(s, 3, p[0], p[1], p[2]);
    const float sval = __ldg(a.plane + plane_index(a, mat4_row(s, 0, p[0], p[1], p[2]) / sw,
                                                   mat4_row(s, 1, p[0], p[1], p[2]) / sw));
    const bool occluded = (sval - a.threshold) > fval;
    float strength = (sval - fval) * a.inv_depth_scale;  // torch's (sval - fval) / depth_scale on the card
    strength = strength > 1.0f ? 1.0f : strength;  // clamp(max=1), NaN kept
    occ = occluded ? occ - a.inv_n * strength : occ;
  }
  a.occ[t] = occ;
}

}  // namespace

extern "C" {

// Launch occlusion_kernel on `stream` over n_frag > 0 fragments (xf, yf,
// zfrag, occ: n_frag floats each, in device memory) with n >= 1 samples
// (dirs: n x 3 floats), reading the shadow plane of `size` floats whose
// rows are `width` wide, tile-swizzled by `tile` (0: row-major).  The
// matrices are row-major 4x4 floats, light 3; inv_depth_scale and inv_n
// the float32 reciprocals of the depth scale and of n.  Returns
// cudaGetLastError() after the launch.
int occlusion_coefficient(const float* xf, const float* yf, const float* zfrag, int n_frag,
                          const float* plane, int width, unsigned int size, int tile,
                          const float* i_vpmv, const float* shadow_matrix, const float* i_m,
                          const float* light, const float* dirs, int n, float step, float threshold,
                          float inv_depth_scale, float inv_n, float* occ, void* stream) {
  if (n_frag <= 0 || n < 1 || width <= 0 || size == 0 || tile < 0) return (int)cudaErrorInvalidValue;
  const Args a{xf, yf, zfrag, plane, i_vpmv, shadow_matrix, i_m, light, dirs, n_frag, n, width, size, tile,
               step, threshold, inv_depth_scale, inv_n, occ};
  occlusion_kernel<<<(n_frag + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* occlusion_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
