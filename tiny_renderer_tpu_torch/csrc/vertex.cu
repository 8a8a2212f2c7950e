// The vertex layer, hand-written for Hopper (sm_90a): the frame-constant
// matrix stack and the per-triangle raster setup.
//
// Replaces no Pallas kernel: the JAX package leaves this layer to XLA's
// fusion (tiny_renderer_tpu/ops/mathlib.py default_prepare and the two
// shadow prepares, tiny_renderer_tpu/ops/vertex.py triangle_setup).  The
// port's plain torch version of the same functions (ops/mathlib.py,
// ops/vertex.py) issues ~1,080 small kernels a shadow frame, most of them on
// 0-d tensors; replayed as CUDA graph nodes they cost ~1.2 ms a frame on the
// H100, about 1.1 us a node.  So this file exists to cut the node count.
//
// What bounds it on this card: launch latency, not bytes or operations.  A
// pass reads 96 B a triangle (positions, uvs, normals) and writes ~120 B, so
// ~1.5 MB a frame at 5,096 triangles (~0.5 us at 3.35 TB/s); the four 4x4
// inverses and the normalisations are a few thousand flops.  The design is
// therefore two launches a pass: one thread computes a prepare's whole
// uniform set (vertex_prepare), one thread per triangle its setup
// (vertex_setup).
//
// Exactness.  Built with -fmad=false and IEEE division and square root
// (nvcc's defaults without --use_fast_math), every expression below is
// written in ops/mathlib.py's order, operation for operation, so the results
// equal the plain torch version bit for bit: nalgebra's accumulation order,
// `1.0 / det` as a reciprocal and then products, norm3 as the float64 square
// root of the float32 dot rounded back to float32, normalize3 as a division
// by it, and Rust's `f32 as i32` as NaN -> 0, clamp to [-2^31, 2147483520],
// truncate.  Integer edge coefficients wrap as torch's int32 ops do.
//
// Layouts (ops/vertex_cuda.py holds the same tables):
//  * the uniform buffer, float32: vpmv [0, 16), m [16, 32), it_m [32, 48),
//    camera_direction [48, 51), t_light_direction [51, 54), and with the
//    inverses i_vpmv [54, 70), i_m [70, 86); matrices row-major;
//  * the setup's int32 buffer, T values a row: rx (T,3), ry (T,3), then a1,
//    b1, c1, a2, b2, c2, cz, x0, x1, y0, y1 (T,) each; its float32 buffer:
//    zv (T,3), uv (T,3,2), then the intensity, (T,) for the face's, (T,3)
//    for the vertices'; valid (T,) bytes; the overflow flag one byte, zeroed
//    by the caller and set by plain stores of 1, so its value does not depend
//    on the order of the stores.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // vertex_setup: threads a block, one triangle each

enum Intensity { kNone = 0, kFace = 1, kVertex = 2 };

__device__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ float norm3(const float* a) {
  return static_cast<float>(sqrt(static_cast<double>(dot3(a, a))));
}

__device__ void normalize3(const float* a, float* out) {
  const float n = norm3(a);
  for (int i = 0; i < 3; ++i) out[i] = a[i] / n;
}

// out = a b, nalgebra's order: (a0 b0 + a1 b1) + (a2 b2 + a3 b3).
__device__ void mat4_mul(const float* a, const float* b, float* out) {
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      out[4 * i + j] = (a[4 * i] * b[j] + a[4 * i + 1] * b[4 + j]) +
                       (a[4 * i + 2] * b[8 + j] + a[4 * i + 3] * b[12 + j]);
    }
  }
}

__device__ void mat4_transform_vector(const float* m, const float* v, float* out) {
  for (int i = 0; i < 3; ++i) out[i] = (m[4 * i] * v[0] + m[4 * i + 1] * v[1]) + m[4 * i + 2] * v[2];
}

// mathlib.mat4_inverse: the cofactor expansion (nalgebra try_inverse / MESA).
__device__ void mat4_inverse(const float* m, float* out) {
  const float m00 = m[0], m01 = m[1], m02 = m[2], m03 = m[3];
  const float m10 = m[4], m11 = m[5], m12 = m[6], m13 = m[7];
  const float m20 = m[8], m21 = m[9], m22 = m[10], m23 = m[11];
  const float m30 = m[12], m31 = m[13], m32 = m[14], m33 = m[15];

  const float s0 = m00 * m11 - m10 * m01;
  const float s1 = m00 * m12 - m10 * m02;
  const float s2 = m00 * m13 - m10 * m03;
  const float s3 = m01 * m12 - m11 * m02;
  const float s4 = m01 * m13 - m11 * m03;
  const float s5 = m02 * m13 - m12 * m03;

  const float c5 = m22 * m33 - m32 * m23;
  const float c4 = m21 * m33 - m31 * m23;
  const float c3 = m21 * m32 - m31 * m22;
  const float c2 = m20 * m33 - m30 * m23;
  const float c1 = m20 * m32 - m30 * m22;
  const float c0 = m20 * m31 - m30 * m21;

  const float det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0;
  const float invdet = 1.0f / det;

  out[0] = (m11 * c5 - m12 * c4 + m13 * c3) * invdet;
  out[1] = (-m01 * c5 + m02 * c4 - m03 * c3) * invdet;
  out[2] = (m31 * s5 - m32 * s4 + m33 * s3) * invdet;
  out[3] = (-m21 * s5 + m22 * s4 - m23 * s3) * invdet;

  out[4] = (-m10 * c5 + m12 * c2 - m13 * c1) * invdet;
  out[5] = (m00 * c5 - m02 * c2 + m03 * c1) * invdet;
  out[6] = (-m30 * s5 + m32 * s2 - m33 * s1) * invdet;
  out[7] = (m20 * s5 - m22 * s2 + m23 * s1) * invdet;

  out[8] = (m10 * c4 - m11 * c2 + m13 * c0) * invdet;
  out[9] = (-m00 * c4 + m01 * c2 - m03 * c0) * invdet;
  out[10] = (m30 * s4 - m31 * s2 + m33 * s0) * invdet;
  out[11] = (-m20 * s4 + m21 * s2 - m23 * s0) * invdet;

  out[12] = (-m10 * c3 + m11 * c1 - m12 * c0) * invdet;
  out[13] = (m00 * c3 - m01 * c1 + m02 * c0) * invdet;
  out[14] = (-m30 * s3 + m31 * s1 - m32 * s0) * invdet;
  out[15] = (m20 * s3 - m21 * s1 + m22 * s0) * invdet;
}

// mathlib.default_prepare (camera_matrices + the transformed light), and
// with `inverses` shadow_pass_2_prepare's i_vpmv and i_m, into `u` (the
// uniform buffer's layout).  One thread: the work is a few thousand flops.
__global__ void prepare_kernel(const float* light, const float* look_from, const float* look_at,
                               const float* up, float w2, float h2, float d2, float coef,
                               int inverses, float* u) {
  float diff[3], t[3], new_x[3], new_y[3], new_z[3], c[3];
  for (int i = 0; i < 3; ++i) diff[i] = look_from[i] - look_at[i];
  normalize3(diff, new_z);
  const float s = dot3(new_z, up);
  for (int i = 0; i < 3; ++i) t[i] = up[i] - s * new_z[i];
  normalize3(t, new_y);
  cross3(new_y, new_z, c);
  normalize3(c, new_x);

  const float model[16] = {new_x[0], new_x[1], new_x[2], 0.0f,
                           new_y[0], new_y[1], new_y[2], 0.0f,
                           new_z[0], new_z[1], new_z[2], 0.0f,
                           0.0f, 0.0f, 0.0f, 1.0f};
  const float view[16] = {1.0f, 0.0f, 0.0f, -look_from[0],
                          0.0f, 1.0f, 0.0f, -look_from[1],
                          0.0f, 0.0f, 1.0f, -look_from[2],
                          0.0f, 0.0f, 0.0f, 1.0f};
  const float projection[16] = {1.0f, 0.0f, 0.0f, 0.0f,
                                0.0f, 1.0f, 0.0f, 0.0f,
                                0.0f, 0.0f, 1.0f, 0.0f,
                                0.0f, 0.0f, coef, 1.0f};
  const float viewport[16] = {w2, 0.0f, 0.0f, w2,
                              0.0f, h2, 0.0f, h2,
                              0.0f, 0.0f, d2, d2,
                              0.0f, 0.0f, 0.0f, 1.0f};
  // viewport * projection * model * view, left to right.
  float vp[16], vpm[16], model_t[16];
  mat4_mul(viewport, projection, vp);
  mat4_mul(vp, model, vpm);
  mat4_mul(vpm, view, u);  // vpmv
  for (int i = 0; i < 16; ++i) {
    u[16 + i] = model[i];
    model_t[i] = model[4 * (i % 4) + i / 4];
  }
  mat4_inverse(model_t, u + 32);  // it_m
  for (int i = 0; i < 3; ++i) u[48 + i] = new_z[i];  // camera_direction
  mat4_transform_vector(model, light, t);
  normalize3(t, u + 51);  // t_light_direction
  if (inverses) {
    mat4_inverse(u, u + 54);  // i_vpmv
    mat4_inverse(model, u + 70);  // i_m
  }
}

// Rust's `f32 as i32`: NaN -> 0, saturate, truncate toward zero.
__device__ int f32_to_i32(float x) {
  if (isnan(x)) x = 0.0f;
  x = fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
  return __float2int_rz(x);
}

// int32 arithmetic that wraps, as torch's does.
__device__ int wsub(int a, int b) { return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b)); }
__device__ int wmul(int a, int b) { return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b)); }
__device__ int wneg(int a) { return static_cast<int>(0u - static_cast<unsigned>(a)); }

struct SetupArgs {
  const float* pos;     // (T, 3, 3)
  const float* uv_raw;  // (T, 3, 2)
  const float* normal;  // (T, 3, 3); read for kVertex only
  int n;
  const float* matrix;  // 4x4
  const float* camera_direction;  // null: no cull
  const float* it_m;    // read for an intensity only
  const float* light;   // t_light_direction; likewise
  int intensity;
  int width, height;
  int exact_max;        // vertex.EXACT_COORD_MAX
  int* ints;
  float* floats;
  unsigned char* valid;
  unsigned char* overflow;
};

// vertex.triangle_setup's base outputs and intensity, one thread a triangle.
__global__ void __launch_bounds__(kThreads) setup_kernel(SetupArgs a) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int n = a.n;
  if (t >= n) return;
  const float* p = a.pos + 9 * t;
  const float* m = a.matrix;

  int x[3], y[3];
  bool in_exact = true;
  for (int v = 0; v < 3; ++v) {
    float o[4];
    for (int i = 0; i < 4; ++i) {
      o[i] = ((m[4 * i] * p[3 * v] + m[4 * i + 1] * p[3 * v + 1]) + m[4 * i + 2] * p[3 * v + 2]) + m[4 * i + 3];
    }
    x[v] = f32_to_i32(o[0] / o[3]);
    y[v] = f32_to_i32(o[1] / o[3]);
    a.floats[3 * t + v] = o[2] / o[3];  // zv
    a.ints[3 * t + v] = x[v];
    a.ints[3 * n + 3 * t + v] = y[v];
    in_exact = in_exact && x[v] >= -a.exact_max && x[v] <= a.exact_max &&
               y[v] >= -a.exact_max && y[v] <= a.exact_max;
  }

  const int cz = wsub(wmul(wsub(x[1], x[0]), wsub(y[2], y[0])), wmul(wsub(x[2], x[0]), wsub(y[1], y[0])));
  int* row = a.ints + 6 * n + t;  // the (T,) fields, n apart
  row[0] = wsub(y[2], y[0]);                                   // a1
  row[n] = wneg(wsub(x[2], x[0]));                             // b1
  row[2 * n] = wsub(wmul(x[2], y[0]), wmul(x[0], y[2]));       // c1
  row[3 * n] = wneg(wsub(y[1], y[0]));                         // a2
  row[4 * n] = wsub(x[1], x[0]);                               // b2
  row[5 * n] = wsub(wmul(x[0], y[1]), wmul(x[1], y[0]));       // c2
  row[6 * n] = cz;

  // The untransformed face normal (p1 - p0) x (p2 - p0).
  float e1[3], e2[3], fn[3];
  for (int i = 0; i < 3; ++i) {
    e1[i] = p[3 + i] - p[i];
    e2[i] = p[6 + i] - p[i];
  }
  cross3(e1, e2, fn);

  bool keep = a.camera_direction ? dot3(a.camera_direction, fn) > 0.0f : true;
  keep = keep && cz != 0;
  const int x0 = max(min(min(x[0], x[1]), x[2]), 0);
  const int x1 = min(max(max(x[0], x[1]), x[2]), a.width - 1);
  const int y0 = max(min(min(y[0], y[1]), y[2]), 0);
  const int y1 = min(max(max(y[0], y[1]), y[2]), a.height - 1);
  row[7 * n] = x0;
  row[8 * n] = x1;
  row[9 * n] = y0;
  row[10 * n] = y1;
  keep = keep && x0 <= x1 && y0 <= y1;
  if (keep && !in_exact) *a.overflow = 1;
  a.valid[t] = keep && in_exact;

  const float* uvr = a.uv_raw + 6 * t;
  float* uv = a.floats + 3 * n + 6 * t;
  for (int v = 0; v < 3; ++v) {
    uv[2 * v] = uvr[2 * v];
    uv[2 * v + 1] = 1.0f - uvr[2 * v + 1];
  }

  float* intensity = a.floats + 9 * n;
  float tv[3], tn[3];
  if (a.intensity == kFace) {
    mat4_transform_vector(a.it_m, fn, tv);
    normalize3(tv, tn);
    intensity[t] = dot3(a.light, tn);
  } else if (a.intensity == kVertex) {
    for (int v = 0; v < 3; ++v) {
      mat4_transform_vector(a.it_m, a.normal + 9 * t + 3 * v, tv);
      normalize3(tv, tn);
      intensity[3 * t + v] = dot3(a.light, tn);
    }
  }
}

}  // namespace

extern "C" {

// Launch prepare_kernel on `stream`: the uniforms of default_prepare from
// (3,) float32 vectors in device memory, with `inverses` also
// shadow_pass_2_prepare's, into `out` (54 or 86 floats).  w2, h2, d2: the
// viewport's half width, height and depth; coef: the projection's.  Returns
// cudaGetLastError() after the launch.
int vertex_prepare(const float* light, const float* look_from, const float* look_at, const float* up,
                   float w2, float h2, float d2, float coef, int inverses, float* out, void* stream) {
  prepare_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      light, look_from, look_at, up, w2, h2, d2, coef, inverses, out);
  return (int)cudaGetLastError();
}

// Launch setup_kernel on `stream` over n > 0 triangles, writing the layouts
// of the note above.  camera_direction null: no cull.  intensity: 0 none, 1
// the face's (it_m, light read), 2 the vertices' (normal too).  Returns
// cudaGetLastError() after the launch.
int vertex_setup(const float* pos, const float* uv_raw, const float* normal, int n, const float* matrix,
                 const float* camera_direction, const float* it_m, const float* light, int intensity,
                 int width, int height, int exact_max, int* ints, float* floats, unsigned char* valid,
                 unsigned char* overflow, void* stream) {
  if (n <= 0 || intensity < kNone || intensity > kVertex) return (int)cudaErrorInvalidValue;
  const SetupArgs a{pos, uv_raw, normal, n, matrix, camera_direction, it_m, light, intensity,
                    width, height, exact_max, ints, floats, valid, overflow};
  setup_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* vertex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
