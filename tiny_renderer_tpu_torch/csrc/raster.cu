// The tile raster, hand-written for Hopper (sm_90a): K1 in every mode and K2.
//
// Replaces, in tiny_renderer_tpu/ops/raster_pallas.py:
//  * K1 rasterize_pallas -> _raster_kernel (raster_pallas.py:167), with
//    - phase 1, the depth resolve (_depth_resolve, :85-152), in its three
//      output modes: depth only (the light pass), index only (the camera
//      pass of a burst frame), depth + index (Scene.render's camera pass);
//    - the gathered record layout, tris == null (:95-98, :208-211);
//    - the int16 index target (:231-234, :419-420);
//    - the strip coverage plane, emit_strips = SL (:236-252);
//    - phase 2, the varying planes (_plane_layout :57-82, vary_body
//      :257-312), modes interp, const, zfrag and texidx:W:H[:tile].
//  * K2 rasterize_pallas_fused -> _fused_raster_kernel (:466-496, call :559):
//    both passes of a two-pass frame in one launch.
//
// Phase 1.  One thread block per tile_h x tile_w screen tile.  The block
// walks the tile's CSR slice [starts[t], starts[t+1]) of the binned
// incidence list in ascending slot (= ascending triangle) order, reads
// record rec[tris[k]] (indirect layout) or rec[k] (gathered layout) and, for
// every pixel of the tile, evaluates the integer edge functions (exact in
// f32), the sign tests and the interpolated depth, and keeps the candidate
// only if its z is strictly greater than the stored one.  So equal depths
// keep the earliest triangle, exactly like the reference's serial
// `z <= stored -> reject` (shader.rs:169-180).  Every pixel is owned by one
// thread, which keeps its z, index and (for phase 2) winning record row in
// registers for the whole walk: no atomics, so the result is deterministic
// and bit-stable.  Clear values are f32::MIN and -1.
//
// int16 target.  The resolve stays int32 in registers; the store casts once
// per pixel.  What bounds it is unchanged; it halves the index write.
//
// Strip plane.  Pixel p of a tile belongs to thread p % blockDim.x (slot
// p / blockDim.x of its registers), and blockDim.x is a multiple of 32, so
// the SL pixels of an aligned strip sit in SL consecutive lanes of one warp
// whenever SL divides 32: a shuffle max over g = gcd(SL, 32) lanes gives the
// strip's max index directly.  For other SL the g-lane partial maxima go
// through shared memory and are combined there.  Written in (H, W/SL)
// layout directly: the TPU's (tiles_x, H, tile_w/SL) detour exists only for
// Mosaic's block rules.  Negligible next to the walk (a few shuffles per
// pixel, one 4-byte write per strip).
//
// Phase 2.  The TPU kernel walks the tile's list a second time and masks
// idx == gidx.  Here each pixel already knows its winning record row after
// phase 1 (kept in registers beside the index; in the gathered layout the
// row is the CSR slot, not the triangle index in lane 12), so it reads that
// one record's lanes and writes the P planes: the same function with no
// second walk.  Uncovered pixels write 0.  The plane table (mode, lane, W, H,
// tile) is a kernel argument, at most kMaxPlanes planes.  What bounds it:
// P plane writes per pixel (bytes: 3 planes x 4 B x 717 k px at 800^2) plus
// one record read per covered pixel from L2; the arithmetic is ~40 flops a
// pixel, negligible beside the walk.
//
// K2.  One launch runs both depth resolves on each tile: the light pass
// writes shadow z, then the camera pass writes idx with its z in
// registers.  The two walks run one after the other in the block through the
// same device function, so registers are reused and not doubled.  It saves
// one launch and nothing on the device: a block's two walks add, so the
// worst tile walks both passes' lists (on an H100 at the 800x800 flagship it
// takes as long as the two launches, PERF.md).
//
// Arithmetic.  Each expression is evaluated in the order the Pallas kernel
// writes it: phase 1 with the reciprocal multiply u = cx * rcz (:124-127),
// phase 2 with the exact division u = (cx * sgn) / |cz| (:266-268), and the
// texel fold NaN -> 0 first (fmaxf/fminf drop NaN where jnp.maximum keeps
// it), then max 0, trunc, min dim - 1, then the swizzle's trunc(c / tile).
// The file is compiled with -fmad=false and IEEE division (no fast math): no
// mul+add is contracted into an FMA, so the kernels equal their eager torch
// twins (raster_cuda.rasterize_reference) bit for bit on the card.
//
// What bounds the walk on this card.  The function's own work is bound by
// bytes: one write per pixel of each output and a few hundred KB of records.
// Its operations are 26 flops per (pixel, candidate) only for the pixels
// inside the candidate's bbox (no other pixel can pass the integer inside
// test): ~70 of a 32x128 tile's 4096 pixels per incidence at 800^2.  This
// kernel walks every pixel of the tile for every candidate, as the TPU
// kernel does, so it makes ~60x the tests the outputs need, and its
// operations come to ~10x the time of its bytes; that brute-force walk is
// its first loss against the bound.  The design keeps the per-pixel state
// in registers (16 pixels per thread), stages the records through shared
// memory in chunks so a block reads each record once from L2 and all
// threads read it as a shared-memory broadcast, and has no per-candidate
// global traffic.  What it does not do yet (later work): skip the pixels
// outside a candidate's bbox, spread the busy tiles' lists over more than
// one block (800x800 makes only 175 blocks for 132 SMs, and the longest
// tile's list sets the time), cp.async/TMA double buffering of the record
// chunks, and a tile shape of its own (this one is the TPU's).

#include <cuda_runtime.h>

namespace {

constexpr int kPix = 16;       // pixels per thread (registers)
constexpr int kChunk = 128;    // records staged per shared-memory chunk
constexpr int kLanes = 13;     // record lanes the depth loop reads
constexpr int kMaxPlanes = 16; // varying planes per launch
constexpr float kF32Min = -3.40282347e+38f;

enum PlaneMode { kInterp = 0, kConst = 1, kZfrag = 2, kTexidx = 3 };

// One binned pass: records (rows, rec_stride) f32, the (cap,) triangle-id
// list (null: records are gathered in CSR order) and the tile offsets.
struct Pass {
  const float* rec;
  int rec_stride;
  const int* tris;
  const int* starts;
};

struct Grid {
  int tiles_x, tile_h, tile_w, row_off, out_w;
  size_t plane;  // pixels of one (Hp, Wp) output plane
};

struct PlaneTable {
  int n;
  int mode[kMaxPlanes];
  int lane[kMaxPlanes];
  float wdim[kMaxPlanes], hdim[kMaxPlanes];
  float swz[kMaxPlanes];  // swizzle tile, 0 for row-major
  float ntx[kMaxPlanes];  // W / swz
};

struct Outputs {
  float* z;         // (Hp, Wp) or null
  void* idx;        // (Hp, Wp) int32 or int16, or null
  int idx16;
  int* strips;      // (Hp, Wp / strip_len) or null
  int strip_len;
  float* planes;    // (P, Hp, Wp) or null
};

struct TileCoords {
  float px[kPix], py[kPix];
};

__device__ __forceinline__ void pixel_coords(const Grid& g, int ty, int tx, TileCoords& c) {
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    const int row = p / g.tile_w;
    const int col = p - row * g.tile_w;
    c.px[j] = (float)(tx * g.tile_w + col);
    c.py[j] = (float)((ty + g.row_off) * g.tile_h + row);
  }
}

__device__ __forceinline__ size_t out_offset(const Grid& g, int ty, int tx, int j) {
  const int p = threadIdx.x + j * blockDim.x;
  const int row = p / g.tile_w;
  const int col = p - row * g.tile_w;
  return (size_t)(ty * g.tile_h + row) * g.out_w + tx * g.tile_w + col;
}

// Phase 1 over one pass's CSR slice of `tile`.  best/bidx/brow hold the
// running winner per pixel (brow: the winner's record row, for phase 2).
template <bool kIdx, bool kRow>
__device__ __forceinline__ void depth_walk(const Pass& ps, int tile, const TileCoords& c,
                                           float (&best)[kPix], int (&bidx)[kPix],
                                           int (&brow)[kPix], float (*s_rec)[16],
                                           int* s_row) {
  const int start = ps.starts[tile];
  const int end = ps.starts[tile + 1];
  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n * kLanes; i += blockDim.x) {
      const int r = i / kLanes;
      const int l = i - r * kLanes;
      const int row = ps.tris ? ps.tris[c0 + r] : c0 + r;
      s_rec[r][l] = ps.rec[(size_t)row * ps.rec_stride + l];
      if (kRow && l == 0) s_row[r] = row;
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float a1 = s_rec[r][0], b1 = s_rec[r][1], c1 = s_rec[r][2];
      const float a2 = s_rec[r][3], b2 = s_rec[r][4], c2 = s_rec[r][5];
      const float sgn = s_rec[r][6], absz = s_rec[r][7], rcz = s_rec[r][8];
      const float z1 = s_rec[r][9], z2 = s_rec[r][10], z3 = s_rec[r][11];
      const int gidx = (int)s_rec[r][12];
      const int row = kRow ? s_row[r] : 0;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const float cx = a1 * c.px[j] + b1 * c.py[j] + c1;
        const float cy = a2 * c.px[j] + b2 * c.py[j] + c2;
        const float cxs = cx * sgn;
        const float cys = cy * sgn;
        const bool inside = (cxs >= 0.0f) & (cys >= 0.0f) & (absz - cxs - cys >= 0.0f);
        const float u = cx * rcz;
        const float v = cy * rcz;
        const float w = 1.0f - (cx + cy) * rcz;
        const float z = (w * z1 + u * z2) + v * z3;
        if (inside && z > best[j]) {
          best[j] = z;
          if (kIdx) bidx[j] = gidx;
          if (kRow) brow[j] = row;
        }
      }
    }
  }
}

// Per-strip max winning index (raster_pallas.py:236-252), see the note.
__device__ __forceinline__ void emit_strips(const Grid& g, int ty, int tx,
                                            const int (&bidx)[kPix], int* strips, int sl,
                                            int* s_part) {
  const int lowbit = sl & -sl;
  const int gw = lowbit < 32 ? lowbit : 32;  // gcd(sl, 32)
  const int lane = threadIdx.x & 31;
  const int sw = g.tile_w / sl;  // strips per tile row
  const int strips_w = g.out_w / sl;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    int v = bidx[j];
    for (int off = 1; off < gw; off <<= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane & (gw - 1)) continue;
    const int p = threadIdx.x + j * blockDim.x;
    if (gw == sl) {
      const int row = p / g.tile_w;
      const int col = p - row * g.tile_w;
      strips[(size_t)(ty * g.tile_h + row) * strips_w + tx * sw + col / sl] = v;
    } else {
      s_part[p / gw] = v;
    }
  }
  if (gw == sl) return;
  __syncthreads();
  const int per = sl / gw;
  for (int s = threadIdx.x; s < g.tile_h * sw; s += blockDim.x) {
    int v = s_part[s * per];
    for (int k = 1; k < per; ++k) v = max(v, s_part[s * per + k]);
    const int row = s / sw;
    strips[(size_t)(ty * g.tile_h + row) * strips_w + tx * sw + (s - row * sw)] = v;
  }
}

// Phase 2 (raster_pallas.py:257-312): each pixel's planes from its winning
// record, 0 where uncovered.
__device__ __forceinline__ void vary(const Pass& ps, const Grid& g, int ty, int tx,
                                     const TileCoords& c, const int (&bidx)[kPix],
                                     const int (&brow)[kPix], const PlaneTable& pt,
                                     float* planes) {
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const size_t o = out_offset(g, ty, tx, j);
    if (bidx[j] < 0) {
      for (int p = 0; p < pt.n; ++p) planes[p * g.plane + o] = 0.0f;
      continue;
    }
    const float* r = ps.rec + (size_t)brow[j] * ps.rec_stride;
    const float cx = r[0] * c.px[j] + r[1] * c.py[j] + r[2];
    const float cy = r[3] * c.px[j] + r[4] * c.py[j] + r[5];
    const float sgn = r[6], absz = r[7];
    // Exact division: (cx*sgn)/|cz| rounds like the reference's cx/cz.
    const float u = (cx * sgn) / absz;
    const float v = (cy * sgn) / absz;
    const float w = 1.0f - ((cx + cy) * sgn) / absz;
    for (int p = 0; p < pt.n; ++p) {
      const int l = pt.lane[p];
      float val;
      if (pt.mode[p] == kConst) {
        val = r[l];
      } else if (pt.mode[p] == kTexidx) {
        const float wd = pt.wdim[p], hd = pt.hdim[p];
        const float uu = (r[l] * w + r[l + 1] * u) + r[l + 2] * v;
        const float vv = (r[l + 3] * w + r[l + 4] * u) + r[l + 5] * v;
        float xw = uu * wd;
        float yw = vv * hd;
        xw = isnan(xw) ? 0.0f : xw;
        yw = isnan(yw) ? 0.0f : yw;
        const float cxp = fminf(truncf(fmaxf(xw, 0.0f)), wd - 1.0f);
        const float cyp = fminf(truncf(fmaxf(yw, 0.0f)), hd - 1.0f);
        const float fb = pt.swz[p];
        if (fb != 0.0f) {
          const float ttx = truncf(cxp / fb);
          const float tty = truncf(cyp / fb);
          const float ix = cxp - ttx * fb;
          const float iy = cyp - tty * fb;
          val = ((tty * pt.ntx[p] + ttx) * fb + iy) * fb + ix;
        } else {
          val = cyp * wd + cxp;
        }
      } else {  // interp, zfrag
        val = (r[l] * w + r[l + 1] * u) + r[l + 2] * v;
      }
      planes[p * g.plane + o] = val;
    }
  }
}

// K1.  kIdx: resolve the winning index (else depth only).  kPlanes: keep
// the winning record row and run phase 2.
template <bool kIdx, bool kPlanes>
__global__ void raster_kernel(Pass ps, Grid g, Outputs out, PlaneTable pt) {
  __shared__ float s_rec[kChunk][16];
  __shared__ int s_row[kPlanes ? kChunk : 1];
  extern __shared__ int s_part[];  // strip partial maxima (dynamic)

  const int tile = blockIdx.x;
  const int ty = tile / g.tiles_x;
  const int tx = tile - ty * g.tiles_x;
  TileCoords c;
  pixel_coords(g, ty, tx, c);
  float best[kPix];
  int bidx[kPix], brow[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    best[j] = kF32Min;
    bidx[j] = -1;
    brow[j] = 0;
  }
  depth_walk<kIdx, kPlanes>(ps, tile, c, best, bidx, brow, s_rec, s_row);

#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const size_t o = out_offset(g, ty, tx, j);
    if (out.z) out.z[o] = best[j];
    if (kIdx && out.idx) {
      if (out.idx16) {
        static_cast<short*>(out.idx)[o] = (short)bidx[j];
      } else {
        static_cast<int*>(out.idx)[o] = bidx[j];
      }
    }
  }
  if (kIdx && out.strips) emit_strips(g, ty, tx, bidx, out.strips, out.strip_len, s_part);
  if (kPlanes) vary(ps, g, ty, tx, c, bidx, brow, pt, out.planes);
}

// K2: the light pass's depth, then the camera pass's index, on one tile.
__global__ void raster_fused_kernel(Pass light, Pass camera, Grid g, float* shadow_z,
                                    int* idx) {
  __shared__ float s_rec[kChunk][16];
  const int tile = blockIdx.x;
  const int ty = tile / g.tiles_x;
  const int tx = tile - ty * g.tiles_x;
  TileCoords c;
  pixel_coords(g, ty, tx, c);
  float best[kPix];
  int bidx[kPix], brow[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) best[j] = kF32Min;
  depth_walk<false, false>(light, tile, c, best, bidx, brow, s_rec, nullptr);
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    shadow_z[out_offset(g, ty, tx, j)] = best[j];
    best[j] = kF32Min;
    bidx[j] = -1;
  }
  depth_walk<true, false>(camera, tile, c, best, bidx, brow, s_rec, nullptr);
#pragma unroll
  for (int j = 0; j < kPix; ++j) idx[out_offset(g, ty, tx, j)] = bidx[j];
}

Grid make_grid(int tiles_x, int tile_h, int tile_w, int row_off, int num_tiles) {
  Grid g;
  g.tiles_x = tiles_x;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.row_off = row_off;
  g.out_w = tiles_x * tile_w;
  g.plane = (size_t)(num_tiles / tiles_x) * tile_h * g.out_w;
  return g;
}

template <bool kIdx, bool kPlanes>
int launch(int num_tiles, int threads, size_t smem, cudaStream_t s, const Pass& ps,
           const Grid& g, const Outputs& out, const PlaneTable& pt) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        raster_kernel<kIdx, kPlanes>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  raster_kernel<kIdx, kPlanes><<<num_tiles, threads, smem, s>>>(ps, g, out, pt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixels each thread owns; the wrapper launches tile_h * tile_w / this
// many threads per block.
int raster_pixels_per_thread() { return kPix; }

// Launch K1 on `stream`.  tris may be null (gathered records).  z_out,
// idx_out (int16 when idx16), strips_out ((Hp, Wp / strip_len) int32) and
// planes_out ((n_planes, Hp, Wp) f32) may be null (not emitted); strips and
// planes need idx_out.  plane_desc holds n_planes rows of (mode, lane, W, H,
// swizzle tile).  All outputs are row-major over (Hp, Wp) =
// (num_tiles / tiles_x * tile_h, tiles_x * tile_w).  Returns
// cudaGetLastError() after the launch.
int raster_depth(const float* rec, int rec_stride, const int* tris, const int* starts,
                 int num_tiles, int tiles_x, int tile_h, int tile_w, int row_off,
                 float* z_out, void* idx_out, int idx16, int* strips_out, int strip_len,
                 float* planes_out, int n_planes, const int* plane_desc, void* stream) {
  if (n_planes < 0 || n_planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
  if ((strips_out || planes_out) && !idx_out) return (int)cudaErrorInvalidValue;
  if (!z_out && !idx_out) return (int)cudaErrorInvalidValue;
  const int threads = tile_h * tile_w / kPix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pass ps{rec, rec_stride, tris, starts};
  const Grid g = make_grid(tiles_x, tile_h, tile_w, row_off, num_tiles);
  const Outputs out{z_out, idx_out, idx16, strips_out, strip_len, planes_out};
  PlaneTable pt{};
  pt.n = planes_out ? n_planes : 0;
  for (int p = 0; p < pt.n; ++p) {
    const int* d = plane_desc + 5 * p;
    pt.mode[p] = d[0];
    pt.lane[p] = d[1];
    pt.wdim[p] = (float)d[2];
    pt.hdim[p] = (float)d[3];
    pt.swz[p] = (float)d[4];
    pt.ntx[p] = d[4] ? (float)(d[2] / d[4]) : 0.0f;
  }
  size_t smem = 0;
  if (strips_out) {
    const int lowbit = strip_len & -strip_len;
    const int gw = lowbit < 32 ? lowbit : 32;
    if (gw != strip_len) smem = (size_t)(tile_h * tile_w / gw) * sizeof(int);
  }
  if (planes_out) return launch<true, true>(num_tiles, threads, smem, s, ps, g, out, pt);
  if (idx_out) return launch<true, false>(num_tiles, threads, smem, s, ps, g, out, pt);
  return launch<false, false>(num_tiles, threads, smem, s, ps, g, out, pt);
}

// Launch K2 on `stream`: shadow_z from the light pass, idx (int32) from the
// camera pass, both (Hp, Wp) row-major.  tris1/tris2 may be null (gathered).
int raster_fused(const float* rec1, int stride1, const int* tris1, const int* starts1,
                 const float* rec2, int stride2, const int* tris2, const int* starts2,
                 int num_tiles, int tiles_x, int tile_h, int tile_w, int row_off,
                 float* shadow_z, int* idx, void* stream) {
  const int threads = tile_h * tile_w / kPix;
  const Pass light{rec1, stride1, tris1, starts1};
  const Pass camera{rec2, stride2, tris2, starts2};
  const Grid g = make_grid(tiles_x, tile_h, tile_w, row_off, num_tiles);
  raster_fused_kernel<<<num_tiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      light, camera, g, shadow_z, idx);
  return (int)cudaGetLastError();
}

const char* raster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
