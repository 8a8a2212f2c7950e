// The tile raster, hand-written for Hopper (sm_90a): K1 in every mode and K2.
//
// Replaces, in tiny_renderer_tpu/ops/raster_pallas.py:
//  * K1 rasterize_pallas -> _raster_kernel (raster_pallas.py:167, call :449),
//    with
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
// What bounds it on this card.  The function's work is bound by bytes: one
// write per pixel of each output and a few hundred KB of records (about
// 1 us per pass at 800x800).  Its operations are 26 flops per (pixel,
// candidate) only at the pixels inside the candidate's bbox (~70 of a
// 32x128 bin tile's 4096 pixels per incidence), a fifth of the bytes' time.
// What the kernel pays on top: the binned lists are lopsided (at 800x800
// 32 of the 175 bin tiles hold every triangle, one of them 503), and a
// test evaluated for a pixel the candidate cannot cover is lost.  So the
// design tests only the 4 x 8 rects a candidate may cover, and spreads each
// bin tile over 16 blocks.
//
// Blocks.  One 256-thread block (8 warps) per 8 x 32 sub-tile of a bin
// tile (the sub-tile divides every tile shape the config admits: tile_h % 8
// == 0, tile_w % 128 == 0): 2,800 blocks at 800x800.  Each block walks its
// bin tile's whole CSR slice [starts[t], starts[t+1]) in ascending slot
// (= ascending triangle) order and keeps, per pixel, the candidate whose z
// is strictly greater than the stored one.  Equal depths keep the earliest
// slot, as the reference's serial `z <= stored -> reject` (shader.rs:169-
// 180).  Every pixel is owned by one thread, which holds its z, index and
// (for phase 2) winning record row in registers: no atomics and no merge,
// so the order and the result are those of the serial walk, whatever the
// split.  Clear values are f32::MIN and -1.  Of the shapes timed on the
// H100 (PERF.md), this one was the fastest: 8 x 32, 8 x 64 and 8 x 128
// sub-tiles with 2 to 16 warps, 1 to 4 rects per warp, and a persistent
// grid fed from a work queue (slower: the queue's atomics and the empty
// sub-tiles' turns cost more than the hardware's block launches).
//
// Thread -> pixel map.  The sub-tile is two rows of four 4 x 8 rects; warp
// w owns rect (w / 4, w mod 4) (rect_row, rect_col), lane l pixel (l / 8,
// l mod 8) of it, so a thread holds one pixel and a cluster of small
// triangles spreads over the warps of its rects.  A record's rect mask has
// one bit per rect (per warp).
//
// The walk, per staged chunk of up to 512 records:
//  1. each thread loads two records (13 lanes each, every load in flight at
//     once) into shared memory, zero padded to four float4s, and tests each
//     against the whole sub-tile;
//  2. for each survivor, 8 lanes of a warp test it against the 8 rects (4
//     survivors per warp step), and the warp's ballot holds their masks;
//  3. each warp walks the chunk's masks 32 at a time with a ballot of the
//     records whose bit for its rect is set, takes them two at a time
//     (three float4 loads and one float each; both evaluated together, kept
//     in slot order): the skip is warp-uniform, so no lane idles in a test.
// A rect test rejects only what every pixel of the rect would reject.  Each
// edge value is evaluated as the walk evaluates it, a*x + b*y + c in f32
// with no FMA, and that expression is monotone in x (for fixed y) with the
// sign of a and in y with the sign of b, because rounding is monotone.  So
// its largest value over the rect, times sgn, is its value at the corner
// picked by the signs of a*sgn and b*sgn: edges 1 and 2 reject a rect
// exactly when no pixel of it passes their test, in any range of values.
// Edge 3, (|cz| - e1) - e2, is monotone decreasing in e1 and e2, so |cz|
// minus the two edges' minima (their other corners) bounds it from above: a
// rect rejected by the bound has no passing pixel.  When every value the
// test forms over the sub-tile is an integer below 2^24 (integral lanes,
// sgn = +-1, a bound on the magnitudes: the binned records of on-screen
// triangles), the arithmetic is exact, edge 3 is affine, and its value at
// its own corner is its maximum: then the test is exact for all three
// edges.  raster_cuda.cull_masks models this cull in torch: the CPU tests
// hold the model to the per-pixel test, and chip_smoke.py holds it to the
// masks this kernel computes (read from the probe build, below).
//
// int16 target.  The resolve stays int32 in registers; the store casts once
// per pixel.  It halves the index write.
//
// Stores.  After the walk the block stashes its pixels' results in shared
// memory in the sub-tile's row-major order (rows padded to 40 words, so the
// stash and the reads are free of bank conflicts) and writes every output
// row-major: a warp writes one 128-byte sub-tile row of int32 or f32, 64
// bytes of int16.
//
// Strip plane.  Read from the stashed index rows: one thread per strip (or
// per part of a strip) takes the max of its SL indices.  Strips inside the
// sub-tile (every strip when SL divides 32) are stored; a strip that
// crosses a sub-tile border (SL 64; SL 24 on 384-wide tiles) is combined
// with atomicMax into a plane the wrapper fills with -1 first.  A max is
// exact in any order, so the plane is deterministic.
//
// Phase 2.  The TPU kernel walks the tile's list a second time and masks
// idx == gidx.  Here each pixel already knows its winning record row after
// phase 1 (in the gathered layout the row is the CSR slot, not lane 12), so
// the row-major store pass reads that one record's lanes and writes the P
// planes: the same function with no second walk.  Uncovered pixels write
// 0.  The plane table (mode, lane, W, H, tile) is a kernel argument, at
// most kMaxPlanes planes.
//
// K2.  One launch runs both depth resolves on each sub-tile: the light pass
// writes shadow z, then the camera pass writes idx.  The two walks run one
// after the other through the same device function, so a block's two walks
// add; the sub-tile split shrinks that sum with the sub-tile.
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
// Probe build.  Compiled with -DRASTER_PROBE (raster_cuda.build(probe=
// True), ops/raster_probe.py), the PROBE_* markers below stamp each block's
// start, end and phase times from %globaltimer, with a block barrier added
// after the walk, and write each staged record's rect mask out.  Without
// the define they expand to nothing.
//
// What it does not do yet: split a long list across blocks (every block of
// a bin tile stages and culls the tile's whole list, so a tile of 2,000
// triangles costs each of its 16 blocks ~10 us of staging on the H100),
// keep the next chunk's loads in flight during the walk (cp.async/TMA), or
// start the busy blocks first: ~80% of the blocks at 800x800 find an empty
// list, and a busy block queued behind thousands of them starts up to
// 6-8 us late (a separate kernel that ordered the tiles busy-first cost
// more than it saved, PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kSubH = 8;                // rows of a block's sub-tile
constexpr int kSubW = 32;               // columns of a block's sub-tile
constexpr int kRects = kSubH / 4 * (kSubW / 8);  // 4 x 8 rects of a sub-tile
constexpr int kWarps = kRects;          // one rect a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 2;               // records each thread stages per chunk
constexpr int kChunk = kStage * kThreads;
constexpr int kUnroll = 2;              // candidates a warp evaluates together
constexpr int kLanes = 13;              // record lanes the depth walk reads
constexpr int kOutStride = kSubW + 8;   // stash row stride in words
constexpr int kMaxPlanes = 16;          // varying planes per launch
constexpr float kF32Min = -3.40282347e+38f;
constexpr float kExactSpan = 8388608.0f;  // 2^23: see exact_over
static_assert(kSubH == 8 && 32 % kRects == 0, "two rows of rects; a record's rect mask fits a ballot");

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

struct Smem {
  union {
    float4 rec[kChunk][4];      // the staged chunk of records (lanes 0-12, zero padded)
    struct {                    // after the walk: the sub-tile's results, row-major
      float z[kSubH][kOutStride];
      int idx[kSubH][kOutStride];
      int row[kSubH][kOutStride];
    } out;
  };
  unsigned mask[kChunk];  // per staged record: sub-tile cull, then its rect mask
  int row[kChunk];        // per staged record: its record row (phase 2)
};

// This block's sub-tile: its bin tile, the pixel coordinates of its top-left
// (y includes the band offset row_off), its first output row, and its index
// among its bin tile's sub-tiles (row-major) and their count.
struct Block {
  int tile, x0, y0, orow, sub, subs;
};

__device__ __forceinline__ Block block_of(const Grid& g) {
  Block b;
  const int per_x = g.tile_w / kSubW, per_y = g.tile_h / kSubH;
  b.tile = blockIdx.y / per_y * g.tiles_x + blockIdx.x / per_x;
  b.x0 = blockIdx.x * kSubW;
  b.orow = blockIdx.y * kSubH;
  b.y0 = g.row_off * g.tile_h + b.orow;
  b.sub = blockIdx.y % per_y * per_x + blockIdx.x % per_x;
  b.subs = per_x * per_y;
  return b;
}

// Warp w's rect, (w / 4, w mod 4) of the sub-tile's two rows of 4 x 8
// rects: bit w of a record's rect mask.
__device__ __forceinline__ int rect_row(int w) { return 4 * (w / (kRects / 2)); }
__device__ __forceinline__ int rect_col(int w) { return 8 * (w % (kRects / 2)); }

// The running winner of a thread's pixel: its z, triangle index and record
// row (for phase 2).
struct Winner {
  float z;
  int idx, row;
};

__device__ __forceinline__ void clear(Winner& w) {
  w.z = kF32Min;
  w.idx = -1;
  w.row = 0;
}

#ifdef RASTER_PROBE
// Probe buffers (raster_set_probe; null: off).  probe_times: 8 u64 per
// block, row-major over the grid: total, staging + sub-tile cull, rect
// masks, walk (ns, summed over chunks and passes), start, end (ns).
// probe_masks: (CSR slots, sub-tiles per bin tile) u32, each staged
// record's rect mask in each sub-tile block of its tile (K1 only: K2's
// second pass would overwrite the first's).
__device__ unsigned long long* probe_times;
__device__ unsigned* probe_masks;

__device__ __forceinline__ unsigned long long probe_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned long long& probe_slot(int s) {
  return probe_times[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 8 + s];
}
#define PROBE_BEGIN(s) if (threadIdx.x == 0 && probe_times) probe_slot(s) -= probe_now();
#define PROBE_END(s) if (threadIdx.x == 0 && probe_times) probe_slot(s) += probe_now();
#define PROBE_STAMP(s) if (threadIdx.x == 0 && probe_times) probe_slot(s) = probe_now();
#define PROBE_SYNC() __syncthreads();
#define PROBE_MASKS(c0, n, b, sm)                                                   \
  if (probe_masks) {                                                                \
    for (int t = threadIdx.x; t < (n); t += kThreads) {                             \
      probe_masks[(size_t)((c0) + t) * (b).subs + (b).sub] = (sm).mask[t];          \
    }                                                                               \
  }
#else
#define PROBE_BEGIN(s)
#define PROBE_END(s)
#define PROBE_STAMP(s)
#define PROBE_SYNC()
#define PROBE_MASKS(c0, n, b, sm)
#endif

// An edge function at a pixel, as the walk evaluates it.
__device__ __forceinline__ float edge(float a, float b, float c, float x, float y) {
  return a * x + b * y + c;
}

// Whether every value the inside test forms for record r at the pixels
// [0, x1] x [0, y1] is an integer below 2^24 in magnitude, so that the f32
// arithmetic is exact: integral lanes, sgn = +-1, and a bound on the
// magnitudes (itself rounded, hence 2^23).
__device__ __forceinline__ bool exact_over(const float* r, float x1, float y1) {
  bool ints = fabsf(r[6]) == 1.0f;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    if (l != 6) ints &= truncf(r[l]) == r[l];
  }
  const float span = ((fabsf(r[0]) + fabsf(r[3])) * x1 + (fabsf(r[1]) + fabsf(r[4])) * y1) +
                     ((fabsf(r[2]) + fabsf(r[5])) + fabsf(r[7]));
  return ints & (span <= kExactSpan);
}

// False only if no pixel of [x0, x1] x [y0, y1] passes record r's inside
// test (see the note): edges 1 and 2 at their maximising corners, edge 3 at
// its own corner when `exact`, else bounded through the other two's minima.
__device__ __forceinline__ bool may_cover(const float* r, bool exact, float x0, float x1,
                                          float y0, float y1) {
  const float a1 = r[0], b1 = r[1], c1 = r[2], a2 = r[3], b2 = r[4], c2 = r[5];
  const float sgn = r[6], absz = r[7];
  const bool pos = sgn > 0.0f;
  const float xh1 = ((a1 > 0.0f) == pos) ? x1 : x0, yh1 = ((b1 > 0.0f) == pos) ? y1 : y0;
  const float xh2 = ((a2 > 0.0f) == pos) ? x1 : x0, yh2 = ((b2 > 0.0f) == pos) ? y1 : y0;
  const float e1 = edge(a1, b1, c1, xh1, yh1) * sgn;
  const float e2 = edge(a2, b2, c2, xh2, yh2) * sgn;
  float e3;
  if (exact) {
    const float x3 = ((a1 + a2 > 0.0f) == pos) ? x0 : x1;
    const float y3 = ((b1 + b2 > 0.0f) == pos) ? y0 : y1;
    e3 = absz - edge(a1, b1, c1, x3, y3) * sgn - edge(a2, b2, c2, x3, y3) * sgn;
  } else {
    e3 = absz - edge(a1, b1, c1, x0 + x1 - xh1, y0 + y1 - yh1) * sgn -
         edge(a2, b2, c2, x0 + x1 - xh2, y0 + y1 - yh2) * sgn;
  }
  return (e1 >= 0.0f) & (e2 >= 0.0f) & (e3 >= 0.0f);
}

// Phase 1 over one pass's CSR slice of the block's bin tile.
template <bool kIdx, bool kRow>
__device__ __forceinline__ void depth_walk(const Pass& ps, const Block& b, Winner& win, Smem& sm) {
  const int start = ps.starts[b.tile];
  const int end = ps.starts[b.tile + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // This thread's pixel.
  const float px = (float)(b.x0 + rect_col(warp) + (lane & 7));
  const float py = (float)(b.y0 + rect_row(warp) + (lane >> 3));
  // The rect pass: lane l tests rect l % kRects of one of 32 / kRects
  // records at a time.
  constexpr int kPer = 32 / kRects;
  const int sub = lane / kRects, rect = lane % kRects;
  const float rx0 = (float)(b.x0 + rect_col(rect));
  const float ry0 = (float)(b.y0 + rect_row(rect));
  const float bx0 = (float)b.x0, by0 = (float)b.y0;
  const float bx1 = bx0 + (float)(kSubW - 1), by1 = by0 + (float)(kSubH - 1);
  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    __syncthreads();  // the previous chunk is consumed
    PROBE_BEGIN(1)
    // 1. Stage the records, each thread its own, and cull each against the
    //    sub-tile: mask 0 = misses it, else 1 | exact << 1.
#pragma unroll
    for (int h = 0; h < kStage; ++h) {
      const int t = threadIdx.x + h * kThreads;
      if (t < n) {
        const int row = ps.tris ? ps.tris[c0 + t] : c0 + t;
        const float* src = ps.rec + (size_t)row * ps.rec_stride;
        float v[16];
#pragma unroll
        for (int l = 0; l < 16; ++l) v[l] = l < kLanes ? __ldg(src + l) : 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sm.rec[t][q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        }
        if (kRow) sm.row[t] = row;
        const bool ex = exact_over(v, bx1, by1);
        sm.mask[t] = may_cover(v, ex, bx0, bx1, by0, by1) ? 1u + 2u * ex : 0u;
      }
    }
    __syncthreads();
    PROBE_END(1) PROBE_BEGIN(2)
    // 2. Rect masks of the survivors: warp w takes records w, w + kWarps, ...
    for (int g = 0; g < kChunk / (32 * kWarps); ++g) {
      const int mine = warp + kWarps * (lane + 32 * g);
      const unsigned f = mine < n ? sm.mask[mine] : 0u;
      unsigned live = __ballot_sync(~0u, f != 0u);
      while (live) {
        int k = -1;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          if (q == sub && live) k = __ffs(live) - 1;
          live &= live - 1;
        }
        const unsigned fk = __shfl_sync(~0u, f, max(k, 0));
        const int r = warp + kWarps * (max(k, 0) + 32 * g);
        const float* rec = reinterpret_cast<const float*>(sm.rec[r]);
        const bool hit = k >= 0 && may_cover(rec, (fk >> 1) & 1u, rx0, rx0 + 7.0f, ry0, ry0 + 3.0f);
        const unsigned m = __ballot_sync(~0u, hit);
        if (rect == 0 && k >= 0) sm.mask[r] = (m >> (sub * kRects)) & ((1u << kRects) - 1u);
      }
    }
    __syncthreads();
    PROBE_MASKS(c0, n, b, sm)
    PROBE_END(2) PROBE_BEGIN(3)
    // 3. The walk, in slot order, over the records that touch this warp's
    //    rect, kUnroll at a time (evaluated together, kept in order).
    for (int base = 0; base < n; base += 32) {
      const bool touches = base + lane < n && ((sm.mask[base + lane] >> warp) & 1u);
      unsigned live = __ballot_sync(~0u, touches);
      while (live) {
        float4 q0[kUnroll], q1[kUnroll], q2[kUnroll];
        float q3[kUnroll];
        bool on[kUnroll];
        int row[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          on[u] = live != 0u;
          const int k = on[u] ? __ffs(live) - 1 : 0;
          q0[u] = sm.rec[base + k][0];
          q1[u] = sm.rec[base + k][1];
          q2[u] = sm.rec[base + k][2];
          q3[u] = sm.rec[base + k][3].x;
          row[u] = kRow ? sm.row[base + k] : 0;
          live &= live - 1;
        }
        bool inside[kUnroll];
        float z[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          // Lanes: a1 b1 c1 a2 | b2 c2 sgn |cz| | 1/cz z1 z2 z3 | index.
          const float cx = q0[u].x * px + q0[u].y * py + q0[u].z;
          const float cy = q0[u].w * px + q1[u].x * py + q1[u].y;
          const float cxs = cx * q1[u].z;
          const float cys = cy * q1[u].z;
          inside[u] = on[u] & (cxs >= 0.0f) & (cys >= 0.0f) & (q1[u].w - cxs - cys >= 0.0f);
          const float uu = cx * q2[u].x;
          const float vv = cy * q2[u].x;
          const float ww = 1.0f - (cx + cy) * q2[u].x;
          z[u] = (ww * q2[u].y + uu * q2[u].z) + vv * q2[u].w;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (inside[u] && z[u] > win.z) {
            win.z = z[u];
            if (kIdx) win.idx = (int)q3[u];
            if (kRow) win.row = row[u];
          }
        }
      }
    }
    PROBE_SYNC() PROBE_END(3)
  }
}

// The walk's results into the row-major stash (which overlays the staged
// records, so it waits for every thread's walk).
template <bool kIdx, bool kRow>
__device__ __forceinline__ void stash(Smem& sm, const Winner& win) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = rect_row(warp) + (lane >> 3);
  const int col = rect_col(warp) + (lane & 7);
  __syncthreads();
  sm.out.z[row][col] = win.z;
  if (kIdx) sm.out.idx[row][col] = win.idx;
  if (kRow) sm.out.row[row][col] = win.row;
  __syncthreads();
}

// Per-strip max winning index (raster_pallas.py:236-252) from the stash, see
// the note.
__device__ __forceinline__ void emit_strips(const Grid& g, const Block& b, const Smem& sm,
                                            int* strips, int sl) {
  const int strips_w = g.out_w / sl;
  const int s0 = b.x0 / sl;
  const int ns = (b.x0 + kSubW - 1) / sl - s0 + 1;  // strips meeting the sub-tile, per row
  for (int i = threadIdx.x; i < kSubH * ns; i += kThreads) {
    const int row = i / ns;
    const int s = s0 + (i - row * ns);
    const int lo = max(s * sl, b.x0) - b.x0;
    const int hi = min(s * sl + sl, b.x0 + kSubW) - b.x0;
    int v = sm.out.idx[row][lo];
    for (int c = lo + 1; c < hi; ++c) v = max(v, sm.out.idx[row][c]);
    int* dst = strips + (size_t)(b.orow + row) * strips_w + s;
    if (hi - lo == sl) {
      *dst = v;
    } else {
      atomicMax(dst, v);
    }
  }
}

// Phase 2 (raster_pallas.py:257-312) at one pixel: its planes from its
// winning record, 0 where uncovered.
__device__ __forceinline__ void vary(const Pass& ps, const PlaneTable& pt, float* planes,
                                     size_t plane, size_t o, float px, float py, int idx,
                                     int brow) {
  if (idx < 0) {
    for (int p = 0; p < pt.n; ++p) planes[p * plane + o] = 0.0f;
    return;
  }
  const float* r = ps.rec + (size_t)brow * ps.rec_stride;
  const float cx = r[0] * px + r[1] * py + r[2];
  const float cy = r[3] * px + r[4] * py + r[5];
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
    planes[p * plane + o] = val;
  }
}

// K1.  kIdx: resolve the winning index (else depth only).  kPlanes: keep
// the winning record row and run phase 2.
template <bool kIdx, bool kPlanes>
__global__ void __launch_bounds__(kThreads) raster_kernel(Pass ps, Grid g, Outputs out,
                                                          PlaneTable pt) {
  __shared__ Smem sm;
  PROBE_STAMP(4) PROBE_BEGIN(0)
  const Block b = block_of(g);
  Winner win;
  clear(win);
  depth_walk<kIdx, kPlanes>(ps, b, win, sm);
  stash<kIdx, kPlanes>(sm, win);
  for (int p = threadIdx.x; p < kSubH * kSubW; p += kThreads) {
    const int row = p / kSubW, col = p - row * kSubW;
    const size_t o = (size_t)(b.orow + row) * g.out_w + b.x0 + col;
    if (out.z) out.z[o] = sm.out.z[row][col];
    if (kIdx && out.idx) {
      if (out.idx16) {
        static_cast<short*>(out.idx)[o] = (short)sm.out.idx[row][col];
      } else {
        static_cast<int*>(out.idx)[o] = sm.out.idx[row][col];
      }
    }
    if (kPlanes) {
      vary(ps, pt, out.planes, g.plane, o, (float)(b.x0 + col), (float)(b.y0 + row),
           sm.out.idx[row][col], sm.out.row[row][col]);
    }
  }
  if (kIdx && out.strips) emit_strips(g, b, sm, out.strips, out.strip_len);
  PROBE_SYNC() PROBE_END(0) PROBE_STAMP(5)
}

// K2: the light pass's depth, then the camera pass's index, on one sub-tile.
__global__ void __launch_bounds__(kThreads) raster_fused_kernel(Pass light, Pass camera,
                                                                Grid g, float* shadow_z,
                                                                int* idx) {
  __shared__ Smem sm;
  PROBE_STAMP(4) PROBE_BEGIN(0)
  const Block b = block_of(g);
  Winner win;
  clear(win);
  depth_walk<false, false>(light, b, win, sm);
  stash<false, false>(sm, win);
  for (int p = threadIdx.x; p < kSubH * kSubW; p += kThreads) {
    const int row = p / kSubW, col = p - row * kSubW;
    shadow_z[(size_t)(b.orow + row) * g.out_w + b.x0 + col] = sm.out.z[row][col];
  }
  clear(win);
  depth_walk<true, false>(camera, b, win, sm);
  stash<true, false>(sm, win);
  for (int p = threadIdx.x; p < kSubH * kSubW; p += kThreads) {
    const int row = p / kSubW, col = p - row * kSubW;
    idx[(size_t)(b.orow + row) * g.out_w + b.x0 + col] = sm.out.idx[row][col];
  }
  PROBE_SYNC() PROBE_END(0) PROBE_STAMP(5)
}

bool make_grid(int num_tiles, int tiles_x, int tile_h, int tile_w, int row_off, Grid& g,
               dim3& blocks) {
  if (tiles_x <= 0 || num_tiles % tiles_x || tile_h % kSubH || tile_w % kSubW) return false;
  g.tiles_x = tiles_x;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.row_off = row_off;
  g.out_w = tiles_x * tile_w;
  const int out_h = num_tiles / tiles_x * tile_h;
  g.plane = (size_t)out_h * g.out_w;
  blocks = dim3(g.out_w / kSubW, out_h / kSubH);
  return true;
}

}  // namespace

extern "C" {

// Launch K1 on `stream`.  tile_h must be a multiple of kSubH (8) and tile_w
// of kSubW (32).  tris may be null (gathered records).  z_out, idx_out
// (int16 when idx16), strips_out ((Hp, Wp / strip_len) int32) and
// planes_out ((n_planes, Hp, Wp) f32) may be null (not emitted); strips and
// planes need idx_out, and strips_out must hold -1 where a strip crosses a
// sub-tile border (strip_len not dividing kSubW (32)).  plane_desc holds
// n_planes rows of (mode, lane, W, H, swizzle tile).  All outputs are
// row-major over (Hp, Wp) = (num_tiles / tiles_x * tile_h, tiles_x *
// tile_w).  Returns cudaGetLastError() after the launch.
int raster_depth(const float* rec, int rec_stride, const int* tris, const int* starts,
                 int num_tiles, int tiles_x, int tile_h, int tile_w, int row_off,
                 float* z_out, void* idx_out, int idx16, int* strips_out, int strip_len,
                 float* planes_out, int n_planes, const int* plane_desc, void* stream) {
  if (n_planes < 0 || n_planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
  if ((strips_out || planes_out) && !idx_out) return (int)cudaErrorInvalidValue;
  if (!z_out && !idx_out) return (int)cudaErrorInvalidValue;
  if (strips_out && (strip_len <= 0 || tile_w % strip_len)) return (int)cudaErrorInvalidValue;
  Grid g;
  dim3 blocks;
  if (!make_grid(num_tiles, tiles_x, tile_h, tile_w, row_off, g, blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pass ps{rec, rec_stride, tris, starts};
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
  if (planes_out) {
    raster_kernel<true, true><<<blocks, kThreads, 0, s>>>(ps, g, out, pt);
  } else if (idx_out) {
    raster_kernel<true, false><<<blocks, kThreads, 0, s>>>(ps, g, out, pt);
  } else {
    raster_kernel<false, false><<<blocks, kThreads, 0, s>>>(ps, g, out, pt);
  }
  return (int)cudaGetLastError();
}

// Launch K2 on `stream`: shadow_z from the light pass, idx (int32) from the
// camera pass, both (Hp, Wp) row-major.  tris1/tris2 may be null (gathered).
int raster_fused(const float* rec1, int stride1, const int* tris1, const int* starts1,
                 const float* rec2, int stride2, const int* tris2, const int* starts2,
                 int num_tiles, int tiles_x, int tile_h, int tile_w, int row_off,
                 float* shadow_z, int* idx, void* stream) {
  Grid g;
  dim3 blocks;
  if (!make_grid(num_tiles, tiles_x, tile_h, tile_w, row_off, g, blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const Pass light{rec1, stride1, tris1, starts1};
  const Pass camera{rec2, stride2, tris2, starts2};
  raster_fused_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      light, camera, g, shadow_z, idx);
  return (int)cudaGetLastError();
}

const char* raster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef RASTER_PROBE
// Point the probe build's probes at device buffers (see probe_times and
// probe_masks; null: off) for the launches that follow.
int raster_set_probe(void* times, void* masks) {
  const cudaError_t err = cudaMemcpyToSymbol(probe_times, &times, sizeof(times));
  return (int)(err ? err : cudaMemcpyToSymbol(probe_masks, &masks, sizeof(masks)));
}
#endif

}  // extern "C"
