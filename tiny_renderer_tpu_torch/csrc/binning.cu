// Screen-tile binning, hand-written for Hopper (sm_90a): a stable counting
// sort of one pass's triangles by tile, with the record pack, in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves binning to XLA
// (tiny_renderer_tpu/ops/binning.py bin_triangles: the candidate keys
// tile * K + triangle, a sort, searchsorted, the record pack).  The port's
// plain torch version of the same function (ops/binning.py
// bin_triangles_reference) issues ~60 kernels a pass and cub's radix sort
// over every T x max_span_y x max_span_x candidate key on all 32 bits; as
// graph nodes they cost ~0.15 ms a pass on the H100.  So this file exists
// to cut the chain of dependent launches to one.
//
// What bounds it on this card: not bytes.  A pass reads 57 B of setup
// columns a triangle and writes a 64 B record a triangle, the id list and
// the tile starts: ~0.7 MB at 5,096 triangles and 175 tiles, ~0.2 us at
// 3.35 TB/s.  The launch takes ~12 us there: the instructions each block
// repeats, since every block walks every triangle's rectangle (twice
// where its tile holds one), so the busiest SMs' issue sets the time.
//
// Design.  One block a tile, 512 threads, each of its 16 warps over its own
// run of consecutive triangles, 32 at a time, coalesced.  Every triangle's
// clamped tile rectangle is recomputed from its bbox columns where it is
// needed (17 B a triangle, read by every block from L2), so no launch
// precedes this one.  A block needs, besides its own ids, the number of
// incidences in the tiles before its own; a rectangle's incidences before
// a tile follow from the rectangle alone (whole rows above, a prefix of the
// tile's row), so a block sums them over all triangles instead of waiting
// for the other blocks' counts.  Pass 1 sums them, the candidates (the
// total, for the cap) and the span-clamp bits, and counts the triangles
// covering the tile per warp (a ballot and popc), then the warps' partial
// sums go through shared memory.  Pass 2 runs under binning_compact only: a
// triangle's candidates take the triangle-major positions base + dy * sx +
// dx, base a prefix sum of the counts (a warp scan a chunk), and those at
// or past cap are dropped before the sort, so the tile's start is the kept
// candidates before it, summed in a second walk.  Pass 3, in blocks whose
// tile holds a triangle, writes each covering triangle's id at start + its
// rank among the tile's covering triangles in triangle order (the warps'
// offsets, then the ballot's lower lanes): triangle ids ascend within a
// tile, as the sorted keys have them.  Without binning_compact an incidence
// is kept if its tile-major slot is below cap; with it, if its
// triangle-major position is (the kept ones of a tile are then its first
// covering triangles, so the rank still gives the slot).  Every block
// writes its tile's start, a share of the slots past the kept incidences
// (T - 1, or T - 1's record row) and, in the indirect layout, a share of
// the (T, lanes) record table; block 0 writes the overflow flag, the last
// block starts[tiles].  Gathered (csr_indirect off), pass 3 writes each
// kept incidence's record row in place of its id.  No atomic decides a
// position; the kernel allocates nothing and leaves no scratch.
//
// Exactness.  The outputs equal ops/binning.py's plain version bit for
// bit, for triangles whose bbox lies on the screen with x0 <= x1 and
// y0 <= y1 where valid (as triangle_setup gives them): tile bounds by
// floor division (Python's //: an arithmetic shift where the tile sizes
// are powers of two, as at every size the benchmark runs, which saves the
// integer divisions every block would repeat for every triangle; else C's
// /, which truncates toward zero, corrected), the row offset subtracted
// and the rows clamped as there; the record's
// columns as int32 -> float32 (round to nearest), the sign and |cz| of
// float32(cz), 1 / cz (1 where cz is 0) by an IEEE division (nvcc's
// default without --use_fast_math; torch's reciprocal is one too), the
// triangle index as float32 (exact below 2^24), the depth and the spec
// lanes copied, zeros to the padded width.
//
// Columns (ops/binning_cuda.py COLUMNS holds the same order): valid
// (bytes), x0, x1, y0, y1, a1, b1, c1, a2, b2, c2, cz (int32), zv[:, 0..2]
// (float32), then one float32 column a spec lane, each with its stride
// between triangles in elements.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // a block: one tile
constexpr int kWarps = kThreads / 32;
constexpr int kBaseLanes = 13;  // ops/binning.py BASE_LANES
constexpr int kMaxLanes = 128;  // record lanes a launch writes at most
enum Column { kValid = 0, kX0, kX1, kY0, kY1, kA1, kCz = kA1 + 6, kZv, kSpec = kZv + 3 };
constexpr int kMaxColumns = kSpec + kMaxLanes - kBaseLanes;

struct Params {
  const void* col[kMaxColumns];
  int stride[kMaxColumns];  // elements between triangles
  int n_spec, n_tri, tiles_x, tiles_y, tile_h, tile_w, shift_h, shift_w, span_y, span_x, row_offset, cap, slots,
      compact, lanes;
  float* records;  // (n_tri, lanes), or gathered (slots, lanes)
  int* tris;       // (slots,); null when gathered
  int* starts;     // (tiles + 1,)
  unsigned char* overflowed;
};

// Element i of column c (i * stride below 2^31: the wrapper checks).
__device__ __forceinline__ int load_int(const Params& p, int c, int i) {
  return __ldg(static_cast<const int*>(p.col[c]) + i * p.stride[c]);
}

__device__ __forceinline__ float load_float(const Params& p, int c, int i) {
  return __ldg(static_cast<const float*>(p.col[c]) + i * p.stride[c]);
}

// Python's a // b for b > 0: with kShift, b = 2^shift and an arithmetic
// shift gives it; else a division rounded toward minus infinity.
template <bool kShift>
__device__ __forceinline__ int floor_div(int a, int b, int shift) {
  if (kShift) return a >> shift;
  const int q = a / b;
  return a % b < 0 ? q - 1 : q;
}

// A triangle's candidate tiles: rows ty0 .. ty0 + sy - 1, columns tx0 ..
// tx0 + sx - 1 of the band (sy = sx = 0: none), and whether the span caps
// cut them.
struct Rect {
  int ty0, tx0, sy, sx;
  bool clamped;
};

template <bool kShift>
__device__ Rect rect_of(const Params& p, int i) {
  const bool valid = __ldg(static_cast<const unsigned char*>(p.col[kValid]) + i * p.stride[kValid]) != 0;
  const int tx0 = floor_div<kShift>(load_int(p, kX0, i), p.tile_w, p.shift_w);
  const int tx1 = floor_div<kShift>(load_int(p, kX1, i), p.tile_w, p.shift_w);
  int ty0 = floor_div<kShift>(load_int(p, kY0, i), p.tile_h, p.shift_h) - p.row_offset;
  int ty1 = floor_div<kShift>(load_int(p, kY1, i), p.tile_h, p.shift_h) - p.row_offset;
  const bool v = valid && ty1 >= 0 && ty0 <= p.tiles_y - 1;
  ty0 = min(max(ty0, 0), p.tiles_y - 1);
  ty1 = min(max(ty1, 0), p.tiles_y - 1);
  const int span_x = tx1 - tx0, span_y = ty1 - ty0;
  Rect r;
  r.ty0 = ty0;
  r.tx0 = tx0;
  r.sy = v ? max(min(span_y + 1, p.span_y), 0) : 0;
  r.sx = v ? max(min(span_x + 1, p.span_x), 0) : 0;
  r.clamped = v && (span_x > p.span_x - 1 || span_y > p.span_y - 1);
  return r;
}

__device__ __forceinline__ bool covers(const Rect& q, int row, int col) {
  const int dr = row - q.ty0, dc = col - q.tx0;
  return dr >= 0 && dr < q.sy && dc >= 0 && dc < q.sx;
}

// The rectangle's candidates in tiles before (row, col), tile-major: its
// position dy * sx + dx there when it covers the tile.
__device__ __forceinline__ int before(const Rect& q, int row, int col) {
  const int dr = row - q.ty0, dc = col - q.tx0;
  const int in_row = dr >= 0 && dr < q.sy ? min(max(dc, 0), q.sx) : 0;
  return min(max(dr, 0), q.sy) * q.sx + in_row;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(~0u, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Lane `lane` of triangle i's record (ops/binning.py pack_triangle_records).
__device__ float lane_value(const Params& p, int i, int lane) {
  if (lane < 6) return static_cast<float>(load_int(p, kA1 + lane, i));
  if (lane < 9) {
    const int cz = load_int(p, kCz, i);
    const float czf = static_cast<float>(cz);
    if (lane == 6) return czf < 0.0f ? -1.0f : 1.0f;
    if (lane == 7) return fabsf(czf);
    return 1.0f / (cz == 0 ? 1.0f : czf);
  }
  if (lane < 12) return load_float(p, kZv + lane - 9, i);
  if (lane == 12) return static_cast<float>(i);
  if (lane - kBaseLanes < p.n_spec) return load_float(p, kSpec + lane - kBaseLanes, i);
  return 0.0f;
}

// Triangle i's record into row `slot` of the gathered table.
__device__ void write_row(const Params& p, int slot, int i) {
  float4* row = reinterpret_cast<float4*>(p.records + static_cast<long long>(slot) * p.lanes);
  for (int l = 0; l < p.lanes; l += 4) {
    row[l / 4] = make_float4(lane_value(p, i, l), lane_value(p, i, l + 1), lane_value(p, i, l + 2),
                             lane_value(p, i, l + 3));
  }
}

// kShift: tile_h and tile_w are powers of two.
template <bool kShift>
__global__ void __launch_bounds__(kThreads) binning_kernel(const Params p) {
  __shared__ int s_cover[kWarps], s_count[kWarps], s_before[kWarps], s_clamped[kWarps], s_kept[kWarps];
  const int tile = blockIdx.x, tiles = gridDim.x, row = tile / p.tiles_x, col = tile % p.tiles_x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lower = (1u << lane) - 1;
  // This warp's run of triangles, whole chunks of 32 but the last.
  const int run = ((p.n_tri + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int first = min(warp * run, p.n_tri), last = min(first + run, p.n_tri);

  // Pass 1: the covering triangles, the candidates, those before the tile.
  int cover = 0, count = 0, ahead = 0, clamped = 0;
#pragma unroll 4
  for (int i0 = first; i0 < last; i0 += 32) {
    const int i = i0 + lane;
    Rect q{0, 0, 0, 0, false};
    if (i < last) q = rect_of<kShift>(p, i);
    cover += __popc(__ballot_sync(~0u, covers(q, row, col)));
    count += q.sy * q.sx;
    ahead += before(q, row, col);
    clamped |= q.clamped;
  }
  count = warp_sum(count);
  ahead = warp_sum(ahead);
  clamped = __any_sync(~0u, clamped);
  if (lane == 0) {
    s_cover[warp] = cover;
    s_count[warp] = count;
    s_before[warp] = ahead;
    s_clamped[warp] = clamped;
  }
  __syncthreads();
  int cover_off = 0, count_off = 0, covering = 0, total = 0, start = 0;
  bool any_clamped = false;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      cover_off += s_cover[w];
      count_off += s_count[w];
    }
    covering += s_cover[w];
    total += s_count[w];
    start += s_before[w];
    any_clamped |= s_clamped[w] != 0;
  }

  // Pass 2 (binning_compact): the kept candidates before the tile.
  if (p.compact) {
    int kept = 0, base = count_off;
    for (int i0 = first; i0 < last; i0 += 32) {
      const int i = i0 + lane;
      Rect q{0, 0, 0, 0, false};
      if (i < last) q = rect_of<kShift>(p, i);
      const int n = q.sy * q.sx, incl = warp_inclusive(n, lane);
      kept += max(0, min(before(q, row, col), p.cap - (base + incl - n)));
      base += __shfl_sync(~0u, incl, 31);
    }
    kept = warp_sum(kept);
    if (lane == 0) s_kept[warp] = kept;
    __syncthreads();
    start = 0;
    for (int w = 0; w < kWarps; ++w) start += s_kept[w];
  }

  // Pass 3: the tile's ids (or record rows), in triangle order.
  if (covering > 0) {
    int rank = cover_off, base = count_off;
    for (int i0 = first; i0 < last; i0 += 32) {
      const int i = i0 + lane;
      Rect q{0, 0, 0, 0, false};
      if (i < last) q = rect_of<kShift>(p, i);
      const bool cov = covers(q, row, col);
      const unsigned m = __ballot_sync(~0u, cov);
      const int slot = start + rank + __popc(m & lower);
      bool keep = slot < p.cap;
      if (p.compact) {
        const int n = q.sy * q.sx, incl = warp_inclusive(n, lane);
        keep = before(q, row, col) < p.cap - (base + incl - n);
        base += __shfl_sync(~0u, incl, 31);
      }
      if (cov && keep) {
        if (p.tris) {
          p.tris[slot] = i;
        } else {
          write_row(p, slot, i);
        }
      }
      rank += __popc(m);
    }
  }

  const int kept_all = min(total, p.cap);
  if (threadIdx.x == 0) {
    p.starts[tile] = min(start, p.cap);
    if (tile == tiles - 1) p.starts[tiles] = kept_all;
    if (tile == 0) *p.overflowed = total > p.cap || any_clamped;
  }
  const int step = tiles * kThreads;
  const int at = tile * kThreads + threadIdx.x;
  if (p.tris) {
    for (int s = kept_all + at; s < p.slots; s += step) p.tris[s] = p.n_tri - 1;
    const int n = p.n_tri * p.lanes;
    for (int e = at; e < n; e += step) p.records[e] = lane_value(p, e / p.lanes, e % p.lanes);
  } else {
    for (int s = kept_all + at; s < p.slots; s += step) write_row(p, s, p.n_tri - 1);
  }
}

}  // namespace

extern "C" {

// Launch binning_kernel on `stream`: one block a tile of the tiles_y x
// tiles_x band.  cols, strides: kSpec + n_spec columns in the order of the
// note above.  cap: the incidence cap; slots: the id list's length (cap,
// or the candidate count where that is less: the plain version cuts its
// sorted keys there).  records: (n_tri, lanes) float32, or with tris null
// the gathered (slots, lanes); tris (slots,) int32; starts (tiles + 1,)
// int32; overflowed one byte.  lanes: a multiple of 4, at most kMaxLanes,
// at least kBaseLanes + n_spec.  Returns cudaGetLastError() after the
// launch.
int binning_launch(const void* const* cols, const int* strides, int n_spec, int n_tri, int tiles_x, int tiles_y,
                   int tile_h, int tile_w, int span_y, int span_x, int row_offset, int cap, int slots,
                   int compact, int lanes, float* records, int* tris, int* starts, unsigned char* overflowed,
                   void* stream) {
  if (n_spec < 0 || lanes > kMaxLanes || lanes % 4 != 0 || kBaseLanes + n_spec > lanes || n_tri < 0 || cap < 0 ||
      slots < 0 || tiles_x < 1 || tiles_y < 1 || tile_h < 1 || tile_w < 1 || span_y < 1 || span_x < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  for (int c = 0; c < kSpec + n_spec; ++c) {
    p.col[c] = cols[c];
    p.stride[c] = strides[c];
  }
  p.n_spec = n_spec;
  p.n_tri = n_tri;
  p.tiles_x = tiles_x;
  p.tiles_y = tiles_y;
  p.tile_h = tile_h;
  p.tile_w = tile_w;
  p.span_y = span_y;
  p.span_x = span_x;
  p.row_offset = row_offset;
  p.cap = cap;
  p.slots = slots;
  p.compact = compact;
  p.lanes = lanes;
  p.records = records;
  p.tris = tris;
  p.starts = starts;
  p.overflowed = overflowed;
  p.shift_h = __builtin_ctz(tile_h);
  p.shift_w = __builtin_ctz(tile_w);
  const auto kernel = tile_h == 1 << p.shift_h && tile_w == 1 << p.shift_w ? binning_kernel<true>
                                                                            : binning_kernel<false>;
  kernel<<<tiles_x * tiles_y, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* binning_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
