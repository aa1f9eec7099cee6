// K7: the input stage of tracking: the noise filters of level 0 and the
// pyramid, every level in one launch.
//
// The filters (filter_input = True / "bilateral", "median", "median2")
// replace supereight_tpu/ops/preprocess.py:bilateral_filter (28-52) and
// median_filter3 (55-76), which XLA runs as 25 or 9 shifted slices of an
// edge-padded image. Each is one launch; reads clamp global coordinates
// into the image, so the edge is replicated as jnp.pad(mode="edge")
// replicates it:
//  * bilateral_kernel: the weight of a neighbour cur at row offset i and
//    column offset j is (g[i] g[j]) exp(-(cur - d)^2 / (2 e_d^2)), 0
//    where cur <= 0; t and s summed i outer, j inner, as JAX's loop;
//    t / (s == 0 ? 1 : s), and 0 where the centre d == 0. The spatial
//    factors g[i] g[j] are the wrapper's f32 products of the f32 values of
//    JAX's exp(-i^2 / (2 DELTA^2)). Each pair of pixels is weighed once:
//    the weight of p's tap on q at (i, j) is the weight of q's tap on p
//    at (-i, -j) to the bit (a - b is -(b - a) exactly, and g is
//    symmetric to the bit), so a position weighs its 12 pairs in one
//    half-plane (i > 0, or i == 0 < j) and its partners read them; the
//    centre's factor is g[0]^2 with no expf. A CTA owns a kBilW x kBilH
//    tile: it reads the tile's depths with a halo (clamped on load, so no
//    tap clamps) into shared memory, weighs the half-plane pairs of every
//    position that an output pixel pairs with (a thread a position, 12
//    independent weights each) into a shared table, and after a barrier
//    sums each output pixel's 25 taps from the table (a warp an output
//    row). The division and expf a pair stay as the twin's, so the
//    output is the per-tap kernel's bit for bit.
//  * median_kernel<P>: P passes of the 3 x 3 median: the nine taps, each
//    zero (<= 0) tap replaced by the centre, their fifth smallest; 0 where
//    the centre <= 0. No shared memory and no barrier: a warp owns 32
//    columns of a strip of kMedRows rows and outputs the 32 - 2P columns
//    inside them; each lane loads its column's kMedRows + 2P rows (clamped
//    into the image, so the edge is replicated) into registers and reads
//    its neighbours' columns by shuffle. Each row's three taps are sorted
//    once and shared by the three windows that hold the row; a window's
//    median is med3(max of the rows' minima, med3 of their medians, min
//    of their maxima) (Paeth's identity). The centre replacement would
//    break that sharing, so where a warp holds a tap <= 0 the rows are
//    sorted twice, with those taps as -inf and as +inf, and the median is
//    clamp(centre, the first median, the second) (median_rows); a warp
//    without one sorts once. With P = 2 the first pass is evaluated for
//    the kMedRows + 2 rows the second reads, each row and column outside
//    the image then taking the value of the nearest one inside it (JAX's
//    edge padding of the first pass's output). Every output is one of its
//    taps, so the result is the twin's bit for bit.
// Bound on the H100: bytes, the depth read once and the filtered depth
// written once (614 KB at 320x240: 0.18 us at 3.35 TB/s), or the
// bilateral's 12 pair weights (~14 operations each) and 25 taps (~4) a
// pixel (0.31 us at the f32 rate). The range weights, a division and an
// expf each, were 5.4 of the per-tap kernel's 7.9 us (PERF.md): sharing
// the pairs leaves 15 an output (12, the halo positions' besides) of 25.
// They need threads in flight: warp strips that kept a lane's rows and
// their weights in registers (4 rows a lane, 5.5 warps an SM at
// 320x240) took 13.1 us against the per-tap kernel's 8.0. A median warp
// reads (kMedRows + 2P) x 32 pixels for kMedRows x (32 - 2P), a
// bilateral CTA (kBilH + 4) x (kBilW + 8) for kBilH x kBilW, the rest
// from L2. At that size the filters are latency-bound: a median warp is
// one load round trip and ~20 min/max operations a row and an output
// (twice that where it holds a zero tap), with no phase waiting on
// another.
//
// The pyramid (the filter_input=False path, and the pass after a filter).
//
// Replaces supereight_tpu/pipeline.py:_preprocess_and_pyramid (26-58)
// with ops/preprocess.py:half_sample_robust (79-98), depth2vertex
// (101-114) and vertex2normal (117-143), which XLA runs as gathers,
// concatenations and an einsum over each level's image.
//
// Each CTA owns a square of the coarsest level, kRegion >> (L - 1) pixels
// a side, and the same region of every finer level (kRegion >> l pixels a
// side at level l). It reads the level-0 depth of that region plus a halo
// of 2^(L-1) pixels into shared memory once, then
//  * half-samples level by level in shared memory, each coarser level's
//    region and halo (ref preprocessing.cpp:190-226): the 2x2 window at
//    offsets {0, 1} from (2r, 2c), clamped at the last row and column;
//    samples with |cur - center| >= e_d are left out of the mean; t and s
//    summed in the twin's order (row offset outer, column offset inner),
//    t / (s == 0 ? 1 : s);
//  * writes every level's depth (levels >= 1), vertex, normal and valid
//    for its regions in one pass over their pixels (ref
//    preprocessing.cpp:91-159): the inverse intrinsics of k / 2^level as
//    se3.inverse_camera_matrix builds them (once a CTA), the
//    back-projected vertex d * (ik[r][0] x + ik[r][1] y + ik[r][2]) (0
//    where d <= 0), the four edge-replicated neighbours' vertices
//    recomputed from depth, the cross product of the central differences
//    over its norm (1 where the norm is 0), and the sentinel (INVALID, 0,
//    0) where the pixel or a neighbour has no depth; neg_y swaps the
//    vertical neighbours.
// Level l needs a halo of 2^(L-1-l): one pixel for its own normals,
// doubled by each half-sample below it. Clamping uses global image
// coordinates, so a CTA at the image's edge reads what the twins'
// clamped gathers read; halo values are computed by every CTA that holds
// them, with the same arithmetic. No CTA waits for another.
//
// Bound on the H100: bytes. The level-0 depth is read once (300 KB at
// 320x240) and every level's depth, vertex, normal and valid written once
// (1.9 MB at level 0, 2.6 MB for three levels: ~0.9 us at 3.35 TB/s); the
// ~60 operations a pixel are far below the f32 rate. The halo makes a CTA
// read (16 + 2^L)^2 level-0 pixels for its 16^2, the rest from L2. The
// region and block size are the fastest of those timed on the H100
// (PERF.md).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLevels = 4;   // _lib.MAX_ICP_LEVELS
constexpr int kRegion = 16;     // level-0 pixels a CTA owns a side
constexpr float kInvalid = -2.f;  // constants.INVALID (ref commons.h)

// the widest window of level l is (kRegion + 2^kMaxLevels) >> l a side;
// the windows lie one after another in shared memory
constexpr int kSide0 = kRegion + (1 << kMaxLevels);
__host__ __device__ constexpr int window_offset(int l) {
  int off = 0;
  for (int j = 0; j < l; ++j) off += (kSide0 >> j) * (kSide0 >> j);
  return off;
}
constexpr int kWindowFloats = window_offset(kMaxLevels);
// a CTA's window of level l of n_lv: its region (kRegion >> l a side) and
// a halo of 2^(n_lv - 1 - l); the global row or column of its first pixel
// for CTA index t along that axis
__device__ __forceinline__ int window_side(int l, int n_lv) {
  return (kRegion >> l) + (2 << (n_lv - 1 - l));
}
__device__ __forceinline__ int window_origin(int t, int l, int n_lv) {
  return t * (kRegion >> l) - (1 << (n_lv - 1 - l));
}

// per-level outputs and sizes, passed by value (_lib.Levels); depth[0] is
// unused (level 0 is the input)
struct Levels {
  float* depth[kMaxLevels];
  float* vertex[kMaxLevels];
  float* normal[kMaxLevels];
  uint8_t* valid[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int n_levels;
};

// The camera-frame vertex of pixel (r, c) of depth d: d times the ray of
// the inverse intrinsics ik (rows 0 and 1; row 2 is (0, 0, 1)), summed
// left to right like the twin's rays.
__device__ __forceinline__ float3 vertex(float d, int r, int c,
                                         const float* ik) {
  if (!(d > 0.f)) return make_float3(0.f, 0.f, 0.f);
  const float x = (float)c, y = (float)r;
  return make_float3(d * (ik[0] * x + ik[1] * y + ik[2]),
                     d * (ik[3] * x + ik[4] * y + ik[5]),
                     d * (0.f * x + 0.f * y + 1.f));
}

__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const float* __restrict__ depth, const float* __restrict__ k,
               float e_d, int neg_y, Levels lv) {
  __shared__ float win[kWindowFloats];
  // each level's inverse intrinsics, rows 0 and 1 (row 2 is (0, 0, 1))
  __shared__ float inv_k[kMaxLevels][6];
  const int n_lv = lv.n_levels;

  // se3.inverse_camera_matrix(k / 2^level): exact power-of-two scaling
  if (threadIdx.x < n_lv) {
    const int l = threadIdx.x;
    const float scale = (float)(1 << l);
    const float fx = k[0] / scale, fy = k[1] / scale;
    const float cx = k[2] / scale, cy = k[3] / scale;
    const float ik[6] = {1.f / fx, 0.f, -cx / fx, 0.f, 1.f / fy, -cy / fy};
    for (int j = 0; j < 6; ++j) inv_k[l][j] = ik[j];
  }

  // level 0's window: its region and halo, the pixels inside the image
  {
    const int side = window_side(0, n_lv);
    const int oy = window_origin(blockIdx.y, 0, n_lv);
    const int ox = window_origin(blockIdx.x, 0, n_lv);
    for (int i = threadIdx.x; i < side * side; i += kThreads) {
      const int gy = oy + i / side, gx = ox + i % side;
      if (gy >= 0 && gy < lv.h[0] && gx >= 0 && gx < lv.w[0])
        win[i] = depth[gy * lv.w[0] + gx];
    }
  }
  __syncthreads();

  // the coarser levels' windows, each the robust 2x2 mean of the one
  // before over the pixels inside its image (a pixel (r, c) of level l + 1
  // reads rows 2r, 2r + 1 and columns 2c, 2c + 1 of level l's window)
  for (int l = 0; l + 1 < n_lv; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const int side = window_side(l, n_lv);
    const int oy = window_origin(blockIdx.y, l, n_lv);
    const int ox = window_origin(blockIdx.x, l, n_lv);
    const float* cur = win + window_offset(l);
    const int nside = window_side(l + 1, n_lv);
    const int noy = window_origin(blockIdx.y, l + 1, n_lv);
    const int nox = window_origin(blockIdx.x, l + 1, n_lv);
    float* nxt = win + window_offset(l + 1);
    for (int i = threadIdx.x; i < nside * nside; i += kThreads) {
      const int ry = noy + i / nside, rx = nox + i % nside;
      if (ry < 0 || ry >= lv.h[l + 1] || rx < 0 || rx >= lv.w[l + 1])
        continue;
      const int r = 2 * ry, c = 2 * rx;
      const float center = cur[(r - oy) * side + c - ox];
      float t = 0.f, s = 0.f;
      for (int di = 0; di < 2; ++di)
        for (int dj = 0; dj < 2; ++dj) {
          const float v = cur[(min(r + di, h - 1) - oy) * side +
                              min(c + dj, w - 1) - ox];
          const bool take = fabsf(v - center) < e_d;
          t = t + (take ? v : 0.f);
          s = s + (take ? 1.f : 0.f);
        }
      nxt[i] = t / (s == 0.f ? 1.f : s);
    }
    __syncthreads();
  }

  // every level's outputs in one pass over the regions' pixels inside the
  // images, finest level first
  int n_px = 0;
  for (int l = 0; l < n_lv; ++l) n_px += (kRegion >> l) * (kRegion >> l);
  for (int i = threadIdx.x; i < n_px; i += kThreads) {
    int l = 0, j = i;
    while (j >= (kRegion >> l) * (kRegion >> l)) {
      j -= (kRegion >> l) * (kRegion >> l);
      ++l;
    }
    const int region = kRegion >> l, h = lv.h[l], w = lv.w[l];
    const int r = blockIdx.y * region + j / region;
    const int c = blockIdx.x * region + j % region;
    if (r >= h || c >= w) continue;
    const int side = window_side(l, n_lv);
    const int oy = window_origin(blockIdx.y, l, n_lv);
    const int ox = window_origin(blockIdx.x, l, n_lv);
    const float* cur = win + window_offset(l);
    // the level's depth at global (gy, gx), clamped into the image
    auto at = [&](int gy, int gx) {
      return cur[(min(max(gy, 0), h - 1) - oy) * side +
                 min(max(gx, 0), w - 1) - ox];
    };
    const float* ik = inv_k[l];
    const float d = at(r, c);
    const float3 v = vertex(d, r, c, ik);
    const float3 left = vertex(at(r, c - 1), r, max(c - 1, 0), ik);
    const float3 right = vertex(at(r, c + 1), r, min(c + 1, w - 1), ik);
    const float3 prev = vertex(at(r - 1, c), max(r - 1, 0), c, ik);
    const float3 next = vertex(at(r + 1, c), min(r + 1, h - 1), c, ik);
    const float3 up = neg_y ? prev : next;
    const float3 down = neg_y ? next : prev;
    const bool ok = v.z != 0.f && left.z != 0.f && right.z != 0.f &&
                    up.z != 0.f && down.z != 0.f;
    float3 n = make_float3(kInvalid, 0.f, 0.f);
    if (ok) {
      const float ax = right.x - left.x, ay = right.y - left.y,
                  az = right.z - left.z;
      const float bx = up.x - down.x, by = up.y - down.y, bz = up.z - down.z;
      const float nx = ay * bz - az * by;
      const float ny = az * bx - ax * bz;
      const float nz = ax * by - ay * bx;
      const float len = sqrtf(nx * nx + ny * ny + nz * nz);
      const float dd = len == 0.f ? 1.f : len;
      n = make_float3(nx / dd, ny / dd, nz / dd);
    }
    const int p = r * w + c;
    if (l > 0) lv.depth[l][p] = d;
    float* vo = lv.vertex[l] + 3 * p;
    float* no = lv.normal[l] + 3 * p;
    vo[0] = v.x;
    vo[1] = v.y;
    vo[2] = v.z;
    no[0] = n.x;
    no[1] = n.y;
    no[2] = n.z;
    lv.valid[l][p] = ok ? 1 : 0;
  }
}

constexpr int kMaxHalo = 2;  // the bilateral filter's radius

__device__ __forceinline__ void sort2(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// a row's three taps, sorted
struct Sorted3 {
  float lo, mid, hi;
};

__device__ __forceinline__ Sorted3 sort3(float a, float b, float c) {
  sort2(a, b);
  sort2(b, c);
  sort2(a, b);
  return {a, b, c};
}

// the fifth smallest of the 3 x 3 window of rows j - 1, j, j + 1, from
// their sorted taps (exact for any values: Paeth's identity)
template <int N>
__device__ __forceinline__ float med9(const Sorted3 (&s)[N], int j) {
  return med3(fmaxf(fmaxf(s[j - 1].lo, s[j].lo), s[j + 1].lo),
              med3(s[j - 1].mid, s[j].mid, s[j + 1].mid),
              fminf(fminf(s[j - 1].hi, s[j].hi), s[j + 1].hi));
}

constexpr unsigned kFullMask = 0xffffffffu;
// output rows a median lane owns: median2 on the noise maps' 320x240
// depths took 1.91 / 2.09-2.11 us on the H100 at 2, against 1.95 /
// 2.47-2.51 at 4, 2.16 / 2.46-2.47 at 1 and 2.22 / 3.34 at 8 (PERF.md,
// PR 16): fewer rows shorten a lane's chain, more share a lane's sorts
// between more outputs
constexpr int kMedRows = 2;
constexpr int kMedWarps = 4;  // warps of a median CTA, strips stacked

// One 3 x 3 median pass down a lane's column (ops/preprocess.py:
// median_filter3): in[j] is the column's value at row q0 + j, the lanes
// either side hold the columns either side; out[j] is the median at row
// q0 + 1 + j: the taps' fifth smallest with each tap <= 0 replaced by the
// centre d, 0 where d <= 0. With z of the nine taps <= 0 (and d > 0) that
// is clamp(d, T5, U5), T5 the fifth smallest of the taps with those z as
// -inf and U5 with them as +inf: the replaced taps are z copies of d
// among the positive taps, and T5, U5 are the positive taps' (5 - z)-th
// and fifth smallest. A warp none of whose taps is <= 0 takes T5 = U5
// alone. Either way the taps are replaced before the rows are sorted, so
// each row's sort serves the three windows that hold it. Every lane of
// the warp calls it (the shuffles); the edge lanes' results are not the
// image's.
template <int N>
__device__ __forceinline__ void median_rows(const float (&in)[N],
                                            float (&out)[N - 2]) {
  const float inf = __int_as_float(0x7f800000);
  float l[N], r[N];
  bool zero = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    l[j] = __shfl_up_sync(kFullMask, in[j], 1);
    r[j] = __shfl_down_sync(kFullMask, in[j], 1);
    zero |= !(l[j] > 0.f && in[j] > 0.f && r[j] > 0.f);
  }
  if (!__any_sync(kFullMask, zero)) {
    Sorted3 s[N];
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = sort3(l[j], in[j], r[j]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j) out[j - 1] = med9(s, j);
    return;
  }
  Sorted3 lo[N], hi[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    lo[j] = sort3(l[j] > 0.f ? l[j] : -inf, in[j] > 0.f ? in[j] : -inf,
                  r[j] > 0.f ? r[j] : -inf);
    hi[j] = sort3(l[j] > 0.f ? l[j] : inf, in[j] > 0.f ? in[j] : inf,
                  r[j] > 0.f ? r[j] : inf);
  }
#pragma unroll
  for (int j = 1; j < N - 1; ++j) {
    const float d = in[j];
    out[j - 1] = d > 0.f ? fminf(fmaxf(d, med9(lo, j)), med9(hi, j)) : 0.f;
  }
}

// kPasses (1 or 2) median passes. Warp (blockIdx.y * kMedWarps + warp)
// takes the strip of rows [r0, r0 + kMedRows), lane the column c = x0 +
// lane - kPasses of the warp's 32, and writes the 32 - 2 kPasses columns
// from x0.
template <int kPasses>
__global__ void __launch_bounds__(kMedWarps * 32)
median_kernel(const float* __restrict__ depth, int h, int w,
              float* __restrict__ out) {
  constexpr int kCols = 32 - 2 * kPasses;
  constexpr int kIn = kMedRows + 2 * kPasses;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.y * kMedWarps + (threadIdx.x >> 5)) * kMedRows;
  if (r0 >= h) return;  // the whole warp
  const int c = blockIdx.x * kCols + lane - kPasses;
  const int cc = min(max(c, 0), w - 1);
  float v[kIn];
#pragma unroll
  for (int j = 0; j < kIn; ++j)
    v[j] = __ldg(depth + min(max(r0 - kPasses + j, 0), h - 1) * w + cc);
  float o[kMedRows];
  if constexpr (kPasses == 1) {
    median_rows<kIn>(v, o);
  } else {
    // the first pass at rows r0 - 1 .. r0 + kMedRows; a row or column
    // outside the image takes the nearest one's
    float p1[kMedRows + 2];
    median_rows<kIn>(v, p1);
    if (r0 == 0) p1[0] = p1[1];
#pragma unroll
    for (int j = 1; j < kMedRows + 2; ++j)
      if (r0 - 1 + j > h - 1) p1[j] = p1[j - 1];
    const int src = lane + cc - c;
#pragma unroll
    for (int j = 0; j < kMedRows + 2; ++j)
      p1[j] = __shfl_sync(kFullMask, p1[j], src);
    median_rows<kMedRows + 2>(p1, o);
  }
  if (lane < kPasses || lane >= 32 - kPasses || c >= w) return;
#pragma unroll
  for (int j = 0; j < kMedRows; ++j)
    if (r0 + j < h) out[(r0 + j) * w + c] = o[j];
}

// The bilateral filter's spatial factors g[i] g[j] for i, j in -2..2, by
// value (_lib.Spatial): the wrapper's f32 products of its f32 weights,
// the twin's g[i] * g[j] to the bit.
struct Spatial {
  float gg[5][5];
};

// A bilateral CTA's output tile, and the region of positions whose
// half-plane pairs it weighs (a thread each): rows ty - 2 .. ty + kBilH - 1
// and columns tx - 2 .. tx + kBilW + 1, every partner of an output pixel;
// the depths it reads: 2 more rows below and 2 more columns either side.
constexpr int kBilW = 28;
constexpr int kBilH = 22;
constexpr int kRegW = kBilW + 2 * kMaxHalo;  // 32: a warp a region row
constexpr int kRegH = kBilH + kMaxHalo;
constexpr int kBilThreads = kRegW * kRegH;
constexpr int kValW = kBilW + 4 * kMaxHalo;
constexpr int kValH = kBilH + 2 * kMaxHalo;
constexpr int kHalf = 12;  // the pairs a position weighs: one half-plane
static_assert(kBilH <= kRegH, "an output row a warp");

// the half-plane's offsets (i, j), i > 0 or i == 0 < j, in order o
__host__ __device__ constexpr int half_i(int o) {
  return o < 2 ? 0 : (o < 7 ? 1 : 2);
}
__host__ __device__ constexpr int half_j(int o) {
  return o < 2 ? o + 1 : (o < 7 ? o - 4 : o - 9);
}
__host__ __device__ constexpr int half_index(int i, int j) {
  return i == 0 ? j - 1 : (i == 1 ? j + 4 : j + 9);
}

// the weight of the pair of depths (a, b) at spatial factor gg, as the
// twin weighs b's tap on a: symmetric in (a, b) to the bit, since b - a
// is -(a - b) exactly and so their squares are equal. Equal depths weigh
// gg, as the twin's exp(-0) = 1 makes them, and their quotient is not
// taken: a zero dividend sends the IEEE division down its slow path
// (PERF.md), and 3-9 % of a noisy frame's taps pair equal
// millimetres.
__device__ __forceinline__ float pair_weight(float gg, float a, float b,
                                             float e_d_sq_2) {
  const float diff = b - a;
  const float mod = diff * diff;
  const float q = -(mod == 0.f ? 1.f : mod) / e_d_sq_2;
  return mod == 0.f ? gg : gg * expf(q);
}

// The tile (blockIdx.x * kBilW, blockIdx.y * kBilH): its depths, clamped
// into the image on load (so every position, inside or outside, holds
// the value its tap reads, and no tap clamps), into val; thread (ry, rx)
// weighs the 12 half-plane pairs of region position (ry, rx) into
// wt[o][ry][rx]; after the barrier warp oy's lane ox sums output pixel
// (oy, ox)'s 25 taps in JAX's order, its own half-plane's weights at
// wt[o][oy + 2][ox + 2] and the other half's, those of its partners, at
// wt[o][oy + 2 - i][ox + 2 - j].
__global__ void __launch_bounds__(kBilThreads)
bilateral_kernel(const float* __restrict__ depth, int h, int w, Spatial S,
                 float e_d_sq_2, float* __restrict__ out) {
  __shared__ float val[kValH][kValW];
  __shared__ float wt[kHalf][kRegH][kRegW];
  const int ty = blockIdx.y * kBilH, tx = blockIdx.x * kBilW;
  for (int k = threadIdx.x; k < kValH * kValW; k += kBilThreads) {
    const int gy = min(max(ty - kMaxHalo + k / kValW, 0), h - 1);
    const int gx = min(max(tx - 2 * kMaxHalo + k % kValW, 0), w - 1);
    val[k / kValW][k % kValW] = __ldg(depth + gy * w + gx);
  }
  __syncthreads();
  {
    const int ry = threadIdx.x / kRegW, rx = threadIdx.x % kRegW;
    const float a = val[ry][rx + kMaxHalo];
#pragma unroll
    for (int o = 0; o < kHalf; ++o) {
      const int i = half_i(o), j = half_j(o);
      wt[o][ry][rx] = pair_weight(S.gg[i + 2][j + 2], a,
                                  val[ry + i][rx + kMaxHalo + j], e_d_sq_2);
    }
  }
  __syncthreads();
  const int oy = threadIdx.x >> 5, ox = threadIdx.x & 31;
  const int r = ty + oy, c = tx + ox;
  if (oy >= kBilH || ox >= kBilW || r >= h || c >= w) return;
  const int py = oy + kMaxHalo, px = ox + kMaxHalo;  // p's region position
  const float d = val[py][px + kMaxHalo];
  float t = 0.f, s = 0.f;
#pragma unroll
  for (int i = -kMaxHalo; i <= kMaxHalo; ++i)
#pragma unroll
    for (int j = -kMaxHalo; j <= kMaxHalo; ++j) {
      const float cur = val[py + i][px + kMaxHalo + j];
      float factor;
      if (i == 0 && j == 0) {
        // the twin's exp(-(d - d)^2 ...) is 1 for a finite d, NaN else
        const float z = d - d;
        factor = z == 0.f ? S.gg[2][2] : z;
      } else if (i > 0 || (i == 0 && j > 0)) {
        factor = wt[half_index(i, j)][py][px];
      } else {
        factor = wt[half_index(-i, -j)][py + i][px + j];
      }
      factor = cur > 0.f ? factor : 0.f;
      t = t + factor * cur;
      s = s + factor;
    }
  const float q = t / (s == 0.f ? 1.f : s);
  out[r * w + c] = d == 0.f ? 0.f : q;
}

}  // namespace

// lv.h and lv.w hold every level's size (each ceil(half) the one before)
SE_EXPORT int se_pyramid(const float* depth, const float* k, float e_d,
                         int neg_y, Levels lv, void* stream) {
  const int n_lv = lv.n_levels;
  if (n_lv < 1 || n_lv > kMaxLevels) return (int)cudaErrorInvalidValue;
  const int tile = kRegion >> (n_lv - 1);
  const dim3 grid((lv.w[n_lv - 1] + tile - 1) / tile,
                  (lv.h[n_lv - 1] + tile - 1) / tile);
  if (grid.x == 0 || grid.y == 0) return 0;
  pyramid_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(depth, k, e_d,
                                                              neg_y, lv);
  return (int)cudaGetLastError();
}

// passes: 1 (median) or 2 (median2)
SE_EXPORT int se_median(const float* depth, int h, int w, int passes,
                        float* out, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (passes != 1 && passes != 2) return (int)cudaErrorInvalidValue;
  constexpr int kStrip = kMedRows * kMedWarps;
  const int cols = 32 - 2 * passes;  // a warp's output columns
  const dim3 grid((w + cols - 1) / cols, (h + kStrip - 1) / kStrip);
  cudaStream_t st = (cudaStream_t)stream;
  if (passes == 1)
    median_kernel<1><<<grid, kMedWarps * 32, 0, st>>>(depth, h, w, out);
  else
    median_kernel<2><<<grid, kMedWarps * 32, 0, st>>>(depth, h, w, out);
  return (int)cudaGetLastError();
}

SE_EXPORT int se_bilateral(const float* depth, int h, int w, Spatial g,
                           float e_d_sq_2, float* out, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 grid((w + kBilW - 1) / kBilW, (h + kBilH - 1) / kBilH);
  bilateral_kernel<<<grid, kBilThreads, 0, (cudaStream_t)stream>>>(
      depth, h, w, g, e_d_sq_2, out);
  return (int)cudaGetLastError();
}
