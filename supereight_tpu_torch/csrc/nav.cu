// K2: the raycast's navigation grid, one i32 per block cell, both fields.
//
// Replaces supereight_tpu/ops/raycast.py:build_nav (138-174) with
// block_distance (103-112) and coarse_cell_grid (115-135), which XLA runs
// as five 3^3 reduce_window min-dilations over the B^3 grid plus a
// repeat-broadcast of every mip level.
//
// nav[c] = slot[c] where the block is allocated and slot < bucket, else
// -(1 + e) with
//   bits 0-2  the Chebyshev block distance to the nearest allocated block,
//             capped at MAX_JUMP = 6 (the safe empty-space jump);
//   + 8 + (q << 4), OFusion only, where the cell is known free: the finest
//             level l whose octant (c >> l) has a value (mip_alloc[l] and
//             mip_y[l] > 0) holds a log-odds v <= SURF_BOUNDARY (0), and
//             q = rint(clip(-v, 0, 1000) * 16), round half to even like
//             jnp.round.
//
// One launch over bit columns. The slot grid is x-major with z minor, so
// the B slots of an (x, y) column are contiguous; a column's occupancy is
// a row of 32-bit words along z (bit z of word z / 32). Each CTA owns an
// 8x8 tile of columns and one word of each (32 z values), and
// holds in shared memory the tile plus a halo of MAX_JUMP - 1 = 5 columns
// on each side and one word above and below:
//   1. D_0, the occupancy: the held slots read once, coalesced, with no
//      branch around a load (a column outside the grid reads a clamped
//      address and counts as empty): for B >= 32 each thread reads 4 slots
//      as an int4 and 8 lanes OR their nibbles into a word with three
//      shuffles; below 32 slots a column is one partial word, a warp's
//      ballot;
//   2. D_k = D_{k-1} dilated by the 3^3 cube, k = 1..5: one warp per held
//      row of x and one lane per column keeps the column's words in
//      registers, dilates them along z (w | w << 1 | w >> 1 with the
//      carries across words), ORs them with the neighbouring lanes' (y),
//      then with the neighbouring rows' through shared memory (x): one
//      barrier a step. A step loses one column (one bit) of exactness at
//      the edge of what is held, so the tile's own words are exact after
//      five; their words of D_0..D_5 are kept. Meanwhile the other warps
//      tabulate, for OFusion, each coarser mip level's code over the tile
//      (-1 where the level has no value, else the payload below), then
//      give each level-1 octant without a value the finest coarser code;
//   3. one thread per cell, stores coalesced along z: the distance is the
//      number of k with the cell outside D_k (the D_k are the Chebyshev
//      balls of radius k around the allocated cells, which the twin's five
//      min-dilations also compute, so the grid equals it bit for bit); an
//      allocated cell below the bucket stores its slot (read again, from
//      L1); else -(1 + e) with e the distance plus the OFusion payload of
//      the finest level with a value: level 0 read per cell, the coarser
//      ones one look-up in level 1's table.
// When given counts, the first thread of the first CTA also writes the
// frame's block count and the blocks past the bucket, max(n_blocks -
// bucket, 0) (parallel/step.py's n_blocks and pool_bucket_overflow), so
// the frame needs no copy or clamp for them.
//
// Bound on the H100: bytes, the slot grid read once and the nav grid
// written once (8 B a cell; 2 MB at 64^3), plus each mip level once for
// OFusion. The halo makes a CTA read its 18x18 columns, 5x its 8x8, from
// L2.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJump = 6;
constexpr int kHalo = kMaxJump - 1;       // columns a dilation step reaches
constexpr int kTile = 8;                  // a CTA's own columns a side
constexpr int kSpan = kTile + 2 * kHalo;  // held columns a side (<= 32)
constexpr int kChunk = 1;                 // a CTA's own words a column
constexpr int kWords = kChunk + 2;        // held words: one halo word a side
constexpr int kCells = kTile * kTile * 32 * kChunk;  // own cells, at most
constexpr int kUnroll = 2;                // loads in flight a thread
constexpr int kMaxLevels = 10;
constexpr unsigned kAll = 0xffffffffu;

// per-level pointers of the mip pyramid (level l is (b >> l)^3, x-major
// then y, z minor like the slot grid)
struct Mips {
  const uint8_t* alloc[kMaxLevels];
  const float* x[kMaxLevels];
  const float* y[kMaxLevels];
};

// Octants of mip level l >= 1 over a CTA's cells: the side in x and y
// (of the tile, or of the grid where it is smaller), and the depth in z
// over zn own cells a column.
__host__ __device__ constexpr int table_side(int l, int b) {
  return ((kTile < b ? kTile : b) >> l) > 1 ? (kTile < b ? kTile : b) >> l
                                            : 1;
}
__host__ __device__ constexpr int table_depth(int l, int zn) {
  return (zn >> l) > 1 ? zn >> l : 1;
}
// the largest tables: every level 1..kMaxLevels-1 at b >= kTile and
// 32 * kChunk own cells a column
__host__ __device__ constexpr int table_size() {
  int n = 0;
  for (int l = 1; l < kMaxLevels; ++l)
    n += table_side(l, kTile) * table_side(l, kTile) *
         table_depth(l, 32 * kChunk);
  return n;
}

// The OFusion code of mip level l's octant i: -1 where it has no value
// (mip_alloc and mip_y > 0), else 8 + (q << 4) where the value is known
// free, else 0 (Octree::get's coarse fallback).
__device__ __forceinline__ int level_code(const Mips& mips, int l, int i) {
  const bool have = __ldg(mips.alloc[l] + i) && __ldg(mips.y[l] + i) > 0.f;
  const float v = __ldg(mips.x[l] + i);
  if (!have) return -1;
  if (!(v <= 0.f)) return 0;  // known free is v <= SURF_BOUNDARY (0)
  const int q = (int)rintf(fminf(fmaxf(-v, 0.f), 1000.f) * 16.f);
  return 8 + (q << 4);
}

// grid (ceil(b / kTile), ceil(b / kTile), ceil(words / kChunk))
__global__ void __launch_bounds__(kThreads)
nav_grid_kernel(const int* __restrict__ slot, int b, int bucket, int ofusion,
                int n_levels, Mips mips, int* __restrict__ nav,
                const int* __restrict__ n_blocks, int* __restrict__ counts) {
  // held words, [column][word]: column (sx, sy) at sx * kSpan + sy; D_0 in
  // held[0], then each dilation step's y-ORed words alternately
  __shared__ uint32_t held[2][kSpan * kSpan * kWords];
  // the own tile's words of D_0 .. D_5, [k][column][word]
  __shared__ uint32_t dil[kMaxJump][kTile * kTile * kChunk];
  // OFusion: the codes of levels 1.. over the own cells, level l's
  // [x][y][z] from t_off[l]
  __shared__ int table[table_size()];
  __shared__ int t_off[kMaxLevels + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (counts != nullptr && tid == 0 &&
      (blockIdx.x | blockIdx.y | blockIdx.z) == 0) {
    const int n = *n_blocks;
    counts[0] = n;
    counts[1] = max(n - bucket, 0);
  }
  const int n_words = (b + 31) / 32;
  const int w0 = blockIdx.z * kChunk;             // first own word
  const int wn = min(kChunk, n_words - w0);       // own words
  const int lo = max(w0 - 1, 0);                  // first held word
  const int nh = min(w0 + wn + 1, n_words) - lo;  // held words
  const int tx = blockIdx.x * kTile, ty = blockIdx.y * kTile;
  const int x0 = tx - kHalo, y0 = ty - kHalo;
  const int zb = 32 * w0, zn = min(32 * wn, b - zb);  // own z (a power of 2)
  if (tid == 0) {
    int off = 0;
    for (int l = 1; l < n_levels; ++l) {
      t_off[l] = off;
      off += table_side(l, b) * table_side(l, b) * table_depth(l, zn);
    }
    t_off[n_levels] = off;
  }

  // 1. D_0 into held[0], every load issued before its value is used
  if (b >= 32) {
    // a column's held words are nh * 8 int4 from word lo; the 8 lanes of
    // a word are 8 consecutive items
    const int per_col = nh * 8, n_items = kSpan * kSpan * per_col;
    // item / per_col as one multiply by ceil(2^32 / per_col), exact while
    // item * per_col < 2^32
    const unsigned inv =
        (unsigned)((0x100000000ull + per_col - 1) / per_col);
    for (int base = tid; base < n_items; base += kUnroll * kThreads) {
      int4 v[kUnroll];
      bool in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int item = min(base + u * kThreads, n_items - 1);
        const int col = __umulhi(item, inv), q = item - col * per_col;
        const int x = x0 + col / kSpan, y = y0 + col % kSpan;
        in[u] = x >= 0 && x < b && y >= 0 && y < b;
        const int xc = min(max(x, 0), b - 1), yc = min(max(y, 0), b - 1);
        v[u] = __ldg(reinterpret_cast<const int4*>(
                         slot + (xc * b + yc) * b + 32 * lo) + q);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int item = base + u * kThreads;
        uint32_t m = 0;
        if (in[u])
          m = (uint32_t)((v[u].x >= 0) | (v[u].y >= 0) << 1 |
                         (v[u].z >= 0) << 2 | (v[u].w >= 0) << 3)
              << (4 * (item & 7));
        m |= __shfl_xor_sync(kAll, m, 1);
        m |= __shfl_xor_sync(kAll, m, 2);
        m |= __shfl_xor_sync(kAll, m, 4);
        if ((item & 7) == 0 && item < n_items) {
          const int col = __umulhi(item, inv);
          held[0][col * kWords + ((item - col * per_col) >> 3)] = m;
        }
      }
    }
  } else {
    // one partial word a column (lo = 0, nh = 1): lane z reads slot z
    constexpr int n_cols = kSpan * kSpan;
    for (int base = warp; base < n_cols; base += kUnroll * kWarps) {
      int s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int col = min(base + u * kWarps, n_cols - 1);
        const int x = x0 + col / kSpan, y = y0 + col % kSpan;
        const int xc = min(max(x, 0), b - 1), yc = min(max(y, 0), b - 1);
        s[u] = __ldg(slot + (xc * b + yc) * b + min(lane, b - 1));
        if (!(x >= 0 && x < b && y >= 0 && y < b && lane < b)) s[u] = -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t m = __ballot_sync(kAll, s[u] >= 0);
        const int col = base + u * kWarps;
        if (lane == 0 && col < n_cols) held[0][col * kWords] = m;
      }
    }
  }
  __syncthreads();

  // 2. five dilations by the row warps; meanwhile the tables by the others
  const bool row_warp = warp < kSpan;
  const bool col_thread = row_warp && lane < kSpan;
  const int col = warp * kSpan + lane;
  const bool own = col_thread && warp >= kHalo && warp < kHalo + kTile &&
                   lane >= kHalo && lane < kHalo + kTile;
  const int tcol = ((warp - kHalo) * kTile + lane - kHalo) * kChunk;
  const int first = w0 - lo;  // the first own word among the held
  if (!row_warp && ofusion) {
    for (int i = tid - kSpan * 32; i < t_off[n_levels];
         i += kThreads - kSpan * 32) {
      int l = 1;
      while (i >= t_off[l + 1]) ++l;
      const int side = table_side(l, b), depth = table_depth(l, zn);
      const int r = i - t_off[l], s = b >> l;
      const int ox = (tx >> l) + r / (side * depth);
      const int oy = (ty >> l) + (r / depth) % side;
      const int oz = (zb >> l) + r % depth;
      table[i] = level_code(mips, l, (ox * s + oy) * s + oz);
    }
    // then level 1's entries without a value take the finest coarser one
    if (n_levels > 2) {
      asm volatile("bar.sync 1, %0;" ::"r"(kThreads - kSpan * 32) : "memory");
      const int side = table_side(1, b), depth = table_depth(1, zn);
      for (int i = tid - kSpan * 32; i < t_off[2];
           i += kThreads - kSpan * 32) {
        if (table[i] >= 0) continue;
        const int ax = (tx >> 1) + i / (side * depth);
        const int ay = (ty >> 1) + (i / depth) % side;
        const int az = (zb >> 1) + i % depth;
        int code = -1;
        for (int l = 2; code < 0 && l < n_levels; ++l)
          code = table[t_off[l] +
                       (((ax >> (l - 1)) - (tx >> l)) * table_side(l, b) +
                        (ay >> (l - 1)) - (ty >> l)) *
                           table_depth(l, zn) +
                       (az >> (l - 1)) - (zb >> l)];
        table[i] = code;
      }
    }
  }
  uint32_t w[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    w[j] = (col_thread && j < nh) ? held[0][col * kWords + j] : 0u;
  if (own)
    for (int j = 0; j < wn; ++j) dil[0][tcol + j] = held[0][col * kWords +
                                                            first + j];
  for (int k = 1; k < kMaxJump; ++k) {
    uint32_t* out = held[k & 1];
    if (row_warp) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        uint32_t z = w[j] | (w[j] << 1) | (w[j] >> 1);
        if (j > 0) z |= w[j - 1] >> 31;
        if (j + 1 < kWords) z |= w[j + 1] << 31;
        // lanes past the span hold 0; lane 0's up is itself
        z |= __shfl_up_sync(kAll, z, 1) | __shfl_down_sync(kAll, z, 1);
        if (col_thread) out[col * kWords + j] = z;
      }
    }
    __syncthreads();
    if (col_thread) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        uint32_t r = out[col * kWords + j];
        if (warp > 0) r |= out[(col - kSpan) * kWords + j];
        if (warp + 1 < kSpan) r |= out[(col + kSpan) * kWords + j];
        w[j] = r;
      }
      if (own)
        for (int j = 0; j < wn; ++j)
          dil[k][tcol + j] = out[col * kWords + first + j] |
                             (out[(col - kSpan) * kWords + first + j] |
                              out[(col + kSpan) * kWords + first + j]);
    }
  }
  __syncthreads();

  // 3. one thread per own cell, z fastest
  const int lz = __ffs(zn) - 1;
  const int side1 = table_side(1, b), depth1 = table_depth(1, zn);
#pragma unroll
  for (int u = 0; u < kCells / kThreads; ++u) {
    const int i = tid + u * kThreads;
    const int tc = i >> lz, zl = i & (zn - 1);
    const int x = tx + tc / kTile, y = ty + tc % kTile, z = zb + zl;
    if (tc >= kTile * kTile || x >= b || y >= b) continue;
    const int c = (x * b + y) * b + z;
    const int wd = tc * kChunk + (zl >> 5);
    const uint32_t bit = 1u << (zl & 31);
    int e = 0;  // D_0 .. D_5 are nested: the count is the distance
#pragma unroll
    for (int k = 0; k < kMaxJump; ++k) e += (dil[k][wd] & bit) ? 0 : 1;
    if (e == 0) {
      const int s = __ldg(slot + c);
      if (s < bucket) {
        nav[c] = s;
        continue;
      }
    }
    if (ofusion) {
      int code = level_code(mips, 0, c);
      if (code < 0 && n_levels > 1)
        code = table[(((x >> 1) - (tx >> 1)) * side1 + (y >> 1) - (ty >> 1)) *
                         depth1 +
                     (z >> 1) - (zb >> 1)];
      e += max(code, 0);
    }
    nav[c] = -(1 + e);
  }
}

}  // namespace

// n_blocks and counts (i32[2]) may be null
SE_EXPORT int se_nav_grid(const int* slot, int b, int bucket, int ofusion,
                          int n_levels, Mips mips, int* nav,
                          const int* n_blocks, int* counts, void* stream) {
  if (b <= 0) return 0;
  if (n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  const int tiles = (b + kTile - 1) / kTile;
  const int chunks = ((b + 31) / 32 + kChunk - 1) / kChunk;
  nav_grid_kernel<<<dim3(tiles, tiles, chunks), kThreads, 0,
                    (cudaStream_t)stream>>>(slot, b, bucket, ofusion,
                                            n_levels, mips, nav, n_blocks,
                                            counts);
  return (int)cudaGetLastError();
}
