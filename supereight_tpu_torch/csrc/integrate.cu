// K3: integration's block pass of both fields, in three launches with no
// torch op between them.
//
// Replaces supereight_tpu/ops/integration.py:integrate's block pass
// (286-375): build_active_worklist (60-75) with in_frustum_mask (44-57),
// _project_voxels_c (78-94), _sample_depth_patch (123-213) and the
// fallback sub-worklist (340-356), which XLA runs as a cumsum compaction,
// [budget, 512] tensors with 16-row depth-strip gathers, a one-hot einsum
// and top_k.
//
//  * integrate_worklist: one cluster of 8 CTAs x 1024 threads
//    (compact.cuh). Each slot below n_blocks is flagged when it is active
//    and its block's origin corner projects into the frame; the flagged
//    slots are compacted in slot order into the first `budget` entries
//    (empty entries = capacity), and the kernel writes n_active (all
//    flagged slots) and blocks_truncated = max(n_active - budget, 0). A
//    device `when` that is false empties the worklist and zeroes
//    blocks_truncated. A cluster and not one CTA: each thread tests ~5
//    slots instead of ~36, and the cross-CTA scan is one cluster barrier.
//  * integrate_fused: a grid of the CTAs the card holds at once (SMs x
//    the CTAs of 512 threads an SM holds, queried once a device), never
//    more than the worklist's entries. CTA c takes the entries c, c + G,
//    c + 2G, ..., 512 a tile, one a thread: an empty entry costs its
//    thread one load and three stores, not a CTA, so a worklist far longer
//    than the blocks it lists (the class pipeline's bucket and the noise
//    row's budget, 49,152) costs about what its listed blocks do. The
//    tile's listed entries are compacted in shared memory (a warp ballot,
//    then the warps' counts, in entry order) and fused one 8^3 block at a
//    time, one thread per voxel; dealing entries one at a time spreads a
//    prefix worklist's blocks evenly over the CTAs (runs of a tile each
//    would hand a prefix's blocks to a few CTAs). One body for the field's
//    update, the TSDF noise_weighted one (a sample weighs
//    clip((1.5 / z)^2, 1/16, 1), fields.cuh, as in the fallback) and the
//    bilinear read (below). Each voxel is projected once (valid when
//    z >= 1e-4 and the pixel lies in [0.5, size - 1.5]); the block's pixel
//    bbox over its valid voxels is reduced with __reduce_min/max_sync in
//    each warp and then over the 16 warps' partials; the depth level
//    follows the JAX rule: level i when dx > 24 << (i-1) or dy > 15 << (i-1)
//    over the n_levels levels whose mip is big enough, covered when the
//    bbox fits the last one. A covered block reads
//    depth[(y >> l) << l, (x >> l) << l] and runs the field's update in
//    place (se::update_field, fields.cuh, shared with K4) and sets its
//    active flag to (any voxel valid). An uncovered block with valid
//    voxels is left as it is, with need = 1, for the fallback.
//  * integrate_fallback: min(32, budget) CTAs of 512 threads. Each CTA
//    ranks `need` in worklist order: a thread counts the flags of its run
//    of 16-byte words (one load and a popcount a word), and a CTA scan of
//    the counts gives each run's first rank. CTA r fuses the need block of
//    rank r at the exact pixel (level 0) and sets its active flag; CTA 0
//    sums the valid voxels of the need blocks beyond rank 31
//    (patch_skipped) and clears their active flags: they skip fusion this
//    frame, as JAX's top_k sub-worklist leaves them.
//  * the bilinear mode of integrate_fused (depth_interp): every valid
//    voxel reads JAX's _sample_depth_bilinear (229-270) at its float pixel:
//    no depth level, no need flag and no fallback launch; CTA 0 writes the
//    frame's patch_skipped, 0.
//
//  * halo_pack (the sharded step's halo, parallel/dist_step.py; replaces
//    supereight_tpu/parallel/dist_step.py:build_halo_worklist, 190-221,
//    and the gathers of its raycast branch, 336-350): each slot below
//    n_blocks is flagged when, with `frustum`, its block's CENTRE projects
//    inside the image padded by margin x size or lies within 0.5 m of the
//    camera (JAX's test, in its order), else always; the flagged slots are
//    compacted in slot order into the first `budget` rows of the rank's
//    send buffer: both 512-voxel channels and the block's cell id ((x b +
//    y) b + z; b^3 pads the rows past the flagged ones). It writes
//    halo_blocks = min(n, budget) and halo_overflow = max(n - budget, 0).
//    The copy is what costs: 4 KB read and 4 KB written a row, 6.1 MB at
//    749 rows, which one cluster's eight SMs moved at ~0.5 TB/s (13 of
//    17.5 us on an H100 80GB HBM3 at 700 W, PERF.md). So the launch is
//    as many clusters of kHaloCluster CTAs as the card holds at once
//    (queried once a device), and every cluster runs the same
//    compaction over the ~2k slots (12 bytes of
//    coordinates each, from L2): no cluster waits on another, and the
//    launch needs no scratch and no reset. Row r is copied by CTA r mod
//    the grid, whose shared memory alone gets its slot (from the emit of
//    its own cluster), so the copies of all rows are in flight on every
//    SM; that CTA also writes the row's cell id, and cluster 0 the
//    padding and the counts.
//    Bound: the flagged bricks read and written once (4 KB each) plus 12
//    bytes of coordinates a slot.
//
// Blocks are disjoint, so fusing the covered blocks in one launch and the
// fallback blocks in the next gives the values of one pass. The OFusion
// update's timestamp is a device f32[]; no launch reads a value on the host.
//
// Bound on the H100: the pool's read-modify-write, 8 bytes (two f32
// channels) per valid voxel of a listed block read and, where it changes,
// written: 3-5 us at HBM rate for the bench config's 2-5k listed blocks;
// the worklist reads 4 bytes and writes 9 per entry (0.6 MB at 49,152
// entries), the worklist kernel 13 bytes per active slot, and the 300 KB
// depth frame stays in L2. The fused kernel projects each voxel once, for
// the level and the update alike, reads each block's two 2 KB rows once,
// coalesced, and writes back only the voxels whose bits changed; the
// update's few dozen flops per voxel stay far below the card's rate. What
// is left is instruction issue and latency: per voxel two IEEE divisions
// and the transforms (-fmad=false), per block a CTA barrier for the bbox
// and the depth read that waits on it. So the kernel keeps 32 registers,
// four CTAs an SM: loading the next block's coordinates and payload under
// the current block's update took 49 registers (two CTAs an SM) and made
// it 9-17 % slower on an H100 (PERF.md). The fallback's need flags are
// 49 KB at 49,152 entries, read in 16-byte words by each of its CTAs.

#include "compact.cuh"
#include "fields.cuh"

namespace {

constexpr int kThreads = se::kBlockVoxels;
constexpr int kWarps = kThreads / 32;
static_assert((kWarps & (kWarps - 1)) == 0 && kWarps <= 32,
              "a warp reduces the warps' partials, one a lane");
constexpr int kBig = 1 << 20;  // an empty bbox's low corner

// The projection of this thread's voxel (the block's origin + the thread's
// in-brick offset); t_cw and K live in shared memory.
__device__ __forceinline__ se::Proj project_voxel(int bx, int by, int bz,
                                                  const float* T,
                                                  const float* K, float voxel,
                                                  int w, int h) {
  const int lin = threadIdx.x;
  const float wx = (float)(bx * 8 + (lin & 7)) * voxel;
  const float wy = (float)(by * 8 + ((lin >> 3) & 7)) * voxel;
  const float wz = (float)(bz * 8 + (lin >> 6)) * voxel;
  return se::project(T, K, wx, wy, wz, w, h);
}

// The frustum predicate of a block (ref algorithms::in_frustum,
// filter.hpp:37-49): its origin corner projects into [0, w) x [0, h) after
// truncation. (int)x >= 0 and (int)x < w are tested as x > -1 and x < w:
// the same for every finite x, and false for the huge or NaN ones that a
// cast would saturate or wrap.
__device__ __forceinline__ bool in_frustum(const int* __restrict__ bc,
                                           const float* T, const float* K,
                                           float scale, int w, int h) {
  const float3 c = se::transform(T, (float)bc[0] * scale,
                                 (float)bc[1] * scale, (float)bc[2] * scale);
  const float3 p = se::transform(K, c.x, c.y, c.z);
  const float z = p.z == 0.f ? 1e-12f : p.z;
  const float px = p.x / z, py = p.y / z;
  return z > 0.f && px > -1.f && px < (float)w && py > -1.f &&
         py < (float)h;
}

// The depth level of a block's pixel bbox (dx, dy) by the JAX rule, -1 when
// no usable level covers it.
__device__ __forceinline__ int depth_level(int dx, int dy, int n_levels) {
  if (n_levels <= 0 || dx > (24 << (n_levels - 1)) ||
      dy > (15 << (n_levels - 1)))
    return -1;
  int lvl = 0;
  for (int i = 1; i < n_levels; ++i)
    if (dx > (24 << (i - 1)) || dy > (15 << (i - 1))) lvl = i;
  return lvl;
}

__global__ void __cluster_dims__(se::kCompactCtas, 1, 1)
    __launch_bounds__(se::kCompactThreads)
    integrate_worklist_kernel(const int* __restrict__ block_coord,
                              const uint8_t* __restrict__ active,
                              const int* __restrict__ n_blocks, int cap,
                              const float* __restrict__ t_cw,
                              const float* __restrict__ kmat, float scale,
                              int w, int h, int budget,
                              const uint8_t* __restrict__ when,
                              int* __restrict__ worklist,
                              int* __restrict__ counts) {
  __shared__ float T[16], K[16];
  se::load_mat4(t_cw, T);
  se::load_mat4(kmat, K);
  __syncthreads();
  const bool go = when == nullptr || *when;
  const int n = min(*n_blocks, cap);
  auto run_mask = [&](int i0, int cnt) {
    uint32_t m = 0;
    for (int j = 0; j < cnt; ++j) {
      const int s = i0 + j;
      if (active[s] && in_frustum(block_coord + 3 * s, T, K, scale, w, h))
        m |= 1u << j;
    }
    return m;
  };
  auto emit = [&](int s, int r) {
    if (go && r < budget) worklist[r] = s;
  };
  se::cluster_compact(n, run_mask, emit, [&](int total) {
    const int filled = go ? min(total, budget) : 0;
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    for (int i = g; i < budget; i += gridDim.x * blockDim.x)
      if (i >= filled) worklist[i] = cap;
    if (g == 0) {
      counts[0] = total;
      counts[1] = go ? max(total - budget, 0) : 0;
    }
  });
}

// JAX's halo predicate (dist_step.py:200-215): the block centre through
// t_cw then K; in view when kz > 0 and u, v fall in [lo, hi) (the image
// padded by the margin, bounds rounded to f32 as JAX's Python floats), or
// near when its camera-frame distance squared is below 0.25.
__device__ __forceinline__ bool halo_flag(const int* __restrict__ bc,
                                          const float* T, const float* K,
                                          float scale, float u_lo, float u_hi,
                                          float v_lo, float v_hi) {
  const float3 p = se::transform(T, ((float)bc[0] + 0.5f) * scale,
                                 ((float)bc[1] + 0.5f) * scale,
                                 ((float)bc[2] + 0.5f) * scale);
  const float3 q = se::transform(K, p.x, p.y, p.z);
  const float z = q.z == 0.f ? 1e-12f : q.z;
  const float u = q.x / z, v = q.y / z;
  const bool in_view = q.z > 0.f && u >= u_lo && u < u_hi && v >= v_lo &&
                       v < v_hi;
  const bool near = p.x * p.x + p.y * p.y + p.z * p.z < 0.25f;
  return in_view || near;
}

// the shape of a halo_pack cluster: each cluster compacts every slot, so
// its size trades the compaction's reads a thread against its cluster
// barrier, and its CTAs' threads the rows a CTA copies against the CTAs an
// SM holds (8 x 256 beat 8 x 512, 8 x 1024, 4 x 512, 4 x 1024, 16 x 512
// and one-CTA clusters on the bench, H100 at 700 W, PERF.md)
constexpr int kHaloCluster = 8;
constexpr int kHaloThreads = 256;

// send: f32[rows, 512] with rows = 2 budget + ceil(budget / 512): the data_x
// bricks in rows [0, budget), the data_y bricks in rows [budget, 2 budget),
// then the i32 cell ids (halo_rows in kernels/halo.py). A grid of whole
// clusters; rows: the slots of the rows this CTA copies, ceil(budget /
// CTAs) entries of dynamic shared memory.
__global__ void __launch_bounds__(kHaloThreads)
    halo_pack_kernel(const int* __restrict__ block_coord,
                     const int* __restrict__ n_blocks, int cap,
                     const float* __restrict__ data_x,
                     const float* __restrict__ data_y,
                     const float* __restrict__ t_cw,
                     const float* __restrict__ kmat, float scale, float u_lo,
                     float u_hi, float v_lo, float v_hi, int frustum, int b,
                     int budget, float* __restrict__ send,
                     int* __restrict__ counts) {
  namespace cg = cooperative_groups;
  extern __shared__ int rows[];
  __shared__ float T[16], K[16];
  se::load_mat4(t_cw, T);
  se::load_mat4(kmat, K);
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int cid = (int)blockIdx.x / csize;  // this CTA's cluster
  const int n_ctas = (int)gridDim.x;
  int* cells = reinterpret_cast<int*>(send + 2 * budget * se::kBlockVoxels);
  const int n = min(*n_blocks, cap);
  auto flag = [&](int i0, int cnt) {
    uint32_t m = 0;
    for (int j = 0; j < cnt; ++j)
      if (!frustum || halo_flag(block_coord + 3 * (i0 + j), T, K, scale,
                                u_lo, u_hi, v_lo, v_hi))
        m |= 1u << j;
    return m;
  };
  // row r's slot into the shared memory of CTA r mod the grid, where that
  // CTA is in this cluster
  auto emit = [&](int s, int r) {
    const int cta = r % n_ctas;
    if (r < budget && cta / csize == cid)
      *cluster.map_shared_rank(rows + r / n_ctas, cta % csize) = s;
  };
  // the tail runs once this CTA's rows are in its shared memory
  se::cluster_compact<true>(n, flag, emit, [&](int total) {
    const int filled = min(total, budget);
    // this CTA's rows r = blockIdx.x + j n_ctas, a float4 a thread: each row
    // is 2 x 128 float4s
    constexpr int kQuads = se::kBlockVoxels / 4;  // float4s a channel row
    const int mine = (int)blockIdx.x < filled
                         ? (filled - (int)blockIdx.x + n_ctas - 1) / n_ctas
                         : 0;
    const float4* x4 = reinterpret_cast<const float4*>(data_x);
    const float4* y4 = reinterpret_cast<const float4*>(data_y);
    float4* send4 = reinterpret_cast<float4*>(send);
    // four float4s a thread in flight: all loads, then all stores
    const int n_quads = mine * 2 * kQuads;
    for (int i0 = threadIdx.x; i0 < n_quads; i0 += 4 * blockDim.x) {
      float4 v[4];
      int dst[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        dst[u] = -1;
        if (i < n_quads) {
          const int j = i / (2 * kQuads), q = i - j * 2 * kQuads;
          const int r = (int)blockIdx.x + j * n_ctas, s = rows[j];
          v[u] = q < kQuads ? x4[s * kQuads + q] : y4[s * kQuads + q - kQuads];
          dst[u] = q < kQuads ? r * kQuads + q : (budget + r) * kQuads + q -
                                                     kQuads;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (dst[u] >= 0) send4[dst[u]] = v[u];
    }
    for (int j = threadIdx.x; j < mine; j += blockDim.x) {  // their cell ids
      const int* c = block_coord + 3 * rows[j];
      cells[(int)blockIdx.x + j * n_ctas] = (c[0] * b + c[1]) * b + c[2];
    }
    if (cid == 0) {  // the padding cells and the counts
      const int t = (int)cluster.block_rank() * (int)blockDim.x + threadIdx.x;
      for (int r = filled + t; r < budget; r += csize * (int)blockDim.x)
        cells[r] = b * b * b;
      if (t == 0) {
        counts[0] = filled;
        counts[1] = total - filled;
      }
    }
  });
}

// JAX's _sample_depth_bilinear (ops/integration.py:229-270): inverse depth
// interpolated over the 2x2 pixels at (px - 0.5, py - 0.5), x0 clamped to
// [0, w - 2] and y0 to [0, h - 2]; 0 if any of them is 0; the nearest read
// where the result lies 5 cm or more from any of them.
__device__ __forceinline__ float sample_bilinear(const float* __restrict__ depth,
                                                 int w, int h,
                                                 const se::Proj& p) {
  const float x0f = floorf(p.px - 0.5f), y0f = floorf(p.py - 0.5f);
  const float fx = (p.px - 0.5f) - x0f, fy = (p.py - 0.5f) - y0f;
  const int x0 = se::clampi((int)x0f, 0, w - 2);
  const int y0 = se::clampi((int)y0f, 0, h - 2);
  const float* r0 = depth + y0 * w + x0;
  const float d00 = r0[0], d10 = r0[1], d01 = r0[w], d11 = r0[w + 1];
  if (d00 == 0.f || d10 == 0.f || d01 == 0.f || d11 == 0.f) return 0.f;
  const float inv = (1.f / d00) * (1.f - fx) * (1.f - fy) +
                    (1.f / d10) * fx * (1.f - fy) +
                    (1.f / d01) * (1.f - fx) * fy + (1.f / d11) * fx * fy;
  const float d = 1.f / inv;
  const bool consistent = fabsf(d - d00) < 0.05f && fabsf(d - d10) < 0.05f &&
                          fabsf(d - d01) < 0.05f && fabsf(d - d11) < 0.05f;
  return consistent ? d : depth[p.yi * w + p.xi];
}

// The need flags of entries [16 w, 16 w + 16) as bits 0-15, from one
// 16-byte load where the word lies wholly below n_work (``need`` 16-byte
// aligned); entries at or past n_work read as 0.
__device__ __forceinline__ uint32_t need_bits(const uint8_t* __restrict__ need,
                                              int n_work, int w) {
  const int i0 = w * 16;
  if (i0 + 16 <= n_work) {
    const uint4 q = reinterpret_cast<const uint4*>(need)[w];
    uint32_t m = 0;
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t v = __vcmpne4(words[k], 0u);  // 0xff a nonzero byte
      m |= ((v & 1u) | (v >> 7 & 2u) | (v >> 14 & 4u) | (v >> 21 & 8u))
           << (4 * k);
    }
    return m;
  }
  uint32_t m = 0;
  for (int j = 0; i0 + j < n_work && j < 16; ++j)
    if (need[i0 + j]) m |= 1u << j;
  return m;
}

// kNoise: the TSDF noise_weighted update (fields.cuh); kBilinear: every
// valid voxel reads the bilinear sample, with no depth level and no
// fallback (JAX sets patch_skipped to 0 and leaves valid alone,
// integration.py:335-337): mode 0, need 0, and CTA 0 writes the frame's
// patch_skipped, 0, into `skipped`.
//
// A grid of resident CTAs (se_integrate_fused sizes it from the card). CTA
// c takes the entries c, c + G, c + 2G, ... (G = gridDim.x), 512 of them a
// tile, one a thread: an empty entry's thread writes its three outputs and
// is done; the tile's listed entries are compacted in shared memory in
// entry order (a warp ballot, then the warps' counts) and fused one block
// at a time by the whole CTA. Entries are dealt one at a time, not in runs,
// so that the listed blocks of any worklist, a prefix or not, spread evenly
// over the CTAs.
template <bool kOFusion, bool kNoise, bool kBilinear>
__global__ void __launch_bounds__(kThreads)
integrate_fused_kernel(const int* __restrict__ worklist, int n_work, int cap,
                       const int* __restrict__ block_coord,
                       const float* __restrict__ t_cw,
                       const float* __restrict__ kmat, float voxel, int w,
                       int h, int n_levels, const float* __restrict__ depth,
                       se::FieldArgs A, float* __restrict__ data_x,
                       float* __restrict__ data_y,
                       uint8_t* __restrict__ active, int* __restrict__ mode,
                       int* __restrict__ n_valid,
                       uint8_t* __restrict__ need, int* __restrict__ skipped) {
  __shared__ float T[16], K[16];
  // per warp: x0, x1, y0, y1, valid count; two buffers, by block parity,
  // so that one barrier a block suffices
  __shared__ int part[2][5][kWarps];
  __shared__ int list_e[kThreads], list_s[kThreads];  // the tile's listed
  __shared__ int warp_n[kWarps];
  if (kBilinear && blockIdx.x == 0 && threadIdx.x == 0) *skipped = 0;
  se::load_mat4(t_cw, T);
  se::load_mat4(kmat, K);
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  const int mine = (n_work - (int)blockIdx.x + G - 1) / G;  // this CTA's
  for (int j0 = 0; j0 < mine; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const int e = (int)blockIdx.x + j * G;
    int slot = cap;
    if (j < mine) {
      slot = worklist[e];
      if (slot >= cap) {  // empty entry
        mode[e] = 0;
        n_valid[e] = 0;
        need[e] = 0;
      }
    }
    const bool listed = slot < cap;
    const unsigned b = __ballot_sync(full, listed);
    if (lane == 0) warp_n[warp] = __popc(b);
    __syncthreads();  // warp_n (and, on the first tile, T and K) written
    int before = 0, n_list = 0;
    for (int i = 0; i < kWarps; ++i) {  // every thread, same order
      before += i < warp ? warp_n[i] : 0;
      n_list += warp_n[i];
    }
    if (listed) {
      const int r = before + __popc(b & ((1u << lane) - 1u));
      list_e[r] = e;
      list_s[r] = slot;
    }
    __syncthreads();  // the tile's list written
    for (int i = 0; i < n_list; ++i) {
      const int ei = list_e[i], si = list_s[i];
      const int* bc = block_coord + 3 * si;
      const se::Proj p = project_voxel(bc[0], bc[1], bc[2], T, K, voxel, w, h);
      // the payload is loaded before the bbox reduction, so that its
      // latency passes under it; stored back only where a bit changed
      const size_t v = (size_t)si * se::kBlockVoxels + threadIdx.x;
      float x = 0.f, y = 0.f;
      if (p.valid) {
        x = data_x[v];
        y = data_y[v];
      }
      int l = 0, count;
      if (kBilinear) {
        count = __syncthreads_count(p.valid);
      } else {
        const int x0 = __reduce_min_sync(full, p.valid ? p.xi : kBig);
        const int x1 = __reduce_max_sync(full, p.valid ? p.xi : -1);
        const int y0 = __reduce_min_sync(full, p.valid ? p.yi : kBig);
        const int y1 = __reduce_max_sync(full, p.valid ? p.yi : -1);
        const int c = __popc(__ballot_sync(full, p.valid));
        int(*pt)[kWarps] = part[i & 1];
        if (lane == 0) {
          pt[0][warp] = x0;
          pt[1][warp] = x1;
          pt[2][warp] = y0;
          pt[3][warp] = y1;
          pt[4][warp] = c;
        }
        __syncthreads();
        // every warp reduces the 16 partials itself, lane q reading warp
        // q's (lanes 16-31 again, but for the count): five loads and five
        // reductions a thread, exact in any order
        const int q = lane & (kWarps - 1);
        const int bx0 = __reduce_min_sync(full, pt[0][q]);
        const int bx1 = __reduce_max_sync(full, pt[1][q]);
        const int by0 = __reduce_min_sync(full, pt[2][q]);
        const int by1 = __reduce_max_sync(full, pt[3][q]);
        count = __reduce_add_sync(full, lane < kWarps ? pt[4][q] : 0);
        l = depth_level(bx1 - bx0, by1 - by0, n_levels);
      }
      if (l >= 0 && p.valid) {
        const float ds =
            kBilinear ? sample_bilinear(depth, w, h, p)
                      : depth[((p.yi >> l) << l) * w + ((p.xi >> l) << l)];
        const int bx = __float_as_int(x), by = __float_as_int(y);
        se::update_field<kOFusion, kNoise>(A, p, ds, &x, &y);
        if (__float_as_int(x) != bx || __float_as_int(y) != by) {
          data_x[v] = x;
          data_y[v] = y;
        }
      }
      if (threadIdx.x == 0) {
        const bool needs = l < 0 && count > 0;
        mode[ei] = l;
        n_valid[ei] = count;
        need[ei] = needs ? 1 : 0;
        // a block stays active iff any voxel projected into the frame (ref
        // update_block, projective_functor.hpp:104-110); a need block's
        // flag is the fallback's to write
        if (!needs) active[si] = (l >= 0 && count > 0) ? 1 : 0;
      }
    }
    __syncthreads();  // the list and warp_n are read before the next tile
  }
}

// gridDim.x = min(32, n_work) CTAs. Each ranks the need flags in worklist
// order: thread t counts the flags of its run of 16-byte words (one load
// and a popcount a word), one CTA scan gives each run's first rank, and
// the thread whose run holds rank blockIdx.x finds that entry among its
// words. CTA r fuses the need block of rank r; CTA 0 also sums the valid
// voxels of the need blocks of rank 32 and on (patch_skipped) and clears
// their active flags.
template <bool kOFusion, bool kNoise>
__global__ void __launch_bounds__(kThreads)
integrate_fallback_kernel(const int* __restrict__ worklist, int n_work,
                          const int* __restrict__ block_coord,
                          const float* __restrict__ t_cw,
                          const float* __restrict__ kmat, float voxel, int w,
                          int h, const float* __restrict__ depth,
                          se::FieldArgs A, float* __restrict__ data_x,
                          float* __restrict__ data_y,
                          uint8_t* __restrict__ active,
                          int* __restrict__ mode,
                          const int* __restrict__ n_valid,
                          const uint8_t* __restrict__ need,
                          int* __restrict__ patch_skipped) {
  __shared__ float T[16], K[16];
  __shared__ int entry;
  const int n_fb = gridDim.x;  // min(32, budget) fallback blocks
  const int n_words = (n_work + 15) / 16;
  const int per = (n_words + kThreads - 1) / kThreads;
  const int w0 = min((int)threadIdx.x * per, n_words);
  const int w1 = min(w0 + per, n_words);
  int cnt = 0;
  for (int q = w0; q < w1; ++q) cnt += __popc(need_bits(need, n_work, q));
  if (threadIdx.x == 0) entry = -1;
  int total;
  const int before = se::block_exclusive_scan(cnt, &total);
  // the need entry of rank blockIdx.x, if there is one
  const int r = blockIdx.x;
  if (r >= before && r < before + cnt) {
    int k = before;
    for (int q = w0; q < w1; ++q) {
      uint32_t m = need_bits(need, n_work, q);
      const int c = __popc(m);
      if (r < k + c) {
        for (; k < r; ++k) m &= m - 1u;  // drop the lower set bits
        entry = q * 16 + __ffs(m) - 1;
        break;
      }
      k += c;
    }
  }
  if (blockIdx.x == 0) {  // the need blocks beyond the bound skip fusion
    int skipped = 0, k = before;
    if (before + cnt > n_fb) {
      for (int q = w0; q < w1; ++q) {
        for (uint32_t m = need_bits(need, n_work, q); m; m &= m - 1u, ++k) {
          if (k < n_fb) continue;
          const int i = q * 16 + __ffs(m) - 1;
          skipped += n_valid[i];
          active[worklist[i]] = 0;
        }
      }
    }
    int sum;
    se::block_exclusive_scan(skipped, &sum);
    if (threadIdx.x == 0) *patch_skipped = sum;
  }
  se::load_mat4(t_cw, T);
  se::load_mat4(kmat, K);
  __syncthreads();
  const int e = entry;
  if (e < 0) return;  // uniform exit: fewer need blocks than this rank
  const int slot = worklist[e];
  const int* bc = block_coord + 3 * slot;
  const se::Proj p = project_voxel(bc[0], bc[1], bc[2], T, K, voxel, w, h);
  if (p.valid) {
    const size_t v = (size_t)slot * se::kBlockVoxels + threadIdx.x;
    se::update_field<kOFusion, kNoise>(A, p, depth[p.yi * w + p.xi],
                                       data_x + v, data_y + v);
  }
  const int any = __syncthreads_or(p.valid);
  if (threadIdx.x == 0) {
    active[slot] = any ? 1 : 0;
    mode[e] = 0;
  }
}

// The CTAs of kThreads threads of `kernel` that the current device holds at
// once: its SMs times the CTAs one SM holds, queried once a device and kept
// in `cache` (one array a kernel instance).
template <class Kernel>
cudaError_t resident_ctas(Kernel kernel, int* cache, int* out) {
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= se::kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, 0)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    cache[dev] = per_sm * sms;
  }
  *out = cache[dev];
  return cudaSuccess;
}

}  // namespace

// when (bool[]) may be null: always true. counts: n_active, truncated.
SE_EXPORT int se_integrate_worklist(const int* block_coord,
                                    const uint8_t* active,
                                    const int* n_blocks, int cap,
                                    const float* t_cw, const float* kmat,
                                    float scale, int w, int h, int budget,
                                    const uint8_t* when, int* worklist,
                                    int* counts, void* stream) {
  integrate_worklist_kernel<<<se::kCompactCtas, se::kCompactThreads, 0,
                              (cudaStream_t)stream>>>(
      block_coord, active, n_blocks, cap, t_cw, kmat, scale, w, h, budget,
      when, worklist, counts);
  return (int)cudaGetLastError();
}

// The sharded step's halo send buffer (see halo_pack_kernel); frustum 0
// takes every allocated slot. counts: i32[2] halo_blocks, halo_overflow.
// The grid: the clusters of kHaloCluster CTAs the card holds at once,
// queried once a device. Returns a cudaError_t, or -1 when no such cluster
// fits the card; a budget of over 12,288 rows a CTA (48 KB of shared
// memory) is refused.
SE_EXPORT int se_halo_pack(const int* block_coord, const int* n_blocks,
                           int cap, const float* data_x, const float* data_y,
                           const float* t_cw, const float* kmat, float scale,
                           float u_lo, float u_hi, float v_lo, float v_hi,
                           int frustum, int b, int budget, float* send,
                           int* counts, void* stream) {
  static se::ClusterFit held[se::kMaxDevices];
  int n_clusters = 0;
  const int err = se::clusters_held(halo_pack_kernel, held, kHaloCluster,
                                    kHaloThreads, &n_clusters);
  if (err != 0) return err;
  const int n_ctas = kHaloCluster * n_clusters;
  const size_t smem = (size_t)((budget + n_ctas - 1) / n_ctas) * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  return se::launch_clusters(halo_pack_kernel, held, kHaloCluster,
                             kHaloThreads, n_clusters, smem, stream,
                             block_coord, n_blocks,
                             cap, data_x, data_y, t_cw, kmat, scale, u_lo,
                             u_hi, v_lo, v_hi, frustum, b, budget, send,
                             counts);
}

// field: 0 = TSDF, 1 = OFusion; timestamp (OFusion) is a device f32[];
// noise (TSDF only): the noise_weighted update; bilinear: the bilinear
// depth read, with `skipped` (i32[]) set to 0, else skipped may be null.
// The grid is min(n_work, the CTAs the card holds at once), its size
// queried once a device and kernel instance.
SE_EXPORT int se_integrate_fused(const int* worklist, int n_work, int cap,
                                 const int* block_coord, const float* t_cw,
                                 const float* kmat, float voxel, int w,
                                 int h, int n_levels, const float* depth,
                                 int field, int noise, int bilinear,
                                 float mu, float max_weight,
                                 float two_voxel, const float* timestamp,
                                 float* data_x, float* data_y,
                                 uint8_t* active, int* mode, int* n_valid,
                                 uint8_t* need, int* skipped, void* stream) {
  if (n_work == 0) return 0;
  if (bilinear && skipped == nullptr) return (int)cudaErrorInvalidValue;
  const se::FieldArgs A{mu, max_weight, two_voxel, timestamp};
  cudaStream_t st = (cudaStream_t)stream;
#define SE_FUSED(OF, NOISE, BILINEAR)                                        \
  do {                                                                       \
    static int ctas[se::kMaxDevices];                                        \
    int g = 0;                                                               \
    const cudaError_t err = resident_ctas(                                   \
        integrate_fused_kernel<OF, NOISE, BILINEAR>, ctas, &g);              \
    if (err != cudaSuccess) return (int)err;                                 \
    integrate_fused_kernel<OF, NOISE, BILINEAR>                              \
        <<<min(g, n_work), kThreads, 0, st>>>(                               \
            worklist, n_work, cap, block_coord, t_cw, kmat, voxel, w, h,     \
            n_levels, depth, A, data_x, data_y, active, mode, n_valid, need, \
            skipped);                                                        \
  } while (0)
  if (field == 1 && bilinear)
    SE_FUSED(true, false, true);
  else if (field == 1)
    SE_FUSED(true, false, false);
  else if (noise && bilinear)
    SE_FUSED(false, true, true);
  else if (noise)
    SE_FUSED(false, true, false);
  else if (bilinear)
    SE_FUSED(false, false, true);
  else
    SE_FUSED(false, false, false);
#undef SE_FUSED
  return (int)cudaGetLastError();
}

// n_fb = min(32, n_work) CTAs, one per fallback block; noise as
// se_integrate_fused's; need 16-byte aligned (read a 16-byte word a load)
SE_EXPORT int se_integrate_fallback(const int* worklist, int n_work,
                                    const int* block_coord, const float* t_cw,
                                    const float* kmat, float voxel, int w,
                                    int h, const float* depth, int field,
                                    int noise, float mu, float max_weight,
                                    float two_voxel, const float* timestamp,
                                    int n_fb, float* data_x, float* data_y,
                                    uint8_t* active, int* mode,
                                    const int* n_valid, const uint8_t* need,
                                    int* patch_skipped, void* stream) {
  if (n_fb == 0) return 0;
  if ((uintptr_t)need % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const se::FieldArgs A{mu, max_weight, two_voxel, timestamp};
  cudaStream_t st = (cudaStream_t)stream;
#define SE_FALLBACK(OF, NOISE)                                              \
  integrate_fallback_kernel<OF, NOISE><<<n_fb, kThreads, 0, st>>>(          \
      worklist, n_work, block_coord, t_cw, kmat, voxel, w, h, depth, A,     \
      data_x, data_y, active, mode, n_valid, need, patch_skipped)
  if (field == 1)
    SE_FALLBACK(true, false);
  else if (noise)
    SE_FALLBACK(false, true);
  else
    SE_FALLBACK(false, false);
#undef SE_FALLBACK
  return (int)cudaGetLastError();
}
