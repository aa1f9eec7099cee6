// K5: allocation, both fields: the TSDF band march and the OFusion
// multi-scale march (the touched-octant grids), and the bump allocator with
// the mip refresh.
//
// The marches, alloc_touch (TSDF) and alloc_touch_of (OFusion):
//
// Replace supereight_tpu/ops/allocation.py:tsdf_touched_mask (75-115) and
// ofusion_touched_masks (148-214) with the static ofusion_step_ladder
// (118-145), _pixel_rays_c_sub (32-58) and _touched_cell_ids (61-72), which
// XLA runs as unrolled sample stacks plus deduplicated scatters.
//
// A ray per sub-sampled pixel (pixel_ray): back-project the pixel centre
// (+0.5) to a world vertex with kpose = pose @ invK, take the unit
// direction toward the camera and back off from the vertex by half the
// band; then store byte 1 into the grid cell under each in-map sample
// (mark). Repeated stores of the same byte need no dedup and no atomics.
// The grids are the map's touched buffer (MapState.touched, levels 0-2
// back to back), all zero between frames: alloc_assign, which reads them
// next, clears them as it reads, so no launch fills them.
//
// Both marches take a column window [x0, x0 + w_win) of the depth frame:
// the sharded step (parallel/dist_step.py) marches each rank's own columns
// with image coordinates kept (JAX allocation.py:44-48, x_offset); the
// single-device step's window is the whole frame.
//
// alloc_touch: one thread per pixel of depth[::2, ::2], num_steps samples
// at t = (float)(s * step) across the +/- band, into the level-0 grid.
//
// alloc_touch_of: the samples are the static ladder (steps of 1 voxel while
// t < band, 10 voxels while t < 1.5 band, then 30 voxels up to max_dist;
// the level of sample i is that of step i - 1), which the wrapper builds
// once per (geometry, mu, max_dist) with the twin's own ofusion_step_ladder
// and keeps on the card as f32 distances and u8 levels, of any length: the
// kernel and its twin sample the same distances by construction. A sample
// counts while f32(t) < dist, the distance from the camera to the ray's
// origin; t only grows along the ladder, so every sample after the first
// dead one is dead and the ray stops there. Threads [0, n2) take the rays of depth[::2, ::2]
// and walk their n_fine level-0 samples. After them (from a warp boundary)
// each ray of depth[::8, ::8] gets kCoarseLanes threads, and lane j takes
// its coarse samples n_fine + j, n_fine + j + kCoarseLanes, ...: a coarse
// ray's level-1 and 2 samples are independent stores instead of one
// thread's serial walk, and each lane leaves at its first dead sample.
// The threads read the ladder through the read-only cache: a warp's lanes
// read the same entry (level 0) or 8 distinct ones (coarse). In a side
// build on the bench's OFusion frame, 8 lanes a coarse ray ran faster than
// 4 or 32, and copying the ladder into shared memory first was slower than
// reading it from the kernel's parameters; parameters hold a few hundred
// samples at most, which a fine map at a wide band exceeds.
//
// Bound on the H100: the sampled depth read once and the 32-byte sectors
// that hold a set cell written once (the grids are already zero, so no
// other byte must move), and 19.2k rays x 8 band samples (TSDF), or 19.2k
// level-0 rays x 7 samples and 1.2k coarse rays x the samples short of
// their surface (OFusion), at the bench config. The scattered byte stores
// stay in L2 (grids of 262 KB, + 33 KB + 4 KB for OFusion, at 512^3). The
// work is small: the launch itself is the cost at this size.

#include "compact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoarseLanes = 8;  // threads of a coarse OFusion ray

struct Ray {
  float ox, oy, oz;  // origin: the vertex backed off by half the band
  float dx, dy, dz;  // unit direction toward the camera
};

// The ray of the sub-sampled pixel (sx, sy) of a [::stride, ::stride]
// sampling of the columns from x0 on of a depth frame w wide, or false
// where its depth is not positive; K = kpose, P = pose (the JAX package's
// arithmetic, in its order: the column's centre is sx * stride + 0.5 +
// x_offset, and x0 = 0 adds an exact zero).
__device__ __forceinline__ bool pixel_ray(const float* __restrict__ depth,
                                          int w, int x0, int stride, int sx,
                                          int sy, const float* K,
                                          const float* P, float band_half,
                                          Ray& r) {
  const float d = depth[(sy * stride) * w + x0 + sx * stride];
  if (!(d > 0.f)) return false;
  const float px = (float)(sx * stride) + 0.5f + (float)x0;
  const float py = (float)(sy * stride) + 0.5f;
  const float3 wv = se::transform(K, px * d, py * d, d);
  const float dx = P[3] - wv.x, dy = P[7] - wv.y, dz = P[11] - wv.z;
  const float norm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float inv = 1.f / (norm == 0.f ? 1.f : norm);
  r.dx = dx * inv;
  r.dy = dy * inv;
  r.dz = dz * inv;
  r.ox = wv.x - band_half * r.dx;
  r.oy = wv.y - band_half * r.dy;
  r.oz = wv.z - band_half * r.dz;
  return true;
}

// Byte 1 into the cell of a level's grid (side cells a side, octants of
// 1 << shift voxels) under the ray's sample at t, if its voxel is in the map.
__device__ __forceinline__ void mark(const Ray& r, float t, float inv_voxel,
                                     int size, int side, int shift,
                                     uint8_t* __restrict__ grid) {
  const int vx = (int)floorf((r.ox + r.dx * t) * inv_voxel);
  const int vy = (int)floorf((r.oy + r.dy * t) * inv_voxel);
  const int vz = (int)floorf((r.oz + r.dz * t) * inv_voxel);
  if (vx < 0 || vx >= size || vy < 0 || vy >= size || vz < 0 || vz >= size)
    return;
  grid[((vx >> shift) * side + (vy >> shift)) * side + (vz >> shift)] = 1;
}

__global__ void __launch_bounds__(kThreads)
alloc_touch_kernel(const float* __restrict__ depth, int w, int x0,
                   int stride, int hs, int ws, const float* __restrict__ kpose,
                   const float* __restrict__ pose, float band_half,
                   double step, int num_steps, float inv_voxel, int size,
                   int b, uint8_t* __restrict__ touched) {
  __shared__ float K[16], P[16];
  se::load_mat4(kpose, K);
  se::load_mat4(pose, P);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hs * ws) return;
  const int sy = i / ws, sx = i - sy * ws;
  Ray r;
  if (!pixel_ray(depth, w, x0, stride, sx, sy, K, P, band_half, r)) return;
  for (int s = 0; s < num_steps; ++s)
    mark(r, (float)(s * step), inv_voxel, size, b, 3, touched);
}

__global__ void __launch_bounds__(kThreads)
alloc_touch_of_kernel(const float* __restrict__ depth, int w, int x0,
                      int hs2, int ws2, int hs8, int ws8,
                      const float* __restrict__ kpose,
                      const float* __restrict__ pose, float band_half,
                      const float* __restrict__ ladder_t,
                      const uint8_t* __restrict__ ladder_level, int n_ladder,
                      int n_fine, float inv_voxel, int size, int b,
                      uint8_t* __restrict__ touched0,
                      uint8_t* __restrict__ touched1,
                      uint8_t* __restrict__ touched2) {
  __shared__ float K[16], P[16];
  se::load_mat4(kpose, K);
  se::load_mat4(pose, P);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n2 = hs2 * ws2;
  const int n2w = (n2 + 31) & ~31;  // the level-0 rays' threads, whole warps
  const bool coarse = i >= n2w;
  const int ray = coarse ? (i - n2w) / kCoarseLanes : i;
  if (ray >= (coarse ? hs8 * ws8 : n2)) return;
  const int ws = coarse ? ws8 : ws2;
  const int sy = ray / ws, sx = ray - sy * ws;
  Ray r;
  if (!pixel_ray(depth, w, x0, coarse ? 8 : 2, sx, sy, K, P, band_half, r))
    return;
  const float cx = P[3] - r.ox, cy = P[7] - r.oy, cz = P[11] - r.oz;
  const float dist = sqrtf(cx * cx + cy * cy + cz * cz);
  // a sample marks while t < dist; the break's !(t < dist) also ends a ray
  // whose dist is NaN, which marks nothing
  if (!coarse) {
    for (int s = 0; s < n_fine; ++s) {
      const float t = __ldg(ladder_t + s);
      if (!(t < dist)) break;
      mark(r, t, inv_voxel, size, b, 3, touched0);
    }
    return;
  }
  for (int s = n_fine + (i - n2w) % kCoarseLanes; s < n_ladder;
       s += kCoarseLanes) {
    const float t = __ldg(ladder_t + s);
    if (!(t < dist)) break;
    const int lvl = __ldg(ladder_level + s);
    if ((b >> lvl) > 0)
      mark(r, t, inv_voxel, size, b >> lvl, 3 + lvl,
           lvl == 1 ? touched1 : touched2);
  }
}

// K5: the bump allocator and the mip refresh (alloc_assign), both fields.
//
// Replaces supereight_tpu/core/map.py:allocate_blocks (273-342) and
// refresh_mip_alloc (345-391), which XLA runs as a top_k over B^3 cells,
// three scatters, a per-slot gather and the OR-reduce pyramid with its
// broadcasts.
//
// One cluster of 8 CTAs x 1024 threads (compact.cuh), one launch:
//  1. a touched cell that has a slot re-activates it (ref
//     alloc_impl.hpp:109), from the slot entry the scan reads anyway;
//  2. the new cells (touched, no slot yet) are compacted in ascending cell
//     id; the one of rank r takes slot n_blocks + r while r < min(kb,
//     capacity - n_blocks): its slot grid entry, block_coord and active
//     flag are written, and 1 is stored into the 8 children at level a - 1
//     of each of its ancestors at levels a >= 1 (the mip values that now
//     exist); the others are dropped and counted (alloc_overflow);
//  3. OFusion: each octant its march touched at level 1 or 2 marks the
//     children of itself and its ancestors the same way;
//  4. the root node always exists: level nl - 2 is all set, and level nl - 1
//     never is; then n_blocks and alloc_overflow are written.
// A device `when` that is false leaves every map grid untouched but the
// root's children, as JAX's masked allocation and unconditional refresh do.
// With an owner grid (the sharded step's, parallel/dist_step.py) a touched
// cell that another rank owns is skipped in step 1 and 2, as JAX's
// `touched & (own == idx)` (dist_step.py:313); it is still cleared.
//
// The touched grids are consumed: they are all zero on return, whatever
// `when` says, so the map's touched buffer needs no fill before the next
// frame's march. The scan clears each run it reads (the zero uint4s stored
// back where its two loads found a byte set), and the extra grids' pass
// zeroes each byte it finds set. Both read and clear before they test
// `when`, so a masked frame leaves no mark for the next one. A level at or
// past nl has no cell (b >> l == 0), so every cell the march wrote is read.
//
// The mip refresh is incremental. JAX's dense refresh ORs
// broadcast(R(slot >= 0 | extra)) into mip_alloc, R being the OR-reduce
// pyramid; this kernel ORs in broadcast(R(new blocks | extra)). The two
// agree because mip_alloc >= broadcast(R(slot >= 0)) holds before every
// call: slots are never freed, mip_alloc only grows, and every call marks
// its own new blocks' ancestors (kernels/alloc.py states it; the CPU tests
// and chip_smoke.py hold it frame by frame against the dense rule). Stores
// of the byte 1 from several threads race harmlessly.
//
// The re-activation is JAX's per-slot gather (active[s] |= touched[cell of
// block_coord[s]] for s < n_blocks) turned around: slot[cell] = s exactly
// when block_coord[s] = cell, for every s < n_blocks, because a slot is
// written with its cell's coordinates in the same step and never freed. So
// the touched cells with a slot flag the same slots, and the loop over all
// slots and its coordinate reads go.
//
// Bound on the H100: the touched grid (B^3 bytes) read once and the sectors
// of its set cells cleared, the slot grid read only under touched cells,
// <= kb new entries written and the mip bytes set: ~0.3 MB at 512^3, ~0.1
// us at HBM rate. A thread reads its 32
// cells' touched bytes as two 16-byte loads and the slot grid only where a
// byte is set; eight SMs share the reads, and the scan's cross-CTA step is
// one cluster barrier, so allocation is one launch after the march. What
// is left is latency: two cluster barriers and the dependent slot loads.

struct Mips {  // per-level pointers, as csrc/nav.cu and node.cu pass them
  uint8_t* alloc[10];
  float* x[10];
  float* y[10];
};

// 1 into the 8 children (level a - 1) of the level-a octant (ax, ay, az)
__device__ __forceinline__ void mark_children(const Mips& M, int b, int a,
                                              int ax, int ay, int az) {
  const int s = b >> (a - 1);
  uint8_t* out = M.alloc[a - 1];
  for (int k = 0; k < 8; ++k) {
    const int x = 2 * ax + (k >> 2), y = 2 * ay + ((k >> 1) & 1),
              z = 2 * az + (k & 1);
    out[(x * s + y) * s + z] = 1;
  }
}

// the children of every ancestor at levels max(l, 1) .. nl - 1 of the
// level-l octant (x, y, z), itself included when l >= 1
__device__ __forceinline__ void mark_ancestors(const Mips& M, int b, int nl,
                                               int l, int x, int y, int z) {
  for (int a = max(l, 1); a < nl; ++a)
    mark_children(M, b, a, x >> (a - l), y >> (a - l), z >> (a - l));
}

// each octant set in the level-l grid `extra` cleared, and, where `go`,
// its ancestors' children marked
__device__ __forceinline__ void mark_extra(const Mips& M, int b, int nl,
                                           int l, uint8_t* __restrict__ extra,
                                           bool go, int g, int n_threads) {
  if (extra == nullptr) return;
  const int s = b >> l;
  for (int i = g; i < s * s * s; i += n_threads) {
    if (!extra[i]) continue;
    extra[i] = 0;
    if (go) mark_ancestors(M, b, nl, l, i / (s * s), (i / s) % s, i % s);
  }
}

__global__ void __cluster_dims__(se::kCompactCtas, 1, 1)
    __launch_bounds__(se::kCompactThreads)
    alloc_assign_kernel(uint8_t* __restrict__ touched,
                        uint8_t* __restrict__ extra1,
                        uint8_t* __restrict__ extra2,
                        const uint8_t* __restrict__ when,
                        const int* __restrict__ owner, int rank, int b,
                        int nl, int cap, int kb, int* __restrict__ slot,
                        int* __restrict__ block_coord,
                        uint8_t* __restrict__ active,
                        int* __restrict__ n_blocks,
                        int* __restrict__ overflow, Mips M) {
  const bool go = when == nullptr || *when;
  const int n_old = *n_blocks;  // read by all before rank 0 writes it
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_threads = gridDim.x * blockDim.x;
  const int room = max(0, min(kb, cap - n_old));  // slots this call may take
  auto run_mask = [&](int i0, int cnt) {
    uint32_t m = 0;
    if (cnt == 32) {  // i0 is a multiple of 32: two aligned 16-byte loads
      uint4* t4 = reinterpret_cast<uint4*>(touched + i0);
      const uint4 a = t4[0], c = t4[1];
      const uint32_t words[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
      for (int k = 0; k < 8; ++k)
        for (int j = 0; j < 4; ++j)
          if ((words[k] >> (8 * j)) & 0xffu) m |= 1u << (4 * k + j);
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      if (a.x | a.y | a.z | a.w) t4[0] = zero;
      if (c.x | c.y | c.z | c.w) t4[1] = zero;
    } else {
      for (int j = 0; j < cnt; ++j)
        if (touched[i0 + j]) {
          m |= 1u << j;
          touched[i0 + j] = 0;
        }
    }
    if (!go) return 0u;  // a masked step only clears
    for (uint32_t r = m; r; r &= r - 1) {  // keep the cells with no slot
      const int j = __ffs(r) - 1;
      if (owner != nullptr && owner[i0 + j] != rank) {  // another rank's
        m &= ~(1u << j);
        continue;
      }
      const int s = slot[i0 + j];
      if (s >= 0) {  // a touched block that exists: re-activated
        active[s] = 1;
        m &= ~(1u << j);
      }
    }
    return m;
  };
  auto emit = [&](int cell, int r) {
    if (r >= room) return;  // beyond the budget or the pool: dropped
    const int dest = n_old + r;
    const int x = cell / (b * b), y = (cell / b) % b, z = cell % b;
    slot[cell] = dest;
    block_coord[3 * dest] = x;
    block_coord[3 * dest + 1] = y;
    block_coord[3 * dest + 2] = z;
    active[dest] = 1;
    mark_ancestors(M, b, nl, 0, x, y, z);
  };
  const int total = se::cluster_compact(b * b * b, run_mask, emit);
  mark_extra(M, b, nl, 1, extra1, go, g, n_threads);
  mark_extra(M, b, nl, 2, extra2, go, g, n_threads);
  if (nl >= 2 && g < 8) M.alloc[nl - 2][g] = 1;  // the root's children
  if (g == 0) {
    const int n_new = min(total, room);
    *n_blocks = n_old + n_new;
    *overflow = total - n_new;
  }
}

}  // namespace

// when (bool[]) may be null: always true; extra1 / extra2 (OFusion's level
// 1 and 2 grids) may be null. owner (i32[B^3], the sharded step's owner
// grid) may be null: every cell is this map's; else only the touched
// cells that owner gives to `rank` are allocated or re-activated (the
// extra grids are not masked, as JAX's sharded step unions them). kb =
// min(B^3, budget). touched, extra1 and extra2 are all zero on return.
SE_EXPORT int se_alloc_assign(uint8_t* touched, uint8_t* extra1,
                              uint8_t* extra2, const uint8_t* when,
                              const int* owner, int rank,
                              int b, int nl, int cap, int kb, int* slot,
                              int* block_coord, uint8_t* active,
                              int* n_blocks, int* overflow, Mips mips,
                              void* stream) {
  alloc_assign_kernel<<<se::kCompactCtas, se::kCompactThreads, 0,
                        (cudaStream_t)stream>>>(
      touched, extra1, extra2, when, owner, rank, b, nl, cap, kb, slot,
      block_coord,
      active, n_blocks, overflow, mips);
  return (int)cudaGetLastError();
}

// The marches sample the columns [x0, x0 + w_win) of a depth frame w
// wide (a rank's slice, JAX's x_offset; the whole frame is x0 = 0, w_win
// = w).
SE_EXPORT int se_alloc_touch_of(const float* depth, int h, int w, int x0,
                                int w_win, const float* kpose, const float* pose,
                                float band_half, const float* ladder_t,
                                const uint8_t* ladder_level, int n_ladder,
                                int n_fine, float inv_voxel, int size, int b,
                                uint8_t* touched0, uint8_t* touched1,
                                uint8_t* touched2, void* stream) {
  const int hs2 = (h + 1) / 2, ws2 = (w_win + 1) / 2;
  const int hs8 = (h + 7) / 8, ws8 = (w_win + 7) / 8;
  const int n = ((hs2 * ws2 + 31) & ~31) + kCoarseLanes * hs8 * ws8;
  const int n_cta = (n + kThreads - 1) / kThreads;
  if (n_cta == 0) return 0;
  alloc_touch_of_kernel<<<n_cta, kThreads, 0, (cudaStream_t)stream>>>(
      depth, w, x0, hs2, ws2, hs8, ws8, kpose, pose, band_half, ladder_t,
      ladder_level, n_ladder, n_fine, inv_voxel, size, b, touched0, touched1,
      touched2);
  return (int)cudaGetLastError();
}

SE_EXPORT int se_alloc_touch(const float* depth, int h, int w, int x0,
                             int w_win, int stride, const float* kpose, const float* pose,
                             float band_half, double step, int num_steps,
                             float inv_voxel, int size, int b,
                             uint8_t* touched, void* stream) {
  const int hs = (h + stride - 1) / stride;
  const int ws = (w_win + stride - 1) / stride;
  const int n_cta = (hs * ws + kThreads - 1) / kThreads;
  if (n_cta == 0) return 0;
  alloc_touch_kernel<<<n_cta, kThreads, 0, (cudaStream_t)stream>>>(
      depth, w, x0, stride, hs, ws, kpose, pose, band_half, step, num_steps,
      inv_voxel, size, b, touched);
  return (int)cudaGetLastError();
}
