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
// (mark). Stores of the same byte from several rays need no atomics.
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
// A thread's chain before its first store is one round trip: it issues
// its depth read before the barrier behind which the CTA's first 15
// threads copy kpose's rows 0-2 and pose's translation into shared
// memory, so the two reads are in flight together. Reading the matrices
// straight into registers instead (15 broadcast loads a thread, no
// barrier) was 0.1 us slower (PERF.md, H100 80GB HBM3 at 700 W).
// Most of a launch above the floor is its stores (the samples' 1 us
// against 0.3 for the rest at the bench's TSDF frame), whose cost barely
// grows with their number (the whole frame's 4x the window's cost 0.2 us
// more). A launch that would give fewer than half the SMs a CTA of 256
// threads takes smaller CTAs (march_threads): the sharded step's window
// of 80 columns (19 CTAs of 256) spreads over 75 CTAs of 64, 0.1-0.2 us
// faster, while the whole frame keeps 256, faster than 64 or 128 there.
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

constexpr int kThreads = 256;    // a march CTA's threads, at most
constexpr int kMinThreads = 64;  // and at least
constexpr int kCoarseLanes = 8;  // threads of a coarse OFusion ray

// *threads: the threads of a march's CTAs for n threads in all, the most
// (from kThreads, halving down to kMinThreads) that still give half the
// current device's SMs a CTA (the SM count queried once a device).
// Returns a cudaError_t.
int march_threads(int n, int* threads) {
  int sms = 0;
  if (const int err = se::sm_count(&sms)) return err;
  int t = kThreads;
  while (t > kMinThreads && (n + t - 1) / t < sms / 2) t /= 2;
  *threads = t;
  return 0;
}

struct Ray {
  float ox, oy, oz;  // origin: the vertex backed off by half the band
  float dx, dy, dz;  // unit direction toward the camera
};

// What a march reads of the frame's matrices: rows 0-2 of kpose = pose @
// invK, and pose's translation (the camera centre).
struct Mats {
  float K[12];
  float cx, cy, cz;
};

// The matrices, copied into shared memory by the CTA's first 15
// threads: every thread of the CTA calls it (a barrier).
__device__ __forceinline__ Mats load_mats(const float* __restrict__ kpose,
                                          const float* __restrict__ pose) {
  __shared__ float sh[15];
  const int t = threadIdx.x;
  if (t < 15) sh[t] = __ldg(t < 12 ? kpose + t : pose + 3 + 4 * (t - 12));
  __syncthreads();
  Mats m;
#pragma unroll
  for (int i = 0; i < 12; ++i) m.K[i] = sh[i];
  m.cx = sh[12];
  m.cy = sh[13];
  m.cz = sh[14];
  return m;
}

// The depth of the sub-sampled pixel (sx, sy) of a [::stride, ::stride]
// sampling of the columns from x0 on of a depth frame w wide.
__device__ __forceinline__ float pixel_depth(const float* __restrict__ depth,
                                             int w, int x0, int stride,
                                             int sx, int sy) {
  return __ldg(depth + (sy * stride) * w + x0 + sx * stride);
}

// The ray of that pixel, of depth d, or false where d is not positive (the
// JAX package's arithmetic, in its order: the column's centre is
// sx * stride + 0.5 + x_offset, and x0 = 0 adds an exact zero).
__device__ __forceinline__ bool pixel_ray(float d, int x0, int stride,
                                          int sx, int sy, const Mats& M,
                                          float band_half, Ray& r) {
  if (!(d > 0.f)) return false;
  const float px = (float)(sx * stride) + 0.5f + (float)x0;
  const float py = (float)(sy * stride) + 0.5f;
  const float3 wv = se::transform(M.K, px * d, py * d, d);
  const float dx = M.cx - wv.x, dy = M.cy - wv.y, dz = M.cz - wv.z;
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
// 1 << shift voxels) under the ray's sample at t, if its voxel is in the
// map.
__device__ __forceinline__ void mark(const Ray& r, float t, float inv_voxel,
                                     int size, int side, int shift,
                                     uint8_t* __restrict__ grid) {
  const int vx = (int)floorf((r.ox + r.dx * t) * inv_voxel);
  const int vy = (int)floorf((r.oy + r.dy * t) * inv_voxel);
  const int vz = (int)floorf((r.oz + r.dz * t) * inv_voxel);
  if (vx < 0 || vx >= size || vy < 0 || vy >= size || vz < 0 || vz >= size)
    return;
  const int cell = ((vx >> shift) * side + (vy >> shift)) * side +
                   (vz >> shift);
  grid[cell] = 1;
}

__global__ void __launch_bounds__(kThreads)
alloc_touch_kernel(const float* __restrict__ depth, int w, int x0,
                   int stride, int hs, int ws, const float* __restrict__ kpose,
                   const float* __restrict__ pose, float band_half,
                   double step, int num_steps, float inv_voxel, int size,
                   int b, uint8_t* __restrict__ touched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int sy = i / ws, sx = i - sy * ws;
  const float d = i < hs * ws ? pixel_depth(depth, w, x0, stride, sx, sy)
                              : 0.f;
  const Mats M = load_mats(kpose, pose);
  if (i >= hs * ws) return;
  Ray r;
  if (!pixel_ray(d, x0, stride, sx, sy, M, band_half, r)) return;
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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n2 = hs2 * ws2;
  const int n2w = (n2 + 31) & ~31;  // the level-0 rays' threads, whole warps
  const bool coarse = i >= n2w;
  const int ray = coarse ? (i - n2w) / kCoarseLanes : i;
  const bool live = ray < (coarse ? hs8 * ws8 : n2);
  const int ws = coarse ? ws8 : ws2, stride = coarse ? 8 : 2;
  const int sy = ray / ws, sx = ray - sy * ws;
  const float d = live ? pixel_depth(depth, w, x0, stride, sx, sy) : 0.f;
  const Mats M = load_mats(kpose, pose);
  if (!live) return;
  Ray r;
  if (!pixel_ray(d, x0, stride, sx, sy, M, band_half, r)) return;
  const float cx = M.cx - r.ox, cy = M.cy - r.oy, cz = M.cz - r.oz;
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
// One launch: a cluster of kAllocCtas CTAs x kAllocThreads threads
// (compact.cuh) runs steps 1, 2 and 4, and for OFusion one or two more
// clusters (a 4-byte word of the coarse grids a thread, 9,216 words at
// 512^3) run step 3 beside it:
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
// In the sharded step (parallel/dist_step.py, world > 0) a touched cell
// that another rank owns is skipped in step 1 and 2, as JAX's
// `touched & (own == idx)` (dist_step.py:313); it is still cleared. The
// owner is arithmetic, not read: JAX's owner_grid deals 64 consecutive
// morton cells to a rank, and those are the 4^3 super-brick (x >> 2,
// y >> 2, z >> 2), so a cell's owner is the super-brick's morton code mod
// the world size (tile_owner), computed once for each 4 cells of a run.
//
// The touched grids are consumed: they are all zero on return, whatever
// `when` says, so the map's touched buffer needs no fill before the next
// frame's march. The scan clears each run it reads (the zero uint4s stored
// back where its two loads found a byte set), and the coarse grids' pass
// reads them 4 bytes a load and stores a zero word back where a byte was
// set (16-byte words put up to 16 set octants, and their marks, on one
// thread). Both read and clear before they test `when`, so a masked frame
// leaves no mark for the next one. A level at or past nl has no cell
// (b >> l == 0), so every cell the march wrote is read.
//
// The mip refresh is incremental. JAX's dense refresh ORs
// broadcast(R(slot >= 0 | extra)) into mip_alloc, R being the OR-reduce
// pyramid; this kernel ORs in broadcast(R(new blocks | extra)). The two
// agree because mip_alloc >= broadcast(R(slot >= 0)) holds before every
// call: slots are never freed, mip_alloc only grows, and every call marks
// its own new blocks' ancestors (kernels/alloc.py states it; the CPU tests
// and chip_smoke.py hold it frame by frame against the dense rule). Stores
// of the byte 1 from several threads race harmlessly. A thread walks its
// cells in ascending order and stops climbing at the first ancestor that
// its previous cell of the same level shares (mark_up): the neighbours of
// a run share most of theirs.
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
// us at HBM rate. What costs is latency and the scattered mip stores on
// few SMs, so each thread's reads go out in as few dependent rounds as
// the data allows: its 32 cells' touched bytes as two 16-byte loads, then
// the slot entries under its set cells as one round of 16-byte loads (the
// words that hold a set cell, all in flight at once; a set cell after set
// cell cost a read after a read, PERF.md); the scan's cross-CTA step is
// one cluster barrier; a mark is four 16-bit stores, and a thread's run
// of neighbours shares its ancestors' marks (mark_up). The coarse grids'
// marks, 3 us of the launch when the compacting cluster made them after
// its scan (H100 80GB HBM3 at 700 W, PERF.md), run on their own SMs
// meanwhile.

// the compacting cluster's shape (each coarse cluster's too): 16 SMs
// share the scan's reads and the marks' stores, 32 cells a thread (16 x
// 512 beat 8 x 1024, 16 x 1024 and 8 x 512 on the bench, H100 at 700 W,
// PERF.md)
constexpr int kAllocCtas = 16;
constexpr int kAllocThreads = 512;
constexpr int kMaxCoarseClusters = 8;

struct Mips {  // per-level pointers, as csrc/nav.cu and node.cu pass them
  uint8_t* alloc[10];
  float* x[10];
  float* y[10];
};

// 1 into the 8 children (level a - 1) of the level-a octant (ax, ay, az):
// two z-adjacent bytes in each of 4 (x, y) rows, one 16-bit store each
// (the level's side is even, so the pair is 2-byte aligned in a 2-byte
// aligned grid)
__device__ __forceinline__ void mark_children(const Mips& M, int b, int a,
                                              int ax, int ay, int az) {
  const int s = b >> (a - 1);
  uint8_t* out = M.alloc[a - 1];
  for (int k = 0; k < 4; ++k) {
    const int x = 2 * ax + (k >> 1), y = 2 * ay + (k & 1);
    *reinterpret_cast<uint16_t*>(out + (x * s + y) * s + 2 * az) = 0x0101u;
  }
}

// The children of every ancestor at levels max(l, 1) .. nl - 1 of the
// level-l octant (x, y, z), itself included when l >= 1, up to the first
// ancestor that `prev` shares (the octant of level l this thread marked
// last, or -1s): prev's ancestors from there up are marked already. Then
// prev is (x, y, z).
__device__ __forceinline__ void mark_up(const Mips& M, int b, int nl, int l,
                                        int x, int y, int z, int3& prev) {
  for (int a = max(l, 1); a < nl; ++a) {
    const int d = a - l;
    const int ax = x >> d, ay = y >> d, az = z >> d;
    if (ax == prev.x >> d && ay == prev.y >> d && az == prev.z >> d) break;
    mark_children(M, b, a, ax, ay, az);
  }
  prev = make_int3(x, y, z);
}

// bits 0-9 of v to every third bit (core/morton.py expand_bits)
__device__ __forceinline__ uint32_t spread3(uint32_t v) {
  v &= 0x3ffu;
  v = (v | (v << 16)) & 0x030000ffu;
  v = (v | (v << 8)) & 0x0300f00fu;
  v = (v | (v << 4)) & 0x030c30c3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// The rank of `world` that owns the block cell (x, y, z): the morton code
// of its 4^3 super-brick mod world (parallel/dist_step.owner_grid at
// TILE = 64: a cell's code // 64 is that super-brick's code). xy is
// spread3(x >> 2) | spread3(y >> 2) << 1, shared by a z-row's cells.
__device__ __forceinline__ int tile_owner(uint32_t xy, int z, int world) {
  const uint32_t code = xy | (spread3(z >> 2) << 2);
  return (int)((world & (world - 1)) ? code % (uint32_t)world
                                     : code & (uint32_t)(world - 1));
}
__device__ __forceinline__ uint32_t row_code(int x, int y) {
  return spread3(x >> 2) | (spread3(y >> 2) << 1);
}

// bit k of the result: byte k of w is not 0
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t nz = __vcmpne4(w, 0u);
  return ((nz >> 7) & 1u) | ((nz >> 14) & 2u) | ((nz >> 21) & 4u) |
         ((nz >> 28) & 8u);
}

// OFusion's coarse grids (levels 1 and 2; null where absent), read 4
// bytes a load: per level its whole 4-byte words (none for a grid off a
// 4-byte boundary) and its bytes; word w < words() is word w of level 1's,
// then of level 2's.
struct Coarse {
  uint8_t* g[2];
  int vec[2], bytes[2];

  __device__ Coarse(uint8_t* e1, uint8_t* e2, int b) {
    g[0] = e1;
    g[1] = e2;
    for (int i = 0; i < 2; ++i) {
      const int s = b >> (i + 1);
      bytes[i] = g[i] == nullptr ? 0 : s * s * s;
      vec[i] = ((uintptr_t)g[i] & 3u) ? 0 : bytes[i] / 4;
    }
  }
  __device__ int words() const { return vec[0] + vec[1]; }
  __device__ uint32_t load(int w) const {
    const int i = w < vec[0] ? 0 : 1;
    return reinterpret_cast<const uint32_t*>(g[i])[w - (i ? vec[0] : 0)];
  }
  // word w, found to hold v: cleared where a byte is set, and each set
  // octant's ancestors marked where go (prev: the octant this thread
  // marked last, of level prev_l)
  __device__ void apply(const Mips& M, int b, int nl, bool go, int w,
                        uint32_t v, int3& prev, int& prev_l) const {
    if (v == 0u) return;
    const int i = w < vec[0] ? 0 : 1, wl = w - (i ? vec[0] : 0);
    reinterpret_cast<uint32_t*>(g[i])[wl] = 0u;
    if (!go) return;
    const int s = b >> (i + 1);
    level(i + 1, prev, prev_l);
    for (uint32_t r = nonzero_bytes(v); r; r &= r - 1) {
      const int c = 4 * wl + __ffs(r) - 1;
      mark_up(M, b, nl, i + 1, c / (s * s), (c / s) % s, c % s, prev);
    }
  }
  // the bytes past the whole words (a grid off a 4-byte boundary is all
  // bytes), thread t of n_threads
  __device__ void bytes_pass(const Mips& M, int b, int nl, bool go, int t,
                             int n_threads, int3& prev, int& prev_l) const {
    for (int i = 0; i < 2; ++i) {
      const int s = b >> (i + 1);
      for (int c = 4 * vec[i] + t; c < bytes[i]; c += n_threads) {
        if (!g[i][c]) continue;
        g[i][c] = 0;
        if (!go) continue;
        level(i + 1, prev, prev_l);
        mark_up(M, b, nl, i + 1, c / (s * s), (c / s) % s, c % s, prev);
      }
    }
  }
  // prev holds an octant of level l from here on (none when it held
  // another level's)
  __device__ static void level(int l, int3& prev, int& prev_l) {
    if (prev_l != l) prev = make_int3(-1, -1, -1);
    prev_l = l;
  }
};

__global__ void __launch_bounds__(kAllocThreads)
    alloc_assign_kernel(uint8_t* __restrict__ touched,
                        uint8_t* __restrict__ extra1,
                        uint8_t* __restrict__ extra2,
                        const uint8_t* __restrict__ when, int world,
                        int rank, int b, int nl, int cap, int kb,
                        int* __restrict__ slot,
                        int* __restrict__ block_coord,
                        uint8_t* __restrict__ active,
                        int* __restrict__ n_blocks,
                        int* __restrict__ overflow, Mips M) {
  const bool go = when == nullptr || *when;
  if (blockIdx.x >= kAllocCtas) {  // a coarse cluster
    const Coarse coarse(extra1, extra2, b);
    const int t = (blockIdx.x - kAllocCtas) * blockDim.x + threadIdx.x;
    const int n_t = (gridDim.x - kAllocCtas) * blockDim.x;
    int3 prev = make_int3(-1, -1, -1);
    int prev_l = 0;
    for (int w = t; w < coarse.words(); w += n_t)
      coarse.apply(M, b, nl, go, w, coarse.load(w), prev, prev_l);
    coarse.bytes_pass(M, b, nl, go, t, n_t, prev, prev_l);
    return;
  }
  const int n_old = *n_blocks;  // read by all before rank 0 writes it
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lb = __ffs(b) - 1;
  const int room = max(0, min(kb, cap - n_old));  // slots this call may take
  auto run_mask = [&](int i0, int cnt) {
    uint32_t m = 0;
    // a run of 16 or 32 cells starts at a multiple of its length (runs are
    // powers of two: b is one), so with b >= cnt it is one z-row
    const bool whole = cnt == 32 || cnt == 16;
    if (whole) {  // one or two aligned 16-byte loads
      uint4* t4 = reinterpret_cast<uint4*>(touched + i0);
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 a = t4[0], c = cnt == 32 ? t4[1] : zero;
      m = nonzero_bytes(a.x) | (nonzero_bytes(a.y) << 4) |
          (nonzero_bytes(a.z) << 8) | (nonzero_bytes(a.w) << 12) |
          (nonzero_bytes(c.x) << 16) | (nonzero_bytes(c.y) << 20) |
          (nonzero_bytes(c.z) << 24) | (nonzero_bytes(c.w) << 28);
      if (a.x | a.y | a.z | a.w) t4[0] = zero;
      if (c.x | c.y | c.z | c.w) t4[1] = zero;
    } else {
      for (int j = 0; j < cnt; ++j)
        if (touched[i0 + j]) {
          m |= 1u << j;
          touched[i0 + j] = 0;
        }
    }
    if (!go || m == 0u) return 0u;  // a masked step only clears
    if (world > 0) {  // keep this rank's cells (b is a power of two)
      if (whole && b >= cnt) {  // one owner for each 4 cells of the row
        const uint32_t xy = row_code(i0 >> (2 * lb), (i0 >> lb) & (b - 1));
        const int z0 = i0 & (b - 1);
        for (int k = 0; k < 8; ++k)
          if (((m >> (4 * k)) & 0xfu) &&
              tile_owner(xy, z0 + 4 * k, world) != rank)
            m &= ~(0xfu << (4 * k));
      } else {
        for (uint32_t r = m; r; r &= r - 1) {
          const int j = __ffs(r) - 1, c = i0 + j;
          if (tile_owner(row_code(c >> (2 * lb), (c >> lb) & (b - 1)),
                         c & (b - 1), world) != rank)
            m &= ~(1u << j);
        }
      }
    }
    // a touched block that exists is re-activated and leaves the mask
    if (whole) {  // the slot words under set cells, all loads at once
      // (m has no bit past cnt)
      const int4* s4 = reinterpret_cast<const int4*>(slot + i0);
      int4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = ((m >> (4 * k)) & 0xfu) ? s4[k] : make_int4(-1, -1, -1, -1);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int s[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (((m >> (4 * k + j)) & 1u) && s[j] >= 0) {
            active[s[j]] = 1;
            m &= ~(1u << (4 * k + j));
          }
      }
    } else {
      for (uint32_t r = m; r; r &= r - 1) {
        const int j = __ffs(r) - 1;
        const int s = slot[i0 + j];
        if (s >= 0) {
          active[s] = 1;
          m &= ~(1u << j);
        }
      }
    }
    return m;
  };
  int3 prev0 = make_int3(-1, -1, -1);
  auto emit = [&](int cell, int r) {
    if (r >= room) return;  // beyond the budget or the pool: dropped
    const int dest = n_old + r;
    const int x = cell >> (2 * lb), y = (cell >> lb) & (b - 1),
              z = cell & (b - 1);
    slot[cell] = dest;
    block_coord[3 * dest] = x;
    block_coord[3 * dest + 1] = y;
    block_coord[3 * dest + 2] = z;
    active[dest] = 1;
    mark_up(M, b, nl, 0, x, y, z, prev0);
  };
  se::cluster_compact(b * b * b, run_mask, emit, [&](int total) {
    if (nl >= 2 && g < 8) M.alloc[nl - 2][g] = 1;  // the root's children
    if (g == 0) {
      const int n_new = min(total, room);
      *n_blocks = n_old + n_new;
      *overflow = total - n_new;
    }
  });
}

}  // namespace

// when (bool[]) may be null: always true; extra1 / extra2 (OFusion's level
// 1 and 2 grids) may be null. world > 0: the sharded step's owner mask:
// only the touched cells that tile_owner gives to `rank` of `world` are
// allocated or re-activated (the extra grids are not masked, as JAX's
// sharded step unions them), in tiles of 64 morton cells (the caller,
// kernels/alloc.py, refuses any other tile). world 0: every cell
// is this map's. kb = min(B^3, budget). touched and slot
// 16-byte aligned, the mip levels below the top 2-byte aligned, b a power
// of two. touched, extra1 and extra2 are all zero on return. Returns a
// cudaError_t, or -1 when no such cluster fits the card.
SE_EXPORT int se_alloc_assign(uint8_t* touched, uint8_t* extra1,
                              uint8_t* extra2, const uint8_t* when,
                              int world, int rank, int b, int nl, int cap,
                              int kb, int* slot, int* block_coord,
                              uint8_t* active, int* n_blocks, int* overflow,
                              Mips mips, void* stream) {
  if (world < 0 || (world > 0 && (rank < 0 || rank >= world)) || b < 1 ||
      (b & (b - 1)))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)touched % 16 || (uintptr_t)slot % 16)
    return (int)cudaErrorMisalignedAddress;
  for (int l = 0; l + 1 < nl; ++l)  // mark_children's 16-bit stores
    if ((uintptr_t)mips.alloc[l] % 2) return (int)cudaErrorMisalignedAddress;
  // the coarse grids' clusters: a 4-byte word (or less) a thread
  int coarse = 0;
  for (int i = 0; i < 2; ++i) {
    const int s = b >> (i + 1);
    if ((i ? extra2 : extra1) != nullptr) coarse += s * s * s;
  }
  const int per_cluster = 4 * kAllocCtas * kAllocThreads;
  const int n_coarse = min(kMaxCoarseClusters,
                           (coarse + per_cluster - 1) / per_cluster);
  static se::ClusterFit held[se::kMaxDevices];
  return se::launch_clusters(alloc_assign_kernel, held, kAllocCtas,
                             kAllocThreads, 1 + n_coarse, 0, stream, touched,
                             extra1, extra2, when, world, rank, b, nl, cap,
                             kb, slot, block_coord, active, n_blocks,
                             overflow, mips);
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
  if (n == 0) return 0;
  int threads = 0;
  if (const int err = march_threads(n, &threads)) return err;
  alloc_touch_of_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
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
  const int n = hs * ws;
  if (n == 0) return 0;
  int threads = 0;
  if (const int err = march_threads(n, &threads)) return err;
  alloc_touch_kernel<<<(n + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      depth, w, x0, stride, hs, ws, kpose, pose, band_half, step, num_steps,
      inv_voxel, size, b, touched);
  return (int)cudaGetLastError();
}
