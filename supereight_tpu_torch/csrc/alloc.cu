// K5: allocation, both fields: the TSDF band march (the touched-block
// grid), the OFusion multi-scale march, and the bump allocator with the
// mip refresh.
//
// alloc_touch, the TSDF band march:
//
// Replaces supereight_tpu/ops/allocation.py:tsdf_touched_mask (75-115)
// with _pixel_rays_c_sub (32-58) and _touched_cell_ids (61-72), which XLA
// runs as an unrolled sample stack plus a deduplicated scatter.
//
// One thread per pixel of depth[::stride, ::stride]: back-project the
// pixel centre (+0.5) to a world vertex with kpose = pose @ invK, take the
// unit direction toward the camera, and walk num_steps samples across the
// +/- band around the surface, storing byte 1 into touched[B^3] for the
// 8^3 block under each in-map sample. Repeated stores of the same byte
// need no dedup and no atomics.
//
// Bound on the H100: scattered byte stores into a 262 KB grid (512^3 map),
// which stays in L2; 19.2k rays x 8 samples at the bench config. The work
// is small: the launch itself is the cost at this size.

#include "compact.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
alloc_touch_kernel(const float* __restrict__ depth, int w, int stride,
                   int hs, int ws, const float* __restrict__ kpose,
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
  const float d = depth[(sy * stride) * w + sx * stride];
  if (!(d > 0.f)) return;
  const float px = (float)(sx * stride) + 0.5f;
  const float py = (float)(sy * stride) + 0.5f;
  const float3 wv = se::transform(K, px * d, py * d, d);
  float dx = P[3] - wv.x, dy = P[7] - wv.y, dz = P[11] - wv.z;
  const float norm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float inv = 1.f / (norm == 0.f ? 1.f : norm);
  dx = dx * inv;
  dy = dy * inv;
  dz = dz * inv;
  const float ox = wv.x - band_half * dx;
  const float oy = wv.y - band_half * dy;
  const float oz = wv.z - band_half * dz;
  for (int s = 0; s < num_steps; ++s) {
    const float t = (float)(s * step);
    const int vx = (int)floorf((ox + dx * t) * inv_voxel);
    const int vy = (int)floorf((oy + dy * t) * inv_voxel);
    const int vz = (int)floorf((oz + dz * t) * inv_voxel);
    if (vx < 0 || vx >= size || vy < 0 || vy >= size || vz < 0 || vz >= size)
      continue;
    touched[((vx >> 3) * b + (vy >> 3)) * b + (vz >> 3)] = 1;
  }
}

// K5-OF: the occupancy allocation march (ofusion_touched_masks).
//
// Replaces supereight_tpu/ops/allocation.py:ofusion_touched_masks
// (148-214) with ofusion_step_ladder (118-145), which XLA runs as one
// unrolled sample stack per level plus deduplicated scatters.
//
// Threads [0, n2) take the rays of depth[::2, ::2] and mark the level-0
// samples; threads [n2, n2 + n8) take the rays of depth[::8, ::8] and mark
// the level-1 and level-2 samples (the coarse levels' 8x8 pixel stride).
// Each ray starts at the depth point backed off by band/2 = 3 mu toward
// the camera and walks the static ladder: steps of 1 voxel while t < band
// (level 0), 10 voxels while t < 1.5 band (level 1), then 30 voxels
// (level 2) up to max_dist, the level of sample i being that of step
// i - 1. The ladder is rebuilt per thread in double precision with the
// JAX package's own additions, so every sample distance is the f32
// rounding of the same double. A sample counts while f32(t) < dist, the
// distance from the camera to the ray origin. It marks byte 1 at octant
// floor(p / voxel) >> (3 + level) of the level's grid when every voxel
// coordinate lies in [0, size).
//
// Bound on the H100: scattered byte stores into grids of 262 KB + 33 KB +
// 4 KB (512^3 map), which stay in L2; 19.2k level-0 rays x 7 samples and
// 1.2k coarse rays x ~30 samples at the bench config. Like alloc_touch,
// the launch itself is the cost at this size.
__global__ void __launch_bounds__(kThreads)
alloc_touch_of_kernel(const float* __restrict__ depth, int w, int hs2,
                      int ws2, int hs8, int ws8,
                      const float* __restrict__ kpose,
                      const float* __restrict__ pose, float band_half,
                      double band, double voxel, double max_dist,
                      float inv_voxel, int size, int b,
                      uint8_t* __restrict__ touched0,
                      uint8_t* __restrict__ touched1,
                      uint8_t* __restrict__ touched2) {
  __shared__ float K[16], P[16];
  se::load_mat4(kpose, K);
  se::load_mat4(pose, P);
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n2 = hs2 * ws2;
  const bool coarse = i >= n2;
  if (coarse) i -= n2;
  const int stride = coarse ? 8 : 2, ws = coarse ? ws8 : ws2;
  if (i >= (coarse ? hs8 * ws8 : n2)) return;
  const int sy = i / ws, sx = i - sy * ws;
  const float d = depth[(sy * stride) * w + sx * stride];
  if (!(d > 0.f)) return;
  const float px = (float)(sx * stride) + 0.5f;
  const float py = (float)(sy * stride) + 0.5f;
  const float3 wv = se::transform(K, px * d, py * d, d);
  float dx = P[3] - wv.x, dy = P[7] - wv.y, dz = P[11] - wv.z;
  const float norm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float inv = 1.f / (norm == 0.f ? 1.f : norm);
  dx = dx * inv;
  dy = dy * inv;
  dz = dz * inv;
  const float ox = wv.x - band_half * dx;
  const float oy = wv.y - band_half * dy;
  const float oz = wv.z - band_half * dz;
  const float cx = P[3] - ox, cy = P[7] - oy, cz = P[11] - oz;
  const float dist = sqrtf(cx * cx + cy * cy + cz * cz);
  double t = 0.0;
  int lvl = 0;  // level of the sample at t
  while (t < max_dist) {
    int next;
    double step;
    if (t < band) {
      step = voxel;
      next = 0;
    } else if (t < band * 1.5) {
      step = 10.0 * voxel;
      next = 1;
    } else {
      step = 30.0 * voxel;
      next = 2;
    }
    const float tf = (float)t;
    if ((lvl > 0) == coarse && tf < dist) {
      const int vx = (int)floorf((ox + dx * tf) * inv_voxel);
      const int vy = (int)floorf((oy + dy * tf) * inv_voxel);
      const int vz = (int)floorf((oz + dz * tf) * inv_voxel);
      const int side = b >> lvl, shift = 3 + lvl;
      uint8_t* out = lvl == 0 ? touched0 : (lvl == 1 ? touched1 : touched2);
      if (side > 0 && vx >= 0 && vx < size && vy >= 0 && vy < size &&
          vz >= 0 && vz < size)
        out[((vx >> shift) * side + (vy >> shift)) * side + (vz >> shift)] =
            1;
    }
    if (!coarse && next > 0) break;  // the level-0 samples are all done
    lvl = next;
    t += step;
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
// A device `when` that is false leaves every grid untouched but the root's
// children, as JAX's masked allocation and unconditional refresh do.
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
// Bound on the H100: the touched grid (B^3 bytes) read once, the slot grid
// read only under touched cells, <= kb new entries written and the mip
// bytes set: ~0.3 MB at 512^3, ~0.1 us at HBM rate. A thread reads its 32
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

__device__ __forceinline__ void mark_extra(const Mips& M, int b, int nl,
                                           int l,
                                           const uint8_t* __restrict__ extra,
                                           int g, int n_threads) {
  if (extra == nullptr) return;
  const int s = b >> l;
  for (int i = g; i < s * s * s; i += n_threads)
    if (extra[i]) mark_ancestors(M, b, nl, l, i / (s * s), (i / s) % s, i % s);
}

__global__ void __cluster_dims__(se::kCompactCtas, 1, 1)
    __launch_bounds__(se::kCompactThreads)
    alloc_assign_kernel(const uint8_t* __restrict__ touched,
                        const uint8_t* __restrict__ extra1,
                        const uint8_t* __restrict__ extra2,
                        const uint8_t* __restrict__ when, int b, int nl,
                        int cap, int kb, int* __restrict__ slot,
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
    if (!go) return m;
    if (cnt == 32) {  // i0 is a multiple of 32: two aligned 16-byte loads
      const uint4* t4 = reinterpret_cast<const uint4*>(touched + i0);
      const uint4 a = t4[0], c = t4[1];
      const uint32_t words[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
      for (int k = 0; k < 8; ++k)
        for (int j = 0; j < 4; ++j)
          if ((words[k] >> (8 * j)) & 0xffu) m |= 1u << (4 * k + j);
    } else {
      for (int j = 0; j < cnt; ++j)
        if (touched[i0 + j]) m |= 1u << j;
    }
    for (uint32_t r = m; r; r &= r - 1) {  // keep the cells with no slot
      const int j = __ffs(r) - 1;
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
  if (go) {
    mark_extra(M, b, nl, 1, extra1, g, n_threads);
    mark_extra(M, b, nl, 2, extra2, g, n_threads);
  }
  if (nl >= 2 && g < 8) M.alloc[nl - 2][g] = 1;  // the root's children
  if (g == 0) {
    const int n_new = min(total, room);
    *n_blocks = n_old + n_new;
    *overflow = total - n_new;
  }
}

}  // namespace

// when (bool[]) may be null: always true; extra1 / extra2 (OFusion's level
// 1 and 2 grids) may be null. kb = min(B^3, budget).
SE_EXPORT int se_alloc_assign(const uint8_t* touched, const uint8_t* extra1,
                              const uint8_t* extra2, const uint8_t* when,
                              int b, int nl, int cap, int kb, int* slot,
                              int* block_coord, uint8_t* active,
                              int* n_blocks, int* overflow, Mips mips,
                              void* stream) {
  alloc_assign_kernel<<<se::kCompactCtas, se::kCompactThreads, 0,
                        (cudaStream_t)stream>>>(
      touched, extra1, extra2, when, b, nl, cap, kb, slot, block_coord,
      active, n_blocks, overflow, mips);
  return (int)cudaGetLastError();
}

SE_EXPORT int se_alloc_touch_of(const float* depth, int h, int w,
                                const float* kpose, const float* pose,
                                float band_half, double band, double voxel,
                                double max_dist, float inv_voxel, int size,
                                int b, uint8_t* touched0, uint8_t* touched1,
                                uint8_t* touched2, void* stream) {
  const int hs2 = (h + 1) / 2, ws2 = (w + 1) / 2;
  const int hs8 = (h + 7) / 8, ws8 = (w + 7) / 8;
  const int n_cta = (hs2 * ws2 + hs8 * ws8 + kThreads - 1) / kThreads;
  if (n_cta == 0) return 0;
  alloc_touch_of_kernel<<<n_cta, kThreads, 0, (cudaStream_t)stream>>>(
      depth, w, hs2, ws2, hs8, ws8, kpose, pose, band_half, band, voxel,
      max_dist, inv_voxel, size, b, touched0, touched1, touched2);
  return (int)cudaGetLastError();
}

SE_EXPORT int se_alloc_touch(const float* depth, int h, int w, int stride,
                             const float* kpose, const float* pose,
                             float band_half, double step, int num_steps,
                             float inv_voxel, int size, int b,
                             uint8_t* touched, void* stream) {
  const int hs = (h + stride - 1) / stride, ws = (w + stride - 1) / stride;
  const int n_cta = (hs * ws + kThreads - 1) / kThreads;
  if (n_cta == 0) return 0;
  alloc_touch_kernel<<<n_cta, kThreads, 0, (cudaStream_t)stream>>>(
      depth, w, stride, hs, ws, kpose, pose, band_half, step, num_steps,
      inv_voxel, size, b, touched);
  return (int)cudaGetLastError();
}
