// K4: the node (coarse mip) pass of both fields, one launch a frame.
//
// Replaces supereight_tpu/ops/integration.py:integrate's node pass: the
// dense levels (377-419) and _node_pass_level0_sparse (433-500), with
// _project_voxels_c (78-94), _sample_depth (97-115) and _field_update
// (273-279), which XLA runs as one dense [s, s, s] program per level and a
// top_k-compacted, sibling-packed gather for level 0.
//
// Ref update_node (projective_functor.hpp:113-137): every existing coarse
// value is re-fused at its octant's origin corner. One thread per coarse
// cell, the cells of all levels laid end to end (level 0 = B^3 first, then
// (B/2)^3, ... 1). A thread
//  * reads its gate and leaves at once where it is shut: level 0 reads
//    `present` (bool[B/2]^3, "the parent is occupied and among the first
//    pbudget occupied parents", ranked by node_rank below) when the caller
//    gives it (B >= 8, the JAX sparse pass), else mip_alloc[0];
//    higher levels read mip_alloc[lvl]; `when` (bool[]) shuts every gate;
//  * places its corner at float(i) * octant_m per axis, octant_m =
//    (8 << lvl) * voxel rounded to f32 once (torch.arange(side) * octant_m);
//  * projects it through t_cw and K (fields.cuh, K3's projection), reads
//    the nearest depth at the truncated pixel (the full-resolution image,
//    not K3's patch levels) and runs the field's update in place.
//
// Bound on the H100: the gates, ~300 KB at 512^3 (299,593 cells, level 0's
// present grid 32 KB), plus ~20 B per live cell (x and y read and written,
// one depth read): a few thousand live cells a frame, under a microsecond
// at 3.35 TB/s. The torch ops it replaces ran ~150 (TSDF) / ~220 (OFusion)
// launches a level; the design answers the bound with one launch and an
// early exit on shut gates, so most threads do one byte load.
//
// node_rank, the launch before it, ranks the level-0 parents on the device
// (JAX _node_pass_level0_sparse 449-458: a top_k over the (B/2)^3
// parents). A parent is occupied when any of its 8 mip_alloc[0] children
// is set; one cluster of 8 CTAs x 1024 threads (compact.cuh) ranks the
// occupied parents in parent-id order, as the top_k of npar - id does, and
// writes present[p] = occupied and rank < pbudget = min(budget, (B/2)^3)
// for every parent, and mip_skipped = (occupied - present) * 8 octants,
// 0 where `when` is false. Bound: the B^3 mip_alloc[0] bytes read once and
// the (B/2)^3 gate bytes written once, ~0.3 MB at 512^3 (~0.1 us); what is
// left is the cluster's two barriers. It stays its own launch: folded into
// node_pass, either that pass's 1,170 CTAs would wait on one cluster, or
// the cluster's 8,192 threads would walk all 299,593 cells (~37 each).

#include "compact.cuh"
#include "fields.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 10;

// per-level pointers of the mip pyramid (the layout of nav.cu's Mips, with
// writable values); level l is (b >> l)^3, x-major then y, z minor
struct Mips {
  const uint8_t* alloc[kMaxLevels];
  float* x[kMaxLevels];
  float* y[kMaxLevels];
};

template <bool kOFusion>
__global__ void __launch_bounds__(kThreads)
node_pass_kernel(Mips mips, int b, int n_cells, double voxel,
                 const uint8_t* __restrict__ present,
                 const uint8_t* __restrict__ when,
                 const float* __restrict__ t_cw,
                 const float* __restrict__ kmat, int w, int h,
                 const float* __restrict__ depth, se::FieldArgs A) {
  __shared__ float T[16], K[16];
  se::load_mat4(t_cw, T);
  se::load_mat4(kmat, K);
  __syncthreads();
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells || (when != nullptr && !*when)) return;
  int lvl = 0, s = b;
  while (c >= s * s * s) {
    c -= s * s * s;
    s >>= 1;
    ++lvl;
  }
  const int x = c / (s * s), y = (c / s) % s, z = c % s;
  if (lvl == 0 && present != nullptr) {
    const int hp = b >> 1;
    if (!present[((x >> 1) * hp + (y >> 1)) * hp + (z >> 1)]) return;
  } else if (!mips.alloc[lvl][c]) {
    return;
  }
  const float octant = (float)((double)(8 << lvl) * voxel);
  const se::Proj p = se::project(T, K, (float)x * octant, (float)y * octant,
                                 (float)z * octant, w, h);
  if (!p.valid) return;
  se::update_field<kOFusion>(A, p, depth[p.yi * w + p.xi], mips.x[lvl] + c,
                             mips.y[lvl] + c);
}

__global__ void __cluster_dims__(se::kCompactCtas, 1, 1)
    __launch_bounds__(se::kCompactThreads)
    node_rank_kernel(const uint8_t* __restrict__ alloc0, int b, int pbudget,
                     const uint8_t* __restrict__ when,
                     uint8_t* __restrict__ present,
                     int* __restrict__ skipped) {
  const int hp = b >> 1;
  // a run's occupied parents; the empty ones' gates are written 0 here,
  // the occupied ones' by emit (each parent by one thread)
  auto run_mask = [&](int i0, int cnt) {
    uint32_t m = 0;
    for (int j = 0; j < cnt; ++j) {
      const int p = i0 + j;
      const int x = p / (hp * hp), y = (p / hp) % hp, z = p % hp;
      // the 8 children: two z-adjacent bytes in each of 4 (x, y) rows
      bool any = false;
      for (int r = 0; r < 4; ++r) {
        const int c = ((2 * x + (r >> 1)) * b + 2 * y + (r & 1)) * b + 2 * z;
        any |= *reinterpret_cast<const uint16_t*>(alloc0 + c) != 0;
      }
      if (any)
        m |= 1u << j;
      else
        present[p] = 0;
    }
    return m;
  };
  auto emit = [&](int p, int rank) { present[p] = rank < pbudget; };
  se::cluster_compact(hp * hp * hp, run_mask, emit, [&](int total) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      const bool go = when == nullptr || *when;
      *skipped = go ? (total - min(total, pbudget)) * 8 : 0;
    }
  });
}

}  // namespace

// b >= 8 and even, alloc0 2-byte aligned; when (bool[]) may be null
SE_EXPORT int se_node_rank(const uint8_t* alloc0, int b, int pbudget,
                           const uint8_t* when, uint8_t* present,
                           int* skipped, void* stream) {
  if (b < 8 || (b & 1)) return (int)cudaErrorInvalidValue;
  node_rank_kernel<<<se::kCompactCtas, se::kCompactThreads, 0,
                     (cudaStream_t)stream>>>(alloc0, b, pbudget, when,
                                             present, skipped);
  return (int)cudaGetLastError();
}

// field: 0 = TSDF, 1 = OFusion; present (bool[b/2]^3) and when (bool[])
// may be null; timestamp (OFusion) is a device f32[]
SE_EXPORT int se_node_pass(Mips mips, int b, int n_levels, double voxel,
                           const uint8_t* present, const uint8_t* when,
                           const float* t_cw, const float* kmat, int w, int h,
                           const float* depth, int field, float mu,
                           float max_weight, float two_voxel,
                           const float* timestamp, void* stream) {
  if (n_levels > kMaxLevels || (b >> (n_levels - 1)) != 1)
    return (int)cudaErrorInvalidValue;
  int n_cells = 0;
  for (int l = 0; l < n_levels; ++l) n_cells += (b >> l) * (b >> l) * (b >> l);
  const int n_cta = (n_cells + kThreads - 1) / kThreads;
  const se::FieldArgs A{mu, max_weight, two_voxel, timestamp};
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 1)
    node_pass_kernel<true><<<n_cta, kThreads, 0, st>>>(
        mips, b, n_cells, voxel, present, when, t_cw, kmat, w, h, depth, A);
  else
    node_pass_kernel<false><<<n_cta, kThreads, 0, st>>>(
        mips, b, n_cells, voxel, present, when, t_cw, kmat, w, h, depth, A);
  return (int)cudaGetLastError();
}
