// K3: integration block pass of both fields, as two launches around a
// cumsum.
//
// Replaces supereight_tpu/ops/integration.py:integrate's block pass
// (286-375) with _project_voxels_c (78-94), _sample_depth_patch (123-213)
// and the fallback sub-worklist (340-356), which XLA runs as [budget, 512]
// tensors with 16-row depth-strip gathers, a one-hot einsum and top_k.
//
// One CTA of 512 threads per worklist entry (one 8^3 block), one thread
// per voxel, reading and writing the pool directly.
//
//  * integrate_prepass: project every voxel (valid when z >= 1e-4 and the
//    pixel lies in [0.5, size - 1.5]), reduce the block's pixel bbox over
//    its valid voxels and pick the depth level by the JAX rule: level i
//    when dx > 24 << (i-1) or dy > 15 << (i-1), over the n_levels levels
//    whose mip is big enough. Writes level (-1 = bbox too big for every
//    level), the valid-voxel count and need (uncovered with valid voxels).
//  * between the launches the caller ranks `need` with a cumsum: the first
//    32 uncovered blocks in worklist order read the exact pixel (level 0),
//    the rest skip fusion this frame and are counted (patch_skipped).
//  * integrate_update: read depth[(y >> l) << l, (x >> l) << l] at the
//    block's mode, run the field's update in place and set the block's
//    active flag to (any voxel valid). One body, instantiated per field:
//    the TSDF update (fields/tsdf.py) or the OFusion update
//    (fields/ofusion.py: bspline sensor model H(diff / sigma), decay
//    window, log2-odds, clamps; y = the frame's timestamp where it
//    writes), in the JAX package's operation order. The projection and
//    both updates live in fields.cuh, shared with K4 (node.cu).
//
// Bound on the H100: the pool read-modify-write, 4 KB per block (two f32
// channels) + depth reads that stay in L1/L2 (a 300 KB frame): 8192 blocks
// -> ~33 MB per frame, about 10 us at HBM rate. Each CTA touches one
// contiguous 2 KB row per channel, so loads and stores are coalesced. The
// OFusion update adds a few dozen flops and one log2f per written voxel,
// far below the card's rate: it stays bound by the same bytes.

#include "fields.cuh"

namespace {

constexpr int kThreads = se::kBlockVoxels;

// The projection of this thread's voxel (its block's origin + the thread's
// in-brick offset); t_cw and K live in shared memory.
__device__ __forceinline__ se::Proj project_voxel(const int* __restrict__ bc,
                                                  const float* T,
                                                  const float* K, float voxel,
                                                  int w, int h) {
  const int lin = threadIdx.x;
  const float wx = (float)(bc[0] * 8 + (lin & 7)) * voxel;
  const float wy = (float)(bc[1] * 8 + ((lin >> 3) & 7)) * voxel;
  const float wz = (float)(bc[2] * 8 + (lin >> 6)) * voxel;
  return se::project(T, K, wx, wy, wz, w, h);
}

__global__ void __launch_bounds__(kThreads)
integrate_prepass_kernel(const int* __restrict__ worklist, int cap,
                         const int* __restrict__ block_coord,
                         const float* __restrict__ t_cw,
                         const float* __restrict__ kmat, float voxel, int w,
                         int h, int n_levels, int* __restrict__ level,
                         int* __restrict__ n_valid, uint8_t* __restrict__ need) {
  __shared__ float T[16], K[16];
  __shared__ int x0, x1, y0, y1;
  const int slot = worklist[blockIdx.x];
  if (slot >= cap) {  // empty worklist entry: uniform exit
    if (threadIdx.x == 0) {
      level[blockIdx.x] = 0;
      n_valid[blockIdx.x] = 0;
      need[blockIdx.x] = 0;
    }
    return;
  }
  se::load_mat4(t_cw, T);
  se::load_mat4(kmat, K);
  if (threadIdx.x == 0) {
    x0 = 1 << 20;
    y0 = 1 << 20;
    x1 = -1;
    y1 = -1;
  }
  __syncthreads();
  const se::Proj p =
      project_voxel(block_coord + 3 * slot, T, K, voxel, w, h);
  if (p.valid) {
    atomicMin(&x0, p.xi);
    atomicMax(&x1, p.xi);
    atomicMin(&y0, p.yi);
    atomicMax(&y1, p.yi);
  }
  const int count = __syncthreads_count(p.valid);
  if (threadIdx.x == 0) {
    const int dx = x1 - x0, dy = y1 - y0;
    int lvl = 0;
    for (int i = 1; i < n_levels; ++i)
      if (dx > (24 << (i - 1)) || dy > (15 << (i - 1))) lvl = i;
    const bool covered = n_levels > 0 && dx <= (24 << (n_levels - 1)) &&
                         dy <= (15 << (n_levels - 1));
    level[blockIdx.x] = covered ? lvl : -1;
    n_valid[blockIdx.x] = count;
    need[blockIdx.x] = (!covered && count > 0) ? 1 : 0;
  }
}

template <bool kOFusion>
__global__ void __launch_bounds__(kThreads)
integrate_update_kernel(const int* __restrict__ worklist, int cap,
                        const int* __restrict__ block_coord,
                        const float* __restrict__ t_cw,
                        const float* __restrict__ kmat, float voxel, int w,
                        int h, const int* __restrict__ mode,
                        const float* __restrict__ depth,
                        se::FieldArgs A,
                        float* __restrict__ data_x,
                        float* __restrict__ data_y,
                        uint8_t* __restrict__ active) {
  __shared__ float T[16], K[16];
  const int slot = worklist[blockIdx.x];
  if (slot >= cap) return;  // uniform exit
  se::load_mat4(t_cw, T);
  se::load_mat4(kmat, K);
  __syncthreads();
  const se::Proj p =
      project_voxel(block_coord + 3 * slot, T, K, voxel, w, h);
  const int l = mode[blockIdx.x];
  const bool valid = p.valid && l >= 0;
  if (valid) {
    const float ds = depth[((p.yi >> l) << l) * w + ((p.xi >> l) << l)];
    const size_t v = (size_t)slot * se::kBlockVoxels + threadIdx.x;
    se::update_field<kOFusion>(A, p, ds, data_x + v, data_y + v);
  }
  // block stays active iff any voxel projected into the frame
  // (ref update_block, projective_functor.hpp:104-110)
  const int any = __syncthreads_or(valid);
  if (threadIdx.x == 0) active[slot] = any ? 1 : 0;
}

}  // namespace

SE_EXPORT int se_integrate_prepass(const int* worklist, int n_work, int cap,
                                   const int* block_coord, const float* t_cw,
                                   const float* kmat, float voxel, int w,
                                   int h, int n_levels, int* level,
                                   int* n_valid, uint8_t* need, void* stream) {
  if (n_work == 0) return 0;
  integrate_prepass_kernel<<<n_work, kThreads, 0, (cudaStream_t)stream>>>(
      worklist, cap, block_coord, t_cw, kmat, voxel, w, h, n_levels, level,
      n_valid, need);
  return (int)cudaGetLastError();
}

// field: 0 = TSDF, 1 = OFusion; timestamp (OFusion) is a device f32[]
SE_EXPORT int se_integrate_update(const int* worklist, int n_work, int cap,
                                  const int* block_coord, const float* t_cw,
                                  const float* kmat, float voxel, int w, int h,
                                  const int* mode, const float* depth,
                                  int field, float mu, float max_weight,
                                  float two_voxel, const float* timestamp,
                                  float* data_x, float* data_y,
                                  uint8_t* active, void* stream) {
  if (n_work == 0) return 0;
  const se::FieldArgs A{mu, max_weight, two_voxel, timestamp};
  if (field == 1)
    integrate_update_kernel<true><<<n_work, kThreads, 0,
                                    (cudaStream_t)stream>>>(
        worklist, cap, block_coord, t_cw, kmat, voxel, w, h, mode, depth, A,
        data_x, data_y, active);
  else
    integrate_update_kernel<false><<<n_work, kThreads, 0,
                                     (cudaStream_t)stream>>>(
        worklist, cap, block_coord, t_cw, kmat, voxel, w, h, mode, depth, A,
        data_x, data_y, active);
  return (int)cudaGetLastError();
}
