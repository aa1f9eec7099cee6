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
// The capped distance transform is separable for the Chebyshev metric:
// min over occupied o of max(|dx|, |dy|, |dz|) is a min-max along x, then
// along y, then along z, each over a window of radius MAX_JUMP - 1. Three
// launches, one thread per cell each: nav_dist_x (u8 row distances from
// the slot grid), nav_dist_y, and nav_final (the z pass fused with the
// payload and the slot pick). When given counts, nav_final's first thread
// also writes the frame's block count and the blocks past the bucket,
// max(n_blocks - bucket, 0) (parallel/step.py's n_blocks and
// pool_bucket_overflow), so the frame needs no copy or clamp for them.
//
// Bound on the H100: 11 byte reads per cell and pass from grids that stay
// in L1/L2 (262k cells at 512^3: 256 KB per u8 grid, 1 MB for the slots),
// plus at most one read of each mip level per cell. Each launch moves a
// few MB: the three launches are the cost at this size.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJump = 6;
constexpr int kRadius = kMaxJump - 1;
constexpr int kMaxLevels = 10;

// per-level pointers of the mip pyramid (level l is (b >> l)^3, x-major
// then y, z minor like the slot grid)
struct Mips {
  const uint8_t* alloc[kMaxLevels];
  const float* x[kMaxLevels];
  const float* y[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads)
nav_dist_x_kernel(const int* __restrict__ slot, int b,
                  uint8_t* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= b * b * b) return;
  const int x = c / (b * b);
  const int yz = c - x * b * b;
  int d = kMaxJump;
  for (int k = -kRadius; k <= kRadius; ++k) {
    const int xk = x + k;
    if (xk < 0 || xk >= b) continue;
    if (slot[xk * b * b + yz] >= 0) d = min(d, abs(k));
  }
  out[c] = (uint8_t)d;
}

__global__ void __launch_bounds__(kThreads)
nav_dist_y_kernel(const uint8_t* __restrict__ in, int b,
                  uint8_t* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= b * b * b) return;
  const int y = (c / b) % b;
  int d = kMaxJump;
  for (int k = -kRadius; k <= kRadius; ++k) {
    const int yk = y + k;
    if (yk < 0 || yk >= b) continue;
    d = min(d, max(abs(k), (int)in[c + k * b]));
  }
  out[c] = (uint8_t)d;
}

__global__ void __launch_bounds__(kThreads)
nav_final_kernel(const uint8_t* __restrict__ in,
                 const int* __restrict__ slot, int b, int bucket,
                 int ofusion, int n_levels, Mips mips,
                 int* __restrict__ nav, const int* __restrict__ n_blocks,
                 int* __restrict__ counts) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c == 0 && counts != nullptr) {
    const int n = *n_blocks;
    counts[0] = n;
    counts[1] = max(n - bucket, 0);
  }
  if (c >= b * b * b) return;
  const int x = c / (b * b), y = (c / b) % b, z = c % b;
  int e = kMaxJump;
  for (int k = -kRadius; k <= kRadius; ++k) {
    const int zk = z + k;
    if (zk < 0 || zk >= b) continue;
    e = min(e, max(abs(k), (int)in[c + k]));
  }
  if (ofusion) {
    // finest existing coarse value (Octree::get's coarse fallback)
    for (int l = 0; l < n_levels; ++l) {
      const int s = b >> l;
      const int i = ((x >> l) * s + (y >> l)) * s + (z >> l);
      if (mips.alloc[l][i] && mips.y[l][i] > 0.f) {
        const float v = mips.x[l][i];
        if (v <= 0.f) {  // known free (SURF_BOUNDARY = 0)
          const int q = (int)rintf(fminf(fmaxf(-v, 0.f), 1000.f) * 16.f);
          e += 8 + (q << 4);
        }
        break;
      }
    }
  }
  const int s = slot[c];
  nav[c] = (s >= 0 && s < bucket) ? s : -(1 + e);
}

}  // namespace

// n_blocks and counts (i32[2]) may be null
SE_EXPORT int se_nav_grid(const int* slot, int b, int bucket, int ofusion,
                          int n_levels, Mips mips, uint8_t* tmp_x,
                          uint8_t* tmp_y, int* nav, const int* n_blocks,
                          int* counts, void* stream) {
  const int n = b * b * b;
  const int n_cta = (n + kThreads - 1) / kThreads;
  if (n_cta == 0) return 0;
  if (n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  nav_dist_x_kernel<<<n_cta, kThreads, 0, st>>>(slot, b, tmp_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nav_dist_y_kernel<<<n_cta, kThreads, 0, st>>>(tmp_x, b, tmp_y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nav_final_kernel<<<n_cta, kThreads, 0, st>>>(
      tmp_y, slot, b, bucket, ofusion, n_levels, mips, nav, n_blocks, counts);
  return (int)cudaGetLastError();
}
