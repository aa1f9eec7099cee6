// K5: TSDF band allocation march (the touched-block grid).
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

#include "common.cuh"

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

}  // namespace

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
