// K7: the input pyramid of the tracking stage (the filter_input=False
// path), two kernels.
//
// Replaces supereight_tpu/pipeline.py:_preprocess_and_pyramid (26-58)
// with ops/preprocess.py:half_sample_robust (79-98), depth2vertex
// (101-114) and vertex2normal (117-143), which XLA runs as gathers,
// concatenations and an einsum over each level's image.
//
//  * half_sample: one thread per output pixel of the next coarser level
//    (ref preprocessing.cpp:190-226): the 2x2 window at offsets {0, 1}
//    from (2r, 2c), clamped at the last row and column; samples with
//    |cur - center| >= e_d are left out of the mean; t and s are summed in
//    the twin's order (row offset outer, column offset inner) and the
//    result is t / (s == 0 ? 1 : s). One launch per coarser level.
//  * vertex_normal: one thread per pixel of a level (ref
//    preprocessing.cpp:91-159): the inverse intrinsics of k / 2^level as
//    se3.inverse_camera_matrix builds them, the back-projected vertex
//    d * (ik[r][0] x + ik[r][1] y + ik[r][2]) (0 where d <= 0), the four
//    edge-replicated neighbours' vertices recomputed from depth, the
//    cross product of the central differences over its norm (1 where the
//    norm is 0), and the sentinel (INVALID, 0, 0) where the pixel or a
//    neighbour has no depth. neg_y swaps the vertical neighbours. One
//    launch per level.
//
// Bound on the H100: bytes. A 320x240 level reads 300 KB of depth and
// writes 1.9 MB of vertex, normal and valid (~0.66 us at 3.35 TB/s); the
// ~50 operations a pixel are far below the f32 rate. The neighbours'
// depths are re-read from L1, so each pixel's input comes from HBM once;
// one launch per level replaces ~50 torch ops per level.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kInvalid = -2.f;  // constants.INVALID (ref commons.h)

__global__ void __launch_bounds__(kThreads)
half_sample_kernel(const float* __restrict__ in, int h, int w, float e_d,
                   float* __restrict__ out, int oh, int ow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= oh * ow) return;
  const int r = 2 * (i / ow), c = 2 * (i % ow);
  const float center = in[r * w + c];
  float t = 0.f, s = 0.f;
  for (int di = 0; di < 2; ++di)
    for (int dj = 0; dj < 2; ++dj) {
      const float cur = in[min(r + di, h - 1) * w + min(c + dj, w - 1)];
      const bool take = fabsf(cur - center) < e_d;
      t = t + (take ? cur : 0.f);
      s = s + (take ? 1.f : 0.f);
    }
  out[i] = t / (s == 0.f ? 1.f : s);
}

// The camera-frame vertex of pixel (r, c): depth times the ray of the
// inverse intrinsics ik (rows 0 and 1; row 2 is (0, 0, 1)), summed left to
// right like the twin's rays.
__device__ __forceinline__ float3 vertex(const float* __restrict__ depth,
                                         int w, int r, int c,
                                         const float* ik) {
  const float d = depth[r * w + c];
  if (!(d > 0.f)) return make_float3(0.f, 0.f, 0.f);
  const float x = (float)c, y = (float)r;
  return make_float3(d * (ik[0] * x + ik[1] * y + ik[2]),
                     d * (ik[3] * x + ik[4] * y + ik[5]),
                     d * (0.f * x + 0.f * y + 1.f));
}

__global__ void __launch_bounds__(kThreads)
vertex_normal_kernel(const float* __restrict__ depth, int h, int w,
                     const float* __restrict__ k, int level, int neg_y,
                     float* __restrict__ vert, float* __restrict__ norm,
                     uint8_t* __restrict__ valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  const int r = i / w, c = i % w;
  // se3.inverse_camera_matrix(k / 2^level): exact power-of-two scaling
  const float scale = (float)(1 << level);
  const float fx = k[0] / scale, fy = k[1] / scale;
  const float cx = k[2] / scale, cy = k[3] / scale;
  const float ik[6] = {1.f / fx, 0.f, -cx / fx, 0.f, 1.f / fy, -cy / fy};
  const float3 v = vertex(depth, w, r, c, ik);
  const float3 left = vertex(depth, w, r, max(c - 1, 0), ik);
  const float3 right = vertex(depth, w, r, min(c + 1, w - 1), ik);
  const float3 prev = vertex(depth, w, max(r - 1, 0), c, ik);
  const float3 next = vertex(depth, w, min(r + 1, h - 1), c, ik);
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
    const float d = len == 0.f ? 1.f : len;
    n = make_float3(nx / d, ny / d, nz / d);
  }
  vert[3 * i] = v.x;
  vert[3 * i + 1] = v.y;
  vert[3 * i + 2] = v.z;
  norm[3 * i] = n.x;
  norm[3 * i + 1] = n.y;
  norm[3 * i + 2] = n.z;
  valid[i] = ok ? 1 : 0;
}

}  // namespace

SE_EXPORT int se_half_sample(const float* in, int h, int w, float e_d,
                             float* out, void* stream) {
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  const int n_cta = (oh * ow + kThreads - 1) / kThreads;
  if (n_cta == 0) return 0;
  half_sample_kernel<<<n_cta, kThreads, 0, (cudaStream_t)stream>>>(
      in, h, w, e_d, out, oh, ow);
  return (int)cudaGetLastError();
}

SE_EXPORT int se_vertex_normal(const float* depth, int h, int w,
                               const float* k, int level, int neg_y,
                               float* vert, float* norm, uint8_t* valid,
                               void* stream) {
  const int n_cta = (h * w + kThreads - 1) / kThreads;
  if (n_cta == 0) return 0;
  vertex_normal_kernel<<<n_cta, kThreads, 0, (cudaStream_t)stream>>>(
      depth, h, w, k, level, neg_y, vert, norm, valid);
  return (int)cudaGetLastError();
}
