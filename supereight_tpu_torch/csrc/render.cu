// K10 render: the visualization renders (depth, tracking status and the
// shaded volume) as RGBA images: one launch a render, or one launch
// (render_views) that writes all three into the viewer's 2x2 composite.
//
// Replaces JAX's three jitted renders, supereight_tpu/ops/rendering.py
// render_depth (:39, with gs2rgb :20), render_track (:64) and the shading
// of render_volume (:77; its fresh-view raycast stays K1's unprimed
// launch) (ref renderDepthKernel / renderTrackKernel / renderVolumeKernel,
// se_denseslam/src/rendering.cpp:111-283, gs2rgb commons.h:105-164). XLA
// fuses each into one program; as torch ops they were ~75 launches and a
// host-to-device copy of the colour table a rendered frame.
//
// One thread a pixel; each pixel's RGBA (alpha 0) goes out as one 32-bit
// store, R in the low byte (the u8[H, W, 4] image's layout). The
// arithmetic is the twins' (kernels/render.py), operation for operation:
// the library builds with -fmad=false, sums run left to right, the
// division and the square root are IEEE-rounded and the f32 -> u8 casts
// truncate, so the kernel equals its twins bit for bit (and their images
// equal JAX's):
//   depth   d = (z - near) * inv, inv = f32(1) / f32(far - near) from the
//           host (XLA's folded reciprocal); v = clamp(d, 0, 1) * 6,
//           sector floor(v) % 6 of the R->Y->G->C->B->M table, frac
//           v - floor(v), each channel * 255; white where z < near, black
//           where z > far (black last, as the twin);
//   track   the codes 1, -1 ... -5 to the legend's rows 1-6, any other code
//           to row 0;
//   volume  light = pose[:3, 3] (or the caller's light), read on the
//           device; diff = v - light, |diff| = sqrtf(dx*dx + dy*dy + dz*dz),
//           each component divided by it (by 1 where it is 0), shade =
//           max(n0*d0 + n1*d1 + n2*d2, 0), grey clamp(shade + 0.1, 0, 1) *
//           255, 0 where not valid.
//
// Bound on the H100: bytes. A pixel moves 4 + 4 B (depth, track) or 12 +
// 12 + 1 + 4 B (volume) for ~20 operations; at the CLI's 320x240 that is
// 0.61 / 0.61 / 2.23 MB, 0.18 / 0.18 / 0.67 us at 3.35 TB/s, below the
// ~1 us launch floor: the launch is the cost, so the design is the plain
// one (no shared memory, coalesced reads, one store a pixel).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rgb(uint32_t r, uint32_t g, uint32_t b) {
  return r | (g << 8) | (b << 16);
}

__device__ __forceinline__ uint32_t to_u8(float x) {
  return (uint32_t)__float2uint_rz(x);
}

// torch.clamp's order (max with lo, then min with hi), NaN passed on
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// the pixel bodies: the single kernels and render_views call the same ones
__device__ __forceinline__ uint32_t depth_word(float z, float near, float far,
                                               float inv) {
  if (z > far) return 0u;
  if (z < near) return rgb(255u, 255u, 255u);
  const float v = clampf((z - near) * inv, 0.f, 1.f) * 6.f;
  const float fl = floorf(v);
  const float up = v - fl, down = 1.f - up;
  float r, g, b;
  switch ((int)fl % 6) {
    case 0: r = 1.f; g = up; b = 0.f; break;
    case 1: r = down; g = 1.f; b = 0.f; break;
    case 2: r = 0.f; g = 1.f; b = up; break;
    case 3: r = 0.f; g = down; b = 1.f; break;
    case 4: r = up; g = 0.f; b = 1.f; break;
    default: r = 1.f; g = 0.f; b = down; break;
  }
  return rgb(to_u8(r * 255.f), to_u8(g * 255.f), to_u8(b * 255.f));
}

__device__ __forceinline__ uint32_t track_word(int code) {
  switch (code) {
    case 1: return rgb(128u, 128u, 128u);   // tracked ok
    case -1: return rgb(0u, 0u, 0u);        // no input
    case -2: return rgb(255u, 0u, 0u);      // not in image
    case -3: return rgb(0u, 255u, 0u);      // no correspondence
    case -4: return rgb(0u, 0u, 255u);      // too far
    case -5: return rgb(255u, 255u, 0u);    // wrong normal
    default: return rgb(255u, 128u, 128u);
  }
}

// pixel i's grey; the light is light[0:3], or pose[:3, 3] where light is
// null. Every input is read before the valid test, so that the loads go
// out together instead of the maps' waiting for valid's: an invalid
// pixel's grey is computed and dropped.
__device__ __forceinline__ uint32_t volume_word(
    const float* __restrict__ vertex, const float* __restrict__ normal,
    const uint8_t* __restrict__ valid, const float* __restrict__ pose,
    const float* __restrict__ light, int i) {
  const bool ok = valid[i] != 0;
  const float* v = vertex + 3 * (size_t)i;
  const float* nm = normal + 3 * (size_t)i;
  const float vx = v[0], vy = v[1], vz = v[2];
  const float n0 = nm[0], n1 = nm[1], n2 = nm[2];
  float lx, ly, lz;
  if (light != nullptr) {
    lx = light[0]; ly = light[1]; lz = light[2];
  } else {
    lx = pose[3]; ly = pose[7]; lz = pose[11];
  }
  float dx = vx - lx, dy = vy - ly, dz = vz - lz;
  const float dn = sqrtf(dx * dx + dy * dy + dz * dz);
  const float den = dn == 0.f ? 1.f : dn;
  dx = dx / den;
  dy = dy / den;
  dz = dz / den;
  float shade = n0 * dx + n1 * dy + n2 * dz;
  shade = shade < 0.f ? 0.f : shade;
  const uint32_t c = to_u8(clampf(shade + 0.1f, 0.f, 1.f) * 255.f);
  return ok ? rgb(c, c, c) : 0u;
}

__global__ void __launch_bounds__(kThreads)
render_depth_kernel(const float* __restrict__ depth, int n, float near,
                    float far, float inv, uint32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = depth_word(depth[i], near, far, inv);
}

__global__ void __launch_bounds__(kThreads)
render_track_kernel(const int* __restrict__ result, int n,
                    uint32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = track_word(result[i]);
}

__global__ void __launch_bounds__(kThreads)
render_volume_kernel(const float* __restrict__ vertex,
                     const float* __restrict__ normal,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ pose,
                     const float* __restrict__ light, int n,
                     uint32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = volume_word(vertex, normal, valid, pose, light, i);
}

// out u32[2h, 2w]: row y of the images at rows y (top) and h + y (bottom)
__global__ void __launch_bounds__(kThreads)
render_views_kernel(const float* __restrict__ depth,
                    const int* __restrict__ result,
                    const float* __restrict__ vertex,
                    const float* __restrict__ normal,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ pose,
                    const float* __restrict__ light, int h, int w,
                    float near, float far, float inv,
                    uint32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w, x = i - y * w;
  uint32_t* top = out + (size_t)y * (2 * w);
  uint32_t* bottom = out + (size_t)(h + y) * (2 * w);
  top[x] = 0u;
  top[w + x] = depth_word(depth[i], near, far, inv);
  bottom[x] = track_word(result[i]);
  bottom[w + x] = volume_word(vertex, normal, valid, pose, light, i);
}

inline unsigned blocks(int n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// n pixels > 0; out u8[n, 4] viewed as n words (4-byte aligned)
SE_EXPORT int se_render_depth(const float* depth, int n, float near,
                              float far, float inv, uint32_t* out,
                              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  render_depth_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      depth, n, near, far, inv, out);
  return (int)cudaGetLastError();
}

SE_EXPORT int se_render_track(const int* result, int n, uint32_t* out,
                              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  render_track_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      result, n, out);
  return (int)cudaGetLastError();
}

// light null: the light is pose[:3, 3] (pose f32[4, 4] row-major)
SE_EXPORT int se_render_volume(const float* vertex, const float* normal,
                               const uint8_t* valid, const float* pose,
                               const float* light, int n, uint32_t* out,
                               void* stream) {
  if (n <= 0 || (pose == nullptr && light == nullptr))
    return (int)cudaErrorInvalidValue;
  render_volume_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      vertex, normal, valid, pose, light, n, out);
  return (int)cudaGetLastError();
}

// the images h x w > 0; out u8[2h, 2w, 4] viewed as 4h * w words; light
// null: the light is pose[:3, 3]
SE_EXPORT int se_render_views(const float* depth, const int* result,
                              const float* vertex, const float* normal,
                              const uint8_t* valid, const float* pose,
                              const float* light, int h, int w, float near,
                              float far, float inv, uint32_t* out,
                              void* stream) {
  if (h <= 0 || w <= 0 || (pose == nullptr && light == nullptr))
    return (int)cudaErrorInvalidValue;
  render_views_kernel<<<blocks(h * w), kThreads, 0, (cudaStream_t)stream>>>(
      depth, result, vertex, normal, valid, pose, light, h, w, near, far, inv,
      out);
  return (int)cudaGetLastError();
}
