// The fusion arithmetic shared by K3 (integrate.cu, the voxels of a block)
// and K4 (node.cu, the coarse values of the mip pyramid): the projection of
// a sample point and the two fields' update functors, in the JAX package's
// operation order (the library builds with -fmad=false, common.cuh).
#pragma once

#include "common.cuh"

namespace se {

// A sample point projected into the frame.
struct Proj {
  float cx, cy, cz;  // camera-frame position
  float px, py;      // pixel coordinates (the bilinear read's)
  int xi, yi;        // truncated pixel, clamped to the frame
  bool valid;
};

// update_block's projection (projective_functor.hpp:85-103; the port's
// kernels/integrate.py:project_voxels): pixel = K pos / z + 0.5, valid
// when z >= 1e-4 and the pixel lies in [0.5, size - 1.5].
__device__ __forceinline__ Proj project(const float* T, const float* K,
                                        float wx, float wy, float wz, int w,
                                        int h) {
  const float3 c = transform(T, wx, wy, wz);
  const float3 k = transform(K, c.x, c.y, c.z);
  const float safe = k.z == 0.f ? 1e-12f : k.z;
  const float px = k.x / safe + 0.5f;
  const float py = k.y / safe + 0.5f;
  Proj p;
  p.cx = c.x;
  p.cy = c.y;
  p.cz = c.z;
  p.px = px;
  p.py = py;
  p.valid = c.z >= 1e-4f && px >= 0.5f && px <= (float)(w - 1.5) &&
            py >= 0.5f && py <= (float)(h - 1.5);
  p.xi = clampi((int)px, 0, w - 1);
  p.yi = clampi((int)py, 0, h - 1);
  return p;
}

// Integral of the B-spline sensor kernel (fields/ofusion.py:bspline).
__device__ __forceinline__ float bspline(float t) {
  const float a = 3.f + t, b = 3.f - t;
  if (t >= -3.f && t <= -1.f) return a * a * a / 48.f;
  if (t > -1.f && t <= 1.f) return 0.5f + (t * a * b) / 24.f;
  if (t > 1.f && t <= 3.f) return 1.f - b * b * b / 48.f;
  return t > 3.f ? 1.f : 0.f;
}

struct FieldArgs {
  float mu, max_weight;  // TSDF
  float two_voxel;       // OFusion: the lower bound of sigma
  const float* timestamp;
};

// TSDF update (ref sdf_update, mapping_impl.hpp:35-65) of one value. With
// kNoise (the noise_weighted option, JAX fields/tsdf.py:52-60) a sample
// weighs w = clip((1.5 / max(z, 1e-3))^2, 1/16, 1) instead of 1; without
// it the arithmetic is the reference's, unchanged.
template <bool kNoise>
__device__ __forceinline__ void update_tsdf(const FieldArgs& A,
                                            const Proj& p, float ds,
                                            float* x, float* y) {
  const float ax = p.cx / p.cz, ay = p.cy / p.cz;
  const float ray_scale = sqrtf(1.f + ax * ax + ay * ay);
  const float diff = (ds - p.cz) * ray_scale;
  if (ds > 0.f && diff > -A.mu) {
    const float ox = *x, oy = *y;
    const float sdf = fminf(1.f, diff / A.mu);
    if (kNoise) {
      const float r = 1.5f / fmaxf(p.cz, 1e-3f);
      const float w = fminf(fmaxf(r * r, 1.f / 16.f), 1.f);
      const float nx = (oy * ox + w * sdf) / (oy + w);
      *x = fminf(fmaxf(nx, -1.f), 1.f);
      *y = fminf(oy + w, A.max_weight);
    } else {
      const float nx = (oy * ox + sdf) / (oy + 1.f);
      *x = fminf(fmaxf(nx, -1.f), 1.f);
      *y = fminf(oy + 1.f, A.max_weight);
    }
  }
}

// OFusion update (ref bfusion_update, mapping_impl.hpp:157-191) of one
// value; log-odds clamp +/-1000, decay window tau = 4 (constants.py)
__device__ __forceinline__ void update_ofusion(const FieldArgs& A,
                                               const Proj& p, float ds,
                                               float* x, float* y) {
  const float ax = p.cx / p.cz, ay = p.cy / p.cz;
  const float ray_scale = sqrtf(1.f + ax * ax + ay * ay);
  const float diff = (p.cz - ds) * ray_scale;
  const float sigma = fminf(fmaxf(A.mu * p.cz * p.cz, A.two_voxel), 0.05f);
  const float u = diff / sigma;
  float sample = bspline(u) - 0.5f * bspline(u - 3.f);
  if (!(ds > 0.f) || sample == 0.5f) return;
  sample = fminf(fmaxf(sample, 0.03f), 0.97f);
  const float ts = *A.timestamp;
  const float ox = *x, oy = *y;
  const float fraction = 1.f / (1.f + (ts - oy) / 4.f);
  const float decayed = ox * fmaxf(fraction, 0.5f);
  const float nx = decayed + log2f(sample / (1.f - sample));
  *x = fminf(fmaxf(nx, -1000.f), 1000.f);
  *y = ts;
}

// The field's update; OFusion ignores kNoise, as JAX's _field_update does
template <bool kOFusion, bool kNoise = false>
__device__ __forceinline__ void update_field(const FieldArgs& A,
                                             const Proj& p, float ds,
                                             float* x, float* y) {
  if (kOFusion)
    update_ofusion(A, p, ds, x, y);
  else
    update_tsdf<kNoise>(A, p, ds, x, y);
}

}  // namespace se
