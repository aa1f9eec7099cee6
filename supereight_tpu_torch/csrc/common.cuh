// Shared helpers of the port's CUDA kernels (sm_90a).
//
// The library is built with -fmad=false: every a*b+c stays a separate
// multiply and add, summed left to right, so a kernel reproduces its plain
// PyTorch twin (and the JAX reference, which does not contract either)
// bit for bit wherever no reduction order is involved. Division and sqrt
// are IEEE-rounded (nvcc's default -prec-div/-prec-sqrt).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SE_EXPORT extern "C" __attribute__((visibility("default")))

namespace se {

constexpr int kBlockVoxels = 512;
// devices a launch keeps a per-device setting for (a checked cluster, a
// grid size)
constexpr int kMaxDevices = 16;

// 4x4 row-major transform of a point, summed left to right like the JAX
// package's se3.transform_c: ((T0 x + T1 y) + T2 z) + T3.
__device__ __forceinline__ float3 transform(const float* T, float x, float y,
                                            float z) {
  return make_float3(T[0] * x + T[1] * y + T[2] * z + T[3],
                     T[4] * x + T[5] * y + T[6] * z + T[7],
                     T[8] * x + T[9] * y + T[10] * z + T[11]);
}

__device__ __forceinline__ float3 rotate(const float* T, float x, float y,
                                         float z) {
  return make_float3(T[0] * x + T[1] * y + T[2] * z,
                     T[4] * x + T[5] * y + T[6] * z,
                     T[8] * x + T[9] * y + T[10] * z);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Copy a 4x4 matrix from device memory into shared memory; the caller
// synchronises the block afterwards.
__device__ __forceinline__ void load_mat4(const float* __restrict__ src,
                                          float* dst) {
  if (threadIdx.x < 16) dst[threadIdx.x] = src[threadIdx.x];
}

}  // namespace se
