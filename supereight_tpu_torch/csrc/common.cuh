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

// *sms: the current device's SM count, and *threads (where not null) the
// threads an SM holds at once, queried once a device. Returns a
// cudaError_t.
inline int sm_count(int* sms, int* threads = nullptr) {
  static int count[kMaxDevices], resident[kMaxDevices];
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (count[dev] == 0 &&
      ((err = cudaDeviceGetAttribute(&resident[dev],
                                     cudaDevAttrMaxThreadsPerMultiProcessor,
                                     dev)) != cudaSuccess ||
       (err = cudaDeviceGetAttribute(&count[dev],
                                     cudaDevAttrMultiProcessorCount, dev)) !=
           cudaSuccess))
    return (int)err;
  *sms = count[dev];
  if (threads) *threads = resident[dev];
  return 0;
}

// The launch configuration of `kernel` (no __cluster_dims__) as n_ctas
// CTAs of `threads` threads in clusters of `ctas`, `smem` bytes of dynamic
// shared memory each, on `stream`; attr holds the cluster attribute.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int ctas,
                                         int n_ctas, int threads,
                                         size_t smem, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// What clusters_held found on a device: how many clusters of the
// kernel's shape it holds at once (0: not asked yet) with `smem` bytes of
// dynamic shared memory a CTA.
struct ClusterFit {
  int clusters;
  size_t smem;
};

// *out: how many clusters of `ctas` CTAs of `threads` threads of `kernel`,
// each CTA with `smem` bytes of dynamic shared memory, the current device
// holds at once, queried once a device into held[dev] and again for a
// larger `smem` (sizes above 8 CTAs are allowed as non-portable there, and
// above 48 KB of dynamic shared memory, before any launch). Returns a
// cudaError_t, or -1 when no such cluster fits the card.
template <typename Kernel>
int clusters_held(Kernel kernel, ClusterFit* held, int ctas, int threads,
                  int* out, size_t smem = 0) {
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (held[dev].clusters == 0 || smem > held[dev].smem) {
    if (ctas > 8 &&
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess)
      return (int)err;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(&attr, ctas, ctas, threads, smem, nullptr);
    int c = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&c, kernel, &cfg)) !=
        cudaSuccess)
      return (int)err;
    if (c < 1) return -1;
    held[dev] = ClusterFit{c, smem};
  }
  *out = held[dev].clusters;
  return 0;
}

// Launch `kernel` as n_clusters clusters of `ctas` CTAs of `threads`
// threads, `smem` bytes of dynamic shared memory each, once clusters_held
// (held: its cache) finds that such a cluster fits the card; a caller
// whose CTAs take dynamic shared memory asks clusters_held with its size
// first. Returns a cudaError_t, or -1 when none fits.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, ClusterFit* held, int ctas, int threads,
                    int n_clusters, size_t smem, void* stream,
                    Args... args) {
  int n_held = 0;
  const int fits = clusters_held(kernel, held, ctas, threads, &n_held);
  if (fits != 0) return fits;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      &attr, ctas, ctas * n_clusters, threads, smem, stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// E = exp(x) (core/se3.exp, Sophus layout x = [translation, rotation])
// with the Taylor branch below theta^2 < 1e-8; sums left to right, as
// se3.exp sums them, so the two agree bit for bit on the same twist.
__device__ __forceinline__ void se3_exp(const float x[6], float E[16]) {
  const float wx = x[3], wy = x[4], wz = x[5];
  const float theta_sq = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(theta_sq);
  float a, b, c;  // only the branch taken is computed
  if (theta_sq < 1e-8f) {
    a = 1.f - theta_sq / 6.f;
    b = 0.5f - theta_sq / 24.f;
    c = (float)(1.0 / 6.0) - theta_sq / 120.f;
  } else {
    const float sn = sinf(theta);
    a = sn / theta;
    b = (1.f - cosf(theta)) / (theta * theta);
    c = (theta - sn) / (theta * theta * theta);
  }
  const float W[9] = {0.f, -wz, wy, wz, 0.f, -wx, -wy, wx, 0.f};
  float W2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i * 3 + j] = W[i * 3] * W[j] + W[i * 3 + 1] * W[3 + j] +
                      W[i * 3 + 2] * W[6 + j];
  float Vm[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      E[i * 4 + j] = eye + a * W[i * 3 + j] + b * W2[i * 3 + j];
      Vm[i * 3 + j] = eye + b * W[i * 3 + j] + c * W2[i * 3 + j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    E[i * 4 + 3] = Vm[i * 3] * x[0] + Vm[i * 3 + 1] * x[1] +
                   Vm[i * 3 + 2] * x[2];
  E[12] = 0.f;
  E[13] = 0.f;
  E[14] = 0.f;
  E[15] = 1.f;
}

// Copy a 4x4 matrix from device memory into shared memory; the caller
// synchronises the block afterwards.
__device__ __forceinline__ void load_mat4(const float* __restrict__ src,
                                          float* dst) {
  if (threadIdx.x < 16) dst[threadIdx.x] = src[threadIdx.x];
}

}  // namespace se
