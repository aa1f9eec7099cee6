// K8: the gather-form probe, counterpart of the four Pallas kernels of
// tools/probe_pallas_gather.py (formA 25, formB 37, formC 50, formD 66).
//
// On the TPU the probe asked which gather forms Pallas lowers inside a
// kernel with every operand in VMEM (form D with its indices in SMEM). On
// Hopper each form is a plain copy kernel:
//  * A  take(table, idx, axis=0), a row gather: one thread per output
//       element, out[n, c] = table[idx[n], c];
//  * B  take_along_axis(table, idx, axis=0): one thread per output
//       element, out[n, c] = table[idx[n, c], c];
//  * C  take_along_axis(table, idx, axis=1), a within-row gather: one
//       thread per output element, out[n, j] = table[n, idx[n, j]];
//  * D  the dynamic row-slice loop, the same result as A: the whole grid
//       shares the copy, one thread per 16-byte float4 of the output (per
//       float where a row is not a whole number of float4 or a pointer is
//       not 16-byte aligned), kThreadsD a CTA, each thread reading its
//       row's index itself (a warp's 32 threads read one row's, one
//       sector). The TPU form's SMEM index operand has no counterpart:
//       staging a CTA's indices in shared memory first puts a barrier
//       between the index load and the copy, and measured slower on the
//       H100 (PERF.md).
// An index outside the table is clamped to its edge (the JAX forms leave
// it undefined; the probe's indices are all in range).
//
// Bound on the H100: bytes. The probe's shapes (f32[512, 128] tables,
// 32k-element outputs) move under 1 MB, which stays in L2: each launch
// costs its few microseconds of launch and latency.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kThreadsD = 128;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return se::clampi(i, 0, n - 1);
}

__global__ void __launch_bounds__(kThreads)
gather_a_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                int rows, int n, int cols, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * cols) return;
  const int r = i / cols, c = i - r * cols;
  out[i] = table[(size_t)clamp_index(idx[r], rows) * cols + c];
}

__global__ void __launch_bounds__(kThreads)
gather_b_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                int rows, int n, int cols, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * cols) return;
  const int c = i % cols;
  out[i] = table[(size_t)clamp_index(idx[i], rows) * cols + c];
}

__global__ void __launch_bounds__(kThreads)
gather_c_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                int table_cols, int n, int cols, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * cols) return;
  const int r = i / cols;
  out[i] = table[(size_t)r * table_cols + clamp_index(idx[i], table_cols)];
}

// V: float4, or float where a row is not a whole number of float4 or a
// pointer is not 16-byte aligned
template <typename V>
__global__ void __launch_bounds__(kThreadsD)
gather_d_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                int rows, int n, int cols, float* __restrict__ out) {
  const int per_row = cols / (int)(sizeof(V) / sizeof(float));
  const long long u = (long long)blockIdx.x * kThreadsD + threadIdx.x;
  if (u >= (long long)n * per_row) return;
  const int r = (int)(u / per_row);
  const int c = (int)(u - (long long)r * per_row);
  reinterpret_cast<V*>(out)[u] = reinterpret_cast<const V*>(
      table)[(size_t)clamp_index(__ldg(idx + r), rows) * per_row + c];
}

int grid_of(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

SE_EXPORT int se_gather_a(const float* table, const int* idx, int rows,
                          int n, int cols, float* out, void* stream) {
  if (n * cols == 0) return 0;
  gather_a_kernel<<<grid_of(n * cols), kThreads, 0, (cudaStream_t)stream>>>(
      table, idx, rows, n, cols, out);
  return (int)cudaGetLastError();
}

SE_EXPORT int se_gather_b(const float* table, const int* idx, int rows,
                          int n, int cols, float* out, void* stream) {
  if (n * cols == 0) return 0;
  gather_b_kernel<<<grid_of(n * cols), kThreads, 0, (cudaStream_t)stream>>>(
      table, idx, rows, n, cols, out);
  return (int)cudaGetLastError();
}

SE_EXPORT int se_gather_c(const float* table, const int* idx, int table_cols,
                          int n, int cols, float* out, void* stream) {
  if (n * cols == 0) return 0;
  gather_c_kernel<<<grid_of(n * cols), kThreads, 0, (cudaStream_t)stream>>>(
      table, idx, table_cols, n, cols, out);
  return (int)cudaGetLastError();
}

SE_EXPORT int se_gather_d(const float* table, const int* idx, int rows,
                          int n, int cols, float* out, void* stream) {
  if (n * cols == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = cols % 4 == 0 &&
                   (((uintptr_t)table | (uintptr_t)out) & 15) == 0;
  const long long units = (long long)n * (vec ? cols / 4 : cols);
  const int grid = (int)((units + kThreadsD - 1) / kThreadsD);
  if (vec)
    gather_d_kernel<float4><<<grid, kThreadsD, 0, st>>>(table, idx, rows, n,
                                                        cols, out);
  else
    gather_d_kernel<float><<<grid, kThreadsD, 0, st>>>(table, idx, rows, n,
                                                       cols, out);
  return (int)cudaGetLastError();
}
