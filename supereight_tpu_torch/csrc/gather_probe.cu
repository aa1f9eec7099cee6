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
//  * D  the dynamic row-slice loop: one CTA per block of kRowsD indices,
//       which it first stages in shared memory (the counterpart of the
//       SMEM index operand), then copies those rows with one thread per
//       column.
// An index outside the table is clamped to its edge (the JAX forms leave
// it undefined; the probe's indices are all in range).
//
// Bound on the H100: bytes. The probe's shapes (f32[512, 128] tables,
// 32k-element outputs) move under 1 MB, which stays in L2: each launch
// costs its few microseconds of launch and latency.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsD = 16;

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

__global__ void __launch_bounds__(kThreads)
gather_d_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                int rows, int n, int cols, float* __restrict__ out) {
  __shared__ int rid[kRowsD];
  const int r0 = blockIdx.x * kRowsD;
  if (threadIdx.x < kRowsD && r0 + (int)threadIdx.x < n)
    rid[threadIdx.x] = clamp_index(idx[r0 + threadIdx.x], rows);
  __syncthreads();
  const int nr = min(kRowsD, n - r0);
  for (int k = 0; k < nr; ++k)
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      out[(size_t)(r0 + k) * cols + c] = table[(size_t)rid[k] * cols + c];
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
  if (n == 0) return 0;
  gather_d_kernel<<<(n + kRowsD - 1) / kRowsD, kThreads, 0,
                    (cudaStream_t)stream>>>(table, idx, rows, n, cols, out);
  return (int)cudaGetLastError();
}
