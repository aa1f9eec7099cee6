// K8: the gather-form probe, counterpart of the four Pallas kernels of
// tools/probe_pallas_gather.py (formA 25, formB 37, formC 50, formD 66).
//
// On the TPU the probe asked which gather forms Pallas lowers inside a
// kernel with every operand in VMEM (form D with its indices in SMEM). On
// Hopper each form is a plain copy kernel:
//  * A  take(table, idx, axis=0), a row gather, out[n, c] =
//       table[idx[n], c], and
//  * B  take_along_axis(table, idx, axis=0), out[n, c] =
//       table[idx[n, c], c], share one layout (copy_rows): output row n
//       has 1 << shift lanes, the least power of two at or above its
//       units, or fewer where the card could not hold that grid at once,
//       so a lane finds its row and first unit with a shift and a mask (no
//       division) and the launch is one wave, each lane walking its row's
//       units `lanes` apart (at a width that is not a power of two some
//       lanes have no unit). A's
//       unit is a float4 (a float where a row is not a whole number of
//       them or a pointer is not 16-byte aligned), and a row's lanes read
//       its index once (the same word, one request) through the
//       read-only path; B's unit is one float: its index, then its table
//       element, then its store. At the brick pool's shapes
//       (tools/probe_gather.py --time, PERF.md) the one wave is what
//       pays: a lane per unit over the whole grid (four waves) took B
//       from 57 to 103 us and A from 7.1 to 8.2, half a wave 61 and 8.0;
//       four floats a B thread (an int4 index, four table reads in
//       flight, one float4 store) 74 us. At the probe's
//       shapes every layout tried is within a timer tick of 1.57 us for
//       B: its 32k reads from random rows, a 32-byte sector each, are its
//       cost above the index's round trip (1.15).
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
// costs its microsecond of launch and its latency. At the brick pool's A
// moves 33.6 MB (~10 us at 3.35 TB/s; its rows cold, 10.3 us), and each
// of B's 4.2 M reads takes a 32-byte sector of a random row for its 4
// bytes, which no layout avoids. The bulk-copy engine (a row into shared
// memory on an mbarrier and out again) was slower for A at both shapes,
// as were two float4 a lane a step and the index shuffled from one lane.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinThreads = 64;
constexpr int kThreadsD = 128;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return se::clampi(i, 0, n - 1);
}

// A's and B's body: output row r's `1 << shift` lanes copy its units (V:
// float4 or float), lane l the units l, l + lanes, ... kAlong: B (a float
// a unit), element c from table row idx[r, c]; else A, the whole row
// idx[r].
template <typename V, bool kAlong>
__device__ __forceinline__ void copy_rows(const float* __restrict__ table,
                                          const int* __restrict__ idx,
                                          int rows, int n, int cols,
                                          int shift,
                                          float* __restrict__ out) {
  constexpr int W = sizeof(V) / sizeof(float);
  static_assert(!kAlong || W == 1, "B reads a float a unit");
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r = (int)(g >> shift);
  if (r >= n) return;
  const int lanes = 1 << shift;
  const size_t row = (size_t)r * cols;
  const float* src = table;
  if constexpr (!kAlong)
    src += (size_t)clamp_index(__ldg(idx + r), rows) * cols;
  for (int c = (int)(g & (lanes - 1)) * W; c < cols; c += lanes * W) {
    if constexpr (kAlong)
      out[row + c] = __ldg(
          table + (size_t)clamp_index(__ldg(idx + row + c), rows) * cols + c);
    else
      *reinterpret_cast<V*>(out + row + c) =
          __ldg(reinterpret_cast<const V*>(src + c));
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_a_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                int rows, int n, int cols, int shift,
                float* __restrict__ out) {
  copy_rows<V, false>(table, idx, rows, n, cols, shift, out);
}

__global__ void __launch_bounds__(kThreads)
gather_b_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                int rows, int n, int cols, int shift,
                float* __restrict__ out) {
  copy_rows<float, true>(table, idx, rows, n, cols, shift, out);
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

// A's and B's launch: 1 << shift lanes a row, the least power of two at
// or above its units of `w` floats, halved while the grid is more
// threads than the card holds at once (its SMs' resident threads, as the
// device reports them; down to one lane), in CTAs of the most threads (kThreads halving
// down to kMinThreads) that still give half the SMs a CTA
template <typename Kernel>
int launch_rows(Kernel kernel, int w, const float* table, const int* idx,
                int rows, int n, int cols, float* out, void* stream) {
  int sms = 0, per_sm = 0;
  if (const int err = se::sm_count(&sms, &per_sm)) return err;
  const long long held = (long long)per_sm * sms;
  int shift = 0;
  while ((1 << shift) < cols / w && ((long long)n << (shift + 1)) <= held)
    ++shift;
  const long long total = (long long)n << shift;
  int t = kThreads;
  while (t > kMinThreads && (total + t - 1) / t < sms / 2) t /= 2;
  kernel<<<(int)((total + t - 1) / t), t, 0, (cudaStream_t)stream>>>(
      table, idx, rows, n, cols, shift, out);
  return (int)cudaGetLastError();
}

}  // namespace

SE_EXPORT int se_gather_a(const float* table, const int* idx, int rows,
                          int n, int cols, float* out, void* stream) {
  if (n * cols == 0) return 0;
  if (cols % 4 == 0 && (((uintptr_t)table | (uintptr_t)out) & 15) == 0)
    return launch_rows(gather_a_kernel<float4>, 4, table, idx, rows, n, cols,
                       out, stream);
  return launch_rows(gather_a_kernel<float>, 1, table, idx, rows, n, cols,
                     out, stream);
}

SE_EXPORT int se_gather_b(const float* table, const int* idx, int rows,
                          int n, int cols, float* out, void* stream) {
  if (n * cols == 0) return 0;
  return launch_rows(gather_b_kernel, 1, table, idx, rows, n, cols, out,
                     stream);
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
