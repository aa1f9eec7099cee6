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
//  * C  take_along_axis(table, idx, axis=1), a within-row gather,
//       out[n, j] = table[n, idx[n, j]]: every element output row n reads
//       lies in table row n, known before any index arrives. So CTA n
//       (gather_c_kernel) copies that row into shared memory, a float4 a
//       thread, while the same threads load the row's indices, an int4 a
//       thread (a float, an int where a width is not a whole number of
//       them or a pointer is not 16-byte aligned): two coalesced loads
//       with no dependency between them, one barrier, then each thread
//       reads its outputs from shared memory (about 3.5 passes a warp for
//       32 random words over 32 banks) and stores them as it loaded its
//       indices. A row wider than kStageFloats (48 KB) takes the direct
//       body instead (gather_c_kernel_direct): copy_rows with each lane
//       reading table[n, idx] straight from the table. At the brick
//       pool's shapes the stage took a cold launch from 24.2 to 16.7 us,
//       ~90 % of the device-memory rate over the sectors it must read;
//       the loads and barrier alone are 16.7, the direct body 24.6, an
//       int a thread in place of the int4 20.3, one wave of CTAs walking
//       their rows with the next row staged by cp.async 16.6-16.7 and by
//       the bulk-copy engine 17.4. At the probe's every layout is within
//       a tick or two of the parent's 1.38 us.
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
// bytes, which no layout avoids. C's 512 indices a row touch ~324 of its
// 512 elements and nearly every 32-byte sector of it, so the whole row
// staged costs no more device-memory traffic than the random reads: its
// floor is table, index and output, 50.3 MB (15.0 us), above the bound's
// distinct elements (44.2 MB, 13.18 us). The bulk-copy engine (a row into
// shared memory on an mbarrier and out again) was slower for A at both
// shapes, as were two float4 a lane a step and the index shuffled from
// one lane.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinThreads = 64;
constexpr int kThreadsD = 128;
// C's staged body: at most kThreadsC threads a row, and the widest row
// it stages, 48 KB of shared memory (no opt-in attribute needed)
constexpr int kThreadsC = 256;
constexpr int kStageFloats = 12288;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return se::clampi(i, 0, n - 1);
}

// what copy_rows copies: A, the whole row idx[r]; B, element c from
// table row idx[r, c]; C, element idx[r, c] of table row r
enum Form { kRow, kAlong, kWithin };

// A's, B's and C's direct body: output row r's `1 << shift` lanes copy
// its units (V: float4 or float), lane l the units l, l + lanes, ...;
// `rows` is the index's bound, the table's rows (A, B) or width (C)
template <typename V, Form kForm>
__device__ __forceinline__ void copy_rows(const float* __restrict__ table,
                                          const int* __restrict__ idx,
                                          int rows, int n, int cols,
                                          int shift,
                                          float* __restrict__ out) {
  constexpr int W = sizeof(V) / sizeof(float);
  static_assert(kForm == kRow || W == 1, "B and C read a float a unit");
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r = (int)(g >> shift);
  if (r >= n) return;
  const int lanes = 1 << shift;
  const size_t row = (size_t)r * cols;
  const float* src = table;
  if constexpr (kForm == kRow)
    src += (size_t)clamp_index(__ldg(idx + r), rows) * cols;
  for (int c = (int)(g & (lanes - 1)) * W; c < cols; c += lanes * W) {
    if constexpr (kForm == kAlong)
      out[row + c] = __ldg(
          table + (size_t)clamp_index(__ldg(idx + row + c), rows) * cols + c);
    else if constexpr (kForm == kWithin)
      out[row + c] = __ldg(table + (size_t)r * rows +
                           clamp_index(__ldg(idx + row + c), rows));
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
  copy_rows<V, kRow>(table, idx, rows, n, cols, shift, out);
}

__global__ void __launch_bounds__(kThreads)
gather_b_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                int rows, int n, int cols, int shift,
                float* __restrict__ out) {
  copy_rows<float, kAlong>(table, idx, rows, n, cols, shift, out);
}

__global__ void __launch_bounds__(kThreads)
gather_c_kernel_direct(const float* __restrict__ table,
                       const int* __restrict__ idx, int table_cols, int n,
                       int cols, int shift, float* __restrict__ out) {
  copy_rows<float, kWithin>(table, idx, table_cols, n, cols, shift, out);
}

// one output of C's staged body, or four: the staged row's element at
// each clamped index
__device__ __forceinline__ float pick(const float* s, int k, int n) {
  return s[clamp_index(k, n)];
}

__device__ __forceinline__ float4 pick(const float* s, int4 k, int n) {
  return make_float4(pick(s, k.x, n), pick(s, k.y, n), pick(s, k.z, n),
                     pick(s, k.w, n));
}

// C's staged body: CTA r copies table row r into shared memory (VT a
// unit: float4, or float) while each thread loads its first index unit
// of the row (VI: int4, or int); then, after one barrier, a thread stores
// its unit's outputs (VO) from the stage, loading its next unit,
// blockDim.x units on, before it reads the current one's
template <typename VT, typename VI>
__global__ void __launch_bounds__(kThreadsC)
gather_c_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                int table_cols, int cols, float* __restrict__ out) {
  using VO = std::conditional_t<sizeof(VI) == sizeof(int4), float4, float>;
  constexpr int WT = sizeof(VT) / sizeof(float);
  constexpr int WI = sizeof(VI) / sizeof(int);
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const size_t r = blockIdx.x;
  const int units = cols / WI, step = blockDim.x;
  const VI* ind = reinterpret_cast<const VI*>(idx + r * cols);
  int u = threadIdx.x;
  VI k = u < units ? __ldg(ind + u) : VI{};
  const VT* src = reinterpret_cast<const VT*>(table + r * table_cols);
#pragma unroll 4
  for (int c = threadIdx.x; c < table_cols / WT; c += step)
    reinterpret_cast<VT*>(stage)[c] = __ldg(src + c);
  __syncthreads();
  VO* dst = reinterpret_cast<VO*>(out + r * cols);
  for (; u < units; u += step) {
    const VI next = u + step < units ? __ldg(ind + u + step) : VI{};
    dst[u] = pick(stage, k, table_cols);
    k = next;
  }
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

// A's, B's and C's direct launch: 1 << shift lanes a row, the least
// power of two at or above its units of `w` floats, halved while the grid
// is more threads than the card holds at once (its SMs' resident threads,
// as the device reports them; down to one lane), in CTAs of the most
// threads (kThreads halving down to kMinThreads) that still give half the
// SMs a CTA
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

// C's staged launch: one CTA a row, its threads the least multiple of 32
// at or above the row's units of table and of index, up to kThreadsC
template <typename VT, typename VI>
int launch_staged(const float* table, const int* idx, int table_cols, int n,
                  int cols, float* out, void* stream) {
  const int units =
      std::max(table_cols / (int)(sizeof(VT) / sizeof(float)),
               cols / (int)(sizeof(VI) / sizeof(int)));
  const int t = std::min(kThreadsC, (units + 31) / 32 * 32);
  gather_c_kernel<VT, VI><<<n, t, table_cols * sizeof(float),
                           (cudaStream_t)stream>>>(table, idx, table_cols,
                                                   cols, out);
  return (int)cudaGetLastError();
}

SE_EXPORT int se_gather_c(const float* table, const int* idx, int table_cols,
                          int n, int cols, float* out, void* stream) {
  if (n * cols == 0) return 0;
  if (table_cols > kStageFloats)
    return launch_rows(gather_c_kernel_direct, 1, table, idx, table_cols,
                       n, cols, out, stream);
  const bool vt = table_cols % 4 == 0 && ((uintptr_t)table & 15) == 0;
  const bool vi =
      cols % 4 == 0 && (((uintptr_t)idx | (uintptr_t)out) & 15) == 0;
  if (vt && vi)
    return launch_staged<float4, int4>(table, idx, table_cols, n, cols, out,
                                       stream);
  if (vt)
    return launch_staged<float4, int>(table, idx, table_cols, n, cols, out,
                                      stream);
  if (vi)
    return launch_staged<float, int4>(table, idx, table_cols, n, cols, out,
                                      stream);
  return launch_staged<float, int>(table, idx, table_cols, n, cols, out,
                                   stream);
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
