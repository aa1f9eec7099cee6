// K6: projective ICP, three kernels around one per-pixel body.
//
// Replaces supereight_tpu/ops/tracking.py:track (242-319) with
// track_residuals (56-118), reduce_tracking (125-153), the 6x6 solve
// (168-212), update_pose (215-223) and check_pose (226-237), which XLA
// runs as a packed-row gather, 32 sibling reductions and a scalar solve
// per Gauss-Newton iteration.
//
// The per-pixel body (icp_pixel, pixel_terms): transform the camera-frame
// vertex by the pose estimate, project it into the reference (last
// raycast) image with `view`, fetch the reference vertex/normal/valid,
// apply the five rejection codes in the reference order and form the
// point-to-plane residual, its 6 Jacobian terms and the 32 reduction
// terms: [0] e^2, [1:7] J^T e, [7:28] the upper triangle of J^T J, row
// major, [28:32] the inlier / too-far / bad-normal / other-reject counts.
//
//  * icp_reduce: one level's 32 sums (f64) over a column window of the
//    level (a rank's slice, read in place through the row pitch): one
//    device's 32-vector without the solve, a rank's share of the sharded
//    frame's reduction (parallel/dist_step.py). ONE launch of one
//    thread-block cluster (kReduceCluster CTAs of kReduceThreads threads,
//    the shape checked once a device): every thread walks its pixels in a
//    grid-stride loop and accumulates their 32 terms in f64 registers in
//    pixel order; each warp reduce-scatters them (lane k ends with term k:
//    31 f64 shuffles a warp, against 160 for a shuffle-down tree a term);
//    the CTA adds its warps in index order and writes its partial into
//    CTA rank 0's shared memory (distributed shared memory; one cluster
//    barrier, its arrival made before the pixel pass); rank 0 adds the
//    partials in rank order and writes the f64[32] that the caller
//    all-reduces. The result map is optional (null writes none). No
//    atomics, so two launches are bit-identical. With a step (red64 not
//    null) the launch first runs icp_update's iteration from the ranks'
//    summed reduction of the previous iteration (sharded_update, by warp 0
//    of every CTA on the same inputs, so every CTA steps to the same pose;
//    rank 0 writes the carry) and reduces at the stepped pose; where the
//    stepped level has converged
//    and the next iteration is not its level's first, the pixel pass is
//    skipped and the sums are zeros, which the next update ignores (JAX
//    freezes such an iteration with where(done)). So a sharded iteration
//    is one launch and one all_reduce.
//  * icp_update: one Gauss-Newton iteration of the sharded frame from the
//    ranks' summed reduction, in one warp (sharded_update and, last,
//    check_pose): the frame's last iteration, after its last all_reduce.
//  * icp_track: a frame's whole tracking step in ONE launch of one
//    thread-block cluster (CTAs on neighbouring SMs that read each other's
//    shared memory; 16 CTAs of 512 threads, launched with
//    cudaLaunchKernelEx after cudaOccupancyMaxActiveClusters confirms the
//    shape fits): the coarse-to-fine Gauss-Newton from the coarsest level
//    to the finest, then check_pose. Per iteration every thread walks its
//    pixels of the level in a grid-stride loop and accumulates the 32
//    terms in pixel order; the CTA reduces them in a fixed order (warp
//    shuffle, then its warps in index order); cluster.sync(); CTA rank 0
//    sums the ranks' partials in rank order through distributed shared
//    memory; one warp of rank 0 solves the 6x6 system (Cholesky in the JAX
//    summation order, non-finite -> 0), applies exp(x) @ pose and tests
//    ||x|| < icp_threshold; after a second cluster.sync() every CTA copies
//    the new pose and the converged flag from rank 0. A converged level is
//    left at once: JAX keeps the converging iteration and freezes the rest
//    with where(done), which is the same result without the frozen
//    iterations' work. No float atomics anywhere, so two launches are
//    bit-identical.
//
// The kernels sum the f32 per-pixel terms in f64 and round each of the 32
// sums to f32 once, and so does their twin (kernels/icp.py
// reduce_tracking). With f32 sums the two orders (this kernel's and
// torch.sum's) differ in the last bits; near convergence J^T e cancels to
// almost nothing, the difference moved the pose by a few ulps and flipped
// a few pixels' reference lookups, and at the last frame of a 43-frame
// slice a J^T e entry differed by 1.6e-3 of its scale (PERF.md, Findings).
// Rounded once from f64, both sides get the same f32 sums and the same
// trajectory.
//
// Bound on the H100: bytes. icp_reduce moves ~0.96 MB over a rank's
// window of the finest level (19,200 pixels of 25 B, each gathering at
// most one 25 B reference pixel, 256 B of sums; 4 B a pixel more with a
// result map); icp_track
// ~4.75 MB a frame once (three levels, the reference, the level-0 result
// map), the repeated iterations hitting L2. The ~140 flops a
// pixel-iteration stay below the byte time unless every iteration runs.
// Both are latency-bound at these sizes: the pixel passes on 16 SMs (two
// dependent loads a pixel, a few pixels a thread), the cluster barriers,
// the one-thread solve. icp_track replaces the single device's 19 launches
// a frame and the solve's few hundred torch ops with one launch; the
// sharded frame is 19 icp_reduce launches and one icp_update.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTerms = 32;
constexpr int kMaxLevels = 4;   // pyramid levels icp_track takes
// icp_track's cluster: 16 CTAs (a non-portable size, the portable maximum
// is 8) of 512 threads, the fastest of 8/16 CTAs x 512/1024 threads
// without register spills on an H100 (PERF.md, Findings)
constexpr int kTrackCluster = 16;
constexpr int kTrackThreads = 512;
// icp_reduce's cluster: icp_track's shape, the fastest a frame of 16 / 8 /
// 4 CTAs x 512 and 16 / 8 x 256 threads on an H100 (PERF.md, Findings)
constexpr int kReduceCluster = 16;
constexpr int kReduceThreads = 512;

// tracking-status codes (constants.py)
constexpr int kOk = 1, kNoInput = -1, kOutOfFrame = -2, kNoRefNormal = -3,
              kTooFar = -4, kBadNormal = -5;

// per-level pointers and sizes of the input pyramid, finest first, and the
// Gauss-Newton iterations of each level (passed by value)
struct Pyramid {
  const float* vertex[kMaxLevels];
  const float* normal[kMaxLevels];
  const uint8_t* valid[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int iterations[kMaxLevels];
  int n_levels;
};

// Pixel i of a level against the reference maps (track_residuals): returns
// the status code and z = [e, J], zero unless the code is kOk.
__device__ __forceinline__ int icp_pixel(
    int i, const float* __restrict__ in_vertex,
    const float* __restrict__ in_normal, const uint8_t* __restrict__ in_valid,
    const float* __restrict__ ref_vertex, const float* __restrict__ ref_normal,
    const uint8_t* __restrict__ ref_valid, int ref_h, int ref_w,
    const float* T, const float* V, float dist_threshold,
    float normal_threshold, float z[7]) {
  const float ivx = in_vertex[3 * i], ivy = in_vertex[3 * i + 1],
              ivz = in_vertex[3 * i + 2];
  const float3 p = se::transform(T, ivx, ivy, ivz);  // world frame
  const float3 pp = se::transform(V, p.x, p.y, p.z);
  const float safe_z = pp.z == 0.f ? 1.f : pp.z;
  const float proj_px = pp.x / safe_z + 0.5f;
  const float proj_py = pp.y / safe_z + 0.5f;
  const bool in_frame = proj_px >= 0.f && proj_px <= (float)(ref_w - 1) &&
                        proj_py >= 0.f && proj_py <= (float)(ref_h - 1);
  const int rx = se::clampi((int)proj_px, 0, ref_w - 1);
  const int ry = se::clampi((int)proj_py, 0, ref_h - 1);
  const int f = ry * ref_w + rx;
  const float rvx = ref_vertex[3 * f], rvy = ref_vertex[3 * f + 1],
              rvz = ref_vertex[3 * f + 2];
  const float rnx = ref_normal[3 * f], rny = ref_normal[3 * f + 1],
              rnz = ref_normal[3 * f + 2];
  const bool ref_ok = ref_valid[f] != 0;

  const float dx = rvx - p.x, dy = rvy - p.y, dz = rvz - p.z;
  const float3 pn = se::rotate(T, in_normal[3 * i], in_normal[3 * i + 1],
                               in_normal[3 * i + 2]);
  const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
  const float ndot = pn.x * rnx + pn.y * rny + pn.z * rnz;

  // rejection cascade, in reference order (the last check wins)
  int code = kOk;
  if (ndot < normal_threshold) code = kBadNormal;
  if (dist > dist_threshold) code = kTooFar;
  if (!ref_ok) code = kNoRefNormal;
  if (!in_frame) code = kOutOfFrame;
  if (!in_valid[i]) code = kNoInput;

  const bool ok = code == kOk;
  z[0] = ok ? rnx * dx + rny * dy + rnz * dz : 0.f;
  z[1] = ok ? rnx : 0.f;
  z[2] = ok ? rny : 0.f;
  z[3] = ok ? rnz : 0.f;
  z[4] = ok ? p.y * rnz - p.z * rny : 0.f;  // j_rot = vertex x ref normal
  z[5] = ok ? p.z * rnx - p.x * rnz : 0.f;
  z[6] = ok ? p.x * rny - p.y * rnx : 0.f;
  return code;
}

// The 32 reduction terms of one pixel from its z and code.
__device__ __forceinline__ void pixel_terms(const float z[7], int code,
                                            float t[kTerms]) {
  t[0] = z[0] * z[0];
#pragma unroll
  for (int c = 0; c < 6; ++c) t[1 + c] = z[0] * z[1 + c];
  int idx = 7;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = r; c < 6; ++c) t[idx++] = z[1 + r] * z[1 + c];
  }
  t[28] = code == kOk ? 1.f : 0.f;
  t[29] = code == kTooFar ? 1.f : 0.f;
  t[30] = code == kBadNormal ? 1.f : 0.f;
  t[31] = (code < 1 && code > kTooFar) ? 1.f : 0.f;
}

// Sum each of a warp's 32 values v[k] over its lanes (shuffle-down tree);
// lane 0 writes them to out[k].
__device__ __forceinline__ void warp_reduce_terms(const double v[kTerms],
                                                  double* out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    double s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[k] = s;
  }
}

// One step of warp_sum_scatter over a lane's first 2h values: the lane
// keeps the lower or the upper h of them, by its bit h, and adds its
// partner's (lane ^ h) copy of those, into v[0:h).
template <int kHalf>
__device__ __forceinline__ void scatter_step(double v[kTerms], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const double send = upper ? v[k] : v[k + kHalf];
    const double keep = upper ? v[k + kHalf] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// Sum each of a warp's 32 values v[k] over its lanes by reduce-scatter:
// at each step a lane keeps half of its values and adds its partner's
// copy of them, so lane k returns the sum of v[k] over the warp, in a
// fixed order, after 16 + 8 + 4 + 2 + 1 shuffles. v is scratch.
__device__ __forceinline__ double warp_sum_scatter(double v[kTerms]) {
  const int lane = threadIdx.x & 31;
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  return v[0];
}

// A[r][c] of the symmetric J^T J held as the row-major upper triangle in
// red[7:28] (makeJTJ).
__device__ __forceinline__ float jtj(const float* red, int r, int c) {
  const int a = r < c ? r : c, b = r < c ? c : r;
  return red[7 + 6 * a - (a * (a - 1)) / 2 + b - a];
}

// x = (J^T J)^-1 J^T e (solve_normal_equations): the unrolled 6x6
// Cholesky with every entry's subtractions in JAX's order (kk = 0..j-1),
// in one thread's registers; a non-finite x becomes 0, the reference's
// LLT-failure fallback.
__device__ __forceinline__ void solve6(const float* red, float x[6]) {
  float L[36];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = jtj(red, i, j);
#pragma unroll
      for (int kk = 0; kk < j; ++kk) s = s - L[i * 6 + kk] * L[j * 6 + kk];
      L[i * 6 + j] = i == j ? sqrtf(s) : s / L[j * 6 + j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = red[1 + i];
#pragma unroll
    for (int kk = 0; kk < i; ++kk) s = s - L[i * 6 + kk] * y[kk];
    y[i] = s / L[i * 6 + i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int kk = i + 1; kk < 6; ++kk) s = s - L[kk * 6 + i] * x[kk];
    x[i] = s / L[i * 6 + i];
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = 0.f;
  }
}

// E = exp(x) (se3.exp, Sophus layout x = [translation, rotation]) with the
// Taylor branch below theta^2 < 1e-8; sums left to right.
__device__ void se3_exp(const float x[6], float E[16]) {
  const float wx = x[3], wy = x[4], wz = x[5];
  const float theta_sq = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(theta_sq);
  const bool small = theta_sq < 1e-8f;
  const float th = small ? 1.f : theta;
  const float a = small ? 1.f - theta_sq / 6.f : sinf(th) / th;
  const float b = small ? 0.5f - theta_sq / 24.f
                        : (1.f - cosf(th)) / (th * th);
  const float c = small ? (float)(1.0 / 6.0) - theta_sq / 120.f
                        : (th - sinf(th)) / (th * th * th);
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

// One Gauss-Newton step from the reduction (update_pose): the new pose
// exp(x) @ T (each dot summed k = 0..3, as se3.matmul4) into out, and
// whether ||x|| < icp_threshold.
__device__ bool gauss_newton_step(const float* red, const float* T,
                                  float icp_threshold, float* out) {
  float x[6];
  solve6(red, x);
  float E[16];
  se3_exp(x, E);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[i * 4 + j] = E[i * 4] * T[j] + E[i * 4 + 1] * T[4 + j] +
                       E[i * 4 + 2] * T[8 + j] + E[i * 4 + 3] * T[12 + j];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) ss = ss + x[i] * x[i];
  return sqrtf(ss) < icp_threshold;
}

__global__ void __launch_bounds__(kTrackThreads, 1)
icp_track_kernel(Pyramid pyr, const float* __restrict__ ref_vertex,
                 const float* __restrict__ ref_normal,
                 const uint8_t* __restrict__ ref_valid, int ref_h, int ref_w,
                 const float* __restrict__ pose_in,
                 const float* __restrict__ view, float icp_threshold,
                 float dist_threshold, float normal_threshold,
                 float track_threshold, float* __restrict__ pose_out,
                 uint8_t* __restrict__ tracked_out,
                 float* __restrict__ reduction_out, int* __restrict__ result,
                 int* __restrict__ iterations_run) {
  constexpr int kWarps = kTrackThreads / 32;
  __shared__ float T[16], V[16];          // pose estimate, K @ raycast^-1
  // the sums run in f64 and round to f32 once at the end (see the note)
  __shared__ double warp_sums[kWarps][kTerms];
  __shared__ double partial[kTerms];      // this CTA's sum (read by rank 0)
  __shared__ int done;                    // this CTA's copy of the flag
  // rank 0 only: this iteration's reduction (the last one is check_pose's),
  // the pose after the step, the converged flag
  __shared__ float red[kTerms];
  __shared__ float next_pose[16];
  __shared__ int next_done;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned n_cta = cluster.num_blocks();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = rank * kTrackThreads + threadIdx.x;
  const int stride = n_cta * kTrackThreads;

  se::load_mat4(pose_in, T);
  se::load_mat4(view, V);
  if (threadIdx.x < kTerms) red[threadIdx.x] = 0.f;
  __syncthreads();

  for (int level = pyr.n_levels - 1; level >= 0; --level) {
    const float* vert = pyr.vertex[level];
    const float* norm = pyr.normal[level];
    const uint8_t* valid = pyr.valid[level];
    const int n = pyr.h[level] * pyr.w[level];
    int it = 0;
    while (it < pyr.iterations[level]) {
      double acc[kTerms];
#pragma unroll
      for (int k = 0; k < kTerms; ++k) acc[k] = 0.0;
      for (int i = first; i < n; i += stride) {
        float z[7];
        const int code = icp_pixel(i, vert, norm, valid, ref_vertex,
                                   ref_normal, ref_valid, ref_h, ref_w, T, V,
                                   dist_threshold, normal_threshold, z);
        if (level == 0) result[i] = code;
        float t[kTerms];
        pixel_terms(z, code, t);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) acc[k] += (double)t[k];
      }
      warp_reduce_terms(acc, warp_sums[warp]);
      __syncthreads();
      if (threadIdx.x < kTerms) {
        double s = 0.0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
        partial[threadIdx.x] = s;
      }
      cluster.sync();  // every CTA's partial is written
      if (rank == 0 && warp == 0) {
        double s = 0.0;
        for (unsigned r = 0; r < n_cta; ++r)
          s += cluster.map_shared_rank(&partial[0], r)[lane];
        red[lane] = (float)s;
        __syncwarp();
        if (lane == 0)
          next_done = gauss_newton_step(red, T, icp_threshold, next_pose);
      }
      cluster.sync();  // rank 0's pose and flag are written
      if (threadIdx.x < 16) {
        const float* pose0 = cluster.map_shared_rank(&next_pose[0], 0);
        T[threadIdx.x] = pose0[threadIdx.x];
      }
      if (threadIdx.x == 0) done = *cluster.map_shared_rank(&next_done, 0);
      __syncthreads();
      ++it;
      if (done) break;  // the reference's per-level early break
    }
    if (rank == 0 && threadIdx.x == 0) iterations_run[level] = it;
  }

  if (pyr.n_levels > 0 && pyr.iterations[0] == 0) {
    // no iteration ran at the finest level: its result map stays zero
    for (int i = first; i < pyr.h[0] * pyr.w[0]; i += stride) result[i] = 0;
  }
  if (rank == 0) {
    // check_pose: keep the tracked pose or roll back to the input pose
    const float n_in = red[28];
    const float rms = sqrtf(red[0] / (n_in == 0.f ? 1.f : n_in));
    const float total = (float)(ref_h * ref_w);
    const bool bad = rms > 2e-2f || n_in / total < track_threshold ||
                     n_in == 0.f;
    if (threadIdx.x < 16)
      pose_out[threadIdx.x] = bad ? pose_in[threadIdx.x] : T[threadIdx.x];
    if (threadIdx.x < kTerms) reduction_out[threadIdx.x] = red[threadIdx.x];
    if (threadIdx.x == 0) tracked_out[0] = bad ? 0 : 1;
  }
  cluster.sync();  // no CTA leaves while another may still read its smem
}

// One Gauss-Newton iteration of a multi-device frame, run by one warp
// (its lane index in lane): the reduction the ranks summed (f64, rounded
// here once to f32), the solve, the pose update and the freeze of a
// converged level. Its lanes load and round the 32 sums, lane 0 runs the
// code icp_track's rank 0 runs (gauss_newton_step, the same solve6), so a
// sharded frame and a single one solve alike. Leaves the pose in T[16],
// the reduction kept in keep[32] and the flag in *done (shared memory; red
// is scratch). red_in null reads as zeros, done_in null as false (a
// level's first iteration); pose_in is read before anything is written.
__device__ void sharded_update(int lane, const double* __restrict__ red64,
                               const float* pose_in, const float* red_in,
                               const uint8_t* done_in, float icp_threshold,
                               float* red, float* keep, float* T, int* done) {
  // the flag is read with the sums, not after them
  const bool was = lane == 0 && done_in != nullptr && *done_in;
  red[lane] = (float)red64[lane];
  keep[lane] = red_in == nullptr ? 0.f : red_in[lane];
  if (lane < 16) T[lane] = pose_in[lane];
  __syncwarp();
  if (lane == 0) {
    bool now = was;
    if (!was) {  // a converged level keeps its pose and reduction
      float next[16];
      now = gauss_newton_step(red, T, icp_threshold, next);
      for (int i = 0; i < 16; ++i) T[i] = next[i];
    }
    *done = now ? 1 : 0;
  }
  if (!__shfl_sync(0xffffffffu, was, 0)) keep[lane] = red[lane];
  __syncwarp();
}

// One Gauss-Newton iteration of a sharded frame in its own launch
// (icp_update; the path runs the frame's last one so): sharded_update and,
// on the frame's last call, check_pose against the frame's old pose.
// pose_in may be pose_out; old_pose, checked and tracked are null but on
// the frame's last call.
__global__ void __launch_bounds__(32)
icp_update_kernel(const double* __restrict__ red64,
                  const float* pose_in, const float* red_in,
                  const uint8_t* done_in, float* pose_out, float* red_out,
                  uint8_t* done_out, float icp_threshold,
                  const float* __restrict__ old_pose, float track_threshold,
                  int ref_h, int ref_w, float* __restrict__ checked,
                  uint8_t* __restrict__ tracked) {
  __shared__ float red[kTerms], keep[kTerms], T[16];
  __shared__ int done;
  const int lane = threadIdx.x;
  sharded_update(lane, red64, pose_in, red_in, done_in, icp_threshold, red,
                 keep, T, &done);
  if (lane == 0) *done_out = (uint8_t)done;
  if (lane < 16) pose_out[lane] = T[lane];
  red_out[lane] = keep[lane];
  if (old_pose == nullptr) return;
  // check_pose, as icp_track's ending
  const float n_in = keep[28];
  const float rms = sqrtf(keep[0] / (n_in == 0.f ? 1.f : n_in));
  const float total = (float)(ref_h * ref_w);
  const bool bad = rms > 2e-2f || n_in / total < track_threshold ||
                   n_in == 0.f;
  if (lane < 16) checked[lane] = bad ? old_pose[lane] : T[lane];
  if (lane == 0) *tracked = bad ? 0 : 1;
}

// The previous iteration's update folded into a launch of icp_reduce
// (sharded_update's inputs, the carry it writes, and whether the iteration
// this launch reduces is the first of its level); red64 null: no step.
struct Step {
  const double* red64;
  const float* red_in;
  const uint8_t* done_in;
  float* pose_out;
  float* red_out;
  uint8_t* done_out;
  float icp_threshold;
  int next_first;
};

__global__ void __launch_bounds__(kReduceThreads, 1)
icp_reduce_kernel(const float* __restrict__ in_vertex,
                  const float* __restrict__ in_normal,
                  const uint8_t* __restrict__ in_valid, int n, int w_win,
                  int pitch, int x0, const float* __restrict__ ref_vertex,
                  const float* __restrict__ ref_normal,
                  const uint8_t* __restrict__ ref_valid, int ref_h, int ref_w,
                  const float* __restrict__ pose,
                  const float* __restrict__ view, float dist_threshold,
                  float normal_threshold, int* __restrict__ result,
                  double* __restrict__ out, Step step) {
  constexpr int kWarps = kReduceThreads / 32;
  __shared__ float T[16], V[16];  // the pose reduced at, K @ raycast^-1
  __shared__ float red[kTerms], keep[kTerms];  // the step's
  __shared__ int done;
  __shared__ double warp_sums[kWarps][kTerms];
  // rank 0's: every rank's sums, written by each rank into rank 0's copy
  __shared__ double gathered[kReduceCluster][kTerms];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = rank * kReduceThreads + threadIdx.x;
  constexpr int kStride = kReduceCluster * kReduceThreads;

  se::load_mat4(view, V);
  if (step.red64 == nullptr) {
    se::load_mat4(pose, T);
    if (threadIdx.x == 0) done = 0;
  } else if (warp == 0) {
    sharded_update(lane, step.red64, pose, step.red_in, step.done_in,
                   step.icp_threshold, red, keep, T, &done);
    if (rank == 0) {
      if (lane < 16) step.pose_out[lane] = T[lane];
      step.red_out[lane] = keep[lane];
      if (lane == 0) *step.done_out = (uint8_t)done;
    }
  }
  __syncthreads();
  if (done && !step.next_first) {
    // a frozen iteration: its sums are never read (every CTA returns
    // here, before any cluster barrier)
    if (rank == 0 && threadIdx.x < kTerms) out[threadIdx.x] = 0.0;
    return;
  }

  double acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0;
  // arrive now, wait before writing into rank 0's shared memory: by then
  // every CTA of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  for (int i = first; i < n; i += kStride) {
    // pixel i of the window: row i / w_win, image column x0 + i % w_win
    const int row = i / w_win;
    const int src = row * pitch + x0 + (i - row * w_win);
    float z[7];
    const int code = icp_pixel(src, in_vertex, in_normal, in_valid,
                               ref_vertex, ref_normal, ref_valid, ref_h,
                               ref_w, T, V, dist_threshold, normal_threshold,
                               z);
    if (result != nullptr) result[i] = code;
    float t[kTerms];
    pixel_terms(z, code, t);
#pragma unroll
    for (int k = 0; k < kTerms; ++k) acc[k] += (double)t[k];
  }
  warp_sums[warp][lane] = warp_sum_scatter(acc);
  __syncthreads();
  double cta = 0.0;  // this CTA's sum of term threadIdx.x
  if (threadIdx.x < kTerms) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) cta += warp_sums[w][threadIdx.x];
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (threadIdx.x < kTerms)
    cluster.map_shared_rank(&gathered[0][0], 0)[rank * kTerms + threadIdx.x] =
        cta;
  cluster.sync();  // every rank's partial is in rank 0's gathered
  if (rank == 0 && warp == 0) {
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < kReduceCluster; ++r) s += gathered[r][lane];
    out[lane] = s;
  }
  // the other CTAs may leave: rank 0 reads only its own shared memory
}

}  // namespace

// One Gauss-Newton iteration from a cross-device f64 reduction (see
// icp_update_kernel).
SE_EXPORT int se_icp_update(const double* red64, const float* pose_in,
                            const float* red_in, const uint8_t* done_in,
                            float* pose_out, float* red_out,
                            uint8_t* done_out, float icp_threshold,
                            const float* old_pose, float track_threshold,
                            int ref_h, int ref_w, float* checked,
                            uint8_t* tracked, void* stream) {
  icp_update_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      red64, pose_in, red_in, done_in, pose_out, red_out, done_out,
      icp_threshold, old_pose, track_threshold, ref_h, ref_w, checked,
      tracked);
  return (int)cudaGetLastError();
}

// The level's columns [x0, x0 + w_win) of its rows of `pitch` pixels
// (n = rows x w_win; the whole level is x0 = 0, w_win = pitch) at `pose`,
// or, with a step, at the pose stepped from it: the 32 f64 sums into out
// and, unless result is null, the window's codes [rows, w_win]. One cluster
// of kReduceCluster CTAs of kReduceThreads threads. Returns a cudaError_t,
// or -1 when no such cluster fits the card.
SE_EXPORT int se_icp_reduce(const float* in_vertex, const float* in_normal,
                            const uint8_t* in_valid, int n, int w_win,
                            int pitch, int x0,
                            const float* ref_vertex, const float* ref_normal,
                            const uint8_t* ref_valid, int ref_h, int ref_w,
                            const float* pose, const float* view,
                            float dist_threshold, float normal_threshold,
                            int* result, double* out, Step step,
                            void* stream) {
  static int held[se::kMaxDevices];  // clusters a device holds, 0: unknown
  return se::launch_clusters(icp_reduce_kernel, held, kReduceCluster,
                             kReduceThreads, 1, 0, stream, in_vertex,
                             in_normal, in_valid, n, w_win, pitch, x0,
                             ref_vertex, ref_normal, ref_valid, ref_h, ref_w,
                             pose, view, dist_threshold, normal_threshold,
                             result, out, step);
}

// The whole tracking step of a frame: one cluster of kTrackCluster CTAs of
// kTrackThreads threads. Writes the checked pose f32[16], the tracked
// flag, the last reduction f32[32], the finest level's result map and the
// iterations run at each level. Returns a cudaError_t, or -1 when no such
// cluster fits the card.
SE_EXPORT int se_icp_track(Pyramid pyr, const float* ref_vertex,
                           const float* ref_normal, const uint8_t* ref_valid,
                           int ref_h, int ref_w, const float* pose,
                           const float* view, float icp_threshold,
                           float dist_threshold, float normal_threshold,
                           float track_threshold, float* pose_out,
                           uint8_t* tracked_out, float* reduction_out,
                           int* result, int* iterations_run, void* stream) {
  static int held[se::kMaxDevices];  // clusters a device holds, 0: unknown
  if (pyr.n_levels < 1 || pyr.n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  return se::launch_clusters(icp_track_kernel, held, kTrackCluster,
                             kTrackThreads, 1, 0, stream, pyr, ref_vertex,
                             ref_normal, ref_valid, ref_h, ref_w, pose, view,
                             icp_threshold, dist_threshold, normal_threshold,
                             track_threshold, pose_out, tracked_out,
                             reduction_out, result, iterations_run);
}
