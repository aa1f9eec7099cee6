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
//  * icp_track: a frame's whole tracking step in ONE launch of as many
//    16-CTA thread-block clusters of 512 threads as the card holds at
//    once, at most 8 (7 on an H100 SXM: 112 SMs; cudaLaunchKernelEx after
//    cudaOccupancyMaxActiveClusters): the coarse-to-fine Gauss-Newton from
//    the coarsest level to the finest, then check_pose. Per iteration
//    every thread walks its pixels of the level in a grid-stride loop over
//    the whole grid and accumulates the 28 f64 sums of its inliers in
//    pixel order (a rejected pixel's terms are +0.0, which change no sum)
//    and its four counts as integers; each warp reduce-scatters its sums
//    (as icp_reduce) and the CTA adds its warps in index order. Within a
//    cluster each CTA pushes its sums into a slot of every CTA's shared
//    memory (st.async, counted on that CTA's mbarrier; two slots, by the
//    iteration's parity), so no cluster barrier is waited on; each CTA
//    adds the 16 in rank order. Across clusters, rank 0 of each writes
//    its cluster's sums to device memory and counts them with a release;
//    every CTA waits for all of them and adds them in cluster order. Then
//    warp 0 of every CTA runs the same Gauss-Newton step on the same sums
//    (the 6x6 Cholesky in the JAX summation order with its columns spread
//    over the lanes, non-finite -> 0, exp(x) @ pose, ||x|| <
//    icp_threshold), so every CTA holds the same pose and converged flag
//    with no copy. A converged level is left at once: JAX keeps the
//    converging iteration and freezes the rest with where(done), which is
//    the same result without the frozen iterations' work. The finest
//    level's result codes stay in shared memory, a byte a pixel, and are
//    written once from its last iteration. No float atomics anywhere, so
//    two launches on one card are bit-identical.
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
// result map); icp_track ~4.75 MB a frame once (three levels, the
// reference, the level-0 result map), the repeated iterations hitting L2.
// The ~140 flops a pixel-iteration stay below the byte time unless every
// iteration runs. Both are latency-bound at these sizes. icp_reduce's
// pixel pass runs on 16 SMs (two dependent loads a pixel, a few pixels a
// thread, an f32 to f64 conversion and an f64 add a sum of an inlier).
// icp_track's iteration is a chain: the pass (one or two pixels a thread
// on 112 SMs), the warp and CTA sums, the exchanges within and across
// clusters, then the step, whose IEEE square roots and divisions follow
// one another (PERF.md, Findings). icp_track replaces the single device's
// 19 launches a frame and the solve's few hundred torch ops with one
// launch; the sharded frame is 19 icp_reduce launches and one icp_update.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTerms = 32;
constexpr int kSums = 28;      // the f64 sums; the last four terms count
constexpr unsigned kFull = 0xffffffffu;  // every lane of a warp
constexpr int kMaxLevels = 4;   // pyramid levels icp_track takes
// icp_track's clusters: 16 CTAs (a non-portable size, the portable
// maximum is 8) of 512 threads, the fastest of 8/16 CTAs x 512/1024
// threads without register spills on an H100 (PERF.md, Findings)
constexpr int kTrackCluster = 16;
constexpr int kTrackThreads = 512;
// the most bytes of result codes a CTA keeps in shared memory: finest
// levels of up to 16 x 200 KB = 3.2 M pixels
constexpr size_t kTrackMaxCodes = 200 * 1024;
// icp_track launches as many of its clusters as the card holds at once, at
// most kTrackClusters (16 x 8 = 128 SMs); they add their sums through
// device memory (grid_sums, grid_counts): kCounters counters in turn and
// an exit counter
constexpr int kTrackClusters = 8;
constexpr int kCounters = 4;
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

// x = (J^T J)^-1 J^T e (solve_normal_equations): the 6x6 Cholesky with
// every entry's subtractions in JAX's order (kk = 0..j-1), by a whole
// warp, which returns x in every lane; a non-finite x becomes 0, the
// reference's LLT-failure fallback. Lane i < 6 holds row i of the factor
// L and forms its entry of each column: lane j's square root of its own
// row's sum, broadcast, divides the rows below it, so a column costs one
// root and one division in sequence, not one for each row (lanes 6-31
// repeat row 5). Both substitutions then
// run in every lane on the broadcast factor: each of their entries
// subtracts the newest unknown first or last, which leaves no two
// divisions independent. Each entry is the expression of a one-thread
// solve, so x is its bits.
__device__ __forceinline__ void solve6(int lane, const float* red,
                                       float x[6]) {
  const int row = lane < 6 ? lane : 5;
  float Lr[6];  // row `row` of L, zero right of its diagonal
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    // the diagonal from the lane's own row (its root waits on no
    // shuffle), the rows below from row j's broadcast entries
    float diag = jtj(red, row, row);
    float s = jtj(red, row, j);
#pragma unroll
    for (int kk = 0; kk < j; ++kk) {
      diag = diag - Lr[kk] * Lr[kk];
      s = s - Lr[kk] * __shfl_sync(kFull, Lr[kk], j);
    }
    const float d = __shfl_sync(kFull, sqrtf(row == j ? diag : 1.f), j);
    // the rows at or above j divide d by itself: a zero or an odd
    // dividend would send the warp down the division's slow path
    const float q = (row > j ? s : d) / d;
    Lr[j] = row == j ? d : (row > j ? q : 0.f);
  }
  float L[6][6];  // L[r][c], r >= c, in every lane
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int r = c; r < 6; ++r) L[r][c] = __shfl_sync(kFull, Lr[c], r);
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = red[1 + i];
#pragma unroll
    for (int kk = 0; kk < i; ++kk) s = s - L[i][kk] * y[kk];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int kk = i + 1; kk < 6; ++kk) s = s - L[kk][i] * x[kk];
    x[i] = s / L[i][i];
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = 0.f;
  }
}

// One Gauss-Newton step from the reduction (update_pose), by the whole
// warp, every lane on the same sums: the new pose exp(x) @ T (each dot
// summed k = 0..3, as se3.matmul4) into out (lane i < 16 writes entry i;
// out may be T), and whether ||x|| < icp_threshold, in every lane.
__device__ bool gauss_newton_step(int lane, const float* red, const float* T,
                                  float icp_threshold, float* out) {
  float x[6];
  solve6(lane, red, x);
  float E[16];
  se::se3_exp(x, E);
  const int i = (lane >> 2) & 3, j = lane & 3;
  float e0 = 0.f, e1 = 0.f, e2 = 0.f, e3 = 0.f;  // row i of E
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (r == i) {
      e0 = E[r * 4];
      e1 = E[r * 4 + 1];
      e2 = E[r * 4 + 2];
      e3 = E[r * 4 + 3];
    }
  const float v = e0 * T[j] + e1 * T[4 + j] + e2 * T[8 + j] + e3 * T[12 + j];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) ss = ss + x[k] * x[k];
  __syncwarp();  // every lane has read T
  if (lane < 16) out[lane] = v;
  __syncwarp();
  return sqrtf(ss) < icp_threshold;
}

// The shared-memory address of p, and that address in CTA `rank` of the
// cluster.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned in_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Store v at the cluster address dst and count its 8 bytes on the
// mbarrier at the cluster address bar (in the same CTA as dst).
__device__ __forceinline__ void push(unsigned dst, double v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" ::"r"(dst),
      "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}

// Arm this CTA's mbarrier bar for its next phase: it completes once
// `bytes` have been counted on it.
__device__ __forceinline__ void arm(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of this CTA's mbarrier bar with parity `parity`
// has completed.
__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The sum over the clusters, in cluster order, of each cluster's sum of
// term `lane` of iteration q (t, the same in every CTA of a cluster), by
// warp 0 of every CTA: rank 0 of each cluster writes its sums into
// grid_sums' slot q & 1 and counts them on counter q % kCounters; every
// CTA waits until all n_clusters are counted, then reads them back.
// Counter q - 1 is then read no more (every cluster counted q only after
// all its CTAs were past their wait on q - 1): cluster 0 clears it. The
// slot of q is written again at q + 2, after every CTA has read it and
// pushed its sums of q + 1.
__device__ double grid_sum(double t, int q, int cluster_id, int n_clusters,
                           unsigned rank, int lane, double* grid_sums,
                           unsigned* grid_counts) {
  double* slot = grid_sums + (size_t)(q & 1) * kTrackClusters * kTerms;
  unsigned* count = grid_counts + q % kCounters;
  if (rank == 0) {
    slot[cluster_id * kTerms + lane] = t;
    __syncwarp();  // the warp's stores come before lane 0's release
    if (lane == 0)
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count)
                   : "memory");
  }
  unsigned seen;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(seen)
                 : "l"(count)
                 : "memory");
  } while (seen < (unsigned)n_clusters);
  double v[kTrackClusters];  // every cluster's sum, loaded at once
#pragma unroll
  for (int c = 0; c < kTrackClusters; ++c)
    v[c] = c < n_clusters ? __ldcg(&slot[c * kTerms + lane]) : 0.0;
  double s = 0.0;
#pragma unroll
  for (int c = 0; c < kTrackClusters; ++c)
    if (c < n_clusters) s += v[c];
  if (cluster_id == 0 && rank == 0 && lane == 0 && q > 0)
    grid_counts[(q - 1) % kCounters] = 0;
  return s;
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
                 int* __restrict__ iterations_run, double* grid_sums,
                 unsigned* grid_counts) {
  constexpr int kWarps = kTrackThreads / 32;
  __shared__ float T[16], V[16];  // pose estimate, K @ raycast^-1
  // the sums run in f64 and round to f32 once at the end (see the note)
  __shared__ double warp_sums[kWarps][kTerms];
  // every CTA's sums of iteration i, pushed into gathered[i & 1][rank] by
  // the CTA of that rank, and the mbarrier of each slot, which completes
  // when all kPushBytes of the iteration are in. No CTA pushes iteration
  // i + 2 into a slot before it has every CTA's sums of i + 1, which each
  // pushes after reading its slot of i and arming it again
  __shared__ double gathered[2][kTrackCluster][kTerms];
  __shared__ uint64_t arrived[2];
  constexpr unsigned kPushBytes = kTrackCluster * kTerms * sizeof(double);
  // this iteration's reduction (the last one is check_pose's) and the
  // converged flag, the same in every CTA
  __shared__ float red[kTerms];
  __shared__ int done;
  // the finest level's codes of this CTA's pixels, one byte each (pixel
  // first + k * stride at k * kTrackThreads + threadIdx.x), kept from the
  // level's last iteration and written out once
  extern __shared__ int8_t codes[];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int n_clusters = gridDim.x / kTrackCluster;
  const int cluster_id = blockIdx.x / kTrackCluster;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kTrackThreads + threadIdx.x;
  const int stride = gridDim.x * kTrackThreads;

  se::load_mat4(pose_in, T);
  se::load_mat4(view, V);
  if (threadIdx.x < kTerms) red[threadIdx.x] = 0.f;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&arrived[k]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    arm(&arrived[0], kPushBytes);
    arm(&arrived[1], kPushBytes);
  }
  // every CTA has started and armed its slots before any push
  cluster.sync();

  int slot = 0;
  unsigned parity = 0;  // bit k: the parity of slot k's next phase
  int q = 0;            // Gauss-Newton iterations run so far
  for (int level = pyr.n_levels - 1; level >= 0; --level) {
    const float* vert = pyr.vertex[level];
    const float* norm = pyr.normal[level];
    const uint8_t* valid = pyr.valid[level];
    const int n = pyr.h[level] * pyr.w[level];
    int it = 0;
    while (it < pyr.iterations[level]) {
      double acc[kTerms];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
      int n_ok = 0, n_far = 0, n_bad = 0, n_other = 0;
      int8_t* code = codes + threadIdx.x;
      for (int i = first; i < n; i += stride) {
        float z[7];
        const int c = icp_pixel(i, vert, norm, valid, ref_vertex, ref_normal,
                                ref_valid, ref_h, ref_w, T, V,
                                dist_threshold, normal_threshold, z);
        if (level == 0) {
          *code = (int8_t)c;
          code += kTrackThreads;
        }
        if (c == kOk) {
          // a rejected pixel's terms are +0.0, which leave an f64 sum as
          // it is: only an inlier adds
          float t[kTerms];
          pixel_terms(z, c, t);
#pragma unroll
          for (int k = 0; k < kSums; ++k) acc[k] += (double)t[k];
          ++n_ok;
        } else {
          n_far += c == kTooFar;
          n_bad += c == kBadNormal;
          n_other += c > kTooFar;
        }
      }
      // the counts are exact in f64 in any order
      acc[28] = n_ok;
      acc[29] = n_far;
      acc[30] = n_bad;
      acc[31] = n_other;
      warp_sums[warp][lane] = warp_sum_scatter(acc);
      __syncthreads();
      if (warp == 0) {
        // this CTA's sum of term `lane`, its warps in index order, pushed
        // into every CTA's slot
        double s = 0.0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += warp_sums[w][lane];
        const unsigned dst = smem_addr(&gathered[slot][rank][lane]);
        const unsigned bar = smem_addr(&arrived[slot]);
#pragma unroll
        for (int r = 0; r < kTrackCluster; ++r)
          push(in_rank(dst, r), s, in_rank(bar, r));
        // every CTA's sums are in: add them in rank order, as every CTA
        // does, and step alike
        wait_phase(&arrived[slot], (parity >> slot) & 1);
        parity ^= 1u << slot;
        double t = 0.0;
#pragma unroll
        for (int r = 0; r < kTrackCluster; ++r) t += gathered[slot][r][lane];
        __syncwarp();  // the slot is read: arm it for its next iteration
        if (lane == 0) arm(&arrived[slot], kPushBytes);
        if (n_clusters > 1) t = grid_sum(t, q, cluster_id, n_clusters, rank,
                                         lane, grid_sums, grid_counts);
        red[lane] = (float)t;
        __syncwarp();
        const bool now = gauss_newton_step(lane, red, T, icp_threshold, T);
        if (lane == 0) done = now;
      }
      __syncthreads();
      slot ^= 1;
      ++q;
      ++it;
      if (done) break;  // the level's early break
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) iterations_run[level] = it;
    if (level == 0) {
      // the last iteration's codes; none ran: the result map stays zero
      const int8_t* code = codes + threadIdx.x;
      for (int i = first; i < n; i += stride, code += kTrackThreads)
        result[i] = it > 0 ? *code : 0;
    }
  }

  if (blockIdx.x == 0) {
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
  cluster.sync();  // no CTA leaves while another may still push into it
  if (n_clusters > 1 && q > 0 && rank == 0 && threadIdx.x == 0) {
    // every CTA of this cluster is past its last wait; the last cluster
    // out clears the last iteration's counter and the exit counter, so the
    // next launch finds them all zero
    __threadfence();
    if (atomicAdd(&grid_counts[kCounters], 1u) == n_clusters - 1u) {
      grid_counts[(q - 1) % kCounters] = 0;
      grid_counts[kCounters] = 0;
    }
  }
}

// One Gauss-Newton iteration of a multi-device frame, run by one warp
// (its lane index in lane): the reduction the ranks summed (f64, rounded
// here once to f32), the solve, the pose update and the freeze of a
// converged level. Its lanes load and round the 32 sums and run
// icp_track's gauss_newton_step, so a sharded frame and a single one
// solve alike. Leaves the pose in T[16], the reduction kept in keep[32]
// and the flag in *done (shared memory; red is scratch). red_in null
// reads as zeros, done_in null as false (a level's first iteration);
// pose_in is read before anything is written.
__device__ void sharded_update(int lane, const double* __restrict__ red64,
                               const float* pose_in, const float* red_in,
                               const uint8_t* done_in, float icp_threshold,
                               float* red, float* keep, float* T, int* done) {
  // the flag is read with the sums, not after them
  const bool was = __shfl_sync(
      kFull, lane == 0 && done_in != nullptr && *done_in, 0);
  red[lane] = (float)red64[lane];
  keep[lane] = red_in == nullptr ? 0.f : red_in[lane];
  if (lane < 16) T[lane] = pose_in[lane];
  __syncwarp();
  bool now = was;
  if (!was) {  // a converged level keeps its pose and reduction
    now = gauss_newton_step(lane, red, T, icp_threshold, T);
    keep[lane] = red[lane];
  }
  if (lane == 0) *done = now ? 1 : 0;
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

se::ClusterFit track_held[se::kMaxDevices];

// *out: the clusters of an icp_track launch, as many as the card holds at
// once, at most kTrackClusters, asked with the shared memory of one
// cluster's launch over `pixels` finest-level pixels (the most a CTA can
// take), which must not pass kTrackMaxCodes. Returns a cudaError_t, or -1
// when none fits.
int track_clusters(int* out, int pixels) {
  constexpr int kStride = kTrackCluster * kTrackThreads;
  const size_t smem = (size_t)((pixels + kStride - 1) / kStride) *
                      kTrackThreads;
  if (smem > kTrackMaxCodes) return (int)cudaErrorInvalidValue;
  int held = 0;
  const int fits = se::clusters_held(icp_track_kernel, track_held,
                                     kTrackCluster, kTrackThreads, &held,
                                     smem);
  if (fits != 0) return fits;
  *out = held < kTrackClusters ? held : kTrackClusters;
  return 0;
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
  static se::ClusterFit held[se::kMaxDevices];
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
                           int* result, int* iterations_run,
                           double* grid_sums, unsigned* grid_counts,
                           void* stream) {
  if (pyr.n_levels < 1 || pyr.n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  int n_clusters = 0;
  const int fits = track_clusters(&n_clusters, pyr.h[0] * pyr.w[0]);
  if (fits != 0) return fits;
  // a byte a finest-level pixel, each CTA's pixels in its own rows
  const int stride = n_clusters * kTrackCluster * kTrackThreads;
  const size_t smem =
      (size_t)((pyr.h[0] * pyr.w[0] + stride - 1) / stride) * kTrackThreads;
  return se::launch_clusters(icp_track_kernel, track_held, kTrackCluster,
                             kTrackThreads, n_clusters, smem, stream, pyr,
                             ref_vertex, ref_normal, ref_valid, ref_h, ref_w,
                             pose, view, icp_threshold, dist_threshold,
                             normal_threshold, track_threshold, pose_out,
                             tracked_out, reduction_out, result,
                             iterations_run, grid_sums, grid_counts);
}

// The clusters an icp_track launch over a finest level of `pixels` pixels
// takes on the current device (into *out). Returns a cudaError_t, or -1
// when none fits.
SE_EXPORT int se_icp_track_clusters(int pixels, int* out) {
  return track_clusters(out, pixels);
}
