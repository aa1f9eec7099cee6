// Ordered stream compaction over one thread-block cluster, shared by K3's
// worklist and the halo's pack (integrate.cu), K4's parent rank (node.cu)
// and K5's bump allocator (alloc.cu).
//
// The items [0, n) are cut into runs of `per` consecutive items (at most
// 32), one run a thread, in thread order over the cluster's CTAs, so that
// thread order is item order. A thread tests its run into a bit mask (the
// run's loads are independent and all in flight at once), the CTA scans its
// threads' counts (warp shuffles, then the warps' totals in index order),
// each CTA adds the totals of the lower-ranked CTAs through distributed
// shared memory, and each thread then emits its flagged items with
// consecutive ranks. The ranks are those of a sequential scan in item
// order, with no atomics, so every launch gives the same result. An n above
// 32 x the cluster's threads takes several passes of the whole cluster.
//
// Why a cluster: one CTA reading the flags of ~10^5 items is bound by its
// one SM's load rate and latency; eight or sixteen CTAs on as many SMs
// share the reads, and the cross-CTA scan is one cluster barrier instead
// of a second launch or a decoupled look-back (which needs scratch flags
// reset every frame).
//
// One cluster barrier a pass: the CTA totals alternate between two shared
// words, so a pass's write cannot meet the previous pass's reads (every
// CTA read those before it arrived at this pass's barrier). The CTAs still
// read each other's shared memory after the last barrier, so a CTA must
// not leave before the others have read its total: the compaction
// arrives at one more cluster barrier once it has read them, and waits
// on it only after the caller's tail (cluster_compact's `tail`), so the
// tail's work overlaps the other CTAs' reads and no caller can leave
// out the wait. That arrival is relaxed, before the last pass's emits: a
// release after them waited for every emitted store to land and cost the
// allocator up to ~1 us (H100 80GB HBM3 at 700 W, PERF.md). Only emits
// that write another CTA's shared memory, which that CTA's tail reads,
// take kSharedEmits: a release arrival after the emits, and the wait
// before the tail.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace se {

// the shape of the worklist's and the parent rank's cluster
constexpr int kCompactCtas = 8;        // the portable cluster size
constexpr int kCompactThreads = 1024;  // threads of each CTA

// Exclusive prefix of v over the CTA's threads in index order; *total gets
// the CTA's sum. Every thread of the CTA calls it (blockDim.x a multiple of
// 32); it synchronises the CTA.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive over the warps
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is free for the next call
  return before + x - v;
}

namespace detail {

// The compaction of cluster_compact up to the arrival at its last
// barrier; returns the count of flagged items.
template <bool kSharedEmits, class RunMask, class Emit>
__device__ __forceinline__ int compact_and_arrive(int n, RunMask run_mask,
                                                  Emit emit) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int cta_total[2];
  const int rank = (int)cluster.block_rank();
  const int n_cta = (int)cluster.num_blocks();
  const int n_threads = n_cta * (int)blockDim.x;
  const int g = rank * (int)blockDim.x + (int)threadIdx.x;
  const int per = max(1, min(32, (n + n_threads - 1) / n_threads));
  int done = 0;  // flagged items of the earlier passes
  for (int p0 = 0, pass = 0; p0 < n; p0 += n_threads * per, ++pass) {
    const int i0 = p0 + g * per;
    const int cnt = max(0, min(per, n - i0));
    const uint32_t mask = cnt > 0 ? run_mask(i0, cnt) : 0u;
    int total;
    const int before = block_exclusive_scan(__popc(mask), &total);
    if (threadIdx.x == 0) cta_total[pass & 1] = total;
    cluster.sync();  // every CTA's total is written
    int below = 0, all = 0;
    for (int r = 0; r < n_cta; ++r) {
      const int t = *cluster.map_shared_rank(&cta_total[pass & 1], r);
      below += r < rank ? t : 0;
      all += t;
    }
    // the last pass: this CTA has read every total (`all` as an operand:
    // the reads have landed before the arrival)
    if (!kSharedEmits && p0 + n_threads * per >= n)
      asm volatile("barrier.cluster.arrive.relaxed;" ::"r"(all) : "memory");
    int k = done + below + before;
    for (uint32_t m = mask; m; m &= m - 1) emit(i0 + __ffs(m) - 1, k++);
    done += all;
  }
  if (n <= 0 && !kSharedEmits)
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  if (kSharedEmits)
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  return done;
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

}  // namespace detail

// Ascending compaction of the items of [0, n) that run_mask flags over
// the CTAs of the calling cluster, then tail(total), total the count of
// flagged items. run_mask(i0, cnt) returns the flags of items i0 .. i0 +
// cnt - 1 as bits 0 .. cnt - 1 (cnt <= 32); emit(i, rank) is called once
// per flagged item with its rank among all flagged items. Every thread of
// the cluster calls it with the same n, once, as the kernel's last step:
// it ends the cluster barrier that keeps each CTA's shared memory alive
// until the others have read it. With kSharedEmits every emit of the
// cluster has landed when tail runs.
template <bool kSharedEmits = false, class RunMask, class Emit, class Tail>
__device__ __forceinline__ void cluster_compact(int n, RunMask run_mask,
                                                Emit emit, Tail tail) {
  const int total =
      detail::compact_and_arrive<kSharedEmits>(n, run_mask, emit);
  if (kSharedEmits) detail::cluster_wait();
  tail(total);
  if (!kSharedEmits) detail::cluster_wait();
}

}  // namespace se
