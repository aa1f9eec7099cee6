// K9: ba_solve, the windowed pose-graph Gauss-Newton (bundle adjustment)
// in one launch.
//
// Replaces supereight_tpu/posegraph/graph.py:optimize (132-212), which XLA
// compiles once a window size (num_nodes is static) into one program: each
// edge's residual and its jacfwd Jacobians under vmap (152-164), the four
// 6x6 blocks of each edge scatter-added into the 6N x 6N normal matrix H
// (166-194), the gauge mask and damping (196-204), cho_factor / cho_solve
// (205-206) and exp(dx) @ T for every pose (207-211), `iters` times under
// lax.scan. Here n (num_nodes), E (the edge capacity) and iters are
// run-time arguments, so a window that grows between solves costs no new
// build and no new capture.
//
// Two tiers, chosen from n at run time (se_ba_plan), one launch either way:
//  Tier S, one CTA of kThreadsS: H and its right-hand side as one augmented
//    N x (N + 1) square (N = 6n, rows ld floats apart) in shared memory,
//    with the reciprocals of U's diagonal, free6 and the lists' offsets;
//    every window whose square fits the opt-in shared memory (n <= 39 on
//    the H100: the CLI's default window of 32 and the loop's windows);
//  Tier L, one CTA an SM (the count queried once a device): the same
//    square in device memory (L2-resident up to n ~ 590), the phases
//    spread over every CTA, a grid barrier between them (red.release.gpu
//    of a counter, ld.acquire.gpu polled, as icp.cu's). It is a
//    cooperative launch, so the grid starts only with every CTA resident
//    at once (or the launch is refused), and a graph captures it; the
//    counter lies in the call's scratch, zeroed by a memset on the
//    launch's stream just before the kernel (a node of a captured graph),
//    so every launch and every replay starts from zero.
// The phases of a launch (S: __syncthreads between them, L: the barrier):
//  0. once a launch the valid edge slots are compacted in edge order (an
//     index out of range in any slot makes every pose NaN), and each node's
//     incident valid edges listed in edge order: padded slots (the keyframe
//     manager's (0, 0) self-edges) never enter the sums;
//  1. residuals and Jacobians, forward mode: a thread an (edge, column)
//     pair of the valid edges, 12 columns an edge, runs the residual
//     log(T_meas^-1 T_i^-1 T_j) in dual numbers (a value and one tangent) at
//     the zero perturbation with the unit tangent of its column (k < 6 on
//     node i's twist, k >= 6 on node j's), following the value's branch at
//     every select: what the twin's torch.func.jvp over the 12-column basis
//     and JAX's jacfwd compute. Both are scaled by the weight into the
//     scratch (r f32[nv, 6], J f32[nv, 6, 12]). A padded slot adds
//     where(valid, w, 0) = 0 times its terms, which is 0 unless a term is
//     not finite: then JAX's H, and every pose, is NaN. So a thread a padded
//     slot runs its residual's value alone, and where its 48 inputs are
//     finite within +-kTame and the value is finite the slot adds zeros
//     (the tangents are the values' products through divisions that the
//     value path holds off zero: qc >= 0.5 in so3_log's window, nv >= 1e-5,
//     th >= 1e-3 outside them); any other padded slot runs its 12 columns
//     too, and a term that is not finite makes every pose NaN, as in JAX;
//  2. the normal equations, upper triangle and b as column N: zeros, then
//     a warp a node and its blocks with itself and its neighbours, a lane
//     two entries, each summing the (edge, row) terms of the valid edges
//     that touch both nodes in edge order, then the gauge mask and the
//     damping; b = J^T r likewise, times free6. No float atomics, so two
//     launches are bit-identical;
//  3. H = U^T U in place, blocked right-looking by kPanel-row panels, the
//     right-hand side folded in as column N (the forward substitution U^T y
//     = b falls out as U's column N): one warp factors a panel's diagonal
//     block in registers (a lane a column, shuffles between its columns, no
//     barrier), the panel's rows are solved a column a thread against it,
//     and the trailing upper triangle is updated in tiles of 4 rows a warp
//     by kTile columns (a thread 4 rows x 2 columns, __fmaf_rn: K9 is held
//     to a tolerance, not to bits; L stages a tile's panel rows in shared
//     memory first). S: three __syncthreads a panel; L: two barriers a
//     panel, the first CTA updating and factoring the next diagonal block
//     while the others take the tiles. A pivot that is not > 0 (NaN
//     included) fails the factorisation, as LAPACK's potrf does, and the
//     step is NaN, as the twin's where(info == 0, L, nan) and JAX's
//     cho_factor leave it: every pose's top three rows NaN, its bottom row
//     too from the next iteration on (phase 5);
//  4. U x = y from the last panel, kBackPanels a step (S 1, L 4): one warp
//     solves their rows in registers, panel by panel, while the rest apply
//     the last step's panels to the rows above (one barrier a step);
//  5. a thread a node: dx = -x * free6, pose <- exp(dx) @ pose (se3_exp of
//     common.cuh, sums left to right); after a failed iteration dx is NaN
//     for that iteration and the rest.
// No host sync and no allocation, so the launch can be captured in a CUDA
// graph. H is indexed in int32: n <= kIndexNodes (36 n^2 < 2^31).
//
// Bound on the H100: operations, ~2.9k an edge (its residual once, its 12
// columns' nonzero tangents and its terms of H and b) and (6n)^3 / 3 a
// factorisation, `iters` times, over 67 TFLOP/s: microseconds. The launch
// is a chain instead: iters x ceil(6n / 32) panels, each a 32-step pivot
// chain in one warp, a 32-step column solve and barriers (S: three
// __syncthreads; L: two grid barriers), and a 32-step backward panel and
// its barrier (one a step of 4 panels in Tier L); an unblocked factor is
// iters x 6n dependent columns of two block barriers each. At large n the
// trailing updates' (6n)^3 / 3 over the SMs takes over.
//
// Agreement: sums in edge order against the twin's jac.T @ jac, and the
// blocked factorisation's order against LAPACK's or cuSOLVER's, differ in
// the last bits; the poses agree to 1e-5 (tests/test_torch_ba.py,
// chip_smoke.py).

#include "common.cuh"

// SE_MARK(k): a time mark k of tools/ba_windows.py --timeline, whose side
// build defines SE_BA_TIMELINE (CTA 0's thread 0 reads the global timer
// into se_tl_t, k into se_tl_k; se_ba_timeline reads them back); nothing
// in the library's build.
#ifdef SE_BA_TIMELINE
namespace {
constexpr int kMarks = 1 << 16;
__device__ unsigned long long se_tl_t[kMarks];
__device__ int se_tl_k[kMarks];
__device__ int se_tl_n;
}  // namespace
#define SE_MARK(k)                                                 \
  do {                                                            \
    if (blockIdx.x == 0 && threadIdx.x == 0 && se_tl_n < kMarks) { \
      unsigned long long t;                                       \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));       \
      se_tl_t[se_tl_n] = t;                                       \
      se_tl_k[se_tl_n++] = k;                                     \
    }                                                             \
  } while (0)
#else
#define SE_MARK(k) \
  do {             \
  } while (0)
#endif

namespace {

// threads a CTA: Tier S 384 (168 registers a thread), Tier L 256 (up to
// 255); fewer registers spill (ptxas -v), and a CTA of Tier S runs the
// loop windows' dual-number columns and padded slots in one round
constexpr int kThreadsS = 384, kThreadsL = 256;
constexpr int kMaxWarps = kThreadsS / 32;
constexpr int kCols = 12;   // Jacobian columns an edge: x_i's 6, x_j's 6
constexpr int kPanel = 32;  // the factor's panel: one warp's lanes
constexpr int kTile = 64;   // the trailing update's tile: its columns
// and its rows: 4 a warp (tile_rows()); Tier L stages a tile's panel rows
constexpr int kStageL = 4 * kThreadsL / 32 + kTile;
constexpr int kStageLoads = kPanel * kStageL / kThreadsL;  // a thread's
static_assert(kPanel * kStageL % kThreadsL == 0, "stage loads");
// the backward substitution's panels a step: Tier L's barrier costs more
// than its lead's applying them, Tier S's __syncthreads less
template <bool kGrid>
constexpr int kBackPanels = kGrid ? 4 : 1;
// a padded slot whose inputs lie within this and whose residual is finite
// adds zeros (phase 1)
constexpr float kTame = 1024.f;
constexpr int kIndexNodes = 7723;  // 36 n^2 < 2^31: H's int32 indexing
constexpr int kMaxEdges = 1 << 20;
constexpr unsigned kFull = 0xffffffffu;

// ---- dual numbers: a value and one tangent, f32 --------------------------

struct Dual {
  float v, d;
};

__device__ __forceinline__ Dual cst(float v) { return Dual{v, 0.f}; }
__device__ __forceinline__ Dual add(Dual a, Dual b) {
  return Dual{a.v + b.v, a.d + b.d};
}
__device__ __forceinline__ Dual sub(Dual a, Dual b) {
  return Dual{a.v - b.v, a.d - b.d};
}
__device__ __forceinline__ Dual mul(Dual a, Dual b) {
  return Dual{a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual scale(Dual a, float c) {
  return Dual{a.v * c, a.d * c};
}
__device__ __forceinline__ Dual div(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual{q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ Dual neg(Dual a) { return Dual{-a.v, -a.d}; }
__device__ __forceinline__ Dual dsqrt(Dual a) {
  const float s = sqrtf(a.v);
  return Dual{s, a.d / (2.f * s)};
}
__device__ __forceinline__ Dual dsin(Dual a) {
  return Dual{sinf(a.v), cosf(a.v) * a.d};
}
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
  return Dual{atan2f(y.v, x.v),
              (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)};
}

// out = a @ b, 4x4 row-major, each entry summed k = 0..3 left to right
// (se3.matmul4); out may not alias a or b.
__device__ __forceinline__ void matmul4(const Dual* a, const Dual* b,
                                        Dual* out) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      Dual s = mul(a[r * 4], b[c]);
#pragma unroll
      for (int k = 1; k < 4; ++k) s = add(s, mul(a[r * 4 + k], b[k * 4 + c]));
      out[r * 4 + c] = s;
    }
}

// out = T^-1 for a rigid T (se3.inverse): R^T and -(R^T t), R^T t summed
// left to right.
__device__ __forceinline__ void inverse(const Dual* T, Dual* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[r * 4 + c] = T[c * 4 + r];
    Dual s = mul(T[r], T[3]);
    s = add(s, mul(T[4 + r], T[7]));
    s = add(s, mul(T[8 + r], T[11]));
    out[r * 4 + 3] = neg(s);
  }
  out[12] = cst(0.f);
  out[13] = cst(0.f);
  out[14] = cst(0.f);
  out[15] = cst(1.f);
}

// exp(x) @ T at x = 0 with the unit tangent on twist entry k (k < 0: none).
// exp's dual at zero is (I, the generator G_k): the Taylor branch's
// coefficients have zero tangents there, so this is what the dual-number
// se3.exp and matmul4 give, written out: G_k @ T puts T's bottom row
// ((0, 0, 0, 1) for a rigid T) in row k for a translation, and
// hat(e_a) @ T moves rows for a rotation about axis a.
__device__ __forceinline__ void perturbed(const float* T, int k,
                                          Dual* out) {
  // hat(e_a) for a rotation (k = 3 + a): row p gets -T[q], row q gets
  // T[p]. Every entry is chosen, none indexed by k, so that out stays in
  // registers.
  const int a = k - 3, p = (a + 1) % 3, q = (a + 2) % 3;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float d = 0.f;
      if (k >= 3)
        d = r == p ? -T[q * 4 + c] : (r == q ? T[p * 4 + c] : 0.f);
      else if (k >= 0 && r == k)
        d = T[12 + c];
      out[r * 4 + c] = Dual{T[r * 4 + c], d};
    }
}

// Rotation (the top-left 3x3 of the 4x4 M) -> quaternion (w, x, y, z):
// rot_to_quat's branchless Shepperd, only its selected candidate (argmax,
// the first maximum on a tie), with the sign flip to w >= 0.
__device__ __forceinline__ void rot_to_quat(const Dual* M, Dual q[4]) {
  const Dual one = cst(1.f);
  const Dual r00 = M[0], r01 = M[1], r02 = M[2];
  const Dual r10 = M[4], r11 = M[5], r12 = M[6];
  const Dual r20 = M[8], r21 = M[9], r22 = M[10];
  const Dual d[4] = {add(add(add(one, r00), r11), r22),
                     sub(sub(add(one, r00), r11), r22),
                     sub(add(sub(one, r00), r11), r22),
                     add(sub(sub(one, r00), r11), r22)};
  int best = 0;  // no d[best]: indexing by it would put d in local memory
  float dv = d[0].v;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (d[k].v > dv) best = k, dv = d[k].v;
  Dual a, b, c, db = d[0];
  int s0, s1, s2;  // the slots of (half, a, b); c takes the last
  if (best == 0) {
    a = sub(r21, r12), b = sub(r02, r20), c = sub(r10, r01);
    s0 = 0, s1 = 1, s2 = 2;
  } else if (best == 1) {
    db = d[1];
    a = sub(r21, r12), b = add(r01, r10), c = add(r02, r20);
    s0 = 1, s1 = 0, s2 = 2;
  } else if (best == 2) {
    db = d[2];
    a = sub(r02, r20), b = add(r01, r10), c = add(r12, r21);
    s0 = 2, s1 = 0, s2 = 1;
  } else {
    db = d[3];
    a = sub(r10, r01), b = add(r02, r20), c = add(r12, r21);
    s0 = 3, s1 = 0, s2 = 1;
  }
  if (!(db.v >= 1e-12f)) db = cst(1e-12f);  // clamp(min=1e-12)
  const Dual s = dsqrt(db);
  const Dual inv = div(cst(0.5f), s);
  const Dual half = scale(s, 0.5f), va = mul(a, inv), vb = mul(b, inv),
             vc = mul(c, inv);
  Dual out[4];  // each slot chosen, none indexed, as perturbed's
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = k == s0 ? half : (k == s1 ? va : (k == s2 ? vb : vc));
  const bool flip = out[0].v < 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = flip ? neg(out[k]) : out[k];
}

// r = se3_log(M) (translation, rotation) of the 4x4 M: so3_log's
// quaternion route with its Taylor window (nv_sq < 1e-10), then V^-1 t
// with se3_log's (theta_sq < 1e-6).
__device__ __forceinline__ void se3_log(const Dual* M, Dual r[6]) {
  Dual q[4];
  rot_to_quat(M, q);
  const Dual nv_sq =
      add(add(mul(q[1], q[1]), mul(q[2], q[2])), mul(q[3], q[3]));
  Dual f;
  if (nv_sq.v < 1e-10f) {
    const Dual qc = q[0].v >= 1e-6f ? q[0] : cst(1e-6f);  // clamp(min=1e-6)
    f = mul(div(cst(2.f), qc),
            sub(cst(1.f), div(nv_sq, scale(mul(qc, qc), 3.f))));
  } else {
    const Dual nv = dsqrt(nv_sq);
    f = div(scale(datan2(nv, q[0]), 2.f), nv);
  }
  const Dual w[3] = {mul(q[1], f), mul(q[2], f), mul(q[3], f)};
  const Dual theta_sq =
      add(add(mul(w[0], w[0]), mul(w[1], w[1])), mul(w[2], w[2]));
  Dual coef;
  if (theta_sq.v < 1e-6f) {
    coef = add(cst((float)(1.0 / 12.0)), div(theta_sq, cst(720.f)));
  } else {
    const Dual th = dsqrt(theta_sq);
    const Dual sh = dsin(scale(th, 0.5f));
    const Dual th2 = mul(th, th);
    const Dual b = div(mul(scale(sh, 2.f), sh), th2);
    const Dual a = div(dsin(th), th);
    coef = div(sub(cst(1.f), div(a, scale(b, 2.f))), th2);
  }
  const Dual z = cst(0.f);
  const Dual W[9] = {z, neg(w[2]), w[1], w[2], z, neg(w[0]), neg(w[1]), w[0],
                     z};
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    Dual vinv[3];  // row `row` of I - W / 2 + coef W^2
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Dual w2 = mul(W[row * 3], W[c]);
      w2 = add(w2, mul(W[row * 3 + 1], W[3 + c]));
      w2 = add(w2, mul(W[row * 3 + 2], W[6 + c]));
      vinv[c] = add(sub(cst(row == c ? 1.f : 0.f), scale(W[row * 3 + c], 0.5f)),
                    mul(coef, w2));
    }
    Dual v = mul(vinv[0], M[3]);
    v = add(v, mul(vinv[1], M[7]));
    r[row] = add(v, mul(vinv[2], M[11]));
  }
  r[3] = w[0];
  r[4] = w[1];
  r[5] = w[2];
}

// The residual (values) and its Jacobian column k (tangents) of the edge
// (T_i, T_j, T_meas): log(T_meas^-1 (exp(x_i) T_i)^-1 exp(x_j) T_j).
__device__ __forceinline__ void edge_column(const float* ti,
                            const float* tj,
                            const float* tm, int k, Dual r[6]) {
  Dual A[16], B[16], C[16];
  perturbed(ti, k < 6 ? k : -1, A);
  inverse(A, B);                          // (exp(x_i) T_i)^-1
  perturbed(tj, k >= 6 ? k - 6 : -1, A);  // exp(x_j) T_j
  matmul4(B, A, C);                       // rel
#pragma unroll
  for (int x = 0; x < 16; ++x) A[x] = cst(tm[x]);
  inverse(A, B);                          // T_meas^-1
  matmul4(B, C, A);
  se3_log(A, r);
}

// Entry (row k, column ka of node p) of an edge's row of the full
// Jacobian: J_i's column where p is i, J_j's where p is j, their sum for an
// edge from a node to itself (the twin's one-hot incidence sum).
__device__ __forceinline__ float jac_of(const float* Je, int k,
                                        int ka, int i, int j, int p) {
  // both read, then chosen: no branch between a list's loads
  const float* row = Je + k * kCols;
  const float ji = row[ka], jj = row[6 + ka];
  return i == p && j == p ? ji + jj : (i == p ? ji : jj);
}

// ---- the solve's state ----------------------------------------------------

// The kernel's arguments. jac .. inc are device scratch for both tiers;
// H, rd, fr, off and flags are device scratch for Tier L only (Tier S keeps
// them in shared memory).
struct Args {
  const float* __restrict__ poses_in;
  float* poses;
  const int* __restrict__ ei;
  const int* __restrict__ ej;
  const float* __restrict__ t_meas;
  const float* __restrict__ weight;
  const bool* __restrict__ valid;
  const bool* __restrict__ fixed;  // or null
  int n, E, iters;
  float damping;
  float* jac;  // f32[nv, 6, 12], a row of the valid edges in edge order
  float* res;  // f32[nv, 6]
  int* act;    // the valid slots in edge order
  int* inv;    // the padded slots
  int* ci;     // node i of each valid edge, in the same order
  int* cj;
  int* inc;  // node p's valid edges inc[off[p] .. off[p + 1]), in order
  float* H;
  float* rd;
  float* fr;
  int* off;
  int* flags;
  unsigned* bar;  // Tier L: the grid barrier's counter, zero at the launch
};

enum { kNv, kNinv, kBad, kDead, kFlags };

// Where a launch keeps what its phases share.
struct View {
  float* H;   // N x ld, row-major, the upper triangle; column N: b, y, x
  float* rd;  // 1 / U[j][j]
  float* fr;  // free6
  int* off;   // n + 1
  volatile int* flags;
  int* scan;  // kMaxWarps + 1 ints of shared memory
  float* uk;  // Tier L: a panel's diagonal block (kPanel x (kPanel + 1))
              // and its reciprocals, in shared memory
  float* stage;  // Tier L: a tile's panel rows, kPanel x kStageL floats
  int n, N, ld;
};

__host__ __device__ constexpr int row_floats(int N) { return (N + 4) & ~3; }

// ---- the team: a CTA (Tier S) or the grid (Tier L) ------------------------

template <bool kGrid>
struct Team;

template <>
struct Team<false> {
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ bool lead() const { return true; }
  __device__ void sync() { __syncthreads(); }
};

// Every CTA resident at once (one an SM, a cooperative launch); sync() is
// a barrier over the grid on a counter that starts at zero and only grows
// within a launch.
template <>
struct Team<true> {
  unsigned* bar;
  unsigned passed;
  __device__ int rank() const { return blockIdx.x * blockDim.x + threadIdx.x; }
  __device__ int size() const { return gridDim.x * blockDim.x; }
  __device__ bool lead() const { return blockIdx.x == 0; }
  __device__ void sync() {
    __syncthreads();
    passed += gridDim.x;
    if (threadIdx.x == 0) {
      // release: the CTA's writes (ordered before this by the barrier)
      // are seen by every CTA that acquires the count
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar)
                   : "memory");
      unsigned seen;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(seen)
                     : "l"(bar)
                     : "memory");
      } while ((int)(seen - passed) < 0);
    }
    __syncthreads();
  }
};

// Exclusive sum of v over the CTA (every thread calls it); *total gets
// the whole sum. tmp: kMaxWarps + 1 ints of shared memory.
__device__ int block_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // tmp may still be read by an earlier call
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < warps; ++w) {
      const int t = tmp[w];
      tmp[w] = s;
      s += t;
    }
    tmp[kMaxWarps] = s;
  }
  __syncthreads();
  *total = tmp[kMaxWarps];
  return tmp[warp] + x - v;
}

// ---- phase 0: the valid edges and each node's list -----------------------

// By the lead CTA: the valid slots (act, ci, cj) and the padded ones (inv)
// in edge order, a contiguous run of slots a thread; the flags.
__device__ void compact(const Args& a, const View& v) {
  const int per = (a.E + blockDim.x - 1) / blockDim.x;
  const int lo = min(a.E, (int)threadIdx.x * per), hi = min(a.E, lo + per);
  int nvalid = 0, bad = 0;
  for (int e = lo; e < hi; ++e) {
    const int i = a.ei[e], j = a.ej[e];
    bad |= i < 0 || i >= a.n || j < 0 || j >= a.n;
    nvalid += a.valid[e];
  }
  int nv, ninv;
  int pv = block_scan(nvalid, v.scan, &nv);
  int pi = block_scan(hi - lo - nvalid, v.scan, &ninv);
  bad = __syncthreads_or(bad);
  for (int e = lo; e < hi; ++e) {
    if (a.valid[e]) {
      a.act[pv] = e;
      a.ci[pv] = a.ei[e];
      a.cj[pv] = a.ej[e];
      ++pv;
    } else {
      a.inv[pi++] = e;
    }
  }
  if (threadIdx.x == 0) {
    v.flags[kNv] = nv;
    v.flags[kNinv] = ninv;
    v.flags[kBad] = bad;
    v.flags[kDead] = 0;
  }
}

// Node p's valid edges (an edge from a node to itself once) in edge order:
// a thread a node counts, the lead CTA sums the counts into off, a thread a
// node lists. Ends with the team's barrier.
template <bool kGrid>
__device__ void node_lists(Team<kGrid>& team, const Args& a, const View& v,
                           int nv) {
  for (int p = team.rank(); p < a.n; p += team.size()) {
    int c = 0;
    for (int x = 0; x < nv; ++x) c += a.ci[x] == p || a.cj[x] == p;
    v.off[p + 1] = c;
  }
  team.sync();
  SE_MARK(1);
  if (team.lead()) {
    const int per = (a.n + blockDim.x - 1) / blockDim.x;
    const int lo = min(a.n, (int)threadIdx.x * per), hi = min(a.n, lo + per);
    int s = 0;
    for (int p = lo; p < hi; ++p) s += v.off[p + 1];
    int total;
    int at = block_scan(s, v.scan, &total);
    for (int p = lo; p < hi; ++p) {
      at += v.off[p + 1];
      v.off[p + 1] = at;
    }
    if (threadIdx.x == 0) v.off[0] = 0;
  }
  team.sync();
  SE_MARK(2);
  for (int p = team.rank(); p < a.n; p += team.size()) {
    int at = v.off[p];
    for (int x = 0; x < nv; ++x)
      if (a.ci[x] == p || a.cj[x] == p) a.inc[at++] = x;
  }
  team.sync();
  SE_MARK(3);
}

// ---- phase 1: residuals and Jacobian columns ------------------------------

// Whether padded slot e's terms are all finite (phase 1 of the note): its
// residual's value where its inputs are tame, else all 12 columns.
__device__ bool slot_finite(const Args& a, int e) {
  const float* ti = a.poses + 16 * a.ei[e];
  const float* tj = a.poses + 16 * a.ej[e];
  const float* tm = a.t_meas + 16 * e;
  bool tame = true;
  for (int x = 0; x < 16; ++x)
    tame = tame && fabsf(ti[x]) <= kTame && fabsf(tj[x]) <= kTame &&
           fabsf(tm[x]) <= kTame;  // false for NaN
  for (int k = tame ? -1 : 0; k < (tame ? 0 : kCols); ++k) {
    Dual r[6];
    edge_column(ti, tj, tm, k, r);
#pragma unroll
    for (int row = 0; row < 6; ++row)
      if (!isfinite(r[row].v) || !isfinite(r[row].d)) return false;
  }
  return true;
}

template <bool kGrid>
__device__ void dual_pass(Team<kGrid>& team, const Args& a, const View& v,
                          int nv, int ninv) {
  const int cols = nv * kCols;
  for (int t = team.rank(); t < cols + ninv; t += team.size()) {
    if (t < cols) {
      const int x = t / kCols, k = t - x * kCols, e = a.act[x];
      Dual r[6];
      edge_column(a.poses + 16 * a.ci[x], a.poses + 16 * a.cj[x],
                  a.t_meas + 16 * e, k, r);
      const float s = a.weight[e];
#pragma unroll
      for (int row = 0; row < 6; ++row) {
        a.jac[(x * 6 + row) * kCols + k] = r[row].d * s;
        if (k == 0) a.res[x * 6 + row] = r[row].v * s;
      }
    } else if (!slot_finite(a, a.inv[t - cols])) {
      v.flags[kDead] = 1;
    }
  }
}

// ---- phase 2: the normal equations ----------------------------------------

// The upper triangle is zeroed first (one barrier); then a warp a node p
// sums its diagonal block and its block with each neighbour q > p (the
// first edge of p's list to reach q): 18 lanes, each entry (ka, kb) and
// (ka, kb + 3), sum the (edge, k) terms of the edges of p's list that
// touch q, in edge order, then the gauge mask and the damping; in the
// diagonal block's turn 6 more lanes sum b's rows of p. An entry's sum is
// the same whichever lane or list takes it.
template <bool kGrid>
__device__ void normal_equations(Team<kGrid>& team, const Args& a,
                                 const View& v) {
  const int N = v.N, ld = v.ld, lane = threadIdx.x & 31;
  const int warp0 = team.rank() >> 5, warps = team.size() >> 5;
  for (int row = warp0; row < N; row += warps)
    for (int col = row + lane; col < N; col += 32) v.H[row * ld + col] = 0.f;
  team.sync();
  for (int p = warp0; p < v.n; p += warps) {
    const int lo = v.off[p], hi = v.off[p + 1];
    for (int x = lo - 1; x < hi; ++x) {  // x = lo - 1: the diagonal block
      int q = p;
      if (x >= lo) {
        const int c = a.inc[x];
        q = a.ci[c] == p ? a.cj[c] : a.ci[c];
        bool seen = q <= p;  // a lower block, or a self-edge's own
        for (int y = lo; y < x && !seen; ++y) {
          const int c2 = a.inc[y];
          seen = (a.ci[c2] == p ? a.cj[c2] : a.ci[c2]) == q;
        }
        if (seen) continue;
      }
      if (lane < 18) {
        const int ka = lane / 3, kb = lane - 3 * ka, row = 6 * p + ka;
        float h0 = 0.f, h1 = 0.f;
        for (int y = lo; y < hi; ++y) {
          const int c = a.inc[y], i = a.ci[c], j = a.cj[c];
          if (i != q && j != q) continue;
          const float* Je = a.jac + c * 6 * kCols;
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            const float ja = jac_of(Je, k, ka, i, j, p);
            h0 = h0 + ja * jac_of(Je, k, kb, i, j, q);
            h1 = h1 + ja * jac_of(Je, k, kb + 3, i, j, q);
          }
        }
        const float fa = v.fr[row];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 6 * q + kb + 3 * e;
          if (col < row) continue;
          // the gauge: fixed rows and columns out, identity on their
          // diagonal; then the damping
          float h = (e ? h1 : h0) * fa * v.fr[col];
          if (row == col) h = h + (1.f - fa) + a.damping;
          v.H[row * ld + col] = h;
        }
      } else if (lane < 24 && q == p) {  // b = J^T r, times free6
        const int ka = lane - 18, row = 6 * p + ka;
        float h = 0.f;
        for (int y = lo; y < hi; ++y) {
          const int c = a.inc[y];
          const float* Je = a.jac + c * 6 * kCols;
#pragma unroll
          for (int k = 0; k < 6; ++k)
            h = h + jac_of(Je, k, ka, a.ci[c], a.cj[c], p) * a.res[c * 6 + k];
        }
        v.H[row * ld + N] = h * v.fr[row];
      }
    }
  }
}

// ---- phase 3: the blocked factorisation -----------------------------------

__device__ __forceinline__ int panel_width(int k, int N) {
  return min(kPanel, N - k * kPanel);
}

// U^T U of the w x w diagonal block at (j0, j0), in place, by the calling
// warp: lane l holds column l in registers; rd[j0 + l] = 1 / U[l][l].
// Returns false on a pivot that is not > 0 (nothing written then). Within
// a step the code is straight-line (a branch between the shuffles would
// cut their schedule into blocks that each wait out a shuffle): every lane
// updates every row, and the rows below its diagonal (r > l), which no
// valid entry reads, take garbage and are never written.
__device__ bool diag_factor(float* H, int ld, int j0, int w, float* rd) {
  const int lane = threadIdx.x & 31;
  float col[kPanel];
#pragma unroll
  for (int r = 0; r < kPanel; ++r)
    col[r] = lane < w && r <= lane ? H[(j0 + r) * ld + j0 + lane]
                                   : (r == lane ? 1.f : 0.f);
  float diag = 1.f;
#pragma unroll
  for (int t = 0; t < kPanel; ++t) {
    if (t >= w) break;
    const float pivot = __shfl_sync(kFull, col[t], t);
    if (!(pivot > 0.f)) return false;  // every lane reads the same pivot
    const float d = sqrtf(pivot);
    // U[t][lane], divided: a window whose f32 H is indefinite only by
    // rounding (the gauge-less one) then fails where LAPACK's does
    const float q = col[t] / d;
    const float u = lane > t ? q : (lane == t ? d : col[t]);
    col[t] = u;
    diag = lane == t ? d : diag;
    float ur[kPanel];  // U[t][r]: every shuffle issued before its use
#pragma unroll
    for (int r = t + 1; r < kPanel; ++r) ur[r] = __shfl_sync(kFull, u, r);
#pragma unroll
    for (int r = t + 1; r < kPanel; ++r) col[r] = col[r] - ur[r] * u;
  }
  if (lane < w) {
#pragma unroll
    for (int r = 0; r < kPanel; ++r)
      if (r <= lane) H[(j0 + r) * ld + j0 + lane] = col[r];
    rd[j0 + lane] = 1.f / diag;
  }
  return true;
}

// The panel's rows [j0, j0 + w) of U in the columns c = j0 + w + first,
// + stride, .. up to N: U_kk^T X = H[j0 .., c], a column a thread, against
// the diagonal block uk (uk[t * ukld + r] = U[j0 + t][j0 + r], read for
// every r < kPanel: Tier L's staged block is zero past w; Tier S's rows
// run at most 31 - w floats past H into its vectors) and its reciprocals
// rk.
__device__ void panel_columns(float* H, int ld, int j0, int w, int N,
                              const float* uk, int ukld, const float* rk,
                              int first, int stride) {
  for (int c = j0 + w + first; c <= N; c += stride) {
    float h[kPanel];
#pragma unroll
    for (int r = 0; r < kPanel; ++r) h[r] = r < w ? H[(j0 + r) * ld + c] : 0.f;
#pragma unroll
    for (int t = 0; t < kPanel; ++t) {
      if (t >= w) break;
      const float x = h[t] * rk[t];
      h[t] = x;
      // straight-line, as diag_factor's: rows r >= w take garbage, never
      // stored (uk's rows stay inside the allocation: its note)
#pragma unroll
      for (int r = t + 1; r < kPanel; ++r)
        h[r] = h[r] - uk[t * ukld + r] * x;
    }
#pragma unroll
    for (int r = 0; r < kPanel; ++r)
      if (r < w) H[(j0 + r) * ld + c] = h[r];
  }
}

__device__ __forceinline__ int tile_rows() { return 4 * (blockDim.x >> 5); }

// H[a][b] -= sum_s U[j0 + s][a] U[j0 + s][b], s < kPanel (a panel with a
// trailing matrix is a whole one), over the tile of rows [r0, r0 +
// tile_rows()) and columns [c0, c0 + kTile): the upper entries below row N
// and up to column N, but for those with a and b both below skip. Every
// thread of the CTA: 4 rows (a warp's) by 2 columns (its lane's). Tier L
// first stages the panel's rows under the tile (its rows' columns, then
// its kTile columns) in `stage`, a float a thread at a time, all in flight
// at once: one round trip to L2 a tile; Tier S (stage null) reads H.
__device__ void update_tile(const View& v, int j0, int r0, int c0, int skip,
                            float* stage) {
  const int N = v.N, ld = v.ld, tr = tile_rows(), sld = tr + kTile;
  const float* U = v.H + j0 * ld;
  int uld = ld, ua = 0, ub = 0;
  if (stage != nullptr) {
    // every load before any store: a store could alias a later load, and
    // would hold it back a round trip
    float tmp[kStageLoads];
#pragma unroll
    for (int i = 0; i < kStageLoads; ++i) {
      const int t = threadIdx.x + i * kThreadsL, s = t / sld;
      const int c = t - s * sld, src = c < tr ? r0 + c : c0 + c - tr;
      tmp[i] = U[s * ld + min(src, N)];
    }
    __syncthreads();  // the last tile's reads of the stage are done
#pragma unroll
    for (int i = 0; i < kStageLoads; ++i)
      stage[threadIdx.x + i * kThreadsL] = tmp[i];
    __syncthreads();
    U = stage, uld = sld, ua = -r0, ub = tr - c0;
  }
  const int a0 = r0 + 4 * (threadIdx.x >> 5);
  const int b0 = c0 + (threadIdx.x & 31), b1 = b0 + 32;
  if (a0 >= N || b1 < a0) return;
  // columns past N read column N (Tier S) or its staged copy: discarded
  const int i0 = ub + (stage != nullptr ? b0 : min(b0, N));
  const int i1 = ub + (stage != nullptr ? b1 : min(b1, N));
  float acc[4][2] = {};
#pragma unroll 8
  for (int s = 0; s < kPanel; ++s) {
    const float* us = U + s * uld;
    const float4 ua4 = *reinterpret_cast<const float4*>(us + ua + a0);
    const float u0 = us[i0], u1 = us[i1];
    const float av[4] = {ua4.x, ua4.y, ua4.z, ua4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r][0] = __fmaf_rn(av[r], u0, acc[r][0]);
      acc[r][1] = __fmaf_rn(av[r], u1, acc[r][1]);
    }
  }
  // the 8 entries read, then written (no store ahead of a load)
  float h[4][2];
  bool put[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int a = a0 + r, b = c ? b1 : b0;
      put[r][c] = a < N && b >= a && b <= N && !(a < skip && b < skip);
      h[r][c] = put[r][c] ? v.H[a * ld + b] : 0.f;
    }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (put[r][c]) v.H[(a0 + r) * ld + (c ? b1 : b0)] = h[r][c] - acc[r][c];
}

// The trailing update of panel [j0, j0 + kPanel): tiles me, me + workers,
// .. of the upper triangle of rows [j0 + kPanel, N) and columns up to N,
// each by the whole CTA.
__device__ void trailing(const View& v, int j0, int me, int workers,
                         int skip, float* stage) {
  const int N = v.N, j1 = j0 + kPanel;
  const int tr = tile_rows();
  const int rows = (N - j1 + tr - 1) / tr;
  const int cols = (N + 1 - j1 + kTile - 1) / kTile;
  // tiles in row-major order, row tile ti from column tile ti * tr / kTile
  // (the first with an upper entry); a CTA walks them `workers` at a time
  // (no division a tile: enumerating them all took longer than the tiles)
  int ti = 0, tj = me;
  auto settle = [&] {
    while (ti < rows && tj >= cols) {
      const int over = tj - cols;
      ++ti;
      tj = ti * tr / kTile + over;
    }
  };
  for (settle(); ti < rows; tj += workers, settle())
    update_tile(v, j0, j1 + ti * tr, j1 + tj * kTile, skip, stage);
}

// Tier L's lead CTA: the update of the next diagonal block [j1, j2)^2 by
// panel [j0, j1), in update_tile's order, from the panel's rows over the
// block's columns staged in shared memory (all loads in flight at once).
__device__ void update_block(const View& v, int j0, int j1, int j2) {
  constexpr int kLoads = kPanel * kPanel / kThreadsL, sld = kPanel + 1;
  const int m = j2 - j1, ld = v.ld;
  float tmp[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int t = threadIdx.x + i * kThreadsL, s = t / kPanel;
    tmp[i] = v.H[(j0 + s) * ld + j1 + min(t - s * kPanel, m - 1)];
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int t = threadIdx.x + i * kThreadsL, s = t / kPanel;
    v.stage[s * sld + t - s * kPanel] = tmp[i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < m * m; t += blockDim.x) {
    const int a = t / m, b = t % m;
    if (b < a) continue;
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < kPanel; ++s)
      acc = __fmaf_rn(v.stage[s * sld + a], v.stage[s * sld + b], acc);
    v.H[(j1 + a) * ld + j1 + b] = v.H[(j1 + a) * ld + j1 + b] - acc;
  }
}

// H = U^T U and y = U^-T b (column N). Returns false (uniformly) once
// the launch is dead: a pivot failed here or a term was not finite.
template <bool kGrid>
__device__ bool factor(Team<kGrid>& team, const View& v) {
  const int N = v.N, ld = v.ld, K = (N + kPanel - 1) / kPanel;
  const int warp = threadIdx.x >> 5;
  if (team.lead() && warp == 0 &&
      !diag_factor(v.H, ld, 0, panel_width(0, N), v.rd))
    v.flags[kDead] = 1;
  team.sync();
  SE_MARK(6);
  for (int k = 0; k < K; ++k) {
    if (v.flags[kDead]) return false;
    const int j0 = k * kPanel, w = panel_width(k, N), j1 = j0 + w;
    if constexpr (kGrid) {
      for (int t = threadIdx.x; t < kPanel * kPanel; t += blockDim.x) {
        const int r = t / kPanel, c = t - r * kPanel;
        v.uk[r * (kPanel + 1) + c] =
            r < w && c < w ? v.H[(j0 + r) * ld + j0 + c] : 0.f;
      }
      if (threadIdx.x < kPanel)
        v.uk[kPanel * (kPanel + 1) + threadIdx.x] =
            (int)threadIdx.x < w ? v.rd[j0 + threadIdx.x] : 0.f;
      __syncthreads();
      panel_columns(v.H, ld, j0, w, N, v.uk, kPanel + 1,
                    v.uk + kPanel * (kPanel + 1), team.rank(), team.size());
    } else {
      panel_columns(v.H, ld, j0, w, N, v.H + j0 * ld + j0, ld, v.rd + j0,
                    threadIdx.x, blockDim.x);
    }
    team.sync();
    SE_MARK(7);
    if (k + 1 == K) break;
    const int j2 = j1 + panel_width(k + 1, N);
    if constexpr (kGrid) {
      if (team.lead()) {
        update_block(v, j0, j1, j2);
        __syncthreads();
        SE_MARK(8);
        if (warp == 0 && !diag_factor(v.H, ld, j1, j2 - j1, v.rd))
          v.flags[kDead] = 1;
        SE_MARK(9);
      } else {
        trailing(v, j0, blockIdx.x - 1, gridDim.x - 1, j2, v.stage);
      }
      team.sync();
      SE_MARK(10);
    } else {
      trailing(v, j0, 0, 1, j1, nullptr);
      __syncthreads();
      if (warp == 0 && !diag_factor(v.H, ld, j1, j2 - j1, v.rd))
        v.flags[kDead] = 1;
      __syncthreads();
      SE_MARK(11);
    }
  }
  return !v.flags[kDead];
}

// ---- phase 4: U x = y, column N -------------------------------------------

// y[row] -= sum_c H[row][c] x[c] over panel pp's columns in order (x in
// column N).
__device__ __forceinline__ float apply_panel(const View& v, const float* row,
                                             int pp, float y) {
  const int c0 = pp * kPanel, w = panel_width(pp, v.N);
  float rv[kPanel], xv[kPanel];  // all loads in flight at once
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    const int col = c0 + min(c, w - 1);
    rv[c] = row[col];
    xv[c] = v.H[col * v.ld + v.N];
  }
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    const float yn = y - rv[c] * xv[c];
    y = c < w ? yn : y;
  }
  return y;
}

// kBackPanels panels a step from the last, one barrier a step: the lead
// warp, a lane a row, applies the panels solved since its rows were last
// reached (the last step's and this one's, in descending order) to each of
// this step's panels and solves it in registers; the workers (S: the other
// warps, L: the other CTAs) apply the last step's panels to the rows above.
// Every row takes the panels after it in descending order, as one panel a
// step would.
template <bool kGrid>
__device__ void backward(Team<kGrid>& team, const View& v) {
  const int N = v.N, ld = v.ld, K = (N + kPanel - 1) / kPanel;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lead = team.lead() && warp == 0;
  const bool worker = kGrid ? !team.lead() : warp > 0;
  const int me = kGrid ? ((int)blockIdx.x - 1) * blockDim.x + threadIdx.x
                       : threadIdx.x - 32;
  const int workers = kGrid ? (gridDim.x - 1) * blockDim.x : blockDim.x - 32;
  constexpr int G = kBackPanels<kGrid>;
  for (int k1 = K - 1; k1 >= 0; k1 -= G) {
    const int k0 = max(k1 - G + 1, 0);
    const int last = min(k1 + G, K - 1);  // the last step's first
    if (lead) {
      for (int k = k1; k >= k0; --k) {
        const int j0 = k * kPanel, w = panel_width(k, N);
        float y = 0.f, rl = 0.f, urow[kPanel];
        if (lane < w) {
          const float* row = v.H + (j0 + lane) * ld;
          y = row[N];
          for (int pp = last; pp > k; --pp) y = apply_panel(v, row, pp, y);
          rl = v.rd[j0 + lane];
        }
#pragma unroll
        for (int t = 0; t < kPanel; ++t)
          urow[t] = lane < w && t > lane && t < w
                        ? v.H[(j0 + lane) * ld + j0 + t]
                        : 0.f;
#pragma unroll
        for (int t = kPanel - 1; t >= 0; --t) {
          if (t >= w) continue;
          const float xt = __shfl_sync(kFull, y * rl, t);
          const float yn = y - urow[t] * xt;  // straight-line: selects
          y = lane == t ? xt : (lane < t ? yn : y);
        }
        if (lane < w) v.H[(j0 + lane) * ld + N] = y;
        __syncwarp();
      }
    } else if (worker) {
      for (int i = me; i < k0 * kPanel; i += workers) {
        float* row = v.H + i * ld;
        float y = row[N];
        for (int pp = last; pp > k1; --pp) y = apply_panel(v, row, pp, y);
        row[N] = y;
      }
    }
    team.sync();
    SE_MARK(12);
  }
}

// ---- phase 5: the pose update ---------------------------------------------

// nan: the iteration failed (a pivot, or a term that is not finite), and
// dx is NaN, as JAX's: exp(dx) keeps its bottom row (0, 0, 0, 1), so a
// pose's bottom row survives the first such update and not the next
template <bool kGrid>
__device__ void update_poses(Team<kGrid>& team, const Args& a, const View& v,
                             bool nan) {
  for (int p = team.rank(); p < v.n; p += team.size()) {
    float dx[6], E4[16], T[16];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      dx[k] = nan ? __int_as_float(0x7fc00000)
                  : -v.H[(6 * p + k) * v.ld + v.N] * v.fr[6 * p + k];
    se::se3_exp(dx, E4);
#pragma unroll
    for (int x = 0; x < 16; ++x) T[x] = a.poses[16 * p + x];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int col = 0; col < 4; ++col)
        a.poses[16 * p + r * 4 + col] =
            E4[r * 4] * T[col] + E4[r * 4 + 1] * T[4 + col] +
            E4[r * 4 + 2] * T[8 + col] + E4[r * 4 + 3] * T[12 + col];
  }
}

// ---- the kernel -----------------------------------------------------------

template <bool kGrid>
__global__ void __launch_bounds__(kGrid ? kThreadsL : kThreadsS, 1)
    ba_solve_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = a.n, N = 6 * n;
  View v;
  v.n = n;
  v.N = N;
  v.ld = row_floats(N);
  Team<kGrid> team;
  if constexpr (kGrid) {
    team.bar = a.bar;
    team.passed = 0;
    v.H = a.H;
    v.rd = a.rd;
    v.fr = a.fr;
    v.off = a.off;
    v.flags = a.flags;
    v.stage = smem;  // 16-byte aligned for the tiles' float4 reads
    v.uk = v.stage + kPanel * kStageL;
    v.scan = reinterpret_cast<int*>(v.uk + kPanel * (kPanel + 1) + kPanel);
  } else {
    v.H = smem;
    v.rd = v.H + N * v.ld;
    v.fr = v.rd + N;
    v.off = reinterpret_cast<int*>(v.fr + N);
    v.flags = v.off + n + 1;
    v.scan = v.off + n + 1 + kFlags;
    v.uk = v.stage = nullptr;
  }
  for (int x = team.rank(); x < n * 16; x += team.size())
    a.poses[x] = a.poses_in[x];
  if (a.iters > 0) {
    for (int r = team.rank(); r < N; r += team.size()) {
      const int p = r / 6;
      v.fr[r] = (p == 0 || (a.fixed != nullptr && a.fixed[p])) ? 0.f : 1.f;
    }
    if (team.lead()) compact(a, v);
    team.sync();
    SE_MARK(0);
    if (!v.flags[kBad]) {
      const int nv = v.flags[kNv], ninv = v.flags[kNinv];
      node_lists(team, a, v, nv);
      int it = 0;
      for (; it < a.iters; ++it) {
        dual_pass(team, a, v, nv, ninv);
        team.sync();
        SE_MARK(4);
        if (v.flags[kDead]) break;
        normal_equations(team, a, v);
        team.sync();
        SE_MARK(5);
        if (!factor(team, v)) break;
        backward(team, v);
        update_poses(team, a, v, false);
        team.sync();
        SE_MARK(13);
      }
      // a failed iteration and the rest: NaN steps, as JAX's (after two
      // every entry is NaN, and stays so); a thread keeps its nodes
      for (int k = it; k < min(a.iters, it + 2); ++k)
        update_poses(team, a, v, true);
    } else {  // an edge node out of range (only while a graph captures)
      for (int x = team.rank(); x < n * 16; x += team.size())
        a.poses[x] = __int_as_float(0x7fc00000);
    }
  }
}

// ---- the plan -------------------------------------------------------------

// What the current device offers K9, queried once a device.
struct Device {
  int sms;       // Tier L's CTAs: one an SM
  size_t room;   // Tier S's dynamic shared memory: the opt-in less static
  bool ready;
};

constexpr size_t kTierLSmem =
    sizeof(float) * (kPanel * kStageL + kPanel * (kPanel + 1) + kPanel +
                     kMaxWarps + 1);

size_t tier_s_smem(int n) {
  const size_t N = 6 * (size_t)n;
  return sizeof(float) *
         (N * row_floats((int)N) + 2 * N + (n + 1) + kFlags + kMaxWarps + 1);
}

int device(Device** out) {
  static Device devs[se::kMaxDevices];
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= se::kMaxDevices) return (int)cudaErrorInvalidDevice;
  Device& d = devs[dev];
  if (!d.ready) {
    int optin = 0, per_sm = 0;
    cudaFuncAttributes fa;
    if ((err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (err = cudaFuncGetAttributes(&fa, ba_solve_kernel<false>)) !=
            cudaSuccess)
      return (int)err;
    d.room = (size_t)optin - fa.sharedSizeBytes;
    if ((err = cudaFuncSetAttribute(
             ba_solve_kernel<false>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)d.room)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ba_solve_kernel<true>, kThreadsL, kTierLSmem)) !=
            cudaSuccess)
      return (int)err;
    if (per_sm < 1 || d.sms < 2) return (int)cudaErrorLaunchOutOfResources;
    d.ready = true;
  }
  *out = &d;
  return 0;
}

// A launch's tier, CTAs, dynamic shared memory and scratch (4-byte words,
// each part's offset).
struct Plan {
  int tier, ctas;
  size_t smem, words;
  size_t jac, res, act, inv, ci, cj, inc, H, rd, fr, off, flags, bar;
};

// Tier S (0) where its square fits the shared memory, else L (1); a side
// build that defines SE_BA_TIER_L takes Tier L for every window
// (tools/ba_windows.py --tier-l).
int plan_for(int n, int E, Plan* p) {
  if (n < 1 || n > kIndexNodes || E < 0 || E > kMaxEdges)
    return (int)cudaErrorInvalidValue;
  Device* d;
  const int err = device(&d);
  if (err != 0) return err;
  int tier = tier_s_smem(n) <= d->room ? 0 : 1;
#ifdef SE_BA_TIER_L
  tier = 1;
#endif
  const size_t N = 6 * (size_t)n, e = E;
  size_t o = 0;
  p->jac = o, o += 72 * e;
  p->res = o, o += 6 * e;
  p->act = o, o += e;
  p->inv = o, o += e;
  p->ci = o, o += e;
  p->cj = o, o += e;
  p->inc = o, o += 2 * e;
  p->H = p->rd = p->fr = p->off = p->flags = p->bar = 0;
  if (tier == 1) {
    p->bar = o, o += 1;
    p->rd = o, o += N;
    p->fr = o, o += N;
    p->off = o, o += n + 1;
    p->flags = o, o += kFlags;
    o = (o + 3) & ~(size_t)3;  // 16-byte rows for the tiles' float4 reads
    p->H = o, o += N * row_floats((int)N);
  }
  p->words = o > 0 ? o : 1;
  p->tier = tier;
  p->ctas = tier ? d->sms : 1;
  p->smem = tier ? kTierLSmem : tier_s_smem(n);
  return 0;
}

}  // namespace

// The plan of a launch over n nodes and E edge slots: out = {tier (0 S,
// 1 L), CTAs, scratch words, dynamic shared memory bytes}. Returns a
// cudaError_t.
SE_EXPORT int se_ba_plan(int n, int E, long long* out) {
  Plan p;
  const int err = plan_for(n, E, &p);
  if (err != 0) return err;
  out[0] = p.tier;
  out[1] = p.ctas;
  out[2] = (long long)p.words;
  out[3] = (long long)p.smem;
  return 0;
}

// *out: the most nodes Tier S takes on the current device.
SE_EXPORT int se_ba_tier_nodes(int* out) {
  Device* d;
  const int err = device(&d);
  if (err != 0) return err;
  int n = 0;
  while (n < kIndexNodes && tier_s_smem(n + 1) <= d->room) ++n;
  *out = n;
  return 0;
}

// `iters` Gauss-Newton iterations over the window of n poses (poses_in
// f32[n, 4, 4] -> poses f32[n, 4, 4]) and E edges (ei, ej i32[E], t_meas
// f32[E, 4, 4], weight f32[E], valid bool[E]); fixed (bool[n], or null)
// holds nodes besides node 0 fixed. scratch: `words` 4-byte words, at
// least se_ba_plan's. Returns a cudaError_t.
SE_EXPORT int se_ba_solve(const float* poses_in, float* poses, const int* ei,
                          const int* ej, const float* t_meas,
                          const float* weight, const bool* valid,
                          const bool* fixed, int n, int E, int iters,
                          float damping, float* scratch, long long words,
                          void* stream) {
  Plan p;
  int err = plan_for(n, E, &p);
  if (err != 0) return err;
  if (iters < 0 || words < (long long)p.words)
    return (int)cudaErrorInvalidValue;
  int* iw = reinterpret_cast<int*>(scratch);
  Args a{poses_in,     poses,         ei,           ej,
         t_meas,       weight,        valid,        fixed,
         n,            E,             iters,        damping,
         scratch + p.jac, scratch + p.res, iw + p.act, iw + p.inv,
         iw + p.ci,    iw + p.cj,     iw + p.inc,   nullptr,
         nullptr,      nullptr,       nullptr,      nullptr,
         nullptr};
  if (p.tier == 1) {
    a.H = scratch + p.H;
    a.rd = scratch + p.rd;
    a.fr = scratch + p.fr;
    a.off = iw + p.off;
    a.flags = iw + p.flags;
    a.bar = reinterpret_cast<unsigned*>(iw + p.bar);
    cudaError_t e = cudaMemsetAsync(a.bar, 0, sizeof(unsigned),
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.ctas, 1, 1);
    cfg.blockDim = dim3(kThreadsL, 1, 1);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if ((e = cudaLaunchKernelEx(&cfg, ba_solve_kernel<true>, a)) !=
        cudaSuccess)
      return (int)e;
  } else {
    ba_solve_kernel<false>
        <<<1, kThreadsS, p.smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

#ifdef SE_BA_TIMELINE
// The marks since the last call: *n of them, times t (ns), marks k.
SE_EXPORT int se_ba_timeline(unsigned long long* t, int* k, int* n) {
  cudaError_t err = cudaMemcpyFromSymbol(n, se_tl_n, sizeof(int));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(t, se_tl_t, sizeof(unsigned long long) * *n);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(k, se_tl_k, sizeof(int) * *n);
  const int zero = 0;
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(se_tl_n, &zero, sizeof(int));
  return (int)err;
}
#endif
