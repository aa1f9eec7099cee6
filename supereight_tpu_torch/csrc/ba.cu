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
// ONE CTA of kThreads threads runs the whole solve; __syncthreads between
// the phases of an iteration:
//  1. residuals and Jacobians, forward mode: a thread an (edge, column)
//     pair, 12 columns an edge, runs the edge's residual
//     log(T_meas^-1 T_i^-1 T_j) in dual numbers (a value and one tangent)
//     at the zero perturbation with the unit tangent of its column (k < 6
//     on node i's twist, k >= 6 on node j's), following the value's branch
//     at every select: what the twin's torch.func.jvp over the 12-column
//     basis and JAX's jacfwd compute. The values are the residual. Both are
//     scaled by where(valid, weight, 0) into the scratch (r f32[E, 6],
//     J f32[E, 6, 12]);
//  2. the normal equations, upper triangle: a thread an entry of H (warp
//     rows, lane columns), summing the (edge, row) terms of the edges that
//     touch both of its nodes in edge order (each node's incident edges are
//     listed once a launch, in edge order), then the gauge mask and the
//     damping; b = J^T r likewise, times free6. No float atomics, so two
//     launches are bit-identical;
//  3. Cholesky H = U^T U in place, right-looking: column j's row is divided
//     by its pivot's root, then the trailing triangle updated (two barriers
//     a column). A pivot that is not > 0 (NaN included) fails the
//     factorisation, as LAPACK's potrf does: every pose becomes NaN, as the
//     twin's where(info == 0, L, nan) and JAX's cho_factor leave them;
//  4. the two triangular solves by warp 0 (a __syncwarp a column);
//  5. a thread a node: dx = -x * free6, pose <- exp(dx) @ pose (se3_exp of
//     common.cuh, sums left to right).
// H and the per-edge terms live in a scratch tensor from the caller's
// caching allocator (L2-resident at the loop's windows: H is 144 KiB at
// the default window of 32); the vectors and the edge lists' offsets in
// shared memory. No host sync and no allocation, so the launch can be
// captured in a CUDA graph.
//
// Bound on the H100: operations, ~2.9k an edge (its residual once, its 12
// columns' nonzero tangents and its terms of H and b) and (6n)^3 / 3 a
// factorisation, `iters` times, over 67 TFLOP/s: microseconds. The launch
// is a chain instead: iters x 6n dependent factor columns, each two block
// barriers, and 2 x 6n dependent substitution steps, on one SM. Spreading
// the factorisation over a cluster, shared-memory H where it fits and
// warp-parallel columns are the ways to that bound. The factorisation's
// (6n)^3 / 3 on one SM makes the launch slower than the twin above ~180
// nodes; kernels/ba.py takes at most MAX_NODES.
//
// Agreement: sums in edge order against the twin's jac.T @ jac, and the
// factorisation's order against LAPACK's or cuSOLVER's, differ in the last
// bits; the poses agree to 1e-5 (tests/test_torch_ba.py, chip_smoke.py).

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 12;  // Jacobian columns an edge: x_i's 6, x_j's 6
// nodes a launch takes: its vectors fill the shared memory at ~2,300
constexpr int kMaxNodes = 2048;

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
// (0, 0, 0, 1) in row k for a translation, and hat(e_a) @ T moves rows
// for a rotation about axis a.
__device__ __forceinline__ void perturbed(const float* __restrict__ T, int k,
                                          Dual* out) {
#pragma unroll
  for (int x = 0; x < 16; ++x) out[x] = cst(T[x]);
  if (k < 0) return;
  if (k < 3) {
    out[k * 4 + 3].d = 1.f;
    return;
  }
  const int a = k - 3, p = (a + 1) % 3, q = (a + 2) % 3;
  // hat(e_a): row p gets -T[q], row q gets T[p]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out[p * 4 + c].d = -T[q * 4 + c];
    out[q * 4 + c].d = T[p * 4 + c];
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
  int best = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (d[k].v > d[best].v) best = k;
  Dual a, b, c, db = d[0];
  int s0, s1, s2, s3;  // the slots of (half, a, b, c)
  if (best == 0) {
    a = sub(r21, r12), b = sub(r02, r20), c = sub(r10, r01);
    s0 = 0, s1 = 1, s2 = 2, s3 = 3;
  } else if (best == 1) {
    db = d[1];
    a = sub(r21, r12), b = add(r01, r10), c = add(r02, r20);
    s0 = 1, s1 = 0, s2 = 2, s3 = 3;
  } else if (best == 2) {
    db = d[2];
    a = sub(r02, r20), b = add(r01, r10), c = add(r12, r21);
    s0 = 2, s1 = 0, s2 = 1, s3 = 3;
  } else {
    db = d[3];
    a = sub(r10, r01), b = add(r02, r20), c = add(r12, r21);
    s0 = 3, s1 = 0, s2 = 1, s3 = 2;
  }
  if (!(db.v >= 1e-12f)) db = cst(1e-12f);  // clamp(min=1e-12)
  const Dual s = dsqrt(db);
  const Dual inv = div(cst(0.5f), s);
  Dual out[4];
  out[s0] = scale(s, 0.5f);
  out[s1] = mul(a, inv);
  out[s2] = mul(b, inv);
  out[s3] = mul(c, inv);
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
__device__ void edge_column(const float* __restrict__ ti,
                            const float* __restrict__ tj,
                            const float* __restrict__ tm, int k, Dual r[6]) {
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
__device__ __forceinline__ float jac_of(const float* __restrict__ Je, int k,
                                        int ka, int i, int j, int p) {
  const float* row = Je + k * kCols;
  if (i == p && j == p) return row[ka] + row[6 + ka];
  return i == p ? row[ka] : row[6 + ka];
}

__global__ void __launch_bounds__(kThreads, 1)
    ba_solve_kernel(const float* __restrict__ poses_in,
                    float* __restrict__ poses, const int* __restrict__ ei,
                    const int* __restrict__ ej,
                    const float* __restrict__ t_meas,
                    const float* __restrict__ weight,
                    const bool* __restrict__ valid,
                    const bool* __restrict__ fixed, int n, int E, int iters,
                    float damping, float* __restrict__ jac,
                    float* __restrict__ res, float* __restrict__ H,
                    int* __restrict__ inc) {
  extern __shared__ float smem[];
  const int N = 6 * n;
  float* c = smem;            // b * free6; the forward solve; then x
  float* y = c + N;           // the forward solve's result, then x's rows
  float* dg = y + N;          // the factor's diagonal
  float* fr = dg + N;         // free6
  int* off = (int*)(fr + N);  // node p's edges: inc[off[p] .. off[p + 1])
  __shared__ int bad, failed;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) bad = 0;
  for (int x = tid; x < n * 16; x += kThreads) poses[x] = poses_in[x];
  for (int a = tid; a < N; a += kThreads) {
    const int p = a / 6;
    fr[a] = (p == 0 || (fixed != nullptr && fixed[p])) ? 0.f : 1.f;
  }
  __syncthreads();
  // each node's incident edges in edge order (an edge from a node to
  // itself once); an index out of range makes every pose NaN
  for (int e = tid; e < E; e += kThreads)
    if (ei[e] < 0 || ei[e] >= n || ej[e] < 0 || ej[e] >= n)
      atomicOr(&bad, 1);
  for (int p = tid; p < n; p += kThreads) {
    int count = 0;
    for (int e = 0; e < E; ++e) count += (ei[e] == p || ej[e] == p);
    off[p + 1] = count;
  }
  __syncthreads();
  if (bad) {
    for (int x = tid; x < n * 16; x += kThreads)
      poses[x] = __int_as_float(0x7fc00000);
    return;
  }
  if (tid == 0) {
    off[0] = 0;
    for (int p = 0; p < n; ++p) off[p + 1] += off[p];
  }
  __syncthreads();
  for (int p = tid; p < n; p += kThreads) {
    int at = off[p];
    for (int e = 0; e < E; ++e)
      if (ei[e] == p || ej[e] == p) inc[at++] = e;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // 1. residuals and Jacobian columns
    for (int t = tid; t < E * kCols; t += kThreads) {
      const int e = t / kCols, k = t - e * kCols;
      Dual r[6];
      edge_column(poses + 16 * ei[e], poses + 16 * ej[e], t_meas + 16 * e, k,
                  r);
      const float s = valid[e] ? weight[e] : 0.f;
#pragma unroll
      for (int row = 0; row < 6; ++row) {
        jac[(e * 6 + row) * kCols + k] = r[row].d * s;
        if (k == 0) res[e * 6 + row] = r[row].v * s;
      }
    }
    if (tid == 0) failed = 0;
    __syncthreads();

    // 2. H's upper triangle and b, each entry summed in edge order over
    // the edges of the shorter of its two nodes' lists
    for (int a = warp; a < N; a += kWarps) {
      const int p = a / 6, ka = a - 6 * p;
      for (int b = a + lane; b < N; b += 32) {
        const int q = b / 6, kb = b - 6 * q;
        const bool p_short = off[p + 1] - off[p] <= off[q + 1] - off[q];
        const int o = p_short ? p : q;
        const int other = p_short ? q : p;
        float h = 0.f;
        for (int x = off[o]; x < off[o + 1]; ++x) {
          const int e = inc[x], i = ei[e], j = ej[e];
          if (i != other && j != other) continue;
          const float* Je = jac + e * 6 * kCols;
#pragma unroll
          for (int k = 0; k < 6; ++k)
            h = h + jac_of(Je, k, ka, i, j, p) * jac_of(Je, k, kb, i, j, q);
        }
        // the gauge: fixed rows and columns out, identity on their
        // diagonal; then the damping
        h = h * fr[a] * fr[b];
        if (a == b) h = h + (1.f - fr[a]) + damping;
        H[a * N + b] = h;
      }
    }
    for (int a = tid; a < N; a += kThreads) {
      const int p = a / 6, ka = a - 6 * p;
      float s = 0.f;
      for (int x = off[p]; x < off[p + 1]; ++x) {
        const int e = inc[x];
        const float* Je = jac + e * 6 * kCols;
#pragma unroll
        for (int k = 0; k < 6; ++k)
          s = s + jac_of(Je, k, ka, ei[e], ej[e], p) * res[e * 6 + k];
      }
      c[a] = s * fr[a];
    }
    __syncthreads();

    // 3. H = U^T U in place (row j of U in row j of H)
    for (int j = 0; j < N; ++j) {
      const float pivot = H[j * N + j];
      if (!(pivot > 0.f)) {  // every thread reads the same pivot
        if (tid == 0) failed = 1;
        break;
      }
      const float d = sqrtf(pivot);
      for (int col = j + 1 + tid; col < N; col += kThreads)
        H[j * N + col] = H[j * N + col] / d;
      if (tid == 0) dg[j] = d;
      __syncthreads();
      for (int row = j + 1 + warp; row < N; row += kWarps) {
        const float u = H[j * N + row];
        for (int col = row + lane; col < N; col += 32)
          H[row * N + col] = H[row * N + col] - u * H[j * N + col];
      }
      __syncthreads();
    }
    __syncthreads();

    // 4. U^T y = c, then U x = y, by warp 0
    if (warp == 0 && !failed) {
      for (int j = 0; j < N; ++j) {
        __syncwarp();
        const float yj = c[j] / dg[j];
        for (int i = j + 1 + lane; i < N; i += 32)
          c[i] = c[i] - H[j * N + i] * yj;
        if (lane == 0) y[j] = yj;
      }
      for (int j = N - 1; j >= 0; --j) {
        __syncwarp();
        const float xj = y[j] / dg[j];
        for (int i = lane; i < j; i += 32) y[i] = y[i] - H[i * N + j] * xj;
        if (lane == 0) c[j] = xj;
      }
    }
    __syncthreads();

    // 5. pose <- exp(dx) @ pose, dx = -x * free6 (all NaN after a failed
    // factorisation)
    for (int p = tid; p < n; p += kThreads) {
      float dx[6], E4[16], T[16];
#pragma unroll
      for (int k = 0; k < 6; ++k)
        dx[k] = failed ? __int_as_float(0x7fc00000)
                       : -c[6 * p + k] * fr[6 * p + k];
      se::se3_exp(dx, E4);
#pragma unroll
      for (int x = 0; x < 16; ++x) T[x] = poses[16 * p + x];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int col = 0; col < 4; ++col)
          poses[16 * p + r * 4 + col] =
              E4[r * 4] * T[col] + E4[r * 4 + 1] * T[4 + col] +
              E4[r * 4 + 2] * T[8 + col] + E4[r * 4 + 3] * T[12 + col];
    }
    __syncthreads();
  }
}

}  // namespace

// `iters` Gauss-Newton iterations over the window of n poses (poses_in
// f32[n, 4, 4] -> poses f32[n, 4, 4]) and E edges (ei, ej i32[E], t_meas
// f32[E, 4, 4], weight f32[E], valid bool[E]); fixed (bool[n], or null)
// holds nodes besides node 0 fixed. Scratch: jac f32[E * 72], res
// f32[E * 6], H f32[36 n^2], inc i32[2 E]. One CTA. Returns a cudaError_t.
SE_EXPORT int se_ba_solve(const float* poses_in, float* poses, const int* ei,
                          const int* ej, const float* t_meas,
                          const float* weight, const bool* valid,
                          const bool* fixed, int n, int E, int iters,
                          float damping, float* jac, float* res, float* H,
                          int* inc, void* stream) {
  if (n < 1 || n > kMaxNodes || E < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  // the vectors c, y, dg, free6 and the lists' offsets
  const size_t smem = 4 * 6 * (size_t)n * sizeof(float) + (n + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ba_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ba_solve_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      poses_in, poses, ei, ej, t_meas, weight, valid, fixed, n, E, iters,
      damping, jac, res, H, inc);
  return (int)cudaGetLastError();
}
