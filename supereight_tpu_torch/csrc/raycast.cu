// K1: the raycast of both fields, depth-primed (the frame step's) or
// unprimed (a fresh view's): start, march, Newton refinement, normal,
// overflow count and the frame state's select.
//
// Replaces supereight_tpu/ops/raycast.py:_march (454-769, with _probe
// 262-299; the unprimed start 537-544), prime_from_depth (772-798) and
// raycast_rays (841-899, with _interp_grad 318-380), and the raycast's
// share of the JAX frame step (parallel/step.py:194-200: the outputs kept
// before frame 3 and the masked ray_overflow). On the TPU that is a
// lockstep march over strip tables and a nav4 grid, cut into a top_k
// compaction cascade with straggler tails.
//
// One thread per pixel ray, marching to its own end, in one body
// instantiated per field (kOF = OFusion) and start (kPrimed):
//  * direction from view = pose @ invK (the frame's prologue,
//    csrc/frame.cu), clipped to the map cube and the near/far planes;
//  * the prime from this frame's depth d at the pixel (x, y): d * sqrt(ux^2
//    + uy^2 + 1) with ux = (x - cx) / fx, uy = (y - cy) / fy, 0 where
//    d <= 0, in prime_from_depth's operation order;
//  * primed start: a tight backoff 0.5 mu + 2 voxels when that probe lands
//    in known space on the free side (TSDF f > 0, OFusion f <=
//    SURF_BOUNDARY = 0), else the wide backoff, 2 mu (TSDF) or 6 mu
//    (OFusion) + 2 voxels (raycast.py:510-536);
//  * unprimed start (raycast.py:537-544): one probe at tnear, its value
//    (the field's fill where unknown) on the free side or the ray misses
//    without marching; no depth and no intrinsics are read. A zero prime
//    is not this start: the primed status tests tnear < tfar alone, and
//    the loop's first probe would take a start behind a surface for a
//    hit;
//  * TSDF: steps of max(f mu, floor) in known space, the floor rising one
//    voxel per 8 consecutive floor-bound steps after 16 (crawl escalation,
//    up to 4 voxels and 0.4 mu); hit where f < 0;
//  * OFusion: inside an allocated block a sigma-band step
//    clip(0.5 clip(mu z^2, 2 voxels, 0.05), 1 voxel, of_cap) with z the
//    camera depth t * zcos; coarse-known free space (the nav payload) and
//    unknown space are jumped; hit where f > SURF_BOUNDARY (raycast.py:
//    547-600);
//  * outside known fine space a jump of max(8 voxels, (d - 1) blocks + 4
//    voxels) with d the capped Chebyshev block distance of the nav grid;
//  * at most max_steps + 96 probes; rays still marching then miss and are
//    counted in ray_overflow;
//  * epilogue: bracket estimate, trilinear value and cell gradient, one
//    Newton step clamped to [t_cross - ss, t_cross], normal (inverted for
//    TSDF);
//  * TSDF with min_ref_weight > 0 (the map-maturity gate of the JAX frame
//    step, parallel/step.py:171-192, before its select): a hit whose voxel
//    at floor(vertex / voxel) has fused less weight (channel y) than
//    min_ref_weight, read through the map's slot grid, is not valid; its
//    vertex and normal are kept. The slot is the hit cell's nav entry
//    where that is >= 0 (the same value), so a hit reads its weight
//    alone; the slot grid only where the block lies outside the bucket.
// A launch may march a column window of the image (x0, w_out): the sharded
// step's rank marches its own columns through the exchanged halo
// (parallel/dist_step.py); the ray direction and the prime read use the
// image column x0 + x, and the outputs are the window's. The whole image
// (x0 = 0, w_out = w) indexes as before the window existed.
// Reads go straight to the pool through the nav grid: nav[cell] >= 0 is
// the pool slot of an allocated in-bucket block, else -(1 + e) with the
// distance in bits 0-2 and, for OFusion, the coarse free-space value in
// bit 3 and bits 4+. A voxel whose channel y is 0 (TSDF weight, OFusion
// time stamp) is unknown in the march (the sentinel: 2 for TSDF, 4096 for
// OFusion) and reads as the field's fill (1 or 0) in the refinement; an
// x+1 corner past the map edge or in a missing block reads fill, as the
// JAX strip table does.
//
// The frame's select: given a device gate `when` (the prologue's frame >
// 2), a gated-off launch marches nothing and writes the state's old
// vertex, normal and valid maps and raycast pose, else the new ones and
// the pose. ray_overflow (rays still marching at the bound) is an integer
// count: each CTA adds its count into scratch[0], and the last CTA to
// finish (a ticket in scratch[1]) writes the total and resets both, so the
// scratch stays zero between launches and the frame needs no fill. That
// holds while the launches that share one scratch run one after another:
// the wrapper keeps one scratch per device and stream.
//
// Bound on the H100: per probe one 4-byte nav read and two 4-byte pool
// reads, dependent: latency-bound on L2 hits rather than bandwidth (a
// 512^3 map's live pool is ~33 MB, inside the 50 MB L2); chip_smoke.py
// counts the probes of its inputs and the distinct nav entries and voxels
// they read. A probe in the same block cell as the last one keeps the nav
// entry it has in a register, and a voxel's two channels are loaded
// together, so a probe inside a block is one L2 round trip instead of
// three. The launch runs in one wave (all CTAs resident), so it lasts as
// long as its longest ray's chain of dependent reads: on the noise maps
// (PERF.md, PR 16) ~0.3 us a probe, the longest rays mostly nav jumps
// through unknown space, one dependent nav read each, on top of ~6.4 us
// with no march probe (start, epilogue, gate and launch). The
// refinement's and the gate's reads are therefore batched (corner_pairs,
// ref_weight). Two ways to shorten the jumps' chain were tried and made
// the launch slower (PERF.md, PR 16): asking L1 or L2 for the next jump's
// six candidate nav cells while a probe's own entry is read (a probe 0.31
// -> 0.56 us), and handing the rays still marching after 8-24 probes to
// their whole warp, one at a time, whose lanes read the nav entries of
// the next 16 blocks at once (a warp's long rays then run one after
// another: 21 -> 24-107 us). A warp is as slow as its longest ray, and
// neighbouring rays of a scene's surface run to similar lengths, so each
// warp takes an 8 x 4 pixel tile rather than 32 pixels of a row: at the
// bench config the warps' longest rays take 24 % (TSDF) and 15 %
// (OFusion) fewer probes in all (PERF.md). A CTA of 8 warps covers 32 x 8
// pixels.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps over a 32 x 8 pixel tile
constexpr int kTileW = 32, kTileH = 8;
constexpr float kInvalid = -2.f;  // normal-map sentinel (constants.INVALID)
constexpr int kMaxJump = 6;

// unknown sentinel (raycast.py:93-100) and refinement fill (the field's
// init value) of each field
template <bool kOF>
struct FieldConst {
  static constexpr float sentinel = kOF ? 4096.f : 2.f;
  static constexpr float fill = kOF ? 0.f : 1.f;
};

struct Params {
  // w x h: the depth frame and the image the rays belong to; the launch
  // marches the column window [x0, x0 + w_out) of it
  int w, h, x0, w_out, size, b, max_probes;
  float dim, inv_voxel, voxel, largestep, half_largestep, bstep, mu,
      near_plane, far_plane, small_backoff, big_backoff, floor_cap,
      two_step, of_cap, min_ref_weight;
};

struct Probe {
  float val, dist;
  bool known, in_block;
};

// The march's reads: the nav grid, with the entry of the last cell kept,
// and the pool's two channels
struct Pool {
  const int* nav;
  const float* data_x;
  const float* data_y;
  int cell, nv;  // the last cell read and its nav entry

  __device__ __forceinline__ int nav_at(int c) {
    if (c != cell) {
      cell = c;
      nv = __ldg(nav + c);
    }
    return nv;
  }
  // the entry of cell c, the kept one where c is the last cell read; the
  // kept entry stays
  __device__ __forceinline__ int nav_of(int c) const {
    return c == cell ? nv : __ldg(nav + c);
  }
};

// A ray: origin and unit direction
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// the nav cell of voxel (vx, vy, vz), clamped into the map
__device__ __forceinline__ int cell_of(const Params& P, int vx, int vy,
                                       int vz) {
  vx = se::clampi(vx, 0, P.size - 1);
  vy = se::clampi(vy, 0, P.size - 1);
  vz = se::clampi(vz, 0, P.size - 1);
  return ((vx >> 3) * P.b + (vy >> 3)) * P.b + (vz >> 3);
}

// value at a pool voxel, y == 0 voxels carrying the unknown sentinel; both
// channels are loaded before either is used
template <bool kOF>
__device__ __forceinline__ float pool_value(const Pool& pool, int slot,
                                            int lin) {
  const size_t v = (size_t)slot * se::kBlockVoxels + lin;
  const float y = __ldg(pool.data_y + v);
  const float x = __ldg(pool.data_x + v);
  return y == 0.f ? FieldConst<kOF>::sentinel : x;
}

// one march probe at a metric position (raycast.py:_probe): truncating
// conversion to voxels, like the JAX astype(int32). OFusion decodes the
// nav payload of an empty cell: a coarse free-space value makes it known.
template <bool kOF>
__device__ __forceinline__ Probe probe(const Params& P, Pool& pool,
                                       const Ray& ray, float t) {
  int vx = (int)((ray.ox + ray.dx * t) * P.inv_voxel);
  int vy = (int)((ray.oy + ray.dy * t) * P.inv_voxel);
  int vz = (int)((ray.oz + ray.dz * t) * P.inv_voxel);
  const bool inb = vx >= 0 && vx < P.size && vy >= 0 && vy < P.size &&
                   vz >= 0 && vz < P.size;
  vx = se::clampi(vx, 0, P.size - 1);
  vy = se::clampi(vy, 0, P.size - 1);
  vz = se::clampi(vz, 0, P.size - 1);
  const int nv = pool.nav_at(((vx >> 3) * P.b + (vy >> 3)) * P.b + (vz >> 3));
  const bool in_block = nv >= 0 && inb;
  constexpr float unk = FieldConst<kOF>::sentinel;
  const int e = nv < 0 ? -nv - 1 : 0;
  const bool coarse_known = kOF && ((e >> 3) & 1) == 1;
  Probe r;
  r.val = in_block
              ? pool_value<kOF>(pool, nv,
                                (vx & 7) + ((vy & 7) << 3) + ((vz & 7) << 6))
              : (coarse_known ? -(float)(e >> 4) * (1.f / 16.f) : unk);
  r.known = (r.val < 0.5f * unk && in_block) || (coarse_known && inb);
  r.in_block = in_block;
  r.dist = nv < 0 ? (float)(e & 7) : 0.f;
  if (!inb) r.dist = (float)kMaxJump;
  return r;
}

// refinement corner decode: sentinel -> fill
template <bool kOF>
__device__ __forceinline__ float corner(const Pool& pool, int slot,
                                        int lin) {
  const float v = pool_value<kOF>(pool, slot, lin);
  return v < 0.5f * FieldConst<kOF>::sentinel ? v : FieldConst<kOF>::fill;
}

// The four (x, x+1) pairs of the refinement's eight corners
// (raycast.py:_interp_grad pair()), rows (y, z) = (y0, z0), (y1, z0), (y0,
// z1), (y1, z1): a row whose x cell holds no in-bucket block is the fill
// (the JAX strip table's sentinel brick), x + 1 lies in the same block or,
// at the block's last voxel, in the next cell's (the fill past the map's
// edge or where that cell holds none). The nav entries of the <= 2 x 2 x
// 2 block cells they lie in are read together (the kept entry where a
// cell is the march's last), then all sixteen pool values together: two
// dependent round trips for the eight corners, where a pair at a time
// took up to eight.
template <bool kOF>
__device__ __forceinline__ void corner_pairs(const Params& P,
                                             const Pool& pool, int ix,
                                             int y0, int y1, int z0, int z1,
                                             float (&v0)[4], float (&v1)[4]) {
  constexpr float fill = FieldConst<kOF>::fill;
  const int cx = ix >> 3, lx = ix & 7;
  const bool next = lx == 7 && cx + 1 < P.b;  // x + 1 in the next cell
  int nv[4], nv2[4], lin[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int y = r & 1 ? y1 : y0, z = r & 2 ? z1 : z0;
    const int c = (cx * P.b + (y >> 3)) * P.b + (z >> 3);
    nv[r] = pool.nav_of(c);
    nv2[r] = next ? pool.nav_of(c + P.b * P.b) : -1;
    lin[r] = lx + ((y & 7) << 3) + ((z & 7) << 6);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // x + 1: the same block inside it, else the next cell's (its entry
    // -1 past the map's edge)
    const int s1 = lx < 7 ? nv[r] : nv2[r];
    const int l1 = lx < 7 ? lin[r] + 1 : lin[r] - 7;
    v0[r] = nv[r] >= 0 ? corner<kOF>(pool, nv[r], lin[r]) : fill;
    v1[r] = nv[r] >= 0 && s1 >= 0 ? corner<kOF>(pool, s1, l1) : fill;
  }
}

// The TSDF map-maturity gate's read (JAX parallel/step.py:185-191 with
// core/map.py:get_voxel_channel_c): the fusion weight (channel y) of the
// voxel at floor(h / voxel) of the map's slot grid's block (every
// allocated block, not only the nav grid's bucket), 0 outside the map or
// where no block is allocated. Where the hit's cell has a nav entry >= 0
// (an in-bucket block) that entry is the block's pool slot, the slot
// grid's entry there, so only the weight is read, one round trip (none
// more for the entry where the cell is the march's last, whose entry is
// kept); where it is < 0 (a block outside the bucket, or none) the slot
// grid is read first, as before.
__device__ __forceinline__ float ref_weight(const Params& P,
                                            const Pool& pool,
                                            const int* __restrict__ slot,
                                            float hx, float hy, float hz) {
  const int vx = (int)floorf(hx * P.inv_voxel);
  const int vy = (int)floorf(hy * P.inv_voxel);
  const int vz = (int)floorf(hz * P.inv_voxel);
  const bool inb = vx >= 0 && vx < P.size && vy >= 0 && vy < P.size &&
                   vz >= 0 && vz < P.size;
  const int c = cell_of(P, vx, vy, vz);
  int s = pool.nav_of(c);
  if (s < 0) s = __ldg(slot + c);
  if (s < 0 || !inb) return 0.f;
  const int lx = se::clampi(vx, 0, P.size - 1) & 7;
  const int ly = se::clampi(vy, 0, P.size - 1) & 7;
  const int lz = se::clampi(vz, 0, P.size - 1) & 7;
  return __ldg(pool.data_y + (size_t)s * se::kBlockVoxels + lx + (ly << 3) +
               (lz << 6));
}

// March the ray of image pixel (x, y) of `view` (V) into output i, primed
// by the depth frame's pixel (x, y) with the intrinsics
// Kc (kPrimed) or from its tnear probe, write its vertex, normal and valid
// flag; returns whether the ray was still marching at the probe bound
// (ray_overflow). kGate (TSDF): a hit whose voxel has fused less weight
// than P.min_ref_weight is not valid; its vertex and normal stay as they
// are.
template <bool kOF, bool kGate, bool kPrimed>
__device__ __forceinline__ bool march_ray(
    const Params& P, const float* V, const float* Kc, Pool& pool,
    const int* __restrict__ slot, const float* __restrict__ depth, int x,
    int y, int i,
    float* __restrict__ vertex, float* __restrict__ normal,
    uint8_t* __restrict__ valid) {
  const float pxf = (float)x, pyf = (float)y;

  // ray_directions_c (rendering.cpp:62-65)
  const float3 r = se::rotate(V, pxf, pyf, 1.f);
  const float rinv = 1.f / sqrtf(r.x * r.x + r.y * r.y + r.z * r.z);
  const float dx = r.x * rinv, dy = r.y * rinv, dz = r.z * rinv;
  const float ox = V[3], oy = V[7], oz = V[11];
  const Ray ray{ox, oy, oz, dx, dy, dz};

  // ray_box_range_c
  float lo[3], hi[3];
  const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float inv = 1.f / (d[a] == 0.f ? 1e-12f : d[a]);
    const float ta = -o[a] * inv, tb = (P.dim - o[a]) * inv;
    lo[a] = fminf(ta, tb);
    hi[a] = fmaxf(ta, tb);
  }
  float tnear = fmaxf(fmaxf(fmaxf(lo[0], lo[1]), lo[2]), P.near_plane);
  const float tfar = fminf(fminf(fminf(hi[0], hi[1]), hi[2]), P.far_plane);

  // camera_zcos (raycast.py:436-452): the cosine between the ray and the
  // optical axis normalize(col0 x col1) of the view matrix
  float zcos = 0.f;
  if (kOF) {
    const float ax = V[4] * V[9] - V[8] * V[5];
    const float ay = V[8] * V[1] - V[0] * V[9];
    const float az = V[0] * V[5] - V[4] * V[1];
    const float ainv = 1.f / sqrtf(ax * ax + ay * ay + az * az);
    zcos = dx * (ax * ainv) + dy * (ay * ainv) + dz * (az * ainv);
  }

  int status;  // 0 marching, 1 hit, 2 missed
  if (kPrimed) {
    // prime_from_depth: the depth frame's surface along the pixel ray
    const float ux = (pxf - Kc[2]) / Kc[0];
    const float uy = (pyf - Kc[3]) / Kc[1];
    const float dep = depth[y * P.w + x];
    const float tp = dep * sqrtf(ux * ux + uy * uy + 1.f);
    const float prime = dep > 0.f ? tp : 0.f;

    // primed start
    const float t_tight =
        prime > 0.f ? fmaxf(tnear, prime - P.small_backoff) : tnear;
    const Probe pt = probe<kOF>(P, pool, ray, t_tight);
    const bool ok_tight = pt.known && (kOF ? pt.val <= 0.f : pt.val > 0.f);
    tnear = ok_tight
                ? t_tight
                : (prime > 0.f ? fmaxf(tnear, prime - P.big_backoff) : tnear);
    status = tnear < tfar ? 0 : 2;
  } else {
    // unprimed start: the value at tnear (the fill where unknown) must lie
    // on the free side
    const Probe p0 = probe<kOF>(P, pool, ray, tnear);
    const float v0 = p0.known ? p0.val : FieldConst<kOF>::fill;
    const bool free_side = kOF ? v0 <= 0.f : v0 > 0.f;
    status = tnear < tfar && free_side ? 0 : 2;
  }

  float t = tnear, ss = kOF ? P.voxel : P.largestep,
        f_t = kOF ? 0.f : __int_as_float(0x7f800000), f_tt = 0.f,
        crawl = 0.f;
  for (int n = 0; n < P.max_probes && status == 0; ++n) {
    const Probe q = probe<kOF>(P, pool, ray, t);
    const bool hit = q.known && (kOF ? q.val > 0.f : q.val < 0.f);
    if (q.known) f_tt = q.val;
    if (hit) {
      status = 1;
      break;
    }
    const float jump =
        fmaxf(P.largestep, fmaxf(q.dist - 1.f, 0.f) * P.bstep +
                               P.half_largestep);
    if (kOF) {
      f_t = f_tt;
      // sigma-band step inside allocated blocks (raycast.py:585-597)
      const float z = t * zcos;
      const float sigma = fminf(fmaxf(P.mu * z * z, P.two_step), 0.05f);
      const float known_step = fminf(fmaxf(0.5f * sigma, P.voxel), P.of_cap);
      ss = q.in_block ? known_step : jump;
    } else {
      if (q.known) f_t = q.val;
      // crawl escalation (raycast.py:568-580, 604-610)
      const float esc = fmaxf(crawl - 16.f, 0.f);
      const float floor_ =
          fminf(P.voxel * (1.f + fminf(esc * 0.125f, 3.f)), P.floor_cap);
      const float known_step = fmaxf(f_tt * P.mu, floor_);
      const bool crawling = q.known && (f_tt * P.mu <= floor_);
      crawl = crawling ? crawl + 1.f : 0.f;
      ss = q.known ? known_step : jump;
    }
    t = t + ss;
    if (t >= tfar) status = 2;
  }

  const bool hit = status == 1;
  // linear zero-crossing estimate from the sample bracket
  float t1;
  if (kOF) {
    const float denom = f_tt == f_t ? 1.f : f_tt - f_t;
    t1 = t - ss * (f_tt - 0.f) / denom;
  } else {
    const float f_hi = isinf(f_t) ? 1.f : f_t;
    const float denom = f_hi == f_tt ? 1.f : f_hi - f_tt;
    t1 = t + ss * f_tt / denom;
  }
  if (!hit) t1 = 0.f;
  const float t_cross = hit ? t : 0.f;
  const float ssh = hit ? ss : 0.f;

  // trilinear value + cell gradient at t1 (raycast.py:_interp_grad)
  const float px = (ox + dx * t1) * P.inv_voxel;
  const float py = (oy + dy * t1) * P.inv_voxel;
  const float pz = (oz + dz * t1) * P.inv_voxel;
  const float bx = floorf(px), by = floorf(py), bz = floorf(pz);
  const float fx = px - bx, fy = py - by, fz = pz - bz;
  const int ix = se::clampi((int)bx, 0, P.size - 1);
  const int iy0 = se::clampi((int)by, 0, P.size - 1);
  const int iz0 = se::clampi((int)bz, 0, P.size - 1);
  const int iy1 = min(iy0 + 1, P.size - 1);
  const int iz1 = min(iz0 + 1, P.size - 1);
  float at_x[4], at_x1[4];  // the four rows' corners at x and x + 1
  corner_pairs<kOF>(P, pool, ix, iy0, iy1, iz0, iz1, at_x, at_x1);
  const float v000 = at_x[0], v100 = at_x1[0], v010 = at_x[1],
              v110 = at_x1[1], v001 = at_x[2], v101 = at_x1[2],
              v011 = at_x[3], v111 = at_x1[3];
  const float c00 = v000 * (1.f - fx) + v100 * fx;
  const float c10 = v010 * (1.f - fx) + v110 * fx;
  const float c01 = v001 * (1.f - fx) + v101 * fx;
  const float c11 = v011 * (1.f - fx) + v111 * fx;
  const float c0 = c00 * (1.f - fy) + c10 * fy;
  const float c1 = c01 * (1.f - fy) + c11 * fy;
  const float v1 = c0 * (1.f - fz) + c1 * fz;
  const float dx00 = v100 - v000, dx10 = v110 - v010, dx01 = v101 - v001,
              dx11 = v111 - v011;
  const float gx = (dx00 * (1.f - fy) + dx10 * fy) * (1.f - fz) +
                   (dx01 * (1.f - fy) + dx11 * fy) * fz;
  const float gy = (c10 - c00) * (1.f - fz) + (c11 - c01) * fz;
  const float gz = c1 - c0;

  // Newton step along the ray, clamped inside the observed bracket (both
  // fields cross the surface at 0)
  const float deriv = (gx * dx + gy * dy + gz * dz) * P.inv_voxel;
  const bool safe = fabsf(deriv) > 1e-6f;
  float t_hit = t1 - (safe ? v1 / deriv : 0.f);
  t_hit = fminf(fmaxf(t_hit, t_cross - ssh), t_cross);
  if (!hit) t_hit = 0.f;

  const float gn = sqrtf(gx * gx + gy * gy + gz * gz);
  float ninv = 1.f / (gn == 0.f ? 1.f : gn);
  if (!kOF) ninv = -ninv;  // TSDF invert_normals
  const bool ok = hit && gn > 0.f;
  const float hx = hit ? ox + dx * t_hit : 0.f;
  const float hy = hit ? oy + dy * t_hit : 0.f;
  const float hz = hit ? oz + dz * t_hit : 0.f;
  vertex[3 * i] = hx;
  vertex[3 * i + 1] = hy;
  vertex[3 * i + 2] = hz;
  normal[3 * i] = ok ? gx * ninv : kInvalid;
  normal[3 * i + 1] = ok ? gy * ninv : 0.f;
  normal[3 * i + 2] = ok ? gz * ninv : 0.f;
  bool keep = ok;
  if (kGate && ok)
    keep = ref_weight(P, pool, slot, hx, hy, hz) >= P.min_ref_weight;
  valid[i] = keep ? 1 : 0;
  return status == 0;
}

template <bool kOF, bool kGate, bool kPrimed>
__global__ void __launch_bounds__(kThreads)
raycast_kernel(Params P, const float* __restrict__ view,
               const int* __restrict__ nav, const float* __restrict__ data_x,
               const float* __restrict__ data_y,
               const int* __restrict__ slot,
               const float* __restrict__ depth, const float* __restrict__ k,
               const uint8_t* __restrict__ when,
               const float* __restrict__ pose,
               const float* __restrict__ old_rp,
               const float* __restrict__ old_vertex,
               const float* __restrict__ old_normal,
               const uint8_t* __restrict__ old_valid,
               float* __restrict__ vertex, float* __restrict__ normal,
               uint8_t* __restrict__ valid, float* __restrict__ raycast_pose,
               int* __restrict__ overflow, int* __restrict__ scratch) {
  __shared__ float V[16], Kc[4];
  __shared__ int cta_live;
  se::load_mat4(view, V);
  if (kPrimed && threadIdx.x < 4) Kc[threadIdx.x] = k[threadIdx.x];
  if (threadIdx.x == 0) cta_live = 0;
  __syncthreads();
  const bool go = when == nullptr || *when;
  if (raycast_pose != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x < 16)
    raycast_pose[threadIdx.x] = go ? pose[threadIdx.x] : old_rp[threadIdx.x];
  // warp w of the CTA takes the 8 x 4 pixel tile (w % 4, w / 4)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // (x, y) of the window, whose outputs are w_out wide; the image column
  // is x0 + x
  const int x = blockIdx.x * kTileW + (warp & 3) * 8 + (lane & 7);
  const int y = blockIdx.y * kTileH + (warp >> 2) * 4 + (lane >> 3);
  const int i = y * P.w_out + x;
  if (x < P.w_out && y < P.h) {
    if (go) {
      Pool pool{nav, data_x, data_y, -1, 0};
      if (march_ray<kOF, kGate, kPrimed>(P, V, Kc, pool, slot, depth,
                                         P.x0 + x, y, i, vertex, normal,
                                         valid))
        atomicAdd(&cta_live, 1);
    } else {  // the state's maps as they were
      for (int a = 0; a < 3; ++a) {
        vertex[3 * i + a] = old_vertex[3 * i + a];
        normal[3 * i + a] = old_normal[3 * i + a];
      }
      valid[i] = old_valid[i];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (cta_live) atomicAdd(&scratch[0], cta_live);
    __threadfence();
    const unsigned int ticket =
        atomicAdd(reinterpret_cast<unsigned int*>(&scratch[1]), 1u);
    if (ticket == gridDim.x * gridDim.y - 1) {  // the last CTA: all are in
      *overflow = atomicExch(&scratch[0], 0);
      atomicExch(&scratch[1], 0);
    }
  }
}

}  // namespace

// The rays of the image columns [x0, x0 + w_out) of a w x h image (the
// sharded step's rank slice; the whole image is x0 = 0, w_out = w), with
// depth the whole w x h frame and the outputs (and the select's old maps)
// h x w_out.
// field: 0 = TSDF, 1 = OFusion. depth and k are null together for the
// unprimed start (then slot must be null too). slot (the map's i32[B^3]
// slot grid) is null for no maturity gate, else (TSDF only) hits whose
// voxel weighs less than min_ref_weight are not valid. when, pose, old_rp, old_vertex,
// old_normal, old_valid and raycast_pose are null together (no select);
// scratch is an i32[2] that is zero before the first launch and that every
// launch leaves zero; launches that share it must not overlap.
SE_EXPORT int se_raycast(const float* view, const int* nav,
                         const float* data_x, const float* data_y,
                         const int* slot, float min_ref_weight,
                         const float* depth, const float* k, int field, int w,
                         int h, int x0, int w_out, int size, int b, int max_probes, float dim,
                         float inv_voxel, float voxel, float largestep,
                         float half_largestep, float bstep, float mu,
                         float near_plane, float far_plane,
                         float small_backoff, float big_backoff,
                         float floor_cap, float two_step, float of_cap,
                         const uint8_t* when, const float* pose,
                         const float* old_rp, const float* old_vertex,
                         const float* old_normal, const uint8_t* old_valid,
                         float* vertex, float* normal, uint8_t* valid,
                         float* raycast_pose, int* overflow, int* scratch,
                         void* stream) {
  Params P{w, h, x0, w_out, size, b, max_probes, dim, inv_voxel, voxel,
           largestep, half_largestep, bstep, mu, near_plane, far_plane,
           small_backoff, big_backoff, floor_cap, two_step, of_cap,
           min_ref_weight};
  if (w <= 0 || h <= 0 || w_out <= 0 || x0 < 0 || x0 + w_out > w)
    return (int)cudaErrorInvalidValue;
  if (field == 1 && slot != nullptr) return (int)cudaErrorInvalidValue;
  const bool primed = depth != nullptr;
  if (primed != (k != nullptr) || (!primed && slot != nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w_out + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  cudaStream_t st = (cudaStream_t)stream;
#define SE_RAYCAST(OF, GATE, PRIMED)                                        \
  raycast_kernel<OF, GATE, PRIMED><<<grid, kThreads, 0, st>>>(              \
      P, view, nav, data_x, data_y, slot, depth, k, when, pose, old_rp,     \
      old_vertex, old_normal, old_valid, vertex, normal, valid,             \
      raycast_pose, overflow, scratch)
  if (!primed && field == 1)
    SE_RAYCAST(true, false, false);
  else if (!primed)
    SE_RAYCAST(false, false, false);
  else if (field == 1)
    SE_RAYCAST(true, false, true);
  else if (slot != nullptr)
    SE_RAYCAST(false, true, true);
  else
    SE_RAYCAST(false, false, true);
#undef SE_RAYCAST
  return (int)cudaGetLastError();
}
