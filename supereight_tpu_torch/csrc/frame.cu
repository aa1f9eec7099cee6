// The frame's pose prologue (frame_mats): every small matrix, gate and
// scalar the stages of parallel/step.py:frame_step build from a pose and
// the intrinsics, in one launch of one warp.
//
// Replaces the se3 algebra the JAX frame step runs inline: the pose select
// and the rate gates (supereight_tpu/parallel/step.py:105-128), the
// OFusion time stamp (:151), the raycast's view = pose @ invK (:162) and
// its frame > 2 gate (:194), tracking's view = K @ inverse(raycast_pose)
// (ops/tracking.py:262), allocation's pose @ invK (ops/allocation.py:42)
// and integration's inverse(pose) and camera_matrix(k)
// (ops/integration.py:310-311). XLA folds these into its programs; as
// torch ops they were ~80 launches a frame.
//
// From k = (fx, fy, cx, cy), a candidate pose pose_t, the pose before the
// frame old_pose (null: pose_t), the tracker's verdict tracked_t (null:
// pose_t counts as tracked whatever the rate, the ground-truth path) and
// the frame number (a device i32, or the value frame_val when null), it
// writes
//   mats[0:16]   pose  = do_track ? pose_t : old_pose,
//                do_track = frame % tracking_rate == 0
//   mats[16:32]  t_cw  = se3.inverse(pose)
//   mats[32:48]  kmat  = se3.camera_matrix(k)
//   mats[48:64]  kpose = pose @ se3.inverse_camera_matrix(k), allocation's
//                march matrix and the raycast's view
//   mats[64:80]  view  = kmat @ t_cw, tracking's view
//   mats[80]     the time stamp f32(1/30) * f32(frame)
//   gates[0..2]  tracked = do_track && tracked_t, do_integrate = (tracked
//                || frame <= 3) && (frame % integration_rate == 0 || frame
//                <= 3), do_raycast = frame > 2
// for frames >= 0 (C's % and Python's agree there).
//
// Lane j < 16 computes entry j of each matrix. Every dot product sums its
// four terms left to right, zero terms included, like se3.matmul4, and the
// library builds with -fmad=false; the intrinsics divide as the twin does
// (1 / fx, and -cx negated first, then a true division). So the kernel
// equals its twin kernels/frame.py:frame_mats_plain bit for bit.
//
// Bound on the H100: ~150 bytes in, ~330 out and ~250 operations, nothing
// at any rate: the launch is the cost, one where the torch ops took ~80.

#include "common.cuh"

namespace {

constexpr int kPose = 0, kTcw = 16, kKmat = 32, kKpose = 48, kView = 64,
              kStamp = 80;

__global__ void __launch_bounds__(32)
frame_mats_kernel(const float* __restrict__ k,
                  const float* __restrict__ pose_t,
                  const float* __restrict__ old_pose,
                  const uint8_t* __restrict__ tracked_t,
                  const int* __restrict__ frame_ptr, int frame_val,
                  int tracking_rate, int integration_rate,
                  float* __restrict__ mats, uint8_t* __restrict__ gates) {
  __shared__ float P[16], T[16], Km[16], Ki[16];
  const int j = threadIdx.x;
  const int frame = frame_ptr != nullptr ? *frame_ptr : frame_val;
  const bool do_track =
      tracked_t == nullptr || frame % tracking_rate == 0;
  if (j < 16) {
    const float* old = old_pose != nullptr ? old_pose : pose_t;
    P[j] = do_track ? pose_t[j] : old[j];
    // camera_matrix and inverse_camera_matrix (ref commons.h:255-270)
    const float fx = k[0], fy = k[1], cx = k[2], cy = k[3];
    float km = 0.f, ki = 0.f;
    switch (j) {
      case 0: km = fx; ki = 1.f / fx; break;
      case 2: km = cx; ki = -cx / fx; break;
      case 5: km = fy; ki = 1.f / fy; break;
      case 6: km = cy; ki = -cy / fy; break;
      case 10:
      case 15: km = 1.f; ki = 1.f; break;
      default: break;
    }
    Km[j] = km;
    Ki[j] = ki;
  }
  __syncwarp();
  if (j < 16) {
    // se3.inverse: [R^T | -(R^T t)] over [0 0 0 1], R^T t summed left to
    // right
    const int r = j >> 2, c = j & 3;
    float v;
    if (r == 3)
      v = c == 3 ? 1.f : 0.f;
    else if (c < 3)
      v = P[4 * c + r];
    else
      v = -(P[r] * P[3] + P[4 + r] * P[7] + P[8 + r] * P[11]);
    T[j] = v;
  }
  __syncwarp();
  if (j < 16) {
    const int r = j >> 2, c = j & 3;
    mats[kPose + j] = P[j];
    mats[kTcw + j] = T[j];
    mats[kKmat + j] = Km[j];
    mats[kKpose + j] = P[4 * r] * Ki[c] + P[4 * r + 1] * Ki[4 + c] +
                       P[4 * r + 2] * Ki[8 + c] + P[4 * r + 3] * Ki[12 + c];
    mats[kView + j] = Km[4 * r] * T[c] + Km[4 * r + 1] * T[4 + c] +
                      Km[4 * r + 2] * T[8 + c] + Km[4 * r + 3] * T[12 + c];
  }
  if (j == 0) {
    const bool tracked =
        tracked_t == nullptr ? true : (do_track && *tracked_t != 0);
    const bool early = frame <= 3;
    mats[kStamp] = (float)(1.0 / 30.0) * (float)frame;
    gates[0] = tracked;
    gates[1] = (tracked || early) && (frame % integration_rate == 0 || early);
    gates[2] = frame > 2;
  }
}

}  // namespace

// old_pose, tracked_t and frame may be null (see above); rates >= 1
SE_EXPORT int se_frame_mats(const float* k, const float* pose_t,
                            const float* old_pose, const uint8_t* tracked_t,
                            const int* frame, int frame_val,
                            int tracking_rate, int integration_rate,
                            float* mats, uint8_t* gates, void* stream) {
  if (tracking_rate < 1 || integration_rate < 1)
    return (int)cudaErrorInvalidValue;
  frame_mats_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      k, pose_t, old_pose, tracked_t, frame, frame_val, tracking_rate,
      integration_rate, mats, gates);
  return (int)cudaGetLastError();
}
