// __device__ dynamics steps shared by the rollout kernels
// (csrc/rollout_grid.cu, csrc/trial_rollout.cu).
//
// Each struct is the twin of a column- or block-form step of
// altro_tpu_torch/models/tile_steps.py, selected on the host by the
// DeviceStep (model, integrator) codes that the Python step carries:
//   model 0, integrator 0: the twin of
//   midpoint_cols(bicycle_cols(frame, length, rear)) and of
//   midpoint_tile(bicycle_tile(frame, length, rear)), with the slip
//   angle's cos/sin from the triangle identity as there. BicycleFrame
//   takes the frame as a template parameter. Its `step` is the whole
//   midpoint step (csrc/rollout_grid.cu); csrc/trial_rollout.cu calls
//   `terms` and `f` itself, to split the steering angle's terms between
//   two lanes.
// Built without --use_fast_math, so sinf/cosf/sincosf/tanf/sqrtf are the
// accurate library versions.

#pragma once

#include <cuda_runtime.h>

namespace altro_dev {

// The kinematic bicycle's right-hand side in frame FRAME: 0 centre of
// gravity, 1 rear axle, 2 front axle. The terms that depend on the
// steering angle alone (`terms`) are split from the rest, so a kernel may
// compute them ahead or in another lane: f(x, u) = f(x, u, terms(x_3)).
template <int FRAME>
struct BicycleFrame {
  static constexpr int NS = 4;
  static constexpr int NI = 2;
  float length;
  float rear;

  // cos and sin of the slip angle (frame 0) and the yaw rate's factor:
  // tan(delta) (frames 0, 1) or sin(delta) (frame 2)
  struct Terms {
    float cosb, sinb, rate;
  };

  __device__ __forceinline__ Terms terms(float delta) const {
    Terms t{1.0f, 0.0f, 0.0f};
    if (FRAME == 0) {
      const float rd = rear * delta;
      const float inv_hyp = 1.0f / sqrtf(length * length + rd * rd);
      t.cosb = length * inv_hyp;
      t.sinb = rd * inv_hyp;
      t.rate = tanf(delta);
    } else if (FRAME == 1) {
      t.rate = tanf(delta);
    } else {
      t.rate = sinf(delta);
    }
    return t;
  }

  __device__ __forceinline__ void f(const float x[NS], const float u[NI], const Terms& t,
                                    float out[NS]) const {
    const float v = u[0], delta_dot = u[1];
    const float theta = x[2], delta = x[3];
    float cos_ang, sin_ang, omega;
    if (FRAME == 0) {
      float ct, st;
      sincosf(theta, &st, &ct);
      cos_ang = ct * t.cosb - st * t.sinb;
      sin_ang = st * t.cosb + ct * t.sinb;
      omega = v * t.cosb * t.rate / length;
    } else if (FRAME == 1) {
      omega = v * t.rate / length;
      sincosf(theta, &sin_ang, &cos_ang);
    } else {
      omega = v * t.rate / length;
      sincosf(theta + delta, &sin_ang, &cos_ang);
    }
    out[0] = v * cos_ang;
    out[1] = v * sin_ang;
    out[2] = omega;
    out[3] = delta_dot;
  }

  // explicit midpoint: x <- x + h f(x + h/2 f(x, u), u)
  __device__ __forceinline__ void step(float x[NS], const float u[NI], float h) const {
    float fx[NS], xm[NS], fm[NS];
    f(x, u, terms(x[3]), fx);
#pragma unroll
    for (int i = 0; i < NS; ++i) xm[i] = x[i] + 0.5f * h * fx[i];
    f(xm, u, terms(xm[3]), fm);
#pragma unroll
    for (int i = 0; i < NS; ++i) x[i] = x[i] + h * fm[i];
  }
};

// min(w, 0) that keeps a NaN (as jnp.minimum / torch.clamp do)
__device__ __forceinline__ float neg_part(float w) { return (w > 0.0f) ? 0.0f : w; }

}  // namespace altro_dev
