// __device__ dynamics steps shared by the rollout kernels
// (csrc/rollout_grid.cu, csrc/trial_rollout.cu).
//
// Each struct is the twin of a column- or block-form step of
// altro_tpu_torch/models/tile_steps.py, selected on the host by the
// DeviceStep (model, integrator) codes that the Python step carries:
//   model 0, integrator 0: BicycleMidpoint, the twin of
//   midpoint_cols(bicycle_cols(frame, length, rear)) and of
//   midpoint_tile(bicycle_tile(frame, length, rear)), with the slip
//   angle's cos/sin from the triangle identity as there.
// Built without --use_fast_math, so sinf/cosf/tanf/sqrtf are the accurate
// library versions.

#pragma once

#include <cuda_runtime.h>

namespace altro_dev {

struct BicycleMidpoint {
  static constexpr int NS = 4;
  static constexpr int NI = 2;
  int frame;  // 0 centre of gravity, 1 rear axle, 2 front axle
  float length;
  float rear;

  __device__ void f(const float x[NS], const float u[NI], float out[NS]) const {
    const float v = u[0], delta_dot = u[1];
    const float theta = x[2], delta = x[3];
    float cos_ang, sin_ang, omega;
    if (frame == 0) {
      const float rd = rear * delta;
      const float inv_hyp = 1.0f / sqrtf(length * length + rd * rd);
      const float cosb = length * inv_hyp;
      const float sinb = rd * inv_hyp;
      const float ct = cosf(theta), st = sinf(theta);
      cos_ang = ct * cosb - st * sinb;
      sin_ang = st * cosb + ct * sinb;
      omega = v * cosb * tanf(delta) / length;
    } else if (frame == 1) {
      omega = v * tanf(delta) / length;
      cos_ang = cosf(theta);
      sin_ang = sinf(theta);
    } else {
      omega = v * sinf(delta) / length;
      const float ang = theta + delta;
      cos_ang = cosf(ang);
      sin_ang = sinf(ang);
    }
    out[0] = v * cos_ang;
    out[1] = v * sin_ang;
    out[2] = omega;
    out[3] = delta_dot;
  }

  // explicit midpoint: x <- x + h f(x + h/2 f(x, u), u)
  __device__ void step(float x[NS], const float u[NI], float h) const {
    float fx[NS], xm[NS], fm[NS];
    f(x, u, fx);
#pragma unroll
    for (int i = 0; i < NS; ++i) xm[i] = x[i] + 0.5f * h * fx[i];
    f(xm, u, fm);
#pragma unroll
    for (int i = 0; i < NS; ++i) x[i] = x[i] + h * fm[i];
  }
};

// min(w, 0) that keeps a NaN (as jnp.minimum / torch.clamp do)
__device__ __forceinline__ float neg_part(float w) { return (w > 0.0f) ? 0.0f : w; }

}  // namespace altro_dev
