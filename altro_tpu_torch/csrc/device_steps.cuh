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
//   model 1, integrator 1: QuadrotorRK4, the twin of
//   rk4_cols(quadrotor_cols(mass, gravity, arm, kf, km, inertia)) and of
//   rk4_tile(quadrotor_tile(...)): `f` is quadrotor_cols' right-hand side
//   (three sine-cosine pairs for roll, pitch and yaw, two divides by
//   cos(pitch)), `step` the classic RK4 with the stages and the update
//   x + (h/6)(k1 + 2 k2 + 2 k3 + k4) summed in that order.
//   model 2, integrator 0: PendulumMidpoint, the twin of
//   midpoint_cols(pendulum_cols(mass, length, b, g)): one sine a
//   evaluation, the midpoint step as the bicycle's.
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

// The planar-attitude quadrotor (n = 12: position, roll-pitch-yaw,
// velocity, body rates; m = 4 rotor thrusts) under classic RK4. Each
// expression keeps quadrotor_cols' order of operations (the compiler may
// still contract a product and a sum into one FMA).
struct QuadrotorRK4 {
  static constexpr int NS = 12;
  static constexpr int NI = 4;
  float mass, gravity, arm, kf, km, Jx, Jy, Jz;

  __device__ __forceinline__ void f(const float x[NS], const float u[NI], float out[NS]) const {
    const float wx = x[9], wy = x[10], wz = x[11];
    const float w0 = kf * u[0], w1 = kf * u[1], w2 = kf * u[2], w3 = kf * u[3];
    float cr, sr, cp, sp, cy, sy;
    sincosf(x[3], &sr, &cr);
    sincosf(x[4], &sp, &cp);
    sincosf(x[5], &sy, &cy);

    const float T = (w0 + w1 + w2 + w3) / mass;
    const float ax = (cy * sp * cr + sy * sr) * T;
    const float ay = (sy * sp * cr - cy * sr) * T;
    const float az = cp * cr * T - gravity;

    const float tx = arm * (w1 - w3);
    const float ty = arm * (w2 - w0);
    const float tz = km * (w0 - w1 + w2 - w3);
    const float wdx = (tx - (wy * Jz * wz - wz * Jy * wy)) / Jx;
    const float wdy = (ty - (wz * Jx * wx - wx * Jz * wz)) / Jy;
    const float wdz = (tz - (wx * Jy * wy - wy * Jx * wx)) / Jz;

    const float tp = sp / cp;
    out[0] = x[6];
    out[1] = x[7];
    out[2] = x[8];
    out[3] = wx + sr * tp * wy + cr * tp * wz;
    out[4] = cr * wy - sr * wz;
    out[5] = (sr * wy + cr * wz) / cp;
    out[6] = ax;
    out[7] = ay;
    out[8] = az;
    out[9] = wdx;
    out[10] = wdy;
    out[11] = wdz;
  }

  // classic RK4; the stage sum is kept as it grows, ((k1 + 2 k2) + 2 k3) + k4
  __device__ __forceinline__ void step(float x[NS], const float u[NI], float h) const {
    float k[NS], xs[NS], acc[NS];
    f(x, u, k);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      acc[i] = k[i];
      xs[i] = x[i] + 0.5f * h * k[i];
    }
    f(xs, u, k);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      acc[i] = acc[i] + 2.0f * k[i];
      xs[i] = x[i] + 0.5f * h * k[i];
    }
    f(xs, u, k);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      acc[i] = acc[i] + 2.0f * k[i];
      xs[i] = x[i] + h * k[i];
    }
    f(xs, u, k);
    const float h6 = h / 6.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i) x[i] = x[i] + h6 * (acc[i] + k[i]);
  }
};

// The torque-driven pendulum (n = 2: angle, rate; m = 1 torque) under the
// explicit midpoint: alpha = (tau - b omega) / (m l^2) - (g / l) sin(theta),
// pendulum_cols' expression.
struct PendulumMidpoint {
  static constexpr int NS = 2;
  static constexpr int NI = 1;
  float mass, length, b, g;

  __device__ __forceinline__ void f(const float x[NS], const float u[NI], float out[NS]) const {
    out[0] = x[1];
    out[1] = (u[0] - b * x[1]) / (mass * length * length) - (g / length) * sinf(x[0]);
  }

  // explicit midpoint: x <- x + h f(x + h/2 f(x, u), u)
  __device__ __forceinline__ void step(float x[NS], const float u[NI], float h) const {
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
