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
//   model 1, integrator 1: QuadrotorAxisRK4, the twin of
//   rk4_cols(quadrotor_cols(mass, gravity, arm, kf, km, inertia)) and of
//   rk4_tile(quadrotor_tile(...)) split over three lanes a trial, one a
//   body axis: `f` is quadrotor_cols' right-hand side (a lane's sine-cosine
//   pair, its angle-rate divide and its body-rate divide, the rest by
//   shuffle), `step` the classic RK4 with the stages and the update
//   x + (h/6)(k1 + 2 k2 + 2 k3 + k4) summed in that order; `axis_policy`
//   the policy split the same way.
//   model 2, integrator 0: PendulumMidpoint, the twin of
//   midpoint_cols(pendulum_cols(mass, length, b, g)): one sine a
//   evaluation, the midpoint step as the bicycle's.
//   model 3, integrator 2 (an exact discrete step, no integrator):
//   DoubleIntegrator, the twin of double_integrator_cols(2) and
//   double_integrator_tile(2).
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
// velocity, body rates; m = 4 rotor thrusts) under classic RK4, split
// over a group of G = 3 lanes of one warp, lane a (0, 1, 2) the body axis
// a. Lane a holds the four state entries of its axis, s = (x_a, x_{3+a},
// x_{6+a}, x_{9+a}): position, angle (roll, pitch, yaw), velocity and body
// rate, and computes their four derivatives:
//   x_a' = x_{6+a}; the angle's rate (roll: wx + sr tp wy + cr tp wz,
//   tp = sp / cp; pitch: cr wy - sr wz; yaw: (sr wy + cr wz) / cp); the
//   acceleration ((cy sp cr + sy sr) T, (sy sp cr - cy sr) T,
//   cp cr T - gravity); and wd_a = (t_a - (w_b J_c w_c - w_c J_b w_b)) / J_a
//   with (b, c) = (a + 1, a + 2) mod 3, the three body-rate expressions of
//   quadrotor_cols in one cyclic form.
// Each lane runs one sincosf (its own angle) and two IEEE divides an
// evaluation, the same code on lane-selected operands (a per-lane branch
// into different expressions would serialise the warp): the attitude
// divide takes num / cp with num = sp (roll, pitch) or sr wy + cr wz (yaw).
// The sines and cosines of the other two lanes come by __shfl_sync from
// the group's lanes base, base + 1, base + 2, the body rates w_b and w_c
// from lanes nb and nc, so every lane of the warp must run the step
// together (lanes that hold no trial run a copy). Each expression keeps
// quadrotor_cols' order of operations (the compiler may still contract a
// product and a sum into one FMA; the roll and pitch accelerations share
// the form (A sp cr + B sr) T, B = -cy for pitch, an exact negation), and
// the RK4 update is the one-lane form's, ((k1 + 2 k2) + 2 k3) + k4, per
// entry.
// Each IEEE divide and each sincosf ends a basic block at its slow-path
// branch, and the compiler does not schedule across one, so the step is
// ordered for the chain: a stage's sincosf is taken right after the angle's
// update (the next knot's first one at the end of the step, where the
// caller's policy can fill its latency), the angle-rate divide before the
// body-rate one.
struct QuadrotorAxisRK4 {
  static constexpr int NS = 12;
  static constexpr int NI = 4;
  static constexpr int G = 3;  // lanes a trial
  float mass, gravity, arm, kf, km, Jx, Jy, Jz;

  // what a lane keeps for the whole rollout: its axis, the warp lanes of
  // the group's axis 0 and of axes a + 1, a + 2 (mod 3), and the inertias
  // about a, a + 1 and a + 2
  struct Axis {
    int a, base, nb, nc;
    float Ja, Jb, Jc;
  };

  __device__ __forceinline__ Axis axis(int a, int base) const {
    return {a, base, base + (a + 1) % 3, base + (a + 2) % 3,
            a == 0 ? Jx : (a == 1 ? Jy : Jz), a == 0 ? Jy : (a == 1 ? Jz : Jx),
            a == 0 ? Jz : (a == 1 ? Jx : Jy)};
  }

  // the sine and cosine of the lane's angle at a stage
  struct Trig {
    float s, c;
  };

  __device__ __forceinline__ static Trig trig(float angle) {
    Trig t;
    sincosf(angle, &t.s, &t.c);
    return t;
  }

  // the thrust over the mass and the lane's torque, fixed through a knot
  struct Thrust {
    float T, t;
  };

  __device__ __forceinline__ Thrust thrust(const float u[NI], const Axis& ax) const {
    const float w0 = kf * u[0], w1 = kf * u[1], w2 = kf * u[2], w3 = kf * u[3];
    const float tx = arm * (w1 - w3);
    const float ty = arm * (w2 - w0);
    const float tz = km * (w0 - w1 + w2 - w3);
    return {(w0 + w1 + w2 + w3) / mass, ax.a == 0 ? tx : (ax.a == 1 ? ty : tz)};
  }

  // the lane's four derivatives at the group's stage state s, whose angle's
  // sine and cosine are tr
  __device__ __forceinline__ void f(const float s[4], Trig tr, const Thrust& th, const Axis& ax,
                                    float out[4]) const {
    constexpr unsigned FULL = 0xffffffffu;
    const float sr = __shfl_sync(FULL, tr.s, ax.base), cr = __shfl_sync(FULL, tr.c, ax.base);
    const float sp = __shfl_sync(FULL, tr.s, ax.base + 1);
    const float cp = __shfl_sync(FULL, tr.c, ax.base + 1);
    const float sy = __shfl_sync(FULL, tr.s, ax.base + 2);
    const float cy = __shfl_sync(FULL, tr.c, ax.base + 2);
    const float wa = s[3];
    const float wb = __shfl_sync(FULL, wa, ax.nb), wc = __shfl_sync(FULL, wa, ax.nc);

    // roll: wx + sr tp wy + cr tp wz with (wx, wy, wz) = (wa, wb, wc) and
    // tp = sp / cp; pitch: cr wy - sr wz, (wy, wz) = (wa, wb); yaw:
    // (sr wy + cr wz) / cp, (wy, wz) = (wc, wa)
    const float q = (ax.a == 2 ? sr * wc + cr * wa : sp) / cp;
    out[1] = ax.a == 0 ? wa + sr * q * wb + cr * q * wc : (ax.a == 1 ? cr * wa - sr * wb : q);
    out[3] = (th.t - (wb * ax.Jc * wc - wc * ax.Jb * wb)) / ax.Ja;
    const float A = ax.a == 0 ? cy : sy, B = ax.a == 0 ? sy : -cy;
    out[2] = ax.a == 2 ? cp * cr * th.T - gravity : (A * sp * cr + B * sr) * th.T;
    out[0] = s[2];
  }

  // classic RK4 on the lane's four entries; the stage sum is kept as it
  // grows, ((k1 + 2 k2) + 2 k3) + k4. tr holds the sine and cosine of
  // s[1] on entry and of the new s[1] on return; h6 = h / 6.
  __device__ __forceinline__ void step(float s[4], Trig& tr, const float u[NI], float h,
                                       float h6, const Axis& ax) const {
    const Thrust th = thrust(u, ax);
    float k[4], xs[4], acc[4];
    f(s, tr, th, ax, k);
    xs[1] = s[1] + 0.5f * h * k[1];
    Trig ts = trig(xs[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] = k[i];
      if (i != 1) xs[i] = s[i] + 0.5f * h * k[i];
    }
    f(xs, ts, th, ax, k);
    xs[1] = s[1] + 0.5f * h * k[1];
    ts = trig(xs[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] = acc[i] + 2.0f * k[i];
      if (i != 1) xs[i] = s[i] + 0.5f * h * k[i];
    }
    f(xs, ts, th, ax, k);
    xs[1] = s[1] + h * k[1];
    ts = trig(xs[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] = acc[i] + 2.0f * k[i];
      if (i != 1) xs[i] = s[i] + h * k[i];
    }
    f(xs, ts, th, ax, k);
    s[1] = s[1] + h6 * (acc[1] + k[1]);
    tr = trig(s[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i != 1) s[i] = s[i] + h6 * (acc[i] + k[i]);
  }
};

// The policy's operands of one lane of a QuadrotorAxisRK4 group at one
// knot: K's columns a, a + 3, a + 6, a + 9 by row (Kc[q] = K[q][a + 3c],
// c = 0..3), x_ref at those entries, and u_ref, d (the group's own).
struct AxisPolicy {
  float4 Kc[4], xr, ur, d;
  float h, h6;  // the step and h / 6
};

// u = u_ref + alpha d - K (x - x_ref) in every lane of the group: lane a sums
// its four columns, then each lane adds the group's three sums in axis
// order (so the group's lanes hold the same bits).
__device__ __forceinline__ void axis_policy(const AxisPolicy& o, const float s[4], float alpha,
                                            int base, float u[4]) {
  constexpr unsigned FULL = 0xffffffffu;
  const float dx[4] = {s[0] - o.xr.x, s[1] - o.xr.y, s[2] - o.xr.z, s[3] - o.xr.w};
  const float ur[4] = {o.ur.x, o.ur.y, o.ur.z, o.ur.w};
  const float d[4] = {o.d.x, o.d.y, o.d.z, o.d.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float k[4] = {o.Kc[q].x, o.Kc[q].y, o.Kc[q].z, o.Kc[q].w};
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) part += k[c] * dx[c];
    const float sum = (__shfl_sync(FULL, part, base) + __shfl_sync(FULL, part, base + 1)) +
                      __shfl_sync(FULL, part, base + 2);
    u[q] = ur[q] + alpha * d[q] - sum;
  }
}

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

// The planar double integrator (n = 4: position, velocity; m = 2
// accelerations) as its exact discrete step, with no integrator around it:
// pos' = (pos + vel h) + u b with b = (0.5 h) h, vel' = vel + u h, in
// double_integrator_cols' order (the positions from the old velocities).
struct DoubleIntegrator {
  static constexpr int NS = 4;
  static constexpr int NI = 2;

  __device__ __forceinline__ void step(float x[NS], const float u[NI], float h) const {
    const float b = 0.5f * h * h;
    const float p0 = x[0] + x[2] * h + u[0] * b;
    const float p1 = x[1] + x[3] * h + u[1] * b;
    x[2] = x[2] + u[0] * h;
    x[3] = x[3] + u[1] * h;
    x[0] = p0;
    x[1] = p1;
  }
};

// min(w, 0) that keeps a NaN (as jnp.minimum / torch.clamp do)
__device__ __forceinline__ float neg_part(float w) { return (w > 0.0f) ? 0.0f : w; }

}  // namespace altro_dev
