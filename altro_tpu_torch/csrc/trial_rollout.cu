// Single-lane W-trial line-search rollout (latency kernel) for Hopper
// (sm_90a): two warps walk the state chains (two lanes a trial), one
// accumulates the merit, one copies.
//
// Replaces: altro_tpu/ops/pallas_rollout.py::_pallas_rollout (its Pallas
// `_kernel` and `_al_term`): the W <= 8 trial rollouts of ONE solve's
// line-search grid,
//   u = u_ref - K (x - x_ref) + alpha_w d,   x+ = step(x, u, h),
// the merit accumulated in the kernel from the diagonal cost rows plus,
// with P > 0 constraint rows, the affine NEGATIVE_ORTHANT augmented-
// Lagrangian term rhoi * sum_e min(w_e, 0)^2, w = wg - wa.x - wu.u taken
// from active-masked, rho-premultiplied rows (rhoi = 1/(2 rho)); the
// terminal knot adds its cost and its state-only AL term. The TPU kernel
// ran the W trials as rows of one tile down a sequential grid.
//
// What bounds it on this card: the chain. At N=500, W=8, n=4, m=2, P=2
// the kernel reads 44 floats per knot (88 KB in all) and writes the W
// state stacks (64 KB): 0.05 us at 3.35 TB/s. Each trial is a chain of N
// dependent midpoint steps; only the policy and the two bicycle
// evaluations (a square root and a divide, a sine and cosine, a tangent
// and a divide by the length, each) lie on it, and the time is N times
// their latency. The merit depends on the states but feeds nothing back.
// The accurate library functions branch to their slow paths, so one
// thread's evaluations run one after the other.
//
// What the design does about it: one block of 128 threads, launched once.
// Two lanes of warps 0-1 (the chain warps) run each trial and do only what
// the chain needs: per knot the policy, the store of x to a staging buffer
// in shared memory and the midpoint step, with the next knot's K, x_ref,
// u_ref, d and h read (16-byte loads, all lanes one address) into
// registers one knot ahead. The steering angle moves by u_1 alone, so
// once u is known both its midpoint and its next value are: lane 1 of the
// pair computes the midpoint's steering terms (tanf, and the slip angle's
// square root and divide) while lane 0 computes the next knot's, the same
// code on two arguments, and a shuffle hands each its partner's. So a
// lane runs one of the model's two evaluations of those terms a knot, and
// the same arithmetic as the one-lane step (the same bits). The frame and
// P (0, 2 or 4: the steering bound's rows, or two groups of two, whose
// rows at a knot where a group is off are all zero, as the solver packs
// them) are template parameters (9 instantiations), so the step has no
// branch of its own and the row loops unroll. Lanes 0..W-1 of warp 2 (the
// merit warp) walk each chunk after the chain warps have left it: each
// recomputes u from the staged state with the same expression (so the
// same bits), accumulates phi in the same knot and term order as the
// plain version's terms below, and stores the states to xstack. Warp 3
// stages the operands in chunks of CH knots with 16-byte cp.async where
// a slice is 16-byte aligned. The pipeline runs in steps: in step s warp 3
// stages chunk s+1, the chain warps walk chunk s and warp 2 chunk s-1, so
// the operands are triple-buffered and the states double-buffered; one
// barrier ends each step. Dynamic shared memory is 3 x operands + 2 x
// states of one chunk (50 KB at n=4, m=2, P=2, W=8, 61 KB at P=4; the
// launch opts in above 48 KB).
//
// The dynamics are a __device__ step from csrc/device_steps.cuh, the twin
// of models/tile_steps.py::midpoint_tile(bicycle_tile(frame, length,
// rear)). The quadrotor's RK4 step (rk4_tile(quadrotor_tile())) runs in a
// second kernel, on the same pipeline with three lanes a trial, and the
// pendulum's midpoint step (midpoint_tile(pendulum_tile())) and the double
// integrator's exact step (double_integrator_tile(2)) in a third, one lane
// a trial on either model (each kernel with its own note below). The merit follows
// ops/trial_rollout.py::trial_rollout_ref term
// for term: phi += 0.5 Q.x.x + q.x + 0.5 R.u.u + r.u + c, then
// + rhoi * sum_e min(w_e, 0)^2.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_steps.cuh"

namespace {

using altro_dev::BicycleFrame;
using altro_dev::neg_part;

constexpr int NS = 4, NI = 2;  // the bicycle's state and input widths
constexpr int CH = 64;         // knots per staged chunk
constexpr int THREADS = 128;   // warps 0-1: the chain; warp 2: the merit; warp 3: copies
constexpr int COPIERS = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_W = 32;

// Float offsets of one chunk's operands in shared memory for a model of
// S states and I inputs, chunks of CHK knots and P rows (each array
// [CHK][width], 16-byte aligned); three such buffers, then a kernel's own
// state buffers from XS on. The bicycle's and the one-lane kernels stage
// through it (`stage`).
template <int S_, int I_, int CHK_, int P_>
struct OperandLayout {
  static constexpr int S = S_, I = I_, CHK = CHK_, P = P_;
  static constexpr int XREF = 0;
  static constexpr int UREF = XREF + CHK * S;
  static constexpr int K = UREF + CHK * I;
  static constexpr int D = K + CHK * I * S;
  static constexpr int H = D + CHK * I;
  static constexpr int Q = H + CHK;
  static constexpr int QL = Q + CHK * S;
  static constexpr int R = QL + CHK * S;
  static constexpr int RL = R + CHK * I;
  static constexpr int C = RL + CHK * I;
  static constexpr int WA = C + CHK;
  static constexpr int WU = WA + CHK * P * S;
  static constexpr int WG = WU + CHK * P * I;
  static constexpr int IN = WG + CHK * P;
  static constexpr int XS = 3 * IN;
  static_assert(IN % 4 == 0 && CHK % 4 == 0, "16-byte aligned arrays");
};

// The bicycle's: then two state buffers [W][CH][NS] and the final states
// [W][NS].
template <int P>
struct Layout : OperandLayout<NS, NI, CH, P> {
  static int floats(int W) { return Layout::XS + 2 * W * CH * NS + W * NS; }
};

struct Args {
  const float *xref, *uref, *K, *d, *Q, *q, *R, *r, *c, *h, *wa, *wu, *wg;
  const float* rhoi;
  const float *alphas, *x0;
  float *phi, *xstack;
  int N, W;
  float length, rear;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// count floats global -> shared with cp.async: 16 bytes a copy when both
// ends are 16-byte aligned, else one float a copy.
__device__ __forceinline__ void copy_in(float* dst, const float* src, int count, int t) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const int n4 = count / 4;
    for (int i = t; i < n4; i += COPIERS) __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    done = 4 * n4;
  }
  for (int i = done + t; i < count; i += COPIERS) __pipeline_memcpy_async(dst + i, src + i, 4);
}

// Chunk c of CHK knots covers knots [kbeg, kbeg + cnt), walked forward.
template <int CHK>
__device__ __forceinline__ void chunk_range(int c, int N, int& kbeg, int& cnt) {
  kbeg = c * CHK;
  cnt = (N - kbeg < CHK) ? N - kbeg : CHK;
}

// Stage chunk c's operands into buf at an OperandLayout's offsets.
template <class Ly>
__device__ void stage(float* buf, const Args& a, int c, int t) {
  constexpr int S = Ly::S, I = Ly::I, P = Ly::P;
  int kbeg, cnt;
  chunk_range<Ly::CHK>(c, a.N, kbeg, cnt);
  const long k0 = kbeg;
  copy_in(buf + Ly::XREF, a.xref + k0 * S, cnt * S, t);
  copy_in(buf + Ly::UREF, a.uref + k0 * I, cnt * I, t);
  copy_in(buf + Ly::K, a.K + k0 * I * S, cnt * I * S, t);
  copy_in(buf + Ly::D, a.d + k0 * I, cnt * I, t);
  copy_in(buf + Ly::H, a.h + k0, cnt, t);
  copy_in(buf + Ly::Q, a.Q + k0 * S, cnt * S, t);
  copy_in(buf + Ly::QL, a.q + k0 * S, cnt * S, t);
  copy_in(buf + Ly::R, a.R + k0 * I, cnt * I, t);
  copy_in(buf + Ly::RL, a.r + k0 * I, cnt * I, t);
  copy_in(buf + Ly::C, a.c + k0, cnt, t);
  if (P > 0) {
    copy_in(buf + Ly::WA, a.wa + k0 * P * S, cnt * P * S, t);
    copy_in(buf + Ly::WU, a.wu + k0 * P * I, cnt * P * I, t);
    copy_in(buf + Ly::WG, a.wg + k0 * P, cnt * P, t);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The policy's operands at one knot.
struct Policy {
  float4 K0, K1, xr;
  float2 ur, d;
};

template <int P>
__device__ __forceinline__ Policy load_policy(const float* in, int j) {
  using Ly = Layout<P>;
  Policy o;
  o.K0 = reinterpret_cast<const float4*>(in + Ly::K)[2 * j];
  o.K1 = reinterpret_cast<const float4*>(in + Ly::K)[2 * j + 1];
  o.xr = reinterpret_cast<const float4*>(in + Ly::XREF)[j];
  o.ur = reinterpret_cast<const float2*>(in + Ly::UREF)[j];
  o.d = reinterpret_cast<const float2*>(in + Ly::D)[j];
  return o;
}

// u = u_ref + alpha d - K (x - x_ref), each rounding pinned, so the chain
// and the merit warp compute the same bits.
__device__ __forceinline__ void policy(const Policy& o, const float x[NS], float alpha,
                                       float u[NI]) {
  const float dx[NS] = {__fsub_rn(x[0], o.xr.x), __fsub_rn(x[1], o.xr.y),
                        __fsub_rn(x[2], o.xr.z), __fsub_rn(x[3], o.xr.w)};
  const float k0[NS] = {o.K0.x, o.K0.y, o.K0.z, o.K0.w};
  const float k1[NS] = {o.K1.x, o.K1.y, o.K1.z, o.K1.w};
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s0 = __fmaf_rn(k0[i], dx[i], s0);
    s1 = __fmaf_rn(k1[i], dx[i], s1);
  }
  u[0] = __fsub_rn(__fmaf_rn(alpha, o.d.x, o.ur.x), s0);
  u[1] = __fsub_rn(__fmaf_rn(alpha, o.d.y, o.ur.y), s1);
}

// One block per launch; saying so lets ptxas use what registers it likes.
template <int FRAME, int P>
__global__ void __launch_bounds__(THREADS, 1) trial_rollout_kernel(const Args a) {
  using Ly = Layout<P>;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.N, W = a.W, nch = (N + CH - 1) / CH;
  float* const xsbuf = smem + Ly::XS;  // states of chunk s at xsbuf + (s & 1) * W * CH * NS
  float* const xfinal = xsbuf + 2 * W * CH * NS;

  if (warp == 3) stage<Ly>(smem, a, 0, tid - 96);
  __syncthreads();

  if (warp < 2) {  // the chain: x through the N steps, two lanes a trial
    using Model = BicycleFrame<FRAME>;
    using Terms = typename Model::Terms;
    const Model model{a.length, a.rear};
    const int w = tid >> 1, half = tid & 1;
    const bool mine = w < W && half == 0;  // the lane that stores trial w's states
    const bool busy = warp * 16 < W;       // a warp without a trial only meets the barriers
    const float alpha = a.alphas[w < W ? w : W - 1];  // lanes past W run a copy of the last trial
    float x[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) x[i] = a.x0[i];
    Terms tk = model.terms(x[3]);  // the steering terms at knot k, for f(x_k, u_k)
    for (int s = 0; s <= nch; ++s) {
      if (s < nch && busy) {
        int kbeg, cnt;
        chunk_range<CH>(s, N, kbeg, cnt);
        const float* in = smem + (s % 3) * Ly::IN;
        float4* xs = reinterpret_cast<float4*>(xsbuf + (s & 1) * W * CH * NS + w * CH * NS);
        Policy cur = load_policy<P>(in, 0);
        float h = in[Ly::H];
        for (int j = 0; j < cnt; ++j) {
          float u[NI];
          policy(cur, x, alpha, u);
          if (mine) xs[j] = make_float4(x[0], x[1], x[2], x[3]);
          const int jn = j + 1 < cnt ? j + 1 : j;
          const Policy nxt = load_policy<P>(in, jn);
          const float hn = in[Ly::H + jn];
          // the explicit midpoint x + h f(x + h/2 f(x, u), u): the steering
          // angle moves by u_1 alone, so its midpoint and next values are
          // known now; lane 1 of the pair takes the midpoint's steering
          // terms, lane 0 the next knot's, at the same time
          const float dm = __fmaf_rn(0.5f * h, u[1], x[3]);
          const float dn = __fmaf_rn(h, u[1], x[3]);
          const Terms own = model.terms(half ? dm : dn);
          float fx[NS], fm[NS];
          model.f(x, u, tk, fx);
          const float xm[NS] = {x[0], x[1], x[2] + 0.5f * h * fx[2], dm};
          Terms tm = own, tn = own;
          tm.rate = __shfl_sync(FULL_MASK, own.rate, tid | 1);
          tn.rate = __shfl_sync(FULL_MASK, own.rate, tid & ~1);
          if (FRAME == 0) {
            tm.cosb = __shfl_sync(FULL_MASK, own.cosb, tid | 1);
            tm.sinb = __shfl_sync(FULL_MASK, own.sinb, tid | 1);
            tn.cosb = __shfl_sync(FULL_MASK, own.cosb, tid & ~1);
            tn.sinb = __shfl_sync(FULL_MASK, own.sinb, tid & ~1);
          }
          model.f(xm, u, tm, fm);
#pragma unroll
          for (int i = 0; i < NS - 1; ++i) x[i] = x[i] + h * fm[i];
          x[3] = dn;  // = x_3 + h fm_3, fm_3 = u_1
          tk = tn;
          cur = nxt;
          h = hn;
        }
        if (s == nch - 1 && mine) {
          reinterpret_cast<float4*>(xfinal)[w] = make_float4(x[0], x[1], x[2], x[3]);
#pragma unroll
          for (int i = 0; i < NS; ++i) a.xstack[((long)w * (N + 1) + N) * NS + i] = x[i];
        }
      }
      __syncthreads();
    }
  } else if (warp == 2) {  // the merit of chunk s - 1, and its states out
    const bool trial = lane < W;
    const float alpha = trial ? a.alphas[lane] : 0.0f;
    const float ri = P > 0 ? *a.rhoi : 0.0f;
    const bool vec = aligned16(a.xstack);
    float phi = 0.0f;
    for (int s = 0; s <= nch; ++s) {
      if (s >= 1 && trial) {
        int kbeg, cnt;
        chunk_range<CH>(s - 1, N, kbeg, cnt);
        const float* in = smem + ((s - 1) % 3) * Ly::IN;
        const float4* xs =
            reinterpret_cast<const float4*>(xsbuf + ((s - 1) & 1) * W * CH * NS + lane * CH * NS);
        float* xout = a.xstack + ((long)lane * (N + 1) + kbeg) * NS;
        for (int j = 0; j < cnt; ++j) {
          const float4 xv = xs[j];
          const float x[NS] = {xv.x, xv.y, xv.z, xv.w};
          float u[NI];
          policy(load_policy<P>(in, j), x, alpha, u);
          float sq = 0.0f, sl = 0.0f, su = 0.0f, sr = 0.0f;
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            sq += in[Ly::Q + j * NS + i] * x[i] * x[i];
            sl += in[Ly::QL + j * NS + i] * x[i];
          }
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            su += in[Ly::R + j * NI + i] * u[i] * u[i];
            sr += in[Ly::RL + j * NI + i] * u[i];
          }
          float ph = phi + 0.5f * sq + sl + 0.5f * su + sr + in[Ly::C + j];
          if (P > 0) {
            float alc = 0.0f;
#pragma unroll
            for (int e = 0; e < P; ++e) {
              float we = in[Ly::WG + j * P + e];
              float sa = 0.0f, sb = 0.0f;
#pragma unroll
              for (int i = 0; i < NS; ++i) sa += in[Ly::WA + (j * P + e) * NS + i] * x[i];
#pragma unroll
              for (int i = 0; i < NI; ++i) sb += in[Ly::WU + (j * P + e) * NI + i] * u[i];
              we = we - sa - sb;
              const float pw = neg_part(we);
              alc += pw * pw;
            }
            ph += ri * alc;
          }
          phi = ph;
          if (vec) {
            reinterpret_cast<float4*>(xout)[j] = xv;
          } else {
#pragma unroll
            for (int i = 0; i < NS; ++i) xout[j * NS + i] = x[i];
          }
        }
      }
      __syncthreads();
    }
    if (trial) {  // terminal knot: state-only cost and constraint rows
      const float4 xv = reinterpret_cast<const float4*>(xfinal)[lane];
      const float x[NS] = {xv.x, xv.y, xv.z, xv.w};
      float sq = 0.0f, sl = 0.0f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        sq += a.Q[(long)N * NS + i] * x[i] * x[i];
        sl += a.q[(long)N * NS + i] * x[i];
      }
      float ph = phi + 0.5f * sq + sl + a.c[N];
      if (P > 0) {
        float alc = 0.0f;
#pragma unroll
        for (int e = 0; e < P; ++e) {
          float sa = 0.0f;
#pragma unroll
          for (int i = 0; i < NS; ++i) sa += a.wa[((long)N * P + e) * NS + i] * x[i];
          const float pw = neg_part(a.wg[(long)N * P + e] - sa);
          alc += pw * pw;
        }
        ph += ri * alc;
      }
      a.phi[lane] = ph;
    }
  } else {  // the copies: chunk s + 1 in
    for (int s = 0; s <= nch; ++s) {
      if (s + 1 < nch) stage<Ly>(smem + ((s + 1) % 3) * Ly::IN, a, s + 1, tid - 96);
      __syncthreads();
    }
  }
}

template <int FRAME, int P>
int launch(const Args& a, cudaStream_t s) {
  auto kern = trial_rollout_kernel<FRAME, P>;
  const size_t bytes = (size_t)Layout<P>::floats(a.W) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<1, THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int FRAME>
int launch_p(const Args& a, int P, cudaStream_t s) {
  if (P == 0) return launch<FRAME, 0>(a, s);
  if (P == 2) return launch<FRAME, 2>(a, s);
  if (P == 4) return launch<FRAME, 4>(a, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The quadrotor's RK4 block step (rk4_tile(quadrotor_tile())), P = 0:
// three lanes a trial.
//
// What bounds it on this card: the chain again. An RK4 step is four
// evaluations of the model behind the policy; one evaluation's path is a
// sine-cosine pair (13 dependent instructions on its fast path), an IEEE
// divide by cos(pitch) and the angle-rate update (about 85 dependent
// instructions a knot in all). One knot's operands are 102 floats, read
// once: 12 KB at N=30 (4 ns at 3.35 TB/s). With one warp of chains the
// time is a lane's instruction stream a knot, nearly in order: each
// accurate sincosf and IEEE divide ends a basic block at its slow-path
// branch, and the compiler does not schedule across one (on an NVIDIA
// H100 80GB HBM3 at 700 W, swapping in the approximate __sincosf and
// __fdividef, not allowed here, took 42% off this kernel, 25% off the
// grid's).
//
// What the design does about it: one block; chain warps of ten trial groups
// of G = 3 lanes (lanes 30, 31 mirror the tenth), as many as W needs (W <=
// 32: four), then a merit warp and a copy warp, the bicycle kernel's
// pipeline above. Each lane of a group runs one body axis of
// QuadrotorAxisRK4 (csrc/device_steps.cuh): a third of the model's sines,
// cosines, divides and stage updates, with the group's other values by
// shuffle, and a third of the policy's columns (`axis_policy`), so W = 8
// trials take one warp and a lane's stream is a third of the model's
// library calls. The next knot's policy operands (K's four columns of the
// lane's axis, its x_ref, u_ref, d, h and h / 6) are read from shared
// memory into registers a knot ahead. Per knot the chain stores its state
// (a float4 a lane) and u to a staging buffer; the merit warp, one chunk
// behind, reads them back, accumulates phi in the plain version's term
// order and writes xstack; the copy warp stages the operands in chunks of
// QCH knots with cp.async, K and x_ref permuted by axis (one axis's 20
// floats a knot contiguous, the three at offsets that share no bank), and
// computes h / 6 for the chain. Dynamic shared memory: 3 x operands + 2 x
// states of a chunk (47,264 bytes at W = 32).

namespace quad {

using altro_dev::AxisPolicy;
using altro_dev::QuadrotorAxisRK4;

constexpr int S = QuadrotorAxisRK4::NS, I = QuadrotorAxisRK4::NI, G = QuadrotorAxisRK4::G;
constexpr int GROUPS = 10;          // trial groups a chain warp
constexpr int QCH = 8;              // knots per staged chunk
constexpr int AX = 20;              // one axis's policy operands a knot: Kc (16), x_ref (4)
constexpr int MAX_CHAIN_WARPS = (MAX_W + GROUPS - 1) / GROUPS;
// Float offsets of one chunk's operands (each array [QCH][width]), three
// such buffers, then two state buffers [W][TSTRIDE] and the final states
// [W][12] (each knot's record: the three axes' float4, then u).
constexpr int KX = 0;  // [QCH][3][AX]
constexpr int UR = KX + QCH * 3 * AX;
constexpr int D = UR + QCH * I;
constexpr int Q = D + QCH * I;
constexpr int QL = Q + QCH * S;
constexpr int R = QL + QCH * S;
constexpr int RL = R + QCH * I;
constexpr int H = RL + QCH * I;
constexpr int H6 = H + QCH;  // h / 6, computed by the copy warp
constexpr int C = H6 + QCH;
constexpr int IN = C + QCH;
constexpr int REC = 16;
constexpr int TSTRIDE = QCH * REC + 12;  // 12 floats of padding: a phase's float4 stores share no bank
constexpr int XS = 3 * IN;
static_assert(IN % 4 == 0 && TSTRIDE % 4 == 0, "16-byte aligned arrays");
inline int floats(int W) { return XS + 2 * W * TSTRIDE + W * S; }

// Stage chunk c: K and x_ref one float at a time into the axis order,
// the rest with copy_in; then h / 6 (the RK4 update's weight, off the
// chain).
__device__ void stage(float* buf, const Args& a, int c, int t) {
  int kbeg, cnt;
  chunk_range<QCH>(c, a.N, kbeg, cnt);
  const long k0 = kbeg;
  for (int e = t; e < cnt * 3 * AX; e += COPIERS) {
    const int j = e / (3 * AX), r = e % (3 * AX), ax = r / AX, f = r % AX;
    const long k = k0 + j;
    const float* src = f < 16 ? a.K + (k * I + f / 4) * S + ax + 3 * (f % 4)
                              : a.xref + k * S + ax + 3 * (f - 16);
    __pipeline_memcpy_async(buf + KX + e, src, sizeof(float));
  }
  copy_in(buf + UR, a.uref + k0 * I, cnt * I, t);
  copy_in(buf + D, a.d + k0 * I, cnt * I, t);
  copy_in(buf + Q, a.Q + k0 * S, cnt * S, t);
  copy_in(buf + QL, a.q + k0 * S, cnt * S, t);
  copy_in(buf + R, a.R + k0 * I, cnt * I, t);
  copy_in(buf + RL, a.r + k0 * I, cnt * I, t);
  copy_in(buf + H, a.h + k0, cnt, t);
  copy_in(buf + C, a.c + k0, cnt, t);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
  if (t < cnt) buf[H6 + t] = buf[H + t] / 6.0f;
}

__device__ __forceinline__ AxisPolicy load_policy(const float* in, int j, int ax) {
  AxisPolicy o;
  const float4* kx = reinterpret_cast<const float4*>(in + KX + (j * 3 + ax) * AX);
#pragma unroll
  for (int q = 0; q < 4; ++q) o.Kc[q] = kx[q];
  o.xr = kx[4];
  o.ur = reinterpret_cast<const float4*>(in + UR)[j];
  o.d = reinterpret_cast<const float4*>(in + D)[j];
  o.h = in[H + j];
  o.h6 = in[H6 + j];
  return o;
}

// The merit's terms at one knot in the plain version's order; x in entry
// order, u null at the terminal knot.
__device__ __forceinline__ float merit(float phi, const float* Qd, const float* ql,
                                       const float* Rd, const float* rl, float c,
                                       const float x[S], const float* u) {
  float sq = 0.0f, sl = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    sq += Qd[i] * x[i] * x[i];
    sl += ql[i] * x[i];
  }
  if (u == nullptr) return phi + 0.5f * sq + sl + c;
  float su = 0.0f, sr = 0.0f;
#pragma unroll
  for (int q = 0; q < I; ++q) {
    su += Rd[q] * u[q] * u[q];
    sr += rl[q] * u[q];
  }
  return phi + 0.5f * sq + sl + 0.5f * su + sr + c;
}

// A record's three axis float4s back in entry order (entry a + 3c at
// axis a, slot c).
__device__ __forceinline__ void unpermute(const float4* v, float x[S]) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    x[ax] = v[ax].x;
    x[ax + 3] = v[ax].y;
    x[ax + 6] = v[ax].z;
    x[ax + 9] = v[ax].w;
  }
}

__global__ void __launch_bounds__(32 * (MAX_CHAIN_WARPS + 2), 1)
    trial_rollout_quadrotor_kernel(const Args a, const QuadrotorAxisRK4 model) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.N, W = a.W, nch = (N + QCH - 1) / QCH;
  const int chain_warps = blockDim.x / 32 - 2;
  float* const xsbuf = smem + XS;  // states of chunk s at xsbuf + (s & 1) * W * TSTRIDE
  float* const xfinal = xsbuf + 2 * W * TSTRIDE;

  if (warp == chain_warps + 1) stage(smem, a, 0, lane);
  __syncthreads();

  if (warp < chain_warps) {  // the chain: three lanes a trial
    const int g = min(lane / G, GROUPS - 1), ax = lane % G, base = G * g;
    const int w = warp * GROUPS + g;
    const bool mine = w < W && lane < G * GROUPS;  // the lanes that store trial w's states
    const int wt = w < W ? w : W - 1;              // groups past W run a copy of the last trial
    const float alpha = a.alphas[wt];
    const QuadrotorAxisRK4::Axis axis = model.axis(ax, base);
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = a.x0[ax + 3 * c];
    QuadrotorAxisRK4::Trig tr = QuadrotorAxisRK4::trig(s[1]);
    for (int st = 0; st <= nch; ++st) {
      if (st < nch) {
        int kbeg, cnt;
        chunk_range<QCH>(st, N, kbeg, cnt);
        const float* in = smem + (st % 3) * IN;
        float* xs = xsbuf + (st & 1) * W * TSTRIDE + wt * TSTRIDE;
        AxisPolicy cur = load_policy(in, 0, ax);
        for (int j = 0; j < cnt; ++j) {
          float u[I];
          altro_dev::axis_policy(cur, s, alpha, base, u);
          if (mine) {
            reinterpret_cast<float4*>(xs + j * REC)[ax] = make_float4(s[0], s[1], s[2], s[3]);
            if (ax == 0) reinterpret_cast<float4*>(xs + j * REC)[3] = make_float4(u[0], u[1], u[2], u[3]);
          }
          const float h = cur.h, h6 = cur.h6;
          cur = load_policy(in, j + 1 < cnt ? j + 1 : j, ax);
          model.step(s, tr, u, h, h6, axis);
        }
        if (st == nch - 1 && mine)
          reinterpret_cast<float4*>(xfinal + wt * S)[ax] = make_float4(s[0], s[1], s[2], s[3]);
      }
      __syncthreads();
    }
  } else if (warp == chain_warps) {  // the merit of chunk s - 1, and its states out
    const bool trial = lane < W;
    const bool vec = aligned16(a.xstack);
    float phi = 0.0f;
    for (int st = 0; st <= nch; ++st) {
      if (st >= 1 && trial) {
        int kbeg, cnt;
        chunk_range<QCH>(st - 1, N, kbeg, cnt);
        const float* in = smem + ((st - 1) % 3) * IN;
        const float* xs = xsbuf + ((st - 1) & 1) * W * TSTRIDE + lane * TSTRIDE;
        float* xout = a.xstack + ((long)lane * (N + 1) + kbeg) * S;
        for (int j = 0; j < cnt; ++j) {
          const float4* rec = reinterpret_cast<const float4*>(xs + j * REC);
          float x[S];
          unpermute(rec, x);
          const float4 uv = rec[3];
          const float u[I] = {uv.x, uv.y, uv.z, uv.w};
          phi = merit(phi, in + Q + j * S, in + QL + j * S, in + R + j * I, in + RL + j * I,
                      in[C + j], x, u);
          if (vec) {
#pragma unroll
            for (int v = 0; v < 3; ++v)
              reinterpret_cast<float4*>(xout + j * S)[v] =
                  make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
          } else {
#pragma unroll
            for (int i = 0; i < S; ++i) xout[j * S + i] = x[i];
          }
        }
      }
      __syncthreads();
    }
    if (trial) {  // terminal knot: the state-only cost
      float x[S];
      unpermute(reinterpret_cast<const float4*>(xfinal + lane * S), x);
      a.phi[lane] = merit(phi, a.Q + (long)N * S, a.q + (long)N * S, nullptr, nullptr, a.c[N],
                          x, nullptr);
#pragma unroll
      for (int i = 0; i < S; ++i) a.xstack[((long)lane * (N + 1) + N) * S + i] = x[i];
    }
  } else {  // the copies: chunk s + 1 in
    for (int st = 0; st <= nch; ++st) {
      if (st + 1 < nch) stage(smem + ((st + 1) % 3) * IN, a, st + 1, lane);
      __syncthreads();
    }
  }
}

int launch(const Args& a, const QuadrotorAxisRK4& model, cudaStream_t s) {
  const int chain_warps = (a.W + GROUPS - 1) / GROUPS;
  const size_t bytes = (size_t)floats(a.W) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trial_rollout_quadrotor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  trial_rollout_quadrotor_kernel<<<1, 32 * (chain_warps + 2), bytes, s>>>(a, model);
  return (int)cudaGetLastError();
}

}  // namespace quad

// The merit's terms at one knot in trial_rollout_ref's order for a model of
// S states and I inputs with P rows; u null at the terminal knot (the
// one-lane-a-trial kernel's merit warp).
template <int S, int I, int P>
__device__ __forceinline__ float merit(float phi, const float* Qd, const float* ql,
                                       const float* Rd, const float* rl, float c,
                                       const float* wa, const float* wu, const float* wg,
                                       float ri, const float x[S], const float* u) {
  float sq = 0.0f, sl = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    sq += Qd[i] * x[i] * x[i];
    sl += ql[i] * x[i];
  }
  float ph;
  if (u == nullptr) {
    ph = phi + 0.5f * sq + sl + c;
  } else {
    float su = 0.0f, sr = 0.0f;
#pragma unroll
    for (int i = 0; i < I; ++i) {
      su += Rd[i] * u[i] * u[i];
      sr += rl[i] * u[i];
    }
    ph = phi + 0.5f * sq + sl + 0.5f * su + sr + c;
  }
  if (P > 0) {
    float alc = 0.0f;
#pragma unroll
    for (int e = 0; e < P; ++e) {
      float sa = 0.0f;
#pragma unroll
      for (int i = 0; i < S; ++i) sa += wa[e * S + i] * x[i];
      float we = wg[e] - sa;
      if (u != nullptr) {
        float sb = 0.0f;
#pragma unroll
        for (int i = 0; i < I; ++i) sb += wu[e * I + i] * u[i];
        we = we - sb;
      }
      const float pw = neg_part(we);
      alc += pw * pw;
    }
    ph += ri * alc;
  }
  return ph;
}


// ---------------------------------------------------------------------------
// One lane a trial: the pendulum's midpoint block step
// (midpoint_tile(pendulum_tile()), P = 0 or 2: the torque bound's two rows on
// u) and the double integrator's exact discrete step (double_integrator_
// tile(2), P = 0, 2 or 4), each a Model with a `step(x, u, h)`.
//
// What bounds it on this card: the chain. A pendulum knot is the policy
// (two multiply-adds behind x), two evaluations of the model (a sine and an
// IEEE divide each) and the two updates; a double integrator knot 8
// multiply-adds of policy and 8 of step. One knot's operands are 3S + 3I +
// SI + 2 + P(S + I + 1) floats, read once: 2.6 KB at the pendulum's N = 30,
// P = 2 and 7 KB at the double integrator's N = 30, P = 4 (under 3 ns at
// 3.35 TB/s). With W <= 32 trials on one warp the time is one lane's
// instruction stream, N knots long, nearly in order (the pendulum's
// accurate sinf and divide end a basic block at their slow-path
// branches); at the facades' N of 10 and 30 the launch and the barriers
// are most of it.
//
// What the design does about it: one block of three warps, launched once.
// Warp 0 (the chain) runs trial w on lane w (lanes past W run a copy of
// the last trial and store nothing); per knot it forms u (as
// trial_rollout_ref: u_ref - K (x - x_ref) + alpha d) from K, x_ref, u_ref,
// d and h held in registers, read from the staged chunk a knot ahead so
// that no shared-memory load sits on the chain, stores (x, u) as one
// record of REC floats (float4 stores) to a staging buffer in shared
// memory and takes the Model's step (csrc/device_steps.cuh; the
// pendulum's is the one rollout_grid.cu runs). Warp 1 (the merit) walks
// each chunk one step behind: from the staged records it accumulates phi
// in trial_rollout_ref's term order (the cost terms, then rhoi * sum_e
// min(w_e, 0)^2 over the rows) and writes x to xstack; it adds the
// terminal knot's state-only terms at the end. Warp 2 stages the operands
// in chunks of LCH knots with cp.async. Model and P are template
// parameters, so the loops unroll. Dynamic shared memory: 3 x operands + 2
// x records of a chunk + the final states (16,704 bytes for the pendulum
// at W = 8, P = 2; 26,112 for the double integrator at W = 8, P = 4).

namespace onelane {

constexpr int LCH = 32;        // knots per staged chunk
constexpr int LTHREADS = 96;   // warp 0: the chain; warp 1: the merit; warp 2: copies

template <class Model, int P>
struct Layout : OperandLayout<Model::NS, Model::NI, LCH, P> {
  static constexpr int REC = (Model::NS + Model::NI + 3) / 4 * 4;  // a knot's (x, u) record
  static int floats(int W) { return Layout::XS + 2 * W * LCH * REC + W * Model::NS; }
};

// The policy's operands at one knot, held in registers a knot ahead.
template <int S, int I>
struct Policy {
  float K[I * S], xr[S], ur[I], d[I], h;
};

template <class Ly>
__device__ __forceinline__ void load_policy(Policy<Ly::S, Ly::I>& o, const float* in, int j) {
  constexpr int S = Ly::S, I = Ly::I;
#pragma unroll
  for (int e = 0; e < I * S; ++e) o.K[e] = in[Ly::K + j * I * S + e];
#pragma unroll
  for (int i = 0; i < S; ++i) o.xr[i] = in[Ly::XREF + j * S + i];
#pragma unroll
  for (int q = 0; q < I; ++q) {
    o.ur[q] = in[Ly::UREF + j * I + q];
    o.d[q] = in[Ly::D + j * I + q];
  }
  o.h = in[Ly::H + j];
}

template <class Model, int P>
__global__ void __launch_bounds__(LTHREADS, 1)
    trial_rollout_lane_kernel(const Args a, const Model model) {
  constexpr int S = Model::NS, I = Model::NI;
  using Ly = Layout<Model, P>;
  constexpr int REC = Ly::REC;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.N, W = a.W, nch = (N + LCH - 1) / LCH;
  float* const recs = smem + Ly::XS;  // chunk s at recs + (s & 1) * W * LCH * REC
  float* const xfinal = recs + 2 * W * LCH * REC;

  if (warp == 2) stage<Ly>(smem, a, 0, lane);
  __syncthreads();

  if (warp == 0) {  // the chain: one lane a trial
    const bool mine = lane < W;
    const int wt = mine ? lane : W - 1;
    const float alpha = a.alphas[wt];
    float x[S];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = a.x0[i];
    for (int s = 0; s <= nch; ++s) {
      if (s < nch) {
        int kbeg, cnt;
        chunk_range<LCH>(s, N, kbeg, cnt);
        const float* in = smem + (s % 3) * Ly::IN;
        float4* rec = reinterpret_cast<float4*>(recs + ((s & 1) * W * LCH + wt * LCH) * REC);
        Policy<S, I> cur;
        load_policy<Ly>(cur, in, 0);
        for (int j = 0; j < cnt; ++j) {
          // u = u_ref - K (x - x_ref) + alpha d, as trial_rollout_ref
          float r[REC];  // the knot's record: x, u, zero padding
#pragma unroll
          for (int i = 0; i < S; ++i) r[i] = x[i];
#pragma unroll
          for (int q = 0; q < I; ++q) {
            float dk = 0.0f;  // K's row from its last column down
#pragma unroll
            for (int i = S - 1; i >= 0; --i) dk += cur.K[q * S + i] * (x[i] - cur.xr[i]);
            r[S + q] = cur.ur[q] - dk + alpha * cur.d[q];
          }
#pragma unroll
          for (int i = S + I; i < REC; ++i) r[i] = 0.0f;
          if (mine) {
#pragma unroll
            for (int v = 0; v < REC / 4; ++v)
              rec[j * (REC / 4) + v] = make_float4(r[4 * v], r[4 * v + 1], r[4 * v + 2],
                                                   r[4 * v + 3]);
          }
          const float h = cur.h;
          load_policy<Ly>(cur, in, j + 1 < cnt ? j + 1 : j);  // the next knot's, off the chain
          model.step(x, r + S, h);
        }
        if (s == nch - 1 && mine) {
#pragma unroll
          for (int i = 0; i < S; ++i) xfinal[lane * S + i] = x[i];
        }
      }
      __syncthreads();
    }
  } else if (warp == 1) {  // the merit of chunk s - 1, and its states out
    const bool trial = lane < W;
    const float ri = P > 0 ? *a.rhoi : 0.0f;
    float phi = 0.0f;
    for (int s = 0; s <= nch; ++s) {
      if (s >= 1 && trial) {
        int kbeg, cnt;
        chunk_range<LCH>(s - 1, N, kbeg, cnt);
        const float* in = smem + ((s - 1) % 3) * Ly::IN;
        const float4* rec =
            reinterpret_cast<const float4*>(recs + (((s - 1) & 1) * W * LCH + lane * LCH) * REC);
        float* xout = a.xstack + ((long)lane * (N + 1) + kbeg) * S;
        for (int j = 0; j < cnt; ++j) {
          float x[REC];
#pragma unroll
          for (int v = 0; v < REC / 4; ++v) {
            const float4 q = rec[j * (REC / 4) + v];
            x[4 * v] = q.x;
            x[4 * v + 1] = q.y;
            x[4 * v + 2] = q.z;
            x[4 * v + 3] = q.w;
          }
          phi = merit<S, I, P>(phi, in + Ly::Q + j * S, in + Ly::QL + j * S, in + Ly::R + j * I,
                               in + Ly::RL + j * I, in[Ly::C + j], in + Ly::WA + j * P * S,
                               in + Ly::WU + j * P * I, in + Ly::WG + j * P, ri, x, x + S);
#pragma unroll
          for (int i = 0; i < S; ++i) xout[j * S + i] = x[i];
        }
      }
      __syncthreads();
    }
    if (trial) {  // terminal knot: state-only cost and constraint rows
      const float* x = xfinal + lane * S;
      a.phi[lane] = merit<S, I, P>(phi, a.Q + (long)N * S, a.q + (long)N * S, nullptr, nullptr,
                                   a.c[N], a.wa + (long)N * P * S, nullptr, a.wg + (long)N * P,
                                   ri, x, nullptr);
#pragma unroll
      for (int i = 0; i < S; ++i) a.xstack[((long)lane * (N + 1) + N) * S + i] = x[i];
    }
  } else {  // the copies: chunk s + 1 in
    for (int s = 0; s <= nch; ++s) {
      if (s + 1 < nch) stage<Ly>(smem + ((s + 1) % 3) * Ly::IN, a, s + 1, lane);
      __syncthreads();
    }
  }
}

template <class Model, int P>
int launch(const Args& a, const Model& model, cudaStream_t s) {
  auto kern = trial_rollout_lane_kernel<Model, P>;
  const size_t bytes = (size_t)Layout<Model, P>::floats(a.W) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<1, LTHREADS, bytes, s>>>(a, model);
  return (int)cudaGetLastError();
}

// The (Model, P) pairs ops/trial_rollout.DEVICE_STEPS admits: the
// pendulum at P 0 or 2, the double integrator at P 0, 2 or 4.
int launch_pendulum(const Args& a, const altro_dev::PendulumMidpoint& m, int P,
                    cudaStream_t s) {
  if (P == 0) return launch<altro_dev::PendulumMidpoint, 0>(a, m, s);
  if (P == 2) return launch<altro_dev::PendulumMidpoint, 2>(a, m, s);
  return (int)cudaErrorInvalidValue;
}

int launch_double_integrator(const Args& a, int P, cudaStream_t s) {
  const altro_dev::DoubleIntegrator m{};
  if (P == 0) return launch<altro_dev::DoubleIntegrator, 0>(a, m, s);
  if (P == 2) return launch<altro_dev::DoubleIntegrator, 2>(a, m, s);
  if (P == 4) return launch<altro_dev::DoubleIntegrator, 4>(a, m, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace onelane

}  // namespace

// wa, wu, wg and rhoi are null when P = 0; rhoi is one float on the
// device. params lies in host memory. (model, integrator) (0, 0): the
// bicycle midpoint step, P 0, 2 or 4, W <= 32, params (frame 0, 1 or 2,
// length, rear); (1, 1): the quadrotor RK4 step, P 0, W <= 32, params
// (mass, gravity, arm, kf, km, Jx, Jy, Jz); (2, 0): the pendulum midpoint
// step, P 0 or 2, W <= 32, params (mass, length, b, g); (3, 2): the double
// integrator's exact step, P 0, 2 or 4, W <= 32, no params.
extern "C" int trial_rollout_f32(
    const float* alphas, const float* x0, const float* xref, const float* uref,
    const float* K, const float* d, const float* Q, const float* q, const float* R,
    const float* r, const float* c, const float* h, const float* wa, const float* wu,
    const float* wg, const float* rhoi, float* phi, float* xstack, int N,
    int W, int P, int model, int integrator, const float* params, void* stream) {
  if (N <= 0 || W <= 0 || W > MAX_W) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (model == 1 && integrator == 1) {
    if (P != 0) return (int)cudaErrorInvalidValue;
    const Args a{xref, uref, K, d, Q, q, R, r, c, h, wa, wu, wg, rhoi,
                 alphas, x0, phi, xstack, N, W, 0.0f, 0.0f};
    const altro_dev::QuadrotorAxisRK4 m{params[0], params[1], params[2], params[3],
                                        params[4], params[5], params[6], params[7]};
    return quad::launch(a, m, s);
  }
  if (model == 2 && integrator == 0) {
    const Args a{xref, uref, K, d, Q, q, R, r, c, h, wa, wu, wg, rhoi,
                 alphas, x0, phi, xstack, N, W, 0.0f, 0.0f};
    return onelane::launch_pendulum(
        a, altro_dev::PendulumMidpoint{params[0], params[1], params[2], params[3]}, P, s);
  }
  if (model == 3 && integrator == 2) {
    const Args a{xref, uref, K, d, Q, q, R, r, c, h, wa, wu, wg, rhoi,
                 alphas, x0, phi, xstack, N, W, 0.0f, 0.0f};
    return onelane::launch_double_integrator(a, P, s);
  }
  if (!(model == 0 && integrator == 0)) return (int)cudaErrorInvalidValue;
  const Args a{xref, uref, K, d, Q, q, R, r, c, h, wa, wu, wg, rhoi,
               alphas, x0, phi, xstack, N, W, params[1], params[2]};
  const int frame = (int)params[0];
  if (frame == 0) return launch_p<0>(a, P, s);
  if (frame == 1) return launch_p<1>(a, P, s);
  if (frame == 2) return launch_p<2>(a, P, s);
  return (int)cudaErrorInvalidValue;
}
