// Batched W-trial line-search rollout with the dynamics in the kernel, for
// Hopper (sm_90a): a tile of lanes x trials per block, each lane's operands
// staged once for all its trials.
//
// Replaces: altro_tpu/ops/pallas_rollout_tiled.py::rollout_grid_pallas_tiled
// (its Pallas `_kernel`): W closed-loop trial rollouts
//   u = u_ref - K (x - x_ref) + alpha_w d,   x+ = step(x, u, h),
// the merit accumulated in the kernel from the diagonal cost rows plus the
// affine NEGATIVE_ORTHANT augmented-Lagrangian term rhoi * min(w, 0)^2 with
// w = wg - wax.x - wau.u, rhoi = 1/(2 rho). The rows are formed here, per
// lane and knot, from the lane-shared affine stacks (cax, cau, cg, act of
// ops/rollout_grid.py::affine_constraint_stacks) and the lane's z and rho:
//   wax = rho (cax act), wau = rho (cau act), wg = act z - rho (cg act),
// each product rounded as the plain twin (`premultiplied_rows`) rounds it.
//
// What bounds it on this card: each thread runs a chain of N dependent
// knot steps; a bicycle midpoint step is two evaluations of the model
// (sin, cos, tan and a square root each) plus the policy and merit, some
// 120 dependent instructions per knot. The grid moves about 3.5 MB at W=8,
// B=2048, N=30, P=2 (1 us at 3.35 TB/s, the state stacks most of it):
// latency of the sequential chain is the bound.
//
// What the design does about it: a block is LANES = 16 lanes
// (threadIdx.x, the coalesced axis) x up to 8 trials (threadIdx.y; more
// trials take more blocks along blockIdx.y): 128 blocks of 128 threads at
// B=2048, W=8. A lane's per-knot operands (K, d, x_ref, u_ref, z) and the
// lane-shared rows (Q, q, R, r, c, h and the affine stacks) are copied
// into shared memory once per block, in chunks of CHUNK knots, with
// cp.async into a second buffer while the previous chunk computes: the W
// trial threads of a lane read them there (the trials of a warp read one
// address, a broadcast) instead of each fetching them through L2 on the
// chain. P (0 and 2) and the model's frame (0, 1, 2) are template
// parameters (6 instantiations), so the row loops unroll and the step has
// no branch. Each thread's policy, merit and AL term are in the order of
// the one-thread-per-(lane, trial) design it replaces. Lanes past B and
// trials past W compute copies and store nothing; every barrier is reached
// by every thread.
//
// The dynamics are a step of csrc/device_steps.cuh: BicycleFrame<FRAME>,
// the twin of models/tile_steps.py::midpoint_cols(bicycle_cols(frame,
// length, rear)) (P = 0 or 2), and QuadrotorRK4, the twin of
// rk4_cols(quadrotor_cols(...)) (P = 0). The quadrotor's lane data is 68
// floats a knot (K 48, d 4, x_ref 12, u_ref 4): two 8-knot chunks take
// 71,808 bytes, above the 48 KB default, so its launch opts in. Its
// thread keeps x, the RK4 stage and the stage sum (36 floats) live
// through the step; at B=1024, W=8 it runs 64 blocks of 128 threads.
// PendulumMidpoint, the twin of midpoint_cols(pendulum_cols(...)) (P = 0
// or 2), has the smallest chunks (8 floats a lane and knot at P = 2, 9,344
// bytes for the two); its torque bound's two rows lie on u (wau), not on
// x as the bicycle's steering rows do.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "device_steps.cuh"

namespace {

using altro_dev::BicycleFrame;
using altro_dev::neg_part;
using altro_dev::PendulumMidpoint;
using altro_dev::QuadrotorRK4;

constexpr int LANES = 16;       // lanes per block (threadIdx.x)
constexpr int MAX_TRIALS = 8;   // trials per block (threadIdx.y)
constexpr int CHUNK = 8;        // knots per staged chunk

struct Ops {
  const float *xref, *uref, *K, *d;       // [N+1, NS, B], [N, NI, B], [N, NI, NS, B], [N, NI, B]
  const float *Q, *q, *R, *r, *c, *h;     // [N+1, NS], [N+1, NS], [N+1, NI], [N+1, NI], [N+1], [N]
  const float *cax, *cau, *cg, *act;      // [N+1, P, NS], [N+1, P, NI], [N+1, P], [N+1, P]
  const float *z0, *z1;                   // [N+1, p0, B], [N+1, P - p0, B] (constraint groups)
  const float *rho, *alphas, *x0;         // [B], [W], [NS, B]
  float *phi, *xstack;                    // [W, B], [W, N+1, NS, B]
  int N, Bsz, W, p0;
};

// Offsets of one knot's data in a staged chunk.
template <int NS, int NI, int P>
struct Chunk {
  // per lane (element e of lane l of knot kk at [(kk * LANE + e) * LANES + l])
  static constexpr int K = 0;  // NI x NS
  static constexpr int D = K + NI * NS;
  static constexpr int XR = D + NI;
  static constexpr int UR = XR + NS;
  static constexpr int Z = UR + NI;
  static constexpr int LANE = Z + P;
  // shared by the lanes (knot kk at [kk * ROW])
  static constexpr int RQ = 0, Rq = NS, RR = 2 * NS, Rr = 2 * NS + NI, RC = 2 * (NS + NI);
  static constexpr int RH = RC + 1;
  static constexpr int AX = RH + 1;  // P x NS
  static constexpr int AU = AX + P * NS;
  static constexpr int CG = AU + P * NI;
  static constexpr int ACT = CG + P;
  static constexpr int ROW = ACT + P;
  static constexpr int ROWS = CHUNK * LANE * LANES;  // the rows follow the lanes' data
  static constexpr int BUF = ROWS + CHUNK * ROW;
};

// Copy chunk ch (knots ch * CHUNK ...) into buf with cp.async: the trial
// threads of a lane split its entries, the block splits the rows.
template <int NS, int NI, int P>
__device__ __forceinline__ void stage_chunk(float* buf, const Ops& o, int ch, int lane, int bl,
                                            int y, int ny) {
  using Ck = Chunk<NS, NI, P>;
  const long S = o.Bsz;
  const int N = o.N, k0 = ch * CHUNK;
  for (int e = y; e < CHUNK * Ck::LANE; e += ny) {
    const int kk = e / Ck::LANE, f = e % Ck::LANE, k = k0 + kk;
    if (k > N) break;
    const float* src = nullptr;
    if (f < Ck::D) {
      if (k < N) src = o.K + ((long)k * NI * NS + f) * S;
    } else if (f < Ck::XR) {
      if (k < N) src = o.d + ((long)k * NI + f - Ck::D) * S;
    } else if (f < Ck::UR) {
      if (k < N) src = o.xref + ((long)k * NS + f - Ck::XR) * S;
    } else if (f < Ck::Z) {
      if (k < N) src = o.uref + ((long)k * NI + f - Ck::UR) * S;
    } else {
      const int g = f - Ck::Z;
      src = (g < o.p0) ? o.z0 + ((long)k * o.p0 + g) * S
                       : o.z1 + ((long)k * (P - o.p0) + g - o.p0) * S;
    }
    if (src) __pipeline_memcpy_async(buf + (kk * Ck::LANE + f) * LANES + lane, src + bl, sizeof(float));
  }
  float* rows = buf + Ck::ROWS;
  for (int e = y * LANES + lane; e < CHUNK * Ck::ROW; e += ny * LANES) {
    const int kk = e / Ck::ROW, f = e % Ck::ROW, k = k0 + kk;
    if (k > N) break;
    const float* src;
    if (f < Ck::Rq) src = o.Q + k * NS + f;
    else if (f < Ck::RR) src = o.q + k * NS + f - Ck::Rq;
    else if (f < Ck::Rr) src = o.R + k * NI + f - Ck::RR;
    else if (f < Ck::RC) src = o.r + k * NI + f - Ck::Rr;
    else if (f == Ck::RC) src = o.c + k;
    else if (f == Ck::RH) src = (k < N) ? o.h + k : nullptr;
    else if (f < Ck::AU) src = o.cax + k * P * NS + f - Ck::AX;
    else if (f < Ck::CG) src = o.cau + k * P * NI + f - Ck::AU;
    else if (f < Ck::ACT) src = o.cg + k * P + f - Ck::CG;
    else src = o.act + k * P + f - Ck::ACT;
    if (src) __pipeline_memcpy_async(rows + kk * Ck::ROW + f, src, sizeof(float));
  }
}

template <class Model, int P>
__global__ void __launch_bounds__(LANES * MAX_TRIALS) rollout_grid_kernel(const Ops o, Model model) {
  constexpr int NS = Model::NS;
  constexpr int NI = Model::NI;
  using Ck = Chunk<NS, NI, P>;
  extern __shared__ float smem[];
  const int lane = threadIdx.x, y = threadIdx.y, ny = blockDim.y;
  const int N = o.N;
  const long S = o.Bsz;
  const int b = blockIdx.x * LANES + lane;
  const int w = blockIdx.y * ny + y;
  const bool valid = b < o.Bsz && w < o.W;
  const int bl = min(b, o.Bsz - 1);  // lanes past B and trials past W compute copies
  const float alpha = o.alphas[min(w, o.W - 1)];
  const float rh = o.rho[bl];
  const float ri = 1.0f / (2.0f * rh);
  float* xs = o.xstack + (long)min(w, o.W - 1) * (N + 1) * NS * S;

  float x[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) x[i] = o.x0[i * S + bl];
  float phi = 0.0f;

  const int nchunks = (N + CHUNK) / CHUNK;  // knots 0..N
  float* const bufs[2] = {smem, smem + Ck::BUF};
  stage_chunk<NS, NI, P>(bufs[0], o, 0, lane, bl, y, ny);
  __pipeline_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) stage_chunk<NS, NI, P>(bufs[(ch + 1) & 1], o, ch + 1, lane, bl, y, ny);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();  // chunk ch is in place

    const float* ln = bufs[ch & 1] + lane;
    const float* rows = bufs[ch & 1] + Ck::ROWS;
    for (int kk = 0; kk < CHUNK; ++kk) {
      const int k = ch * CHUNK + kk;
      if (k > N) break;
      const float* L = ln + kk * Ck::LANE * LANES;  // this lane's entry e at L[e * LANES]
      const float* R = rows + kk * Ck::ROW;
      // this lane's constraint rows at knot k
      float wax[P > 0 ? P : 1][NS], wau[P > 0 ? P : 1][NI], wg[P > 0 ? P : 1];
#pragma unroll
      for (int e = 0; e < P; ++e) {
        const float a = R[Ck::ACT + e];
#pragma unroll
        for (int i = 0; i < NS; ++i) wax[e][i] = __fmul_rn(rh, __fmul_rn(R[Ck::AX + e * NS + i], a));
#pragma unroll
        for (int j = 0; j < NI; ++j) wau[e][j] = __fmul_rn(rh, __fmul_rn(R[Ck::AU + e * NI + j], a));
        wg[e] = __fsub_rn(__fmul_rn(a, L[(Ck::Z + e) * LANES]),
                          __fmul_rn(rh, __fmul_rn(R[Ck::CG + e], a)));
      }

      if (k < N) {
        float u[NI];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < NS; ++i)
            s += L[(Ck::K + j * NS + i) * LANES] * (x[i] - L[(Ck::XR + i) * LANES]);
          u[j] = L[(Ck::UR + j) * LANES] + alpha * L[(Ck::D + j) * LANES] - s;
        }
        float sq = 0.0f, sl = 0.0f, su = 0.0f, sr = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          sq += R[Ck::RQ + i] * x[i] * x[i];
          sl += R[Ck::Rq + i] * x[i];
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          su += R[Ck::RR + j] * u[j] * u[j];
          sr += R[Ck::Rr + j] * u[j];
        }
        float ph = phi + 0.5f * sq + sl + 0.5f * su + sr + R[Ck::RC];
#pragma unroll
        for (int e = 0; e < P; ++e) {
          float we = wg[e];
#pragma unroll
          for (int i = 0; i < NS; ++i) we -= wax[e][i] * x[i];
#pragma unroll
          for (int j = 0; j < NI; ++j) we -= wau[e][j] * u[j];
          const float pw = neg_part(we);
          ph += ri * pw * pw;
        }
        if (valid) {
#pragma unroll
          for (int i = 0; i < NS; ++i) xs[((long)k * NS + i) * S + b] = x[i];
        }
        model.step(x, u, R[Ck::RH]);
        phi = ph;
      } else {  // terminal knot: state-only cost and constraint rows
        float sq = 0.0f, sl = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          sq += R[Ck::RQ + i] * x[i] * x[i];
          sl += R[Ck::Rq + i] * x[i];
        }
        float ph = phi + 0.5f * sq + sl + R[Ck::RC];
#pragma unroll
        for (int e = 0; e < P; ++e) {
          float we = wg[e];
#pragma unroll
          for (int i = 0; i < NS; ++i) we -= wax[e][i] * x[i];
          const float pw = neg_part(we);
          ph += ri * pw * pw;
        }
        if (valid) {
          o.phi[(long)w * S + b] = ph;
#pragma unroll
          for (int i = 0; i < NS; ++i) xs[((long)N * NS + i) * S + b] = x[i];
        }
      }
    }
    __syncthreads();  // before this buffer takes chunk ch + 2
  }
}

template <class Model, int P>
int launch(const Ops& o, const Model& model, cudaStream_t s) {
  auto kern = rollout_grid_kernel<Model, P>;
  const int trials = o.W < MAX_TRIALS ? o.W : MAX_TRIALS;
  const dim3 block(LANES, trials);
  const dim3 grid((o.Bsz + LANES - 1) / LANES, (o.W + trials - 1) / trials);
  const size_t bytes = 2 * (size_t)Chunk<Model::NS, Model::NI, P>::BUF * sizeof(float);
  if (bytes > 48 * 1024) {  // the quadrotor's two chunks (71,808 bytes) opt in
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, block, bytes, s>>>(o, model);
  return (int)cudaGetLastError();
}

template <class Model>
int launch_p(const Ops& o, const Model& m, int P, cudaStream_t s) {
  if (P == 0) return launch<Model, 0>(o, m, s);
  if (P == 2) return launch<Model, 2>(o, m, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// z0 holds the first p0 constraint rows and z1 the other P - p0 (the
// problem's constraint groups, null when empty). (model, integrator)
// (0, 0): the bicycle midpoint step, P 0 or 2, params (frame 0, 1 or 2,
// length, rear); (1, 1): the quadrotor RK4 step, P 0, params (mass,
// gravity, arm, kf, km, Jx, Jy, Jz); (2, 0): the pendulum midpoint step,
// P 0 or 2, params (mass, length, b, g). params lies in host memory.
extern "C" int rollout_grid_f32(
    const float* xref, const float* uref, const float* K, const float* d,
    const float* Q, const float* q, const float* R, const float* r,
    const float* c, const float* h, const float* cax, const float* cau,
    const float* cg, const float* act, const float* z0, const float* z1,
    const float* rho, const float* alphas, const float* x0,
    float* phi, float* xstack, int N, int Bsz, int W, int P, int p0, int model,
    int integrator, const float* params, void* stream) {
  if (N <= 0 || Bsz <= 0 || W <= 0 || (W + MAX_TRIALS - 1) / MAX_TRIALS > 65535 || p0 < 0 ||
      p0 > P)
    return (int)cudaErrorInvalidValue;
  const Ops o{xref, uref, K, d, Q, q, R, r, c, h, cax, cau, cg, act, z0, z1, rho, alphas, x0,
              phi, xstack, N, Bsz, W, p0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (model == 1 && integrator == 1) {
    if (P != 0) return (int)cudaErrorInvalidValue;
    const QuadrotorRK4 m{params[0], params[1], params[2], params[3],
                         params[4], params[5], params[6], params[7]};
    return launch<QuadrotorRK4, 0>(o, m, s);
  }
  if (model == 2 && integrator == 0)
    return launch_p(o, PendulumMidpoint{params[0], params[1], params[2], params[3]}, P, s);
  if (model != 0 || integrator != 0) return (int)cudaErrorInvalidValue;
  const int frame = (int)params[0];
  if (frame == 0) return launch_p(o, BicycleFrame<0>{params[1], params[2]}, P, s);
  if (frame == 1) return launch_p(o, BicycleFrame<1>{params[1], params[2]}, P, s);
  if (frame == 2) return launch_p(o, BicycleFrame<2>{params[1], params[2]}, P, s);
  return (int)cudaErrorInvalidValue;
}
