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
// Per-lane cost rows (JAX's kernel streams Q, q, R, r, c and h per lane,
// broadcasting the shared ones): the template flag LANE_COST moves those
// six rows out of the block's shared rows into each lane's staged region
// of the same cp.async double buffer, read at L[e * LANES] like K and d.
// The cost row keeps its layout (Q, q, R, r, c, h), so the merit reads it
// through one pointer and stride: the row itself (stride 1) or the lane's
// copy (stride LANES). At the bicycle's (4, 2) that is 14 more floats a
// lane and knot (30 to 44 at P = 2): at B=1024, W=8, N=30 the operands
// grow from about 2.0 MB to 2.8 MB beside the 4 MB of state stacks the
// grid writes. The shared instantiations (LANE_COST false) are the code
// they were.
//
// The dynamics are a step of csrc/device_steps.cuh: BicycleFrame<FRAME>,
// the twin of models/tile_steps.py::midpoint_cols(bicycle_cols(frame,
// length, rear)) (P = 0 or 2), and PendulumMidpoint, the twin of
// midpoint_cols(pendulum_cols(...)) (P = 0 or 2), with the smallest chunks
// (8 floats a lane and knot at P = 2, 9,344 bytes for the two); its torque
// bound's two rows lie on u (wau), not on x as the bicycle's steering rows
// do; and DoubleIntegrator, the twin of double_integrator_cols(2), an
// exact discrete step (P = 0 or 2). The quadrotor's RK4 step
// (QuadrotorAxisRK4, P = 0) runs in a kernel of its own, three threads a
// (lane, trial) (its note below).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "device_steps.cuh"

namespace {

using altro_dev::BicycleFrame;
using altro_dev::DoubleIntegrator;
using altro_dev::neg_part;
using altro_dev::PendulumMidpoint;

constexpr int LANES = 16;       // lanes per block (threadIdx.x)
constexpr int MAX_TRIALS = 8;   // trials per block (threadIdx.y)
constexpr int CHUNK = 8;        // knots per staged chunk

struct Ops {
  const float *xref, *uref, *K, *d;       // [N+1, NS, B], [N, NI, B], [N, NI, NS, B], [N, NI, B]
  const float *Q, *q, *R, *r, *c, *h;     // [N+1, NS], [N+1, NS], [N+1, NI], [N+1, NI], [N+1], [N]
                                          // (each with a trailing [B] under LANE_COST)
  const float *cax, *cau, *cg, *act;      // [N+1, P, NS], [N+1, P, NI], [N+1, P], [N+1, P]
  const float *z0, *z1;                   // [N+1, p0, B], [N+1, P - p0, B] (constraint groups)
  const float *rho, *alphas, *x0;         // [B], [W], [NS, B]
  float *phi, *xstack;                    // [W, B], [W, N+1, NS, B]
  int N, Bsz, W, p0;
};

// Offsets of one knot's data in a staged chunk.
template <int NS, int NI, int P, bool LC>
struct Chunk {
  // the cost row's layout, in the block's rows or in a lane's region
  static constexpr int CQ = 0, Cq = NS, CR = 2 * NS, Cr = 2 * NS + NI, CC = 2 * (NS + NI);
  static constexpr int CH = CC + 1;
  static constexpr int COST = CH + 1;
  // per lane (element e of lane l of knot kk at [(kk * LANE + e) * LANES + l])
  static constexpr int K = 0;  // NI x NS
  static constexpr int D = K + NI * NS;
  static constexpr int XR = D + NI;
  static constexpr int UR = XR + NS;
  static constexpr int Z = UR + NI;
  static constexpr int LCOST = Z + P;  // the lane's cost row (LC)
  static constexpr int LANE = LC ? LCOST + COST : LCOST;
  // shared by the lanes (knot kk at [kk * ROW]): the cost row unless LC,
  // then the affine stacks; SAX.. are their offsets with the cost row in
  static constexpr int RB = LC ? COST : 0;
  static constexpr int SAX = COST;  // P x NS
  static constexpr int SAU = SAX + P * NS;
  static constexpr int SCG = SAU + P * NI;
  static constexpr int SACT = SCG + P;
  static constexpr int AX = SAX - RB, AU = SAU - RB, CG = SCG - RB, ACT = SACT - RB;
  static constexpr int ROW = SACT + P - RB;
  static constexpr int ROWS = CHUNK * LANE * LANES;  // the rows follow the lanes' data
  static constexpr int BUF = ROWS + CHUNK * ROW;
};

// Copy chunk ch (knots ch * CHUNK ...) into buf with cp.async: the trial
// threads of a lane split its entries, the block splits the rows.
template <int NS, int NI, int P, bool LC>
__device__ __forceinline__ void stage_chunk(float* buf, const Ops& o, int ch, int lane, int bl,
                                            int y, int ny) {
  using Ck = Chunk<NS, NI, P, LC>;
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
    } else if (!LC || f < Ck::LCOST) {
      const int g = f - Ck::Z;
      src = (g < o.p0) ? o.z0 + ((long)k * o.p0 + g) * S
                       : o.z1 + ((long)k * (P - o.p0) + g - o.p0) * S;
    } else {  // LC: the lane's cost row
      const int g = f - Ck::LCOST;
      if (g < Ck::Cq) src = o.Q + ((long)k * NS + g) * S;
      else if (g < Ck::CR) src = o.q + ((long)k * NS + g - Ck::Cq) * S;
      else if (g < Ck::Cr) src = o.R + ((long)k * NI + g - Ck::CR) * S;
      else if (g < Ck::CC) src = o.r + ((long)k * NI + g - Ck::Cr) * S;
      else if (g == Ck::CC) src = o.c + (long)k * S;
      else if (k < N) src = o.h + (long)k * S;
    }
    if (src) __pipeline_memcpy_async(buf + (kk * Ck::LANE + f) * LANES + lane, src + bl, sizeof(float));
  }
  if (Ck::ROW == 0) return;
  constexpr int RW = Ck::ROW > 0 ? Ck::ROW : 1;
  float* rows = buf + Ck::ROWS;
  for (int e = y * LANES + lane; e < CHUNK * Ck::ROW; e += ny * LANES) {
    const int kk = e / RW, f = e % RW + Ck::RB, k = k0 + kk;
    if (k > N) break;
    const float* src;
    if (f < Ck::Cq) src = o.Q + k * NS + f;
    else if (f < Ck::CR) src = o.q + k * NS + f - Ck::Cq;
    else if (f < Ck::Cr) src = o.R + k * NI + f - Ck::CR;
    else if (f < Ck::CC) src = o.r + k * NI + f - Ck::Cr;
    else if (f == Ck::CC) src = o.c + k;
    else if (f == Ck::CH) src = (k < N) ? o.h + k : nullptr;
    else if (f < Ck::SAU) src = o.cax + k * P * NS + f - Ck::SAX;
    else if (f < Ck::SCG) src = o.cau + k * P * NI + f - Ck::SAU;
    else if (f < Ck::SACT) src = o.cg + k * P + f - Ck::SCG;
    else src = o.act + k * P + f - Ck::SACT;
    if (src) __pipeline_memcpy_async(rows + kk * Ck::ROW + f - Ck::RB, src, sizeof(float));
  }
}

template <class Model, int P, bool LC>
__global__ void __launch_bounds__(LANES * MAX_TRIALS) rollout_grid_kernel(const Ops o, Model model) {
  constexpr int NS = Model::NS;
  constexpr int NI = Model::NI;
  using Ck = Chunk<NS, NI, P, LC>;
  constexpr int CS = LC ? LANES : 1;  // the cost row's stride
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
  stage_chunk<NS, NI, P, LC>(bufs[0], o, 0, lane, bl, y, ny);
  __pipeline_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) stage_chunk<NS, NI, P, LC>(bufs[(ch + 1) & 1], o, ch + 1, lane, bl, y, ny);
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
      const float* C = LC ? L + Ck::LCOST * LANES : R;  // the cost row, entry e at C[e * CS]
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
          sq += C[(Ck::CQ + i) * CS] * x[i] * x[i];
          sl += C[(Ck::Cq + i) * CS] * x[i];
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          su += C[(Ck::CR + j) * CS] * u[j] * u[j];
          sr += C[(Ck::Cr + j) * CS] * u[j];
        }
        float ph = phi + 0.5f * sq + sl + 0.5f * su + sr + C[Ck::CC * CS];
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
        model.step(x, u, C[Ck::CH * CS]);
        phi = ph;
      } else {  // terminal knot: state-only cost and constraint rows
        float sq = 0.0f, sl = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          sq += C[(Ck::CQ + i) * CS] * x[i] * x[i];
          sl += C[(Ck::Cq + i) * CS] * x[i];
        }
        float ph = phi + 0.5f * sq + sl + C[Ck::CC * CS];
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

// ---------------------------------------------------------------------------
// The quadrotor's RK4 column step (rk4_cols(quadrotor_cols())), P = 0:
// three threads a (lane, trial).
//
// What bounds it on this card: the chain, as for the bicycle, but four
// times longer a knot: an RK4 step is four evaluations of the model (a
// sine-cosine pair of each angle, an IEEE divide by cos(pitch) on the path)
// behind the policy, about 85 dependent instructions a knot, and one thread
// that runs the whole knot issues about a thousand. The grid moves about
// 21 MB at B=1024, W=8, N=30 (6 us at 3.35 TB/s, the state stacks most of
// it). The one-thread design ran 256 warps, one a scheduler on 64 SMs,
// each waiting on its own chain.
//
// What the design does about it: a group of G = 3 threads runs a (lane,
// trial), one body axis each (QuadrotorAxisRK4 and `axis_policy` of
// csrc/device_steps.cuh: a third of the sines, cosines, divides, stage
// updates and policy columns, the group's other values by shuffle), so a
// thread makes a third of the model's library calls and two warps share a
// scheduler. A warp is ten lanes b of one trial (threads 30, 31 mirror
// the tenth), a block TRIALS = 8 such warps: B=1024, W=8 runs 103 blocks
// of 256 threads, 824 warps. That leaves 29 SMs idle, but with 824 warps
// for 528 schedulers the busiest scheduler runs two warps at any block
// size, and a block of all eight trials stages each lane's operands once:
// on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --compare against
// the variant tree) this geometry beat four trial warps a block (206
// blocks, every SM) by 8% and five lanes of two trials a warp (205 blocks)
// by 7%. At every knot the group adds its three
// shares of the cost's sums Q.x.x and q.x (three shuffles each), and each
// thread adds the knot's terms to phi in the one-thread design's order:
// the expanded cost 0.5 x'Qx - wp'Qx + c cancels within a knot, so summing
// each axis's share over the knots first would leave terms of hundreds to
// cancel at the end, and their rounding reaches the Armijo test's margin
// (it took the tiled quadrotor row's success from 0.998 to 0.974). Each thread
// stores its four entries of x at every knot, ten neighbouring b a store.
// The block stages its lanes' operands in chunks of QCHUNK knots with
// cp.async (double-buffered): K's columns and x_ref permuted by axis (one
// axis's 20 floats of a lane contiguous, the axis blocks padded so that a
// quarter warp's float4 loads share no bank), u_ref and d, and the
// lane-shared rows, each thread a few fixed positions of a knot walked
// down the chunk (an address's 64-bit products once a position and chunk,
// not once a float); each thread reads the next knot's policy operands
// into registers a knot ahead. 49,664 bytes of dynamic shared memory (opted in above 48 KB).
//
// Per-lane cost rows (the template flag LANE_COST, as in the kernel
// above): the knot's row of Q, q, R, r, c and h becomes one row a lane b,
// GROUPS rows of the same layout and padding after u_ref and d, each staged
// from the lane's column of the [.., B] arrays (neighbouring threads take
// neighbouring lanes, as for K and x_ref); a group reads its own row. That
// is 34 more floats a lane and knot (about 4.3 MB more at B=1024, N=30 over
// the shared kernel's 21 MB) and 70,400 bytes of shared memory. The shared
// instantiation (false) is the code it was.

namespace quad {

using altro_dev::AxisPolicy;
using altro_dev::QuadrotorAxisRK4;

constexpr unsigned FULL = 0xffffffffu;
constexpr int S = QuadrotorAxisRK4::NS, I = QuadrotorAxisRK4::NI, G = QuadrotorAxisRK4::G;
constexpr int GROUPS = 10;  // lanes b a warp, three threads each
constexpr int TRIALS = 8;   // warps a block, one trial each
constexpr int QCHUNK = 8;   // knots per staged chunk
constexpr int AXW = 20;     // one axis's policy operands a knot and lane: Kc (16), x_ref (4)
constexpr int AXS = 220;    // an axis's [GROUPS][AXW] block, 200 floats padded: AXS / 4 = 7 mod 8
// One knot's floats: the three axis blocks, [GROUPS][8] (u_ref, d), then
// the lane-shared row: [3][8] (Q and q at the axis's entries), R, r, c, h.
constexpr int UD = 3 * AXS;
constexpr int ROW = UD + GROUPS * 8;
constexpr int RR = 24, RRL = RR + I, RC = RRL + I, RH = RC + 1, ROW_FLOATS = RH + 1;
constexpr int RSTRIDE = 36;  // a row's floats, padded
static_assert(AXS % 4 == 0 && UD % 4 == 0 && ROW % 4 == 0 && RSTRIDE % 4 == 0 &&
              ROW_FLOATS <= RSTRIDE, "16-byte aligned arrays");

// Positions of one knot's staged floats: the axis blocks (ax, f, g), u_ref
// and d (f, g), then the lane-shared row, or under LC one row a lane (f, g).
constexpr int LANE_POS = 3 * AXW * GROUPS;
constexpr int UD_POS = 8 * GROUPS;

template <bool LC>
struct Knot {
  static constexpr int ROWS = LC ? GROUPS : 1;  // cost rows a knot
  static constexpr int FLOATS = ROW + ROWS * RSTRIDE;
  static constexpr int BUF = QCHUNK * FLOATS;
  static constexpr int POS = LANE_POS + UD_POS + ROWS * ROW_FLOATS;
};

// Copy chunk ch (knots ch * QCHUNK ...) of the block's lanes b0 ..
// b0 + GROUPS - 1 into buf with cp.async, one float a copy: thread t takes
// positions t, t + nt, ... of a knot, finds each one's source once and
// walks it down the chunk's knots; neighbouring threads take neighbouring
// lanes (lanes past B copy lane B - 1).
template <bool LC>
__device__ __forceinline__ void stage(float* buf, const Ops& o, int ch, int b0, int t, int nt) {
  using Kn = Knot<LC>;
  const long B = o.Bsz;
  const int N = o.N, k0 = ch * QCHUNK;
  const int kn = min(QCHUNK, N - k0);      // knots with a policy
  const int kr = min(QCHUNK, N + 1 - k0);  // knots with rows (the terminal one too)
  for (int p = t; p < Kn::POS; p += nt) {
    const float* src;  // the float at knot k0
    long step;         // floats a knot in the source
    int dst, count;
    if (p < LANE_POS) {
      const int g = p % GROUPS, r = p / GROUPS, f = r % AXW, ax = r / AXW;
      const long bl = min(b0 + g, o.Bsz - 1);
      if (f < 16) {
        src = o.K + ((long)k0 * I * S + (f / 4) * S + ax + 3 * (f % 4)) * B + bl;
        step = I * S * B;
      } else {
        src = o.xref + ((long)k0 * S + ax + 3 * (f - 16)) * B + bl;
        step = S * B;
      }
      dst = ax * AXS + g * AXW + f;
      count = kn;
    } else if (p < LANE_POS + UD_POS) {
      const int g = (p - LANE_POS) % GROUPS, f = (p - LANE_POS) / GROUPS;
      const long bl = min(b0 + g, o.Bsz - 1);
      src = (f < I ? o.uref + ((long)k0 * I + f) * B : o.d + ((long)k0 * I + f - I) * B) + bl;
      step = I * B;
      dst = UD + g * 8 + f;
      count = kn;
    } else if (!LC) {
      const int f = p - LANE_POS - UD_POS;
      if (f < RR) {
        src = (f % 8 < 4 ? o.Q : o.q) + (long)k0 * S + f / 8 + 3 * (f % 4);
        step = S;
      } else if (f < RC) {
        src = f < RRL ? o.R + (long)k0 * I + f - RR : o.r + (long)k0 * I + f - RRL;
        step = I;
      } else {
        src = (f == RC ? o.c : o.h) + k0;
        step = 1;
      }
      dst = ROW + f;
      count = f == RH ? kn : kr;  // h has no terminal entry
    } else {  // LC: lane g's row, entry f, from the [.., B] arrays
      const int g = (p - LANE_POS - UD_POS) % GROUPS, f = (p - LANE_POS - UD_POS) / GROUPS;
      const long bl = min(b0 + g, o.Bsz - 1);
      if (f < RR) {
        src = (f % 8 < 4 ? o.Q : o.q) + ((long)k0 * S + f / 8 + 3 * (f % 4)) * B + bl;
        step = S * B;
      } else if (f < RC) {
        src = (f < RRL ? o.R + ((long)k0 * I + f - RR) * B : o.r + ((long)k0 * I + f - RRL) * B) +
              bl;
        step = I * B;
      } else {
        src = (f == RC ? o.c : o.h) + (long)k0 * B + bl;
        step = B;
      }
      dst = ROW + g * RSTRIDE + f;
      count = f == RH ? kn : kr;
    }
    for (int kk = 0; kk < count; ++kk, src += step)
      __pipeline_memcpy_async(buf + kk * Kn::FLOATS + dst, src, sizeof(float));
  }
}

template <bool LC>
__device__ __forceinline__ AxisPolicy load_policy(const float* buf, int kk, int g, int ax) {
  const float* knot = buf + kk * Knot<LC>::FLOATS;
  const float4* kx = reinterpret_cast<const float4*>(knot + ax * AXS + g * AXW);
  const float4* ud = reinterpret_cast<const float4*>(knot + UD + g * 8);
  AxisPolicy o;
#pragma unroll
  for (int q = 0; q < 4; ++q) o.Kc[q] = kx[q];
  o.xr = kx[4];
  o.ur = ud[0];
  o.d = ud[1];
  o.h = knot[ROW + (LC ? g * RSTRIDE : 0) + RH];
  o.h6 = o.h / 6.0f;
  return o;
}

template <bool LC>
__global__ void __launch_bounds__(32 * TRIALS)
    rollout_grid_quadrotor_kernel(const Ops o, const QuadrotorAxisRK4 model) {
  using Kn = Knot<LC>;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, nt = blockDim.x;
  const int g = min(lane / G, GROUPS - 1), ax = lane % G, base = G * g;
  const int N = o.N;
  const long B = o.Bsz;
  const int b0 = blockIdx.x * GROUPS, b = b0 + g;
  const int w = blockIdx.y * (nt / 32) + tid / 32;
  const bool valid = b < o.Bsz && w < o.W && lane < G * GROUPS;
  const long bl = min(b, o.Bsz - 1);  // lanes past B and trials past W compute copies
  const float alpha = o.alphas[min(w, o.W - 1)];
  const QuadrotorAxisRK4::Axis axis = model.axis(ax, base);
  float* const xs = o.xstack + (long)min(w, o.W - 1) * (N + 1) * S * B + b;

  float s[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = o.x0[(ax + 3 * c) * B + bl];
  QuadrotorAxisRK4::Trig tr = QuadrotorAxisRK4::trig(s[1]);
  float phi = 0.0f;

  const int nchunks = (N + QCHUNK) / QCHUNK;  // knots 0..N
  stage<LC>(smem, o, 0, b0, tid, nt);
  __pipeline_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    // the buffers by offset, not from an array of pointers, so that the
    // loads stay shared-memory loads
    if (ch + 1 < nchunks) stage<LC>(smem + ((ch + 1) & 1) * Kn::BUF, o, ch + 1, b0, tid, nt);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();  // chunk ch is in place

    const float* buf = smem + (ch & 1) * Kn::BUF;
    const int k0 = ch * QCHUNK, kend = min(QCHUNK, N + 1 - k0);
    AxisPolicy cur;
    if (k0 < N) cur = load_policy<LC>(buf, 0, g, ax);
    for (int kk = 0; kk < kend; ++kk) {
      const int k = k0 + kk;
      const float* row = buf + kk * Kn::FLOATS + ROW + (LC ? g * RSTRIDE : 0);
      const float4 Qv = reinterpret_cast<const float4*>(row)[2 * ax];
      const float4 qv = reinterpret_cast<const float4*>(row)[2 * ax + 1];
      const float Qa[4] = {Qv.x, Qv.y, Qv.z, Qv.w}, qa[4] = {qv.x, qv.y, qv.z, qv.w};
      float sqa = 0.0f, sla = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sqa += Qa[c] * s[c] * s[c];
        sla += qa[c] * s[c];
      }
      // the knot's whole sums, in every lane of the group: the merit then
      // adds a knot's terms as the one-thread design did, so the expanded
      // cost's large terms cancel within the knot
      const float sq = (__shfl_sync(FULL, sqa, base) + __shfl_sync(FULL, sqa, base + 1)) +
                       __shfl_sync(FULL, sqa, base + 2);
      const float sl = (__shfl_sync(FULL, sla, base) + __shfl_sync(FULL, sla, base + 1)) +
                       __shfl_sync(FULL, sla, base + 2);
      if (valid) {
#pragma unroll
        for (int c = 0; c < 4; ++c) xs[((long)k * S + ax + 3 * c) * B] = s[c];
      }
      if (k < N) {
        float u[I];
        altro_dev::axis_policy(cur, s, alpha, base, u);
        float su = 0.0f, sr = 0.0f;
#pragma unroll
        for (int q = 0; q < I; ++q) {
          su += row[RR + q] * u[q] * u[q];
          sr += row[RRL + q] * u[q];
        }
        phi = phi + 0.5f * sq + sl + 0.5f * su + sr + row[RC];
        const float h = cur.h, h6 = cur.h6;
        if (kk + 1 < kend && k + 1 < N) cur = load_policy<LC>(buf, kk + 1, g, ax);
        model.step(s, tr, u, h, h6, axis);
      } else {  // terminal knot: the state-only cost
        phi = phi + 0.5f * sq + sl + row[RC];
      }
    }
    __syncthreads();  // before this buffer takes chunk ch + 2
  }
  if (valid && ax == 0) o.phi[(long)w * B + b] = phi;
}

template <bool LC>
int launch(const Ops& o, const QuadrotorAxisRK4& model, cudaStream_t s) {
  const int trials = o.W < TRIALS ? o.W : TRIALS;
  const dim3 grid((o.Bsz + GROUPS - 1) / GROUPS, (o.W + trials - 1) / trials);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t bytes = 2 * (size_t)Knot<LC>::BUF * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      rollout_grid_quadrotor_kernel<LC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  rollout_grid_quadrotor_kernel<LC><<<grid, 32 * trials, bytes, s>>>(o, model);
  return (int)cudaGetLastError();
}

}  // namespace quad

template <class Model, int P, bool LC>
int launch(const Ops& o, const Model& model, cudaStream_t s) {
  auto kern = rollout_grid_kernel<Model, P, LC>;
  const int trials = o.W < MAX_TRIALS ? o.W : MAX_TRIALS;
  const dim3 block(LANES, trials);
  const dim3 grid((o.Bsz + LANES - 1) / LANES, (o.W + trials - 1) / trials);
  const size_t bytes = 2 * (size_t)Chunk<Model::NS, Model::NI, P, LC>::BUF * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, block, bytes, s>>>(o, model);
  return (int)cudaGetLastError();
}

template <class Model>
int launch_p(const Ops& o, const Model& m, int P, bool lane_cost, cudaStream_t s) {
  if (P == 0) return lane_cost ? launch<Model, 0, true>(o, m, s) : launch<Model, 0, false>(o, m, s);
  if (P == 2) return lane_cost ? launch<Model, 2, true>(o, m, s) : launch<Model, 2, false>(o, m, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// z0 holds the first p0 constraint rows and z1 the other P - p0 (the
// problem's constraint groups, null when empty). (model, integrator)
// (0, 0): the bicycle midpoint step, P 0 or 2, params (frame 0, 1 or 2,
// length, rear); (1, 1): the quadrotor RK4 step, P 0, params (mass,
// gravity, arm, kf, km, Jx, Jy, Jz); (2, 0): the pendulum midpoint step,
// P 0 or 2, params (mass, length, b, g); (3, 2): the double integrator's
// exact step, P 0 or 2, no params. params lies in host memory. lane_cost
// nonzero: Q, q, R, r, c and h hold one row per lane (a trailing [B]).
extern "C" int rollout_grid_f32(
    const float* xref, const float* uref, const float* K, const float* d,
    const float* Q, const float* q, const float* R, const float* r,
    const float* c, const float* h, const float* cax, const float* cau,
    const float* cg, const float* act, const float* z0, const float* z1,
    const float* rho, const float* alphas, const float* x0,
    float* phi, float* xstack, int N, int Bsz, int W, int P, int p0, int lane_cost, int model,
    int integrator, const float* params, void* stream) {
  if (N <= 0 || Bsz <= 0 || W <= 0 || (W + MAX_TRIALS - 1) / MAX_TRIALS > 65535 || p0 < 0 ||
      p0 > P)
    return (int)cudaErrorInvalidValue;
  const Ops o{xref, uref, K, d, Q, q, R, r, c, h, cax, cau, cg, act, z0, z1, rho, alphas, x0,
              phi, xstack, N, Bsz, W, p0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool lc = lane_cost != 0;
  if (model == 1 && integrator == 1) {
    if (P != 0) return (int)cudaErrorInvalidValue;
    const altro_dev::QuadrotorAxisRK4 m{params[0], params[1], params[2], params[3],
                                        params[4], params[5], params[6], params[7]};
    return lc ? quad::launch<true>(o, m, s) : quad::launch<false>(o, m, s);
  }
  if (model == 2 && integrator == 0)
    return launch_p(o, PendulumMidpoint{params[0], params[1], params[2], params[3]}, P, lc, s);
  if (model == 3 && integrator == 2) return launch_p(o, DoubleIntegrator{}, P, lc, s);
  if (model != 0 || integrator != 0) return (int)cudaErrorInvalidValue;
  const int frame = (int)params[0];
  if (frame == 0) return launch_p(o, BicycleFrame<0>{params[1], params[2]}, P, lc, s);
  if (frame == 1) return launch_p(o, BicycleFrame<1>{params[1], params[2]}, P, lc, s);
  if (frame == 2) return launch_p(o, BicycleFrame<2>{params[1], params[2]}, P, lc, s);
  return (int)cudaErrorInvalidValue;
}
