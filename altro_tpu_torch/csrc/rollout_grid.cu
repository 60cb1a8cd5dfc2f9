// Batched W-trial line-search rollout with the dynamics in the kernel,
// one thread per (lane, trial), for Hopper (sm_90a).
//
// Replaces: altro_tpu/ops/pallas_rollout_tiled.py::rollout_grid_pallas_tiled
// (its Pallas `_kernel`): W closed-loop trial rollouts
//   u = u_ref - K (x - x_ref) + alpha_w d,   x+ = step(x, u, h),
// the merit accumulated in the kernel from the diagonal cost rows plus the
// affine NEGATIVE_ORTHANT augmented-Lagrangian term rhoi * min(w, 0)^2 with
// w = wg - wax.x - wau.u taken from rho-premultiplied rows, rhoi = 1/(2 rho).
//
// What bounds it on this card: each thread runs a chain of N dependent
// knot steps; a bicycle midpoint step is two evaluations of the model
// (sin, cos, tan and a square root each) plus the policy and merit, some
// 150 dependent instructions per knot. Per knot a thread reads the lane's
// x_ref, u_ref, K, d and constraint rows ((n + m + m*n + m + P*(n+m+1)) * 4
// = 80 bytes at n=4, m=2, P=2; the W threads of one lane share them through
// L1/L2) and writes its state (n * 4 = 16 bytes). At W=8, B=2048, N=30 the
// whole grid moves about 6 MB: 2 us at 3.35 TB/s, against a chain of 30
// knots of transcendental-heavy steps. Latency of the sequential chain is
// the bound, and 16,384 threads fill the card only thinly.
//
// What the design does about it: one thread per (lane, trial) rather than
// one thread per lane with the trials unrolled, so the card runs W times
// more independent chains (16,384 instead of 2,048 on the main path) and
// each thread's chain stays short in registers. blockIdx.y is the trial,
// so a warp's 32 threads are 32 neighbouring lanes of one trial and every
// lane-minor load and store ([N, entry, B]) is coalesced. The shared cost
// rows ([N+1, n], the same for every lane) are read at one address by the
// whole warp (a broadcast), never copied per lane. State, merit and the
// policy live in registers; no shared memory.
//
// The dynamics are a __device__ function from csrc/device_steps.cuh, the
// twin of models/tile_steps.py::midpoint_cols(bicycle_cols(frame, length,
// rear)).

#include <cuda_runtime.h>

#include "device_steps.cuh"

namespace {

using altro_dev::BicycleMidpoint;
using altro_dev::neg_part;

template <class Model>
__global__ void rollout_grid_kernel(
    const float* __restrict__ xref,    // [N, NS, Bsz]
    const float* __restrict__ uref,    // [N, NI, Bsz]
    const float* __restrict__ K,       // [N, NI, NS, Bsz]
    const float* __restrict__ d,       // [N, NI, Bsz]
    const float* __restrict__ Qd,      // [N+1, NS] shared by all lanes
    const float* __restrict__ q,       // [N+1, NS]
    const float* __restrict__ Rd,      // [N+1, NI]
    const float* __restrict__ r,       // [N+1, NI]
    const float* __restrict__ c,       // [N+1]
    const float* __restrict__ h,       // [N]
    const float* __restrict__ wax,     // [N+1, P, NS, Bsz]
    const float* __restrict__ wau,     // [N+1, P, NI, Bsz]
    const float* __restrict__ wg,      // [N+1, P, Bsz]
    const float* __restrict__ alphas,  // [W]
    const float* __restrict__ x0,      // [NS, Bsz]
    const float* __restrict__ rhoi,    // [Bsz]
    float* __restrict__ phi_out,       // [W, Bsz]
    float* __restrict__ xstack,        // [W, N+1, NS, Bsz]
    int N, int Bsz, int P, Model model) {
  constexpr int NS = Model::NS;
  constexpr int NI = Model::NI;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  if (b >= Bsz) return;
  const long S = Bsz;
  const float alpha = alphas[w];
  const float ri = rhoi[b];
  float* xs = xstack + (long)w * (N + 1) * NS * S;

  float x[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) x[i] = x0[i * S + b];
  float phi = 0.0f;

  for (int k = 0; k < N; ++k) {
    float u[NI];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s += K[(((long)k * NI + j) * NS + i) * S + b] * (x[i] - xref[((long)k * NS + i) * S + b]);
      u[j] = uref[((long)k * NI + j) * S + b] + alpha * d[((long)k * NI + j) * S + b] - s;
    }
    float sq = 0.0f, sl = 0.0f, su = 0.0f, sr = 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sq += Qd[k * NS + i] * x[i] * x[i];
      sl += q[k * NS + i] * x[i];
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      su += Rd[k * NI + j] * u[j] * u[j];
      sr += r[k * NI + j] * u[j];
    }
    float ph = phi + 0.5f * sq + sl + 0.5f * su + sr + c[k];
    for (int e = 0; e < P; ++e) {
      float we = wg[((long)k * P + e) * S + b];
#pragma unroll
      for (int i = 0; i < NS; ++i) we -= wax[(((long)k * P + e) * NS + i) * S + b] * x[i];
#pragma unroll
      for (int j = 0; j < NI; ++j) we -= wau[(((long)k * P + e) * NI + j) * S + b] * u[j];
      const float pw = neg_part(we);
      ph += ri * pw * pw;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) xs[((long)k * NS + i) * S + b] = x[i];
    model.step(x, u, h[k]);
    phi = ph;
  }

  // terminal knot: state-only cost and constraint rows
  float sq = 0.0f, sl = 0.0f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    sq += Qd[N * NS + i] * x[i] * x[i];
    sl += q[N * NS + i] * x[i];
  }
  float ph = phi + 0.5f * sq + sl + c[N];
  for (int e = 0; e < P; ++e) {
    float we = wg[((long)N * P + e) * S + b];
#pragma unroll
    for (int i = 0; i < NS; ++i) we -= wax[(((long)N * P + e) * NS + i) * S + b] * x[i];
    const float pw = neg_part(we);
    ph += ri * pw * pw;
  }
  phi_out[(long)w * S + b] = ph;
#pragma unroll
  for (int i = 0; i < NS; ++i) xs[((long)N * NS + i) * S + b] = x[i];
}

}  // namespace

extern "C" int rollout_grid_f32(
    const float* xref, const float* uref, const float* K, const float* d,
    const float* Qd, const float* q, const float* Rd, const float* r,
    const float* c, const float* h, const float* wax, const float* wau,
    const float* wg, const float* alphas, const float* x0, const float* rhoi,
    float* phi, float* xstack, int N, int Bsz, int W, int P, int model,
    int integrator, int frame, float length, float rear, void* stream) {
  if (N <= 0 || Bsz <= 0 || W <= 0 || W > 65535 || P < 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid((Bsz + threads - 1) / threads, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (model == 0 && integrator == 0) {
    const BicycleMidpoint m{frame, length, rear};
    rollout_grid_kernel<BicycleMidpoint><<<grid, threads, 0, s>>>(
        xref, uref, K, d, Qd, q, Rd, r, c, h, wax, wau, wg, alphas, x0, rhoi,
        phi, xstack, N, Bsz, P, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
