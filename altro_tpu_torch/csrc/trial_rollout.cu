// Single-lane W-trial line-search rollout (latency kernel) for Hopper (sm_90a).
//
// Replaces: altro_tpu/ops/pallas_rollout.py::_pallas_rollout (its Pallas
// `_kernel` and `_al_term`): the W <= 8 trial rollouts of ONE solve's
// line-search grid,
//   u = u_ref - K (x - x_ref) + alpha_w d,   x+ = step(x, u, h),
// the merit accumulated in the kernel from the diagonal cost rows plus,
// with P > 0 constraint rows, the affine NEGATIVE_ORTHANT augmented-
// Lagrangian term rhoi * sum_e min(w_e, 0)^2, w = wg - wa.x - wu.u taken
// from active-masked, rho-premultiplied rows (rhoi = 1/(2 rho)); the
// terminal knot adds its cost and its state-only AL term.
//
// What bounds it on this card: the chain. At N=500, W=8, n=4, m=2, P=2
// the kernel reads 44 floats per knot (88 KB in all) and writes the W
// state stacks (64 KB): 0.05 us at 3.35 TB/s. Each trial is a chain of N
// dependent midpoint steps (two bicycle evaluations with sin, cos, tan and
// a square root, the policy and the merit: some 150 dependent
// instructions per knot), so the time is N times one knot's latency.
//
// What the design does about it: one block of 128 threads. Lanes 0..W-1
// of warp 0 each run one trial with its state and merit in registers,
// reading the knot's operands from shared memory, where all W lanes read
// the same address (a broadcast). Warps 1-3 stage the operands in chunks
// of CH knots, double-buffered: while the trials walk chunk c, they load
// chunk c+1 (knot-major slices are contiguous, so the loads coalesce) and
// copy chunk c-1's states from their shared-memory staging out to the
// state stacks, so neither loads nor stores sit on the chain. Only chunk
// 0's load is exposed. Dynamic shared memory is 2 x (operands + states)
// of one chunk (38 KB at n=4, m=2, P=2, W=8); above 48 KB the launch opts
// in with cudaFuncSetAttribute.
//
// The dynamics are a __device__ step from csrc/device_steps.cuh, the twin
// of models/tile_steps.py::midpoint_tile(bicycle_tile(frame, length,
// rear)). The merit follows ops/trial_rollout.py::trial_rollout_ref term
// for term: phi += 0.5 Q.x.x + q.x + 0.5 R.u.u + r.u + c, then
// + rhoi * sum_e min(w_e, 0)^2.

#include <cuda_runtime.h>

#include "device_steps.cuh"

namespace {

using altro_dev::BicycleMidpoint;
using altro_dev::neg_part;

constexpr int CH = 64;        // knots per staged chunk
constexpr int THREADS = 128;  // warp 0: the trials; warps 1-3: staging
constexpr int STAGERS = THREADS - 32;
constexpr int MAX_W = 32;

// Float offsets of one chunk's buffers in shared memory.
struct Layout {
  int xref, uref, K, d, Q, q, R, r, c, h, wa, wu, wg, in_size;
  int out_size;  // W trials x CH knots x n states
};

__host__ __device__ inline Layout make_layout(int n, int m, int P, int W) {
  Layout L;
  int c = 0;
  L.xref = c; c += CH * n;
  L.uref = c; c += CH * m;
  L.K = c;    c += CH * m * n;
  L.d = c;    c += CH * m;
  L.Q = c;    c += CH * n;
  L.q = c;    c += CH * n;
  L.R = c;    c += CH * m;
  L.r = c;    c += CH * m;
  L.c = c;    c += CH;
  L.h = c;    c += CH;
  L.wa = c;   c += CH * P * n;
  L.wu = c;   c += CH * P * m;
  L.wg = c;   c += CH * P;
  L.in_size = c;
  L.out_size = W * CH * n;
  return L;
}

struct Operands {
  const float* xref;  // [N+1, NS] (rows 0..N-1 read)
  const float* uref;  // [N, NI]
  const float* K;     // [N, NI, NS]
  const float* d;     // [N, NI]
  const float* Q;     // [N+1, NS]
  const float* q;     // [N+1, NS]
  const float* R;     // [N+1, NI]
  const float* r;     // [N+1, NI]
  const float* c;     // [N+1]
  const float* h;     // [N]
  const float* wa;    // [N+1, P, NS]
  const float* wu;    // [N+1, P, NI]
  const float* wg;    // [N+1, P]
};

__device__ __forceinline__ void copy(float* __restrict__ dst, const float* __restrict__ src,
                                     int count, int t, int nt) {
  for (int i = t; i < count; i += nt) dst[i] = src[i];
}

// Chunk c covers knots [kbeg, kbeg + cnt), walked forward.
__device__ __forceinline__ void chunk_range(int c, int N, int& kbeg, int& cnt) {
  kbeg = c * CH;
  cnt = (N - kbeg < CH) ? N - kbeg : CH;
}

__device__ void stage_in(float* buf, const Layout& L, const Operands& op, int c, int N,
                         int n, int m, int P, int t, int nt) {
  int kbeg, cnt;
  chunk_range(c, N, kbeg, cnt);
  const long k0 = kbeg;
  copy(buf + L.xref, op.xref + k0 * n, cnt * n, t, nt);
  copy(buf + L.uref, op.uref + k0 * m, cnt * m, t, nt);
  copy(buf + L.K, op.K + k0 * m * n, cnt * m * n, t, nt);
  copy(buf + L.d, op.d + k0 * m, cnt * m, t, nt);
  copy(buf + L.Q, op.Q + k0 * n, cnt * n, t, nt);
  copy(buf + L.q, op.q + k0 * n, cnt * n, t, nt);
  copy(buf + L.R, op.R + k0 * m, cnt * m, t, nt);
  copy(buf + L.r, op.r + k0 * m, cnt * m, t, nt);
  copy(buf + L.c, op.c + k0, cnt, t, nt);
  copy(buf + L.h, op.h + k0, cnt, t, nt);
  if (P > 0) {
    copy(buf + L.wa, op.wa + k0 * P * n, cnt * P * n, t, nt);
    copy(buf + L.wu, op.wu + k0 * P * m, cnt * P * m, t, nt);
    copy(buf + L.wg, op.wg + k0 * P, cnt * P, t, nt);
  }
}

// States of chunk c: staging [W][CH][n] -> xstack [W, N+1, n].
__device__ void write_out(const float* buf, float* xstack, int c, int N, int n, int W,
                          int t, int nt) {
  int kbeg, cnt;
  chunk_range(c, N, kbeg, cnt);
  const int per = cnt * n;
  for (int i = t; i < W * per; i += nt) {
    const int w = i / per, e = i - w * per;
    xstack[((long)w * (N + 1) + kbeg) * n + e] = buf[w * CH * n + e];
  }
}

template <class Model>
__global__ void __launch_bounds__(THREADS) trial_rollout_kernel(
    Operands op, const float* __restrict__ alphas, const float* __restrict__ x0,
    const float* __restrict__ rhoi, float* __restrict__ phi_out,
    float* __restrict__ xstack, int N, int W, int P, Model model) {
  constexpr int NS = Model::NS;
  constexpr int NI = Model::NI;
  extern __shared__ float smem[];
  const Layout L = make_layout(NS, NI, P, W);
  float* inbuf[2] = {smem, smem + L.in_size};
  float* outbuf[2] = {smem + 2 * L.in_size, smem + 2 * L.in_size + L.out_size};
  const int tid = threadIdx.x;
  const int nch = (N + CH - 1) / CH;
  const bool runner = tid < W;

  stage_in(inbuf[0], L, op, 0, N, NS, NI, P, tid, THREADS);
  __syncthreads();

  float x[NS];
  float phi = 0.0f, alpha = 0.0f, ri = 0.0f;
  if (runner) {
    alpha = alphas[tid];
    if (P > 0) ri = rhoi[0];
#pragma unroll
    for (int i = 0; i < NS; ++i) x[i] = x0[i];
  }

  for (int c = 0; c <= nch; ++c) {
    if (tid < 32) {
      if (runner && c < nch) {
        int kbeg, cnt;
        chunk_range(c, N, kbeg, cnt);
        const float* in = inbuf[c & 1];
        float* xs = outbuf[c & 1] + tid * CH * NS;
        for (int j = 0; j < cnt; ++j) {
          const float* xr = in + L.xref + j * NS;
          const float* Kj = in + L.K + j * NI * NS;
          float u[NI];
#pragma unroll
          for (int a = 0; a < NI; ++a) {
            float s = 0.0f;
#pragma unroll
            for (int i = 0; i < NS; ++i) s += Kj[a * NS + i] * (x[i] - xr[i]);
            u[a] = in[L.uref + j * NI + a] + alpha * in[L.d + j * NI + a] - s;
          }
          float sq = 0.0f, sl = 0.0f, su = 0.0f, sr = 0.0f;
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            sq += in[L.Q + j * NS + i] * x[i] * x[i];
            sl += in[L.q + j * NS + i] * x[i];
          }
#pragma unroll
          for (int a = 0; a < NI; ++a) {
            su += in[L.R + j * NI + a] * u[a] * u[a];
            sr += in[L.r + j * NI + a] * u[a];
          }
          float ph = phi + 0.5f * sq + sl + 0.5f * su + sr + in[L.c + j];
          if (P > 0) {
            float alc = 0.0f;
            for (int e = 0; e < P; ++e) {
              float we = in[L.wg + j * P + e];
              float sa = 0.0f, sb = 0.0f;
#pragma unroll
              for (int i = 0; i < NS; ++i) sa += in[L.wa + (j * P + e) * NS + i] * x[i];
#pragma unroll
              for (int a = 0; a < NI; ++a) sb += in[L.wu + (j * P + e) * NI + a] * u[a];
              we = we - sa - sb;
              const float pw = neg_part(we);
              alc += pw * pw;
            }
            ph += ri * alc;
          }
#pragma unroll
          for (int i = 0; i < NS; ++i) xs[j * NS + i] = x[i];
          model.step(x, u, in[L.h + j]);
          phi = ph;
        }
      }
    } else {
      if (c + 1 < nch) stage_in(inbuf[(c + 1) & 1], L, op, c + 1, N, NS, NI, P, tid - 32, STAGERS);
      if (c >= 1) write_out(outbuf[(c - 1) & 1], xstack, c - 1, N, NS, W, tid - 32, STAGERS);
    }
    __syncthreads();
  }

  if (runner) {
    // terminal knot: state-only cost and constraint rows
    float sq = 0.0f, sl = 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sq += op.Q[(long)N * NS + i] * x[i] * x[i];
      sl += op.q[(long)N * NS + i] * x[i];
    }
    float ph = phi + 0.5f * sq + sl + op.c[N];
    if (P > 0) {
      float alc = 0.0f;
      for (int e = 0; e < P; ++e) {
        float sa = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) sa += op.wa[((long)N * P + e) * NS + i] * x[i];
        const float pw = neg_part(op.wg[(long)N * P + e] - sa);
        alc += pw * pw;
      }
      ph += ri * alc;
    }
    phi_out[tid] = ph;
#pragma unroll
    for (int i = 0; i < NS; ++i) xstack[((long)tid * (N + 1) + N) * NS + i] = x[i];
  }
}

}  // namespace

extern "C" int trial_rollout_f32(
    const float* alphas, const float* x0, const float* xref, const float* uref,
    const float* K, const float* d, const float* Q, const float* q, const float* R,
    const float* r, const float* c, const float* h, const float* wa, const float* wu,
    const float* wg, const float* rhoi, float* phi, float* xstack, int N, int W, int P,
    int model, int integrator, int frame, float length, float rear, void* stream) {
  if (N <= 0 || W <= 0 || W > MAX_W || P < 0) return (int)cudaErrorInvalidValue;
  if (!(model == 0 && integrator == 0)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(BicycleMidpoint::NS, BicycleMidpoint::NI, P, W);
  const size_t bytes = 2 * (size_t)(L.in_size + L.out_size) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trial_rollout_kernel<BicycleMidpoint>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const Operands op{xref, uref, K, d, Q, q, R, r, c, h, wa, wu, wg};
  const BicycleMidpoint mdl{frame, length, rear};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  trial_rollout_kernel<BicycleMidpoint><<<1, THREADS, bytes, s>>>(
      op, alphas, x0, rhoi, phi, xstack, N, W, P, mdl);
  return (int)cudaGetLastError();
}
