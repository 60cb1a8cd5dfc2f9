// Batched Riccati backward pass, one thread per lane, for Hopper (sm_90a).
//
// Replaces: altro_tpu/ops/pallas_riccati.py::riccati_backward_pallas_tiled
// (the Pallas `_kernel` run by `_run_tiled`), in the diagonal-cost form
// without a cross Hessian and with the affine dynamics term elided, the
// form the batched MPC solve uses.
//
// What bounds it on this card: each lane is a chain of N dependent knot
// steps (about 400 FMAs per knot at n=4, m=2, plus two square roots and
// the divides of the 2x2 Cholesky solve), and per knot it moves
// (n*n + n*m + n + m + n + m) * 4 = 144 bytes in and
// (m*n + m + n*n + n) * 4 = 120 bytes out. At B=2048, N=30 that is
// about 16 MB in all: 5 us at 3.35 TB/s, far below the chain's latency
// (30 knots of a few hundred dependent instructions). With 2048 lanes the
// card holds 2048 threads, a small fraction of its 132 SMs' capacity, so
// the latency of the sequential chain, not bandwidth, is the bound.
//
// What the design does about it: the cost-to-go carry (P, p), the gains
// and every per-knot temporary live in registers (n and m are template
// parameters, so every array is sized at compile time and fully
// unrolled); operands are lane-minor ([N, entry, B]), so a warp's 32
// loads of one entry are 32 neighbouring floats (coalesced), and nothing
// goes through shared memory. The loop over knots replaces the TPU
// kernel's sequential grid.
//
// Semantics carried over exactly from the Pallas kernel:
//   * the guarded pivot sqrt(max(diag, 1e-30));
//   * a knot whose pivot is not > 0 fails, and its K and d are SELECTED
//     to 0 (never multiplied: 0*inf would poison the carry);
//   * fail_index is the smallest failing knot, N when none fails;
//   * P = Qxx - Qux'K - reg K'K (upper triangle, mirrored),
//     p = Qx + Qux'd + reg K'd, dV = (sum d.Qu, -sum (d.Qu + reg d.d)/2);
//   * the terminal P_N is the diagonal lxx_N expanded, p_N = lx_N.

#include <cuda_runtime.h>

namespace {

template <int NS, int NI>
__global__ void riccati_backward_diag_kernel(
    const float* __restrict__ A,    // [N, NS, NS, Bsz]
    const float* __restrict__ Bm,   // [N, NS, NI, Bsz]
    const float* __restrict__ lxx,  // [N+1, NS, Bsz] diagonal
    const float* __restrict__ luu,  // [N, NI, Bsz] diagonal
    const float* __restrict__ lx,   // [N+1, NS, Bsz]
    const float* __restrict__ lu,   // [N, NI, Bsz]
    const float* __restrict__ reg,  // [Bsz]
    float* __restrict__ K_out,      // [N, NI, NS, Bsz]
    float* __restrict__ d_out,      // [N, NI, Bsz]
    float* __restrict__ P_out,      // [N+1, NS, NS, Bsz]
    float* __restrict__ p_out,      // [N+1, NS, Bsz]
    float* __restrict__ dV_out,     // [2, Bsz]
    bool* __restrict__ ok_out,      // [Bsz]
    int* __restrict__ fail_out,     // [Bsz]
    int N, int Bsz) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= Bsz) return;
  const long S = Bsz;

  float P[NS][NS], p[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      P[i][j] = (i == j) ? lxx[((long)N * NS + i) * S + b] : 0.0f;
      P_out[(((long)N * NS + i) * NS + j) * S + b] = P[i][j];
    }
    p[i] = lx[((long)N * NS + i) * S + b];
    p_out[((long)N * NS + i) * S + b] = p[i];
  }

  const float r = reg[b];
  float dV0 = 0.0f, dV1 = 0.0f;
  int fail = N;

  for (int k = N - 1; k >= 0; --k) {
    float a[NS][NS], bm[NS][NI];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int j = 0; j < NS; ++j) a[i][j] = A[(((long)k * NS + i) * NS + j) * S + b];
#pragma unroll
      for (int j = 0; j < NI; ++j) bm[i][j] = Bm[(((long)k * NS + i) * NI + j) * S + b];
    }

    // A'P and B'P
    float AtP[NS][NS], BtP[NI][NS];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int l = 0; l < NS; ++l) s += a[l][i] * P[l][j];
        AtP[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int l = 0; l < NS; ++l) s += bm[l][i] * P[l][j];
        BtP[i][j] = s;
      }

    float Qxx[NS][NS], Quu[NI][NI], Qux[NI][NS], Qx[NS], Qu[NI];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int l = 0; l < NS; ++l) s += AtP[i][l] * a[l][j];
        Qxx[i][j] = (i == j) ? lxx[((long)k * NS + i) * S + b] + s : s;
      }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int l = 0; l < NS; ++l) s += BtP[i][l] * bm[l][j];
        Quu[i][j] = (i == j) ? luu[((long)k * NI + i) * S + b] + s : s;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int l = 0; l < NS; ++l) s += BtP[i][l] * a[l][j];
        Qux[i][j] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int l = 0; l < NS; ++l) s += a[l][i] * p[l];
      Qx[i] = lx[((long)k * NS + i) * S + b] + s;
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int l = 0; l < NS; ++l) s += bm[l][i] * p[l];
      Qu[i] = lu[((long)k * NI + i) * S + b] + s;
    }

    // Unrolled Cholesky of Quu + reg I
    float L[NI][NI];
    bool ok_knot = true;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      float piv = Quu[j][j] + r;
#pragma unroll
      for (int kk = 0; kk < j; ++kk) piv -= L[j][kk] * L[j][kk];
      ok_knot = ok_knot && (piv > 0.0f);
      const float ljj = sqrtf(fmaxf(piv, 1e-30f));
      L[j][j] = ljj;
      const float inv = 1.0f / ljj;
#pragma unroll
      for (int i = j + 1; i < NI; ++i) {
        float s = Quu[i][j];
#pragma unroll
        for (int kk = 0; kk < j; ++kk) s -= L[i][kk] * L[j][kk];
        L[i][j] = s * inv;
      }
    }
    if (!ok_knot) fail = k;  // knots decrease, so the last write is the smallest

    // (L L') [K | d] = [Qux | -Qu]; column c < NS is K's, c == NS is d's
    float Kk[NI][NS], dk[NI];
#pragma unroll
    for (int c = 0; c <= NS; ++c) {
      float y[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float s = (c < NS) ? Qux[i][c] : -Qu[i];
#pragma unroll
        for (int kk = 0; kk < i; ++kk) s -= L[i][kk] * y[kk];
        y[i] = s / L[i][i];
      }
#pragma unroll
      for (int i = NI - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int kk = i + 1; kk < NI; ++kk) s -= L[kk][i] * y[kk];
        y[i] = s / L[i][i];
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float v = ok_knot ? y[i] : 0.0f;  // select, not multiply
        if (c < NS) Kk[i][c] = v; else dk[i] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int j = 0; j < NS; ++j) K_out[(((long)k * NI + i) * NS + j) * S + b] = Kk[i][j];
      d_out[((long)k * NI + i) * S + b] = dk[i];
    }

    // Cost-to-go by the Cholesky identity, upper triangle mirrored
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int j = i; j < NS; ++j) {
        float sq = 0.0f, kk2 = 0.0f;
#pragma unroll
        for (int l = 0; l < NI; ++l) {
          sq += Kk[l][i] * Qux[l][j];
          kk2 += Kk[l][i] * Kk[l][j];
        }
        const float v = Qxx[i][j] - sq - r * kk2;
        P[i][j] = v;
        P[j][i] = v;
      }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int l = 0; l < NI; ++l) {
        s1 += Qux[l][i] * dk[l];
        s2 += Kk[l][i] * dk[l];
      }
      p[i] = Qx[i] + s1 + r * s2;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int j = 0; j < NS; ++j) P_out[(((long)k * NS + i) * NS + j) * S + b] = P[i][j];
      p_out[((long)k * NS + i) * S + b] = p[i];
    }

    float dQu = 0.0f, dd = 0.0f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      dQu += dk[i] * Qu[i];
      dd += dk[i] * dk[i];
    }
    dV0 += dQu;
    dV1 -= 0.5f * (dQu + r * dd);
  }

  dV_out[b] = dV0;
  dV_out[S + b] = dV1;
  ok_out[b] = (fail == N);
  fail_out[b] = fail;
}

}  // namespace

extern "C" int riccati_backward_diag_f32(
    const float* A, const float* Bm, const float* lxx, const float* luu,
    const float* lx, const float* lu, const float* reg,
    float* K, float* d, float* P, float* p, float* dV, bool* ok, int* fail,
    int N, int n, int m, int Bsz, void* stream) {
  if (N <= 0 || Bsz <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid((Bsz + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 4 && m == 2) {
    riccati_backward_diag_kernel<4, 2><<<grid, threads, 0, s>>>(
        A, Bm, lxx, luu, lx, lu, reg, K, d, P, p, dV, ok, fail, N, Bsz);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
