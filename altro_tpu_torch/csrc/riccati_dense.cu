// Batched dense Riccati backward pass, one thread per lane, for Hopper (sm_90a).
//
// Replaces: altro_tpu/ops/pallas_riccati.py::riccati_backward_pallas (the
// Pallas `_kernel` run by `_run` with diag_cost=False, with_f, with_lux),
// the batch-fused backward pass of the vmapped solve with
// pallas_backward=True. Here the operands are lane-minor ([N, entry..., B]);
// the batch-major wrapper transposes at its edges as `_run` did.
//
// What bounds it on this card: per lane and knot it moves
// (n*n + n*m + n + n*n + m*m + m*n + n + m) * 4 bytes in and
// (m*n + m + n*n + n) * 4 out, about 2.5 KB at n=12, m=4: 78 MB at
// B=1024, N=30, or 0.023 ms at 3.35 TB/s. The work is about 2 n^3 + 4 n^2 m
// multiply-adds per knot (A'P'A and B'P'[A B]), 0.25 GFLOP in all, far
// below the f32 peak. But each lane is a chain of N dependent knots of a
// few thousand instructions, and 1024 lanes fill 32 warps of a card that
// holds 8,448: the latency of one thread's chain is the bound in practice.
//
// What the design does about it: one thread per lane, lanes the fastest
// axis, so a warp's 32 loads of one operand entry are 32 neighbouring
// floats (coalesced). n and m are template parameters: every loop is
// unrolled at compile time. At n=12 the carry P (144 floats), A_k (144) and
// the product A'P (144) would not fit the 255 registers of one thread, so
// each thread keeps P (double-buffered), p, A_k and B_k in its own slice of
// shared memory (element e of thread t at [e * THREADS + t]: 32 threads hit
// 32 banks) and builds Qxx = lxx + A'P'A and the new P one row at a time
// (row i of A'P' lives in 12 registers). The gains K and the cross block
// Qux stay in registers. f and lux are compile-time optional. The loop over
// knots replaces the TPU kernel's sequential grid.
//
// Semantics carried over exactly from the Pallas kernel:
//   * Qx = lx + A'(P'f + p'), Qu = lu + B'(P'f + p'), Qux = lux + B'P'A;
//   * the guarded pivot sqrt(max(diag, 1e-30)) of Quu + reg I (its lower
//     triangle), reg per lane;
//   * a knot whose pivot is not > 0 fails, and its K and d are SELECTED to 0
//     (never multiplied: 0*inf would poison the carry);
//   * fail_index is the smallest failing knot, N when none fails;
//   * P = Qxx - Qux'K - reg K'K (upper triangle, mirrored),
//     p = Qx + Qux'd + reg K'd, dV = (sum d.Qu, -sum (d.Qu + reg d.d)/2);
//   * the terminal rows P_N = lxx_N, p_N = lx_N.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;  // one warp per block: B=1024 lanes spread over 32 SMs

template <int NS, int NI>
constexpr int smem_floats() {
  return 2 * NS * NS + NS + NS * NS + NS * NI;  // P (two buffers), p, A_k, B_k
}

template <int NS, int NI, bool WITH_F, bool WITH_LUX>
__global__ void __launch_bounds__(THREADS) riccati_dense_kernel(
    const float* __restrict__ A,    // [N, NS, NS, Bsz]
    const float* __restrict__ Bm,   // [N, NS, NI, Bsz]
    const float* __restrict__ f,    // [N, NS, Bsz]       (WITH_F)
    const float* __restrict__ lxx,  // [N+1, NS, NS, Bsz]
    const float* __restrict__ luu,  // [N, NI, NI, Bsz]
    const float* __restrict__ lux,  // [N, NI, NS, Bsz]   (WITH_LUX)
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
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int b = blockIdx.x * THREADS + t;
  if (b >= Bsz) return;  // no barrier below: each thread owns its slices
  const long S = Bsz;

  // this thread's slices; element e of a slice is at [e * THREADS]
  float* Pc = smem + t;                 // P of knot k+1 (the carry)
  float* Pn = Pc + NS * NS * THREADS;   // P of knot k (being built)
  float* pc = Pn + NS * NS * THREADS;   // p carry
  float* sa = pc + NS * THREADS;        // A_k
  float* sb = sa + NS * NS * THREADS;   // B_k
#define SH(ptr, e) ptr[(e) * THREADS]

#pragma unroll
  for (int e = 0; e < NS * NS; ++e) {
    const float v = lxx[((long)N * NS * NS + e) * S + b];
    SH(Pc, e) = v;
    P_out[((long)N * NS * NS + e) * S + b] = v;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float v = lx[((long)N * NS + i) * S + b];
    SH(pc, i) = v;
    p_out[((long)N * NS + i) * S + b] = v;
  }

  const float r = reg[b];
  float dV0 = 0.0f, dV1 = 0.0f;
  int fail = N;

  for (int k = N - 1; k >= 0; --k) {
#pragma unroll
    for (int e = 0; e < NS * NS; ++e) SH(sa, e) = A[((long)k * NS * NS + e) * S + b];
#pragma unroll
    for (int e = 0; e < NS * NI; ++e) SH(sb, e) = Bm[((long)k * NS * NI + e) * S + b];

    // t = P'f + p', then Qx = lx + A't and Qu = lu + B't
    float tv[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float s = SH(pc, i);
      if (WITH_F) {
#pragma unroll
        for (int l = 0; l < NS; ++l) s += SH(Pc, i * NS + l) * f[((long)k * NS + l) * S + b];
      }
      tv[i] = s;
    }
    float Qx[NS], Qu[NI];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float s = lx[((long)k * NS + i) * S + b];
#pragma unroll
      for (int l = 0; l < NS; ++l) s += SH(sa, l * NS + i) * tv[l];
      Qx[i] = s;
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float s = lu[((long)k * NI + i) * S + b];
#pragma unroll
      for (int l = 0; l < NS; ++l) s += SH(sb, l * NI + i) * tv[l];
      Qu[i] = s;
    }

    // row i of B'P' -> Quu = luu + B'P'B, Qux = lux + B'P'A
    float Quu[NI][NI], Qux[NI][NS];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float btp[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int l = 0; l < NS; ++l) s += SH(sb, l * NI + i) * SH(Pc, l * NS + j);
        btp[j] = s;
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        float s = luu[(((long)k * NI + i) * NI + j) * S + b];
#pragma unroll
        for (int l = 0; l < NS; ++l) s += btp[l] * SH(sb, l * NI + j);
        Quu[i][j] = s;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float s = WITH_LUX ? lux[(((long)k * NI + i) * NS + j) * S + b] : 0.0f;
#pragma unroll
        for (int l = 0; l < NS; ++l) s += btp[l] * SH(sa, l * NS + j);
        Qux[i][j] = s;
      }
    }

    // Unrolled Cholesky of Quu + reg I (lower triangle)
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

    // P row by row: w = row i of A'P', Qxx[i][j] = lxx + w.A[:, j], then the
    // Cholesky identity on the upper triangle, mirrored
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float w[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int l = 0; l < NS; ++l) s += SH(sa, l * NS + i) * SH(Pc, l * NS + j);
        w[j] = s;
      }
#pragma unroll
      for (int j = i; j < NS; ++j) {
        float q = lxx[(((long)k * NS + i) * NS + j) * S + b];
#pragma unroll
        for (int l = 0; l < NS; ++l) q += w[l] * SH(sa, l * NS + j);
        float sq = 0.0f, kk2 = 0.0f;
#pragma unroll
        for (int l = 0; l < NI; ++l) {
          sq += Kk[l][i] * Qux[l][j];
          kk2 += Kk[l][i] * Kk[l][j];
        }
        const float v = q - sq - r * kk2;
        SH(Pn, i * NS + j) = v;
        SH(Pn, j * NS + i) = v;
        P_out[(((long)k * NS + i) * NS + j) * S + b] = v;
        if (j != i) P_out[(((long)k * NS + j) * NS + i) * S + b] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int l = 0; l < NI; ++l) {
        s1 += Qux[l][i] * dk[l];
        s2 += Kk[l][i] * dk[l];
      }
      const float v = Qx[i] + s1 + r * s2;
      SH(pc, i) = v;
      p_out[((long)k * NS + i) * S + b] = v;
    }
    float* tmp = Pc;  // the new P becomes the carry
    Pc = Pn;
    Pn = tmp;

    float dQu = 0.0f, dd = 0.0f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      dQu += dk[i] * Qu[i];
      dd += dk[i] * dk[i];
    }
    dV0 += dQu;
    dV1 -= 0.5f * (dQu + r * dd);
  }
#undef SH

  dV_out[b] = dV0;
  dV_out[S + b] = dV1;
  ok_out[b] = (fail == N);
  fail_out[b] = fail;
}

struct Args {
  const float *A, *Bm, *f, *lxx, *luu, *lux, *lx, *lu, *reg;
  float *K, *d, *P, *p, *dV;
  bool* ok;
  int* fail;
  int N, Bsz;
};

template <int NS, int NI, bool WITH_F, bool WITH_LUX>
int launch_one(const Args& a, cudaStream_t s) {
  auto kern = riccati_dense_kernel<NS, NI, WITH_F, WITH_LUX>;
  const size_t bytes = (size_t)smem_floats<NS, NI>() * THREADS * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Bsz + THREADS - 1) / THREADS);
  riccati_dense_kernel<NS, NI, WITH_F, WITH_LUX><<<grid, THREADS, bytes, s>>>(
      a.A, a.Bm, a.f, a.lxx, a.luu, a.lux, a.lx, a.lu, a.reg, a.K, a.d, a.P, a.p, a.dV,
      a.ok, a.fail, a.N, a.Bsz);
  return (int)cudaGetLastError();
}

template <int NS, int NI>
int launch(const Args& a, cudaStream_t s) {
  if (a.f && a.lux) return launch_one<NS, NI, true, true>(a, s);
  if (a.f) return launch_one<NS, NI, true, false>(a, s);
  if (a.lux) return launch_one<NS, NI, false, true>(a, s);
  return launch_one<NS, NI, false, false>(a, s);
}

}  // namespace

// f and lux may be null (a zero affine term, a zero cross Hessian).
extern "C" int riccati_dense_f32(
    const float* A, const float* Bm, const float* f, const float* lxx, const float* luu,
    const float* lux, const float* lx, const float* lu, const float* reg,
    float* K, float* d, float* P, float* p, float* dV, bool* ok, int* fail,
    int N, int n, int m, int Bsz, void* stream) {
  if (N <= 0 || Bsz <= 0) return (int)cudaErrorInvalidValue;
  const Args a{A, Bm, f, lxx, luu, lux, lx, lu, reg, K, d, P, p, dV, ok, fail, N, Bsz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 4 && m == 2) return launch<4, 2>(a, s);
  if (n == 12 && m == 4) return launch<12, 4>(a, s);
  return (int)cudaErrorInvalidValue;
}
