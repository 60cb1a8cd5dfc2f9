// Single-lane Riccati backward pass (latency kernel) for Hopper (sm_90a).
//
// Replaces: altro_tpu/ops/pallas_packed.py::riccati_backward_pallas_packed
// (its Pallas `_kernel` / `_knot_body`): the whole N-knot backward chain of
// ONE solve in one program, with the Cholesky failure contract and the
// affine term elided when f is absent.
//
// What bounds it on this card: nothing but the chain. At N=500, n=4, m=2
// with diagonal costs the kernel reads 36 floats and writes 30 per knot
// (about 130 KB in all: 0.04 us at 3.35 TB/s) and does about 400 flops
// per knot (0.2 MFLOP: nothing at 67 TFLOP/s). Each knot's (P, p) depends
// on the next one's, so the time is N times the latency of one knot's
// dependent arithmetic (a few hundred instructions with short dependency
// chains, two square roots and divides) plus whatever memory latency the
// chain waits on.
//
// What the design does about it: one block of 128 threads. Thread 0 runs
// the recursion with the carry (P, p), the gains and every per-knot
// temporary in registers (n and m are template parameters, so every array
// is sized at compile time and fully unrolled), reading its operands from
// shared memory (about 30 cycles) instead of device memory (about 600).
// Warps 1-3 stage the operands in chunks of CH knots, double-buffered:
// while thread 0 walks chunk c, they load chunk c+1 (coalesced, knot-major
// slices are contiguous) and write chunk c-1's K, d, P, p back from their
// shared-memory staging, so neither the loads nor the stores sit on the
// chain. Only chunk 0's load is exposed. The dynamic shared memory is
// 2 x (inputs + outputs) of one chunk (34 KB at n=4, m=2, diagonal costs;
// 47 KB dense with lux and f); above 48 KB the launch opts in with
// cudaFuncSetAttribute.
//
// Semantics carried over from the plain version
// (ops/riccati_backward.py::riccati_backward_ref with one lane):
//   * Qxx = lxx + A'P'A, Quu = luu + B'P'B, Qux = (lux +) B'P'A,
//     t = (P'f +) p', Qx = lx + A't, Qu = lu + B't;
//   * L = chol(Quu + reg I) with the guarded pivot sqrt(max(d, 1e-30));
//     a knot whose pivot is not > 0 fails, and its K and d are SELECTED
//     to 0 (never multiplied: 0*inf would poison the carry);
//   * fail_index is the smallest failing knot, N when none fails;
//   * P = Qxx - Qux'K - reg K'K (upper triangle, mirrored),
//     p = Qx + Qux'd + reg K'd, dV = (sum d.Qu, -sum (d.Qu + reg d.d)/2);
//   * P_N = lxx_N (a diagonal expanded), p_N = lx_N.

#include <cuda_runtime.h>

namespace {

constexpr int CH = 64;        // knots per staged chunk
constexpr int THREADS = 128;  // thread 0: the chain; warps 1-3: staging
constexpr int STAGERS = THREADS - 32;

// Float offsets of one chunk's buffers in shared memory.
struct Layout {
  int A, B, lxx, luu, lux, f, lx, lu, in_size;
  int K, d, P, p, out_size;
};

__host__ __device__ inline Layout make_layout(int n, int m, int wxx, int wuu,
                                              int wux, int wf) {
  Layout L;
  int c = 0;
  L.A = c;   c += CH * n * n;
  L.B = c;   c += CH * n * m;
  L.lxx = c; c += CH * wxx;
  L.luu = c; c += CH * wuu;
  L.lux = c; c += CH * wux;
  L.f = c;   c += CH * wf;
  L.lx = c;  c += CH * n;
  L.lu = c;  c += CH * m;
  L.in_size = c;
  c = 0;
  L.K = c;   c += CH * m * n;
  L.d = c;   c += CH * m;
  L.P = c;   c += CH * n * n;
  L.p = c;   c += CH * n;
  L.out_size = c;
  return L;
}

__device__ __forceinline__ void copy(float* __restrict__ dst, const float* __restrict__ src,
                                     int count, int t, int nt) {
  for (int i = t; i < count; i += nt) dst[i] = src[i];
}

struct Operands {
  const float* A;    // [N, NS, NS]
  const float* B;    // [N, NS, NI]
  const float* lxx;  // [N+1, NS] diagonal or [N+1, NS, NS]
  const float* luu;  // [N, NI] diagonal or [N, NI, NI]
  const float* lux;  // [N, NI, NS] or null
  const float* f;    // [N, NS] or null
  const float* lx;   // [N+1, NS]
  const float* lu;   // [N, NI]
};

struct Outputs {
  float* K;  // [N, NI, NS]
  float* d;  // [N, NI]
  float* P;  // [N+1, NS, NS]
  float* p;  // [N+1, NS]
};

// Chunk c covers knots [kbeg, kend), walked from kend-1 down.
__device__ __forceinline__ void chunk_range(int c, int N, int& kbeg, int& cnt) {
  const int kend = N - c * CH;
  kbeg = kend - CH > 0 ? kend - CH : 0;
  cnt = kend - kbeg;
}

__device__ void stage_in(float* buf, const Layout& L, const Operands& op, int c, int N,
                         int n, int m, int wxx, int wuu, int wux, int wf, int t, int nt) {
  int kbeg, cnt;
  chunk_range(c, N, kbeg, cnt);
  const long k0 = kbeg;
  copy(buf + L.A, op.A + k0 * n * n, cnt * n * n, t, nt);
  copy(buf + L.B, op.B + k0 * n * m, cnt * n * m, t, nt);
  copy(buf + L.lxx, op.lxx + k0 * wxx, cnt * wxx, t, nt);
  copy(buf + L.luu, op.luu + k0 * wuu, cnt * wuu, t, nt);
  if (wux) copy(buf + L.lux, op.lux + k0 * wux, cnt * wux, t, nt);
  if (wf) copy(buf + L.f, op.f + k0 * wf, cnt * wf, t, nt);
  copy(buf + L.lx, op.lx + k0 * n, cnt * n, t, nt);
  copy(buf + L.lu, op.lu + k0 * m, cnt * m, t, nt);
}

__device__ void write_out(const float* buf, const Layout& L, const Outputs& out, int c,
                          int N, int n, int m, int t, int nt) {
  int kbeg, cnt;
  chunk_range(c, N, kbeg, cnt);
  const long k0 = kbeg;
  copy(out.K + k0 * m * n, buf + L.K, cnt * m * n, t, nt);
  copy(out.d + k0 * m, buf + L.d, cnt * m, t, nt);
  copy(out.P + k0 * n * n, buf + L.P, cnt * n * n, t, nt);
  copy(out.p + k0 * n, buf + L.p, cnt * n, t, nt);
}

// The recursion over one staged chunk (thread 0 only).
template <int NS, int NI>
__device__ __forceinline__ void chain_chunk(
    const float* __restrict__ in, float* __restrict__ out, const Layout& L, int kbeg,
    int cnt, bool diag_x, bool diag_u, bool has_lux, bool has_f, float r,
    float (&P)[NS][NS], float (&p)[NS], float& dV0, float& dV1, int& fail) {
  for (int j = cnt - 1; j >= 0; --j) {
    const float* a_s = in + L.A + j * NS * NS;
    const float* b_s = in + L.B + j * NS * NI;
    float a[NS][NS], bm[NS][NI];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int l = 0; l < NS; ++l) a[i][l] = a_s[i * NS + l];
#pragma unroll
      for (int l = 0; l < NI; ++l) bm[i][l] = b_s[i * NI + l];
    }

    // t = P'f + p' (f elided when absent)
    float t[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float s = p[i];
      if (has_f) {
        const float* f_s = in + L.f + j * NS;
        float pf = 0.0f;
#pragma unroll
        for (int l = 0; l < NS; ++l) pf += P[i][l] * f_s[l];
        s = pf + p[i];
      }
      t[i] = s;
    }

    // A'P and B'P
    float AtP[NS][NS], BtP[NI][NS];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < NS; ++q) s += a[q][i] * P[q][l];
        AtP[i][l] = s;
      }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < NS; ++q) s += bm[q][i] * P[q][l];
        BtP[i][l] = s;
      }

    float Qxx[NS][NS], Quu[NI][NI], Qux[NI][NS], Qx[NS], Qu[NI];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < NS; ++q) s += AtP[i][q] * a[q][l];
        if (diag_x) {
          Qxx[i][l] = (i == l) ? in[L.lxx + j * NS + i] + s : s;
        } else {
          Qxx[i][l] = in[L.lxx + (j * NS + i) * NS + l] + s;
        }
      }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int l = 0; l < NI; ++l) {
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < NS; ++q) s += BtP[i][q] * bm[q][l];
        if (diag_u) {
          Quu[i][l] = (i == l) ? in[L.luu + j * NI + i] + s : s;
        } else {
          Quu[i][l] = in[L.luu + (j * NI + i) * NI + l] + s;
        }
      }
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < NS; ++q) s += BtP[i][q] * a[q][l];
        Qux[i][l] = has_lux ? in[L.lux + (j * NI + i) * NS + l] + s : s;
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < NS; ++q) s += a[q][i] * t[q];
      Qx[i] = in[L.lx + j * NS + i] + s;
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < NS; ++q) s += bm[q][i] * t[q];
      Qu[i] = in[L.lu + j * NI + i] + s;
    }

    // Unrolled Cholesky of Quu + reg I
    float Lc[NI][NI];
    bool ok_knot = true;
#pragma unroll
    for (int jj = 0; jj < NI; ++jj) {
      float piv = Quu[jj][jj] + r;
#pragma unroll
      for (int kk = 0; kk < jj; ++kk) piv -= Lc[jj][kk] * Lc[jj][kk];
      ok_knot = ok_knot && (piv > 0.0f);
      const float ljj = sqrtf(fmaxf(piv, 1e-30f));
      Lc[jj][jj] = ljj;
      const float inv = 1.0f / ljj;
#pragma unroll
      for (int i = jj + 1; i < NI; ++i) {
        float s = Quu[i][jj];
#pragma unroll
        for (int kk = 0; kk < jj; ++kk) s -= Lc[i][kk] * Lc[jj][kk];
        Lc[i][jj] = s * inv;
      }
    }
    if (!ok_knot) fail = kbeg + j;  // knots decrease, so the last write is the smallest

    // (L L') [K | d] = [Qux | -Qu]; column cc < NS is K's, cc == NS is d's
    float Kk[NI][NS], dk[NI];
#pragma unroll
    for (int cc = 0; cc <= NS; ++cc) {
      float y[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float s = (cc < NS) ? Qux[i][cc] : -Qu[i];
#pragma unroll
        for (int kk = 0; kk < i; ++kk) s -= Lc[i][kk] * y[kk];
        y[i] = s / Lc[i][i];
      }
#pragma unroll
      for (int i = NI - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int kk = i + 1; kk < NI; ++kk) s -= Lc[kk][i] * y[kk];
        y[i] = s / Lc[i][i];
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float v = ok_knot ? y[i] : 0.0f;  // select, not multiply
        if (cc < NS) Kk[i][cc] = v; else dk[i] = v;
      }
    }

    // Cost-to-go by the Cholesky identity, upper triangle mirrored
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int l = i; l < NS; ++l) {
        float sq = 0.0f, kk2 = 0.0f;
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          sq += Kk[q][i] * Qux[q][l];
          kk2 += Kk[q][i] * Kk[q][l];
        }
        const float v = Qxx[i][l] - sq - r * kk2;
        P[i][l] = v;
        P[l][i] = v;
      }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int q = 0; q < NI; ++q) {
        s1 += Qux[q][i] * dk[q];
        s2 += Kk[q][i] * dk[q];
      }
      p[i] = Qx[i] + s1 + r * s2;
    }

    // stage this knot's outputs for the writers
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int l = 0; l < NS; ++l) out[L.K + (j * NI + i) * NS + l] = Kk[i][l];
      out[L.d + j * NI + i] = dk[i];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int l = 0; l < NS; ++l) out[L.P + (j * NS + i) * NS + l] = P[i][l];
      out[L.p + j * NS + i] = p[i];
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
}

template <int NS, int NI>
__global__ void __launch_bounds__(THREADS) riccati_latency_kernel(
    Operands op, const float* __restrict__ reg, Outputs out,
    float* __restrict__ dV_out, bool* __restrict__ ok_out, int* __restrict__ fail_out,
    int N, int diag_x, int diag_u) {
  extern __shared__ float smem[];
  const int wxx = diag_x ? NS : NS * NS;
  const int wuu = diag_u ? NI : NI * NI;
  const int wux = op.lux ? NI * NS : 0;
  const int wf = op.f ? NS : 0;
  const Layout L = make_layout(NS, NI, wxx, wuu, wux, wf);
  float* inbuf[2] = {smem, smem + L.in_size};
  float* outbuf[2] = {smem + 2 * L.in_size, smem + 2 * L.in_size + L.out_size};
  const int tid = threadIdx.x;
  const int nch = (N + CH - 1) / CH;

  stage_in(inbuf[0], L, op, 0, N, NS, NI, wxx, wuu, wux, wf, tid, THREADS);
  __syncthreads();

  float P[NS][NS], p[NS];
  float dV0 = 0.0f, dV1 = 0.0f, r = 0.0f;
  int fail = N;
  if (tid == 0) {
    r = reg[0];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        P[i][l] = diag_x ? ((i == l) ? op.lxx[(long)N * NS + i] : 0.0f)
                         : op.lxx[((long)N * NS + i) * NS + l];
        out.P[((long)N * NS + i) * NS + l] = P[i][l];
      }
      p[i] = op.lx[(long)N * NS + i];
      out.p[(long)N * NS + i] = p[i];
    }
  }

  for (int c = 0; c <= nch; ++c) {
    if (tid == 0) {
      if (c < nch) {
        int kbeg, cnt;
        chunk_range(c, N, kbeg, cnt);
        chain_chunk<NS, NI>(inbuf[c & 1], outbuf[c & 1], L, kbeg, cnt, diag_x != 0,
                            diag_u != 0, op.lux != nullptr, op.f != nullptr, r, P, p,
                            dV0, dV1, fail);
      }
    } else if (tid >= 32) {
      if (c + 1 < nch)
        stage_in(inbuf[(c + 1) & 1], L, op, c + 1, N, NS, NI, wxx, wuu, wux, wf,
                 tid - 32, STAGERS);
      if (c >= 1) write_out(outbuf[(c - 1) & 1], L, out, c - 1, N, NS, NI, tid - 32, STAGERS);
    }
    __syncthreads();
  }

  if (tid == 0) {
    dV_out[0] = dV0;
    dV_out[1] = dV1;
    *ok_out = (fail == N);
    *fail_out = fail;
  }
}

}  // namespace

extern "C" int riccati_latency_f32(
    const float* A, const float* Bm, const float* lxx, const float* luu,
    const float* lux, const float* f, const float* lx, const float* lu,
    const float* reg, float* K, float* d, float* P, float* p, float* dV, bool* ok,
    int* fail, int N, int n, int m, int diag_x, int diag_u, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  if (!(n == 4 && m == 2)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(n, m, diag_x ? n : n * n, diag_u ? m : m * m,
                               lux ? m * n : 0, f ? n : 0);
  const size_t bytes = 2 * (size_t)(L.in_size + L.out_size) * sizeof(float);
  auto kern = riccati_latency_kernel<4, 2>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const Operands op{A, Bm, lxx, luu, lux, f, lx, lu};
  const Outputs out{K, d, P, p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  riccati_latency_kernel<4, 2><<<1, THREADS, bytes, s>>>(op, reg, out, dV, ok, fail, N,
                                                         diag_x, diag_u);
  return (int)cudaGetLastError();
}
