// Batched Riccati backward pass for Hopper (sm_90a): a tile of lanes per
// block, a group of threads per lane, and two warps that copy.
//
// Replaces both entries of the one Pallas `_kernel` of
// altro_tpu/ops/pallas_riccati.py, on lane-minor operands ([N, entry...,
// B]):
//   * riccati_backward_pallas (run by `_run`, pallas_call at :387): dense
//     lxx/luu, f and lux optional, the batch-fused backward pass of the
//     vmapped solve with pallas_backward=True (the batch-major wrapper
//     transposes at its edges as `_run` did);
//   * riccati_backward_pallas_tiled (run by `_run_tiled`, pallas_call at
//     :521): diagonal or dense lxx/luu (DIAG streams n and m entries a knot
//     as `_run_tiled`'s knot_spec(n), knot_spec(m)), lux optional, f zero,
//     the backward pass of the natively batched solve.
//
// What bounds it on this card: per lane and knot it moves
// (n*n + n*m + n + n*n + m*m + m*n + n + m) * 4 bytes in and
// (m*n + m + n*n + n) * 4 out, about 2.5 KB at n=12, m=4: 78 MB at
// B=1024, N=30, or 0.023 ms at 3.35 TB/s; the diagonal form at (4, 2)
// moves 36 floats in and 30 out a knot, 16 MB at B=2048, N=30, 0.0049 ms.
// The work is about 2 n^3 + 4 n^2 m multiply-adds per knot, far below the
// f32 peak. Each lane is a chain of N dependent knots: with 1024-2048
// lanes the card holds about one warp per scheduler, so what bounds a knot
// is the latency of its dependent steps and the instructions one warp
// issues, not bytes.
//
// What the design does about it: a block holds LANES lanes (threadIdx.x,
// the fastest axis: 8 at (12, 4), 16 at (4, 2), 32 at (2, 1) and (6, 3),
// so the compute threads fill whole warps) and G = n + m compute threads
// per lane (threadIdx.y = r < G), 128 blocks of 128 compute threads at
// B=1024, (12, 4), 128 blocks of 96 at B=2048, (4, 2), and 32 blocks of
// 96 (the pendulum's (2, 1)) or 288 (the rocket's (6, 3)) at B=1024. Thread t
// owns a strided tile of M = [A B]' P' and of H = l_hess + M [A B]: rows
// t / GC + GR i, columns t % GC + GC j, so the GC threads of a warp that
// share rows read one row value (a broadcast) and GC distinct columns (GC
// distinct banks). Per knot, three phases separated by named barriers:
//   1. M's tile, then H's tile (the Qxx, Qux and Quu blocks) and the
//      gradient Qg_r = [lx; lu]_r + M_r f + [A B]'_r p'
//      (= l + [A B]'(P'f + p'));
//   2. every thread factors Quu + reg I (the m x m Cholesky, redundantly:
//      shorter than a broadcast), thread c <= n solves for column c of
//      [K | d] (c = n is d), and thread n keeps dV and the failure index;
//   3. the upper triangle of the new P and the new p, spread evenly over
//      the group (n(n+1)/2 + n items), written mirrored.
// The per-lane data sit in shared memory, element e of lane l at
// [e * LANES + l]. Two more warps (threadIdx.y >= G) move the bytes, so
// that the compute warps issue no global load or store: while knot k
// computes they copy knot k-1's A, B, f, lxx, luu, lux, lx and lu into a
// second buffer with cp.async and store knot k+1's K, d, P and p from
// shared memory, 16 bytes (4 lanes of one entry) a copy where B allows;
// each copy's source, destination and knot stride are resolved once. H and
// Qg overwrite the buffer's l_hess and l_grad in place; the diagonal form
// stages only the diagonal slots of l_hess and reads no other slot of it
// (an off-diagonal entry of H starts from 0 at compile time), so the H
// left there two knots before is never read. Lanes past B (a ragged last
// tile) compute copies of lanes that exist and store nothing; every
// barrier is reached by every thread it counts.
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
//   * the terminal rows P_N = lxx_N (diag(lxx_N) in the diagonal form),
//     p_N = lx_N.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace {

// Offsets (in floats per lane) of the per-lane data in shared memory, and
// the launch geometry.
template <int NS, int NI>
struct Layout {
  static constexpr int NT = NS + NI;  // rows of [A B]'
  static constexpr int G = NT;        // compute threads per lane
  // the fewest lanes (8: one 32-byte sector per entry) whose compute
  // threads fill whole warps: 8 at G = 16, 16 at G = 6, 32 at G = 3 and 9
  static constexpr int LANES = (8 * G % 32 == 0) ? 8 : (16 * G % 32 == 0) ? 16 : 32;
  static constexpr int COMPUTE = LANES * G;
  static constexpr int COPY = 64;  // the two copy warps
  static constexpr int THREADS = COMPUTE + COPY;
  // thread t's tile of M and H: rows t / GC + GR i, columns t % GC + GC j,
  // GC the largest of 4, 3, 2, 1 that divides n and n + m (4 at (12, 4),
  // 3 at (6, 3), 2 at (4, 2), 1 at (2, 1))
  static constexpr int GC = (NS % 4 == 0 && NT % 4 == 0)   ? 4
                            : (NS % 3 == 0 && NT % 3 == 0) ? 3
                            : (NS % 2 == 0 && NT % 2 == 0) ? 2
                                                           : 1;
  static constexpr int GR = G / GC;
  static constexpr int PS = NS + 1;  // padded row stride of P
  static constexpr int MS = NS + 1;  // padded row stride of M
  static constexpr int HS = NT + 1;  // padded row stride of l_hess / H
  static constexpr int KS = NS + 1;  // row stride of [K | d]
  // the carry (P', p'), this knot's M and gains
  static constexpr int P = 0;
  static constexpr int p = P + NS * PS;
  static constexpr int M = p + NS;
  static constexpr int KD = M + NT * MS;
  static constexpr int CARRY = KD + NI * KS;
  // one knot's operands; LH and LG become H and Qg in place
  static constexpr int AB = 0;             // [A B], row l at l * NT
  static constexpr int F = AB + NS * NT;   // f
  static constexpr int LH = F + NS;        // lxx at (i, j), lux at (n + i, j), luu at (n + i, n + j)
  static constexpr int LG = LH + NT * HS;  // [lx; lu]
  static constexpr int BUF = LG + NT;
  static constexpr int FLOATS = CARRY + 2 * BUF;
  // phase 3: the upper triangle of P (row-major), then p
  static constexpr int TRI = NS * (NS + 1) / 2;
  static constexpr int ITEMS = TRI + NS;
  static constexpr int PER_THREAD = (ITEMS + G - 1) / G;
  // one knot's entries in and out, and a copy thread's share of their
  // 16-byte copies (4 lanes of one entry each)
  static constexpr int ENTRIES = 2 * NS * NS + NS * NI + NS + NI * NS + NI * NI + NS + NI;
  static constexpr int OUT_ENTRIES = NI * NS + NI + NS * NS + NS;
  static constexpr int IN_COPIES = (ENTRIES * LANES / 4 + COPY - 1) / COPY;
  static constexpr int OUT_COPIES = (OUT_ENTRIES * LANES / 4 + COPY - 1) / COPY;
  static_assert(COMPUTE % 32 == 0, "the compute threads fill whole warps");
  static_assert(LANES % 4 == 0 && THREADS <= 1024, "16-byte copies of 4 lanes, one block");
  static_assert(GR * GC == G && NT % GR == 0 && NS % GC == 0 && NT % GC == 0, "tile grid");
};

#define AT(base, e) (base)[(e) * Ly::LANES]

struct Args {
  const float *A, *Bm, *f, *lxx, *luu, *lux, *lx, *lu, *reg;
  float *K, *d, *P, *p, *dV;
  bool* ok;
  int* fail;
  int N, Bsz;
  bool vec;  // B a multiple of 4 and every array of [..., B] 16-byte aligned
};

// Barrier `id` over `count` threads (whole warps), at any point of the code.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
constexpr int BAR_ALL = 0, BAR_COMPUTE = 1, BAR_CARRY_READ = 2;

// Entry e (of Layout::ENTRIES, in the order A, B, f, lxx, lux, luu, lx, lu)
// of a knot: its array at entry e, its entries per knot and its offset in
// a buffer. With DIAG, lxx and luu hold their diagonals (n and m entries),
// staged to the diagonal slots of l_hess.
template <int NS, int NI, bool WITH_F, bool WITH_LUX, bool DIAG>
__device__ __forceinline__ bool in_entry(const Args& a, int e, const float*& src, int& per_knot,
                                         int& off) {
  using Ly = Layout<NS, NI>;
  constexpr int NT = Ly::NT, HS = Ly::HS;
  auto take = [&](const float* s, int count, bool used) {
    if (!used) return false;
    if (e >= count) {
      e -= count;
      return false;
    }
    src = s;
    per_knot = count;
    return true;
  };
  if (take(a.A, NS * NS, true)) off = Ly::AB + (e / NS) * NT + e % NS;
  else if (take(a.Bm, NS * NI, true)) off = Ly::AB + (e / NI) * NT + NS + e % NI;
  else if (take(a.f, NS, WITH_F)) off = Ly::F + e;
  else if (take(a.lxx, DIAG ? NS : NS * NS, true))
    off = Ly::LH + (DIAG ? e * (HS + 1) : (e / NS) * HS + e % NS);
  else if (take(a.lux, NI * NS, WITH_LUX)) off = Ly::LH + (NS + e / NS) * HS + e % NS;
  else if (take(a.luu, DIAG ? NI : NI * NI, true))
    off = Ly::LH + (DIAG ? (NS + e) * (HS + 1) : (NS + e / NI) * HS + NS + e % NI);
  else if (take(a.lx, NS, true)) off = Ly::LG + e;
  else if (take(a.lu, NI, true)) off = Ly::LG + NS + e;
  else return false;
  src += e * (long)a.Bsz;
  return true;
}

// Output entry e (of Layout::OUT_ENTRIES, in the order K, d, P, p) of a
// knot: its array at entry e, its entries per knot and its offset in the
// carry.
template <int NS, int NI>
__device__ __forceinline__ bool out_entry(const Args& a, int e, float*& dst, int& per_knot,
                                          int& off) {
  using Ly = Layout<NS, NI>;
  if (e < NI * NS) {
    dst = a.K, per_knot = NI * NS, off = Ly::KD + (e / NS) * Ly::KS + e % NS;
  } else if ((e -= NI * NS) < NI) {
    dst = a.d, per_knot = NI, off = Ly::KD + e * Ly::KS + NS;
  } else if ((e -= NI) < NS * NS) {
    dst = a.P, per_knot = NS * NS, off = Ly::P + (e / NS) * Ly::PS + e % NS;
  } else if ((e -= NS * NS) < NS) {
    dst = a.p, per_knot = NS, off = Ly::p + e;
  } else {
    return false;
  }
  dst += e * (long)a.Bsz;
  return true;
}

// The copy warps: per knot, the next knot's operands in and the last
// knot's outputs out. With a.vec, 16-byte copies resolved once; otherwise
// (a B that is not a multiple of 4) one float a copy, a lane past B
// reading lane B-1 and storing nothing.
template <int NS, int NI, bool WITH_F, bool WITH_LUX, bool DIAG>
__device__ void copy_warps(float* smem, const Args& a, int t) {
  using Ly = Layout<NS, NI>;
  const int N = a.N, b0 = blockIdx.x * Ly::LANES;
  float* const buf0 = smem + Ly::CARRY * Ly::LANES;
  float* const buf1 = buf0 + Ly::BUF * Ly::LANES;

  const float* in_src[Ly::IN_COPIES];
  int in_knot[Ly::IN_COPIES], in_off[Ly::IN_COPIES];
#pragma unroll
  for (int q = 0; q < Ly::IN_COPIES; ++q) {
    const int c = t + Ly::COPY * q, l = 4 * (c % (Ly::LANES / 4));
    in_off[q] = -1;
    if (a.vec &&
        in_entry<NS, NI, WITH_F, WITH_LUX, DIAG>(a, c / (Ly::LANES / 4), in_src[q], in_knot[q], in_off[q])) {
      in_src[q] += (b0 + l < a.Bsz) ? b0 + l : b0;
      in_off[q] = in_off[q] * Ly::LANES + l;
    }
  }
  float* out_dst[Ly::OUT_COPIES];
  int out_knot[Ly::OUT_COPIES], out_off[Ly::OUT_COPIES];
#pragma unroll
  for (int q = 0; q < Ly::OUT_COPIES; ++q) {
    const int c = t + Ly::COPY * q, l = 4 * (c % (Ly::LANES / 4));
    out_off[q] = -1;
    if (a.vec && b0 + l < a.Bsz &&
        out_entry<NS, NI>(a, c / (Ly::LANES / 4), out_dst[q], out_knot[q], out_off[q])) {
      out_dst[q] += b0 + l;
      out_off[q] = out_off[q] * Ly::LANES + l;
    }
  }

  auto stage = [&](float* buf, int k) {  // knot k's operands into buf
    const long kS = (long)k * a.Bsz;
    if (a.vec) {
#pragma unroll
      for (int q = 0; q < Ly::IN_COPIES; ++q)
        if (in_off[q] >= 0) __pipeline_memcpy_async(buf + in_off[q], in_src[q] + kS * in_knot[q], 16);
    } else {
      for (int c = t; c < Ly::ENTRIES * Ly::LANES; c += Ly::COPY) {
        const float* src;
        int per_knot, off;
        const int l = c % Ly::LANES;
        if (in_entry<NS, NI, WITH_F, WITH_LUX, DIAG>(a, c / Ly::LANES, src, per_knot, off))
          __pipeline_memcpy_async(buf + off * Ly::LANES + l,
                                  src + kS * per_knot + min(b0 + l, a.Bsz - 1), sizeof(float));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  };
  auto store = [&](int k) {  // knot k's K, d, P, p from the carry
    const long kS = (long)k * a.Bsz;
    if (a.vec) {
#pragma unroll
      for (int q = 0; q < Ly::OUT_COPIES; ++q)
        if (out_off[q] >= 0)
          *reinterpret_cast<float4*>(out_dst[q] + kS * out_knot[q]) =
              *reinterpret_cast<const float4*>(smem + out_off[q]);
    } else {
      for (int c = t; c < Ly::OUT_ENTRIES * Ly::LANES; c += Ly::COPY) {
        float* dst;
        int per_knot, off;
        const int l = c % Ly::LANES;
        if (b0 + l < a.Bsz && out_entry<NS, NI>(a, c / Ly::LANES, dst, per_knot, off))
          dst[kS * per_knot + b0 + l] = smem[off * Ly::LANES + l];
      }
    }
  };

  stage(buf0, N - 1);
  for (int k = N - 1; k >= 0; --k) {
    bar_sync(BAR_ALL, Ly::THREADS);  // knot k+1 is done, knot k's operands are in place
    if (k < N - 1) store(k + 1);
    bar_arrive(BAR_CARRY_READ, Ly::THREADS);  // the compute threads may now rewrite the carry
    if (k > 0) stage(((N - 1 - k) & 1) ? buf0 : buf1, k - 1);
  }
  bar_sync(BAR_ALL, Ly::THREADS);
  store(0);
}

// One block per SM is all a launch fills (128 blocks at B=1024); saying so
// lets ptxas keep every variant free of spills.
template <int NS, int NI, bool WITH_F, bool WITH_LUX, bool DIAG>
__global__ void __launch_bounds__(Layout<NS, NI>::THREADS, 1) riccati_dense_kernel(const Args a) {
  using Ly = Layout<NS, NI>;
  constexpr int NT = Ly::NT, G = Ly::G, PS = Ly::PS, HS = Ly::HS, KS = Ly::KS;
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int r = threadIdx.y;
  if (r >= G) return copy_warps<NS, NI, WITH_F, WITH_LUX, DIAG>(smem, a, (r - G) * Ly::LANES + lane);

  const int N = a.N;
  const long S = a.Bsz;
  const int b = blockIdx.x * Ly::LANES + lane;
  const bool valid = b < a.Bsz;
  const int bl = valid ? b : a.Bsz - 1;  // a lane past B computes lane B-1's chain, stores nothing
  float* const C = smem + lane;          // this lane's carry, M and gains
  float* const buf0 = C + Ly::CARRY * Ly::LANES;
  float* const buf1 = buf0 + Ly::BUF * Ly::LANES;

  for (int e = r; e < NS * NS; e += G) {
    const int i = e / NS, j = e % NS;
    const float v = !DIAG    ? a.lxx[((long)N * NS * NS + e) * S + bl]
                    : i == j ? a.lxx[((long)N * NS + i) * S + bl]
                             : 0.0f;
    AT(C, Ly::P + i * PS + j) = v;
    if (valid) a.P[((long)N * NS * NS + e) * S + b] = v;
  }
  for (int e = r; e < NS; e += G) {
    const float v = a.lx[((long)N * NS + e) * S + bl];
    AT(C, Ly::p + e) = v;
    if (valid) a.p[((long)N * NS + e) * S + b] = v;
  }

  // this thread's phase-3 items: (i, j) of the upper triangle, or (n, i) for p_i
  int item_i[Ly::PER_THREAD], item_j[Ly::PER_THREAD];
#pragma unroll
  for (int q = 0; q < Ly::PER_THREAD; ++q) {
    int t = r + G * q, i = 0;
    while (i < NS && t >= NS - i) {
      t -= NS - i;
      ++i;
    }
    item_i[q] = i;
    item_j[q] = (i < NS) ? i + t : t;  // t >= NS past the last item
  }
  const int tr = r / Ly::GC, tc = r % Ly::GC;

  const float reg = a.reg[bl];
  float dV0 = 0.0f, dV1 = 0.0f;
  int fail = N;

  for (int k = N - 1; k >= 0; --k) {
    float* const cur = ((N - 1 - k) & 1) ? buf1 : buf0;
    bar_sync(BAR_ALL, Ly::THREADS);  // knot k's operands and the carry P', p' are in place

    // phase 1a: M = [A B]' P', this thread's tile of it
    {
      constexpr int MR = NT / Ly::GR, MC = NS / Ly::GC;
      float acc[MR][MC];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) acc[i][j] = 0.0f;
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        float x[MR], y[MC];
#pragma unroll
        for (int i = 0; i < MR; ++i) x[i] = AT(cur, Ly::AB + l * NT + tr + Ly::GR * i);
#pragma unroll
        for (int j = 0; j < MC; ++j) y[j] = AT(C, Ly::P + l * PS + tc + Ly::GC * j);
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int j = 0; j < MC; ++j) acc[i][j] += x[i] * y[j];
      }
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j)
          AT(C, Ly::M + (tr + Ly::GR * i) * Ly::MS + tc + Ly::GC * j) = acc[i][j];
    }
    bar_sync(BAR_COMPUTE, Ly::COMPUTE);

    // phase 1b: the gradient Qg_r, and this thread's tile of
    // H = l_hess + M [A B] (the Qxx, Qux and Quu blocks; H's upper right
    // block, A'P'B, is not needed)
    {
      float g = AT(cur, Ly::LG + r);
      if (WITH_F) {
#pragma unroll
        for (int j = 0; j < NS; ++j) g += AT(C, Ly::M + r * Ly::MS + j) * AT(cur, Ly::F + j);
      }
#pragma unroll
      for (int l = 0; l < NS; ++l) g += AT(cur, Ly::AB + l * NT + r) * AT(C, Ly::p + l);

      constexpr int HR = NT / Ly::GR, HC = NT / Ly::GC;
      float acc[HR][HC];
#pragma unroll
      for (int i = 0; i < HR; ++i)
#pragma unroll
        for (int j = 0; j < HC; ++j) {
          const int row = tr + Ly::GR * i, col = tc + Ly::GC * j;
          // staged: lux in the cross block, the diagonal alone in the diagonal form
          const bool staged = (row >= NS && col < NS) ? WITH_LUX : (!DIAG || row == col);
          acc[i][j] = staged ? AT(cur, Ly::LH + row * HS + col) : 0.0f;
        }
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        float x[HR], y[HC];
#pragma unroll
        for (int i = 0; i < HR; ++i) x[i] = AT(C, Ly::M + (tr + Ly::GR * i) * Ly::MS + l);
#pragma unroll
        for (int j = 0; j < HC; ++j) y[j] = AT(cur, Ly::AB + l * NT + tc + Ly::GC * j);
#pragma unroll
        for (int i = 0; i < HR; ++i)
#pragma unroll
          for (int j = 0; j < HC; ++j) acc[i][j] += x[i] * y[j];
      }
      AT(cur, Ly::LG + r) = g;
#pragma unroll
      for (int i = 0; i < HR; ++i)
#pragma unroll
        for (int j = 0; j < HC; ++j) {
          const int row = tr + Ly::GR * i, col = tc + Ly::GC * j;
          if (row >= NS || col < NS) AT(cur, Ly::LH + row * HS + col) = acc[i][j];
        }
    }
    bar_sync(BAR_CARRY_READ, Ly::THREADS);  // H is in place; the copy warps read knot k+1's outputs

    // phase 2: Cholesky of Quu + reg I in every thread, column r <= n of [K | d]
    {
      float L[NI][NI], inv[NI];
      bool ok_knot = true;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        float piv = AT(cur, Ly::LH + (NS + j) * HS + NS + j) + reg;
#pragma unroll
        for (int kk = 0; kk < j; ++kk) piv -= L[j][kk] * L[j][kk];
        ok_knot = ok_knot && (piv > 0.0f);
        const float guarded = fmaxf(piv, 1e-30f);
        inv[j] = rsqrtf(guarded);  // one MUFU op on the chain for sqrt and reciprocal
        L[j][j] = guarded * inv[j];
#pragma unroll
        for (int i = j + 1; i < NI; ++i) {
          float s = AT(cur, Ly::LH + (NS + i) * HS + NS + j);
#pragma unroll
          for (int kk = 0; kk < j; ++kk) s -= L[i][kk] * L[j][kk];
          L[i][j] = s * inv[j];
        }
      }
      if (!ok_knot) fail = k;  // knots decrease, so the last write is the smallest

      if (r <= NS) {  // (L L') y = [Qux | -Qu] column r
        float y[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float s = (r < NS) ? AT(cur, Ly::LH + (NS + i) * HS + r) : -AT(cur, Ly::LG + NS + i);
#pragma unroll
          for (int kk = 0; kk < i; ++kk) s -= L[i][kk] * y[kk];
          y[i] = s * inv[i];
        }
#pragma unroll
        for (int i = NI - 1; i >= 0; --i) {
          float s = y[i];
#pragma unroll
          for (int kk = i + 1; kk < NI; ++kk) s -= L[kk][i] * y[kk];
          y[i] = s * inv[i];
        }
        float dQu = 0.0f, dd = 0.0f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float v = ok_knot ? y[i] : 0.0f;  // select, not multiply
          AT(C, Ly::KD + i * KS + r) = v;
          dQu += v * AT(cur, Ly::LG + NS + i);
          dd += v * v;
        }
        if (r == NS) {
          dV0 += dQu;
          dV1 -= 0.5f * (dQu + reg * dd);
        }
      }
    }
    bar_sync(BAR_COMPUTE, Ly::COMPUTE);

    // phase 3: P = Qxx - Qux'K - reg K'K (upper triangle, mirrored), p.
    // Item (i, j) reads X = Qux[:, j], Y = K[:, i] and Z = K[:, j]; item p_j
    // reads X = Qux[:, j], Y = d and Z = K[:, j]. Every item's loads come
    // before any store, so they overlap.
    {
      float v[Ly::PER_THREAD];
#pragma unroll
      for (int q = 0; q < Ly::PER_THREAD; ++q) {
        const int i = item_i[q], j = item_j[q] < NS ? item_j[q] : 0;
        const bool tri = i < NS;
        const int yc = tri ? i : NS;
        float sxy = 0.0f, szy = 0.0f;
#pragma unroll
        for (int l = 0; l < NI; ++l) {
          const float y = AT(C, Ly::KD + l * KS + yc);
          sxy += y * AT(cur, Ly::LH + (NS + l) * HS + j);
          szy += y * AT(C, Ly::KD + l * KS + j);
        }
        const float q0 = AT(cur, tri ? Ly::LH + i * HS + j : Ly::LG + j);
        v[q] = tri ? q0 - sxy - reg * szy : q0 + sxy + reg * szy;
      }
#pragma unroll
      for (int q = 0; q < Ly::PER_THREAD; ++q) {
        const int i = item_i[q], j = item_j[q];
        if (i < NS) {
          AT(C, Ly::P + i * PS + j) = v[q];
          AT(C, Ly::P + j * PS + i) = v[q];
        } else if (j < NS) {
          AT(C, Ly::p + j) = v[q];
        }
      }
    }
  }
  bar_sync(BAR_ALL, Ly::THREADS);  // knot 0 is done; the copy warps store it

  if (valid && r == NS) {
    a.dV[b] = dV0;
    a.dV[S + b] = dV1;
    a.ok[b] = (fail == N);
    a.fail[b] = fail;
  }
}

#undef AT

template <int NS, int NI, bool WITH_F, bool WITH_LUX, bool DIAG>
int launch_one(const Args& a, cudaStream_t s) {
  using Ly = Layout<NS, NI>;
  auto kern = riccati_dense_kernel<NS, NI, WITH_F, WITH_LUX, DIAG>;
  const size_t bytes = (size_t)Ly::FLOATS * Ly::LANES * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(Ly::LANES, Ly::G + Ly::COPY / Ly::LANES);
  const dim3 grid((a.Bsz + Ly::LANES - 1) / Ly::LANES);
  kern<<<grid, block, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// The diagonal form is instantiated without f (the batched solve's
// affine term is zero, as `_run_tiled` has it).
template <int NS, int NI>
int launch(const Args& a, bool diag, cudaStream_t s) {
  if (diag) {
    if (a.f) return (int)cudaErrorInvalidValue;
    if (a.lux) return launch_one<NS, NI, false, true, true>(a, s);
    return launch_one<NS, NI, false, false, true>(a, s);
  }
  if (a.f && a.lux) return launch_one<NS, NI, true, true, false>(a, s);
  if (a.f) return launch_one<NS, NI, true, false, false>(a, s);
  if (a.lux) return launch_one<NS, NI, false, true, false>(a, s);
  return launch_one<NS, NI, false, false, false>(a, s);
}

}  // namespace

// f and lux may be null (a zero affine term, a zero cross Hessian). diag:
// lxx [N+1, n, B] and luu [N, m, B] hold diagonals (f must be null), else
// lxx [N+1, n, n, B] and luu [N, m, m, B].
extern "C" int riccati_dense_f32(
    const float* A, const float* Bm, const float* f, const float* lxx, const float* luu,
    const float* lux, const float* lx, const float* lu, const float* reg,
    float* K, float* d, float* P, float* p, float* dV, bool* ok, int* fail,
    int N, int n, int m, int Bsz, int diag, void* stream) {
  if (N <= 0 || Bsz <= 0) return (int)cudaErrorInvalidValue;
  bool vec = Bsz % 4 == 0;
  for (const float* t : {A, Bm, f, lxx, luu, lux, lx, lu, (const float*)K, (const float*)d,
                         (const float*)P, (const float*)p})
    vec = vec && (size_t)t % 16 == 0;
  const Args a{A, Bm, f, lxx, luu, lux, lx, lu, reg, K, d, P, p, dV, ok, fail, N, Bsz, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 4 && m == 2) return launch<4, 2>(a, diag != 0, s);
  if (n == 12 && m == 4) return launch<12, 4>(a, diag != 0, s);
  if (n == 2 && m == 1) return launch<2, 1>(a, diag != 0, s);
  if (n == 6 && m == 3) return launch<6, 3>(a, diag != 0, s);
  return (int)cudaErrorInvalidValue;
}
