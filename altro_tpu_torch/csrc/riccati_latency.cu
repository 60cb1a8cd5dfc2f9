// Single-lane Riccati backward pass (latency kernel) for Hopper (sm_90a):
// one warp (two at (6, 3), five at (12, 4)) computes each knot together,
// three warps copy.
//
// Replaces: altro_tpu/ops/pallas_packed.py::riccati_backward_pallas_packed
// (its Pallas `_kernel` / `_knot_body`): the whole N-knot backward chain of
// ONE solve in one program, with the Cholesky failure contract and the
// affine term elided when f is absent. The TPU kernel packed each knot's
// operands into one (8, 128) tile and walked the knots as a sequential grid.
//
// What bounds it on this card: nothing but the chain. At N=500, n=4, m=2
// with diagonal costs the kernel reads 36 floats and writes 30 per knot
// (about 130 KB in all: 0.04 us at 3.35 TB/s) and does about 400 flops per
// knot (0.2 MFLOP: nothing at 67 TFLOP/s). Each knot's (P, p) depends on
// the next one's, so the time is N times the latency of one knot's
// dependent arithmetic: P' -> [A B]'P'[A B] -> the pivots of Quu + reg I ->
// [K | d] -> P, p. One thread doing all of it issues every multiply-add
// of the knot alone, 20 IEEE divides among them. At (12, 4), N=30 with
// diagonal costs (the quadrotor's single-lane solve) a knot reads 224
// floats and writes 208 (about 52 KB in all: 0.016 us at 3.35 TB/s); the chain
// again bounds it, each knot's Q-block entry a 12-term sum of 12-term sums.
//
// What the design does about it: one block, launched once. The compute
// warps (one at (4, 2) and (2, 1): 128 threads in all) compute each knot
// in two phases, with the carry (P', p'), the Q blocks and the gradient
// exchanged through shared memory and a __syncwarp() between the phases
// (counts at (n, m) = (4, 2); at (2, 1): 6 Q entries and 3 gradient rows,
// then 3 entries of P and 2 of p):
//   A. lane t owns one of the 21 distinct entries of the Q blocks
//      (Qxx upper triangle, Qux, Quu lower triangle) or one of the 6 rows
//      of the gradient: it forms its column of P'[A B] (or P'f + p') in
//      registers from the broadcast carry and takes the dot product with
//      its column of [A B], so no entry of M = P'[A B] is exchanged;
//   B. every lane factors Quu + reg I (m x m, redundantly: shorter than a
//      broadcast) with one rsqrtf per pivot, solves the two columns of
//      [Qux | -Qu] its item needs with multiply-adds only, and writes one
//      of the 10 distinct entries of the new P (mirrored) or one of the 4
//      of p, and of K, d and dV.
// At (12, 4) a knot has 152 phase-A items (78 + 48 + 10 entries and 16
// gradient rows) and 90 phase-B items (78 + 12), so five compute warps
// hold a thread per item (256 threads in all) and meet between the phases
// at a named barrier (BAR_COMPUTE) instead of __syncwarp(); each thread
// runs the same code on its one item. At (6, 3) (the rocket's) 54 phase-A
// items (21 + 18 + 6 + 9) take two compute warps on the same barrier (160
// threads in all, whole warps, as bar.sync counts them); at (4, 1) (the
// cartpole's) 20 items take one warp, on the m = 1 code of (2, 1). Each
// lane's operands of the next knot (its two columns of [A B] or f, and its
// cost term) are read from the staged chunk into registers while phase B
// runs. (n, m), diag_x, diag_u, lux and f are template parameters (16
// instantiations per shape, chosen once on the host; shapes (4, 2),
// (2, 1), (12, 4), (6, 3), (4, 1) and (3, 2), the first odd n) and every
// layout offset is a compile-time constant. Every per-chunk array of shared memory holds CH
// knots, 64, or 32 at n > 4: at (12, 4) one 64-knot buffer of dense
// operands takes 109.6 KB, and at (6, 3) the 32-knot buffers, dense with
// lux and f, take 50.5 KB in all (over 48 KB: `launch` opts in); CH is a
// multiple of 4, so each array starts on a 16-byte boundary at any (n, m).
// The copy warps stage the operands in chunks of CH knots, double-buffered,
// with 16-byte cp.async where a slice is 16-byte aligned (one float a copy
// where not), and write the outputs of the chunk before back from their
// staging. Chunks are
// handed over by named barriers: the copy warps arrive at FULL(b) when
// buffer b holds a chunk and the compute warps sync on it; they arrive at
// DONE(b) when they have finished with buffer b and the copy warps sync
// on it. So the compute warps wait only when a chunk is not staged yet.
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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int COPIERS = 96;  // warps of copies after the compute warps

// Float offsets in shared memory: two buffers of one chunk's operands and
// two of its outputs (each array [CH][width], 16-byte aligned), then warp
// 0's exchange area.
template <int NS, int NI, bool DX, bool DU, bool LUX, bool F>
struct Layout {
  // knots per staged chunk: 64, or 32 at n > 4, where two 64-knot
  // buffers of dense operands would not fit in shared memory
  static constexpr int CH = NS > 4 ? 32 : 64;
  static constexpr int NT = NS + NI;
  static constexpr int WXX = DX ? NS : NS * NS;
  static constexpr int WUU = DU ? NI : NI * NI;
  static constexpr int WUX = LUX ? NI * NS : 0;
  static constexpr int WF = F ? NS : 0;
  // one chunk's operands
  static constexpr int A = 0;
  static constexpr int B = A + CH * NS * NS;
  static constexpr int LXX = B + CH * NS * NI;
  static constexpr int LUU = LXX + CH * WXX;
  static constexpr int LUXO = LUU + CH * WUU;
  static constexpr int FO = LUXO + CH * WUX;
  static constexpr int LX = FO + CH * WF;
  static constexpr int LU = LX + CH * NS;
  static constexpr int IN = LU + CH * NI;
  // one chunk's outputs
  static constexpr int K = 0;
  static constexpr int D = K + CH * NI * NS;
  static constexpr int P = D + CH * NI;
  static constexpr int PV = P + CH * NS * NS;
  static constexpr int OUT = PV + CH * NS;
  // warp 0's exchange: the carry P' (row-major) and p', the Q blocks
  // H[a][b] (a, b < NT: Qxx at a, b < NS, Qux at (NS + q, c), Quu at
  // (NS + q1, NS + q2)) and the gradient G = [Qx; Qu]
  static constexpr int XCP = 2 * (IN + OUT);
  static constexpr int XCV = XCP + NS * NS;
  static constexpr int XH = XCV + NS;
  static constexpr int XG = XH + NT * NT;
  static constexpr int SINK = XG + NT;  // where lanes without a phase-B item store
  static constexpr int FLOATS = SINK + 4;
  // phase A: Qxx upper triangle, Qux, Quu lower triangle, gradient rows
  static constexpr int TRI_X = NS * (NS + 1) / 2;
  static constexpr int TRI_U = NI * (NI + 1) / 2;
  static constexpr int ITEMS_A = TRI_X + NI * NS + TRI_U + NT;
  // phase B: P upper triangle, p
  static constexpr int ITEMS_B = TRI_X + NS;
  // compute warps: a thread per item of the larger phase
  static constexpr int CW = ((ITEMS_A > ITEMS_B ? ITEMS_A : ITEMS_B) + 31) / 32;
  static constexpr int CT = 32 * CW;
  static constexpr int THREADS = CT + COPIERS;
  static_assert(NS * NS + NS <= CT, "the compute threads hold the carry's entries");
  static_assert(IN % 4 == 0 && OUT % 4 == 0 && (CH * NI) % 4 == 0, "16-byte aligned arrays");
};

struct Args {
  const float *A, *Bm, *lxx, *luu, *lux, *f, *lx, *lu;
  const float* reg;
  float *K, *d, *P, *p, *dV;
  bool* ok;
  int* fail;
  int N;
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ int bar_full(int b) { return 1 + b; }  // chunk staged in buffer b
__device__ __forceinline__ int bar_done(int b) { return 3 + b; }  // compute done with buffer b
constexpr int BAR_COMPUTE = 5;  // the compute warps, between the phases of a knot

// The compute threads meet: a warp barrier for one warp, else a named one.
template <int CW>
__device__ __forceinline__ void compute_sync() {
  if (CW == 1) __syncwarp();
  else bar_sync(BAR_COMPUTE, 32 * CW);
}

// 1/sqrt(x) for a normal x > 0: the MUFU result rsqrtf gives there, without
// rsqrtf's rescaling of subnormal inputs.
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// count floats shared -> global, 16 bytes a store where aligned.
__device__ __forceinline__ void copy_out(float* dst, const float* src, int count, int t) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const int n4 = count / 4;
    for (int i = t; i < n4; i += COPIERS)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    done = 4 * n4;
  }
  for (int i = done + t; i < count; i += COPIERS) dst[i] = src[i];
}

// Chunk c of CH knots covers knots [kbeg, kbeg + cnt), walked from the last down.
template <int CH>
__device__ __forceinline__ void chunk_range(int c, int N, int& kbeg, int& cnt) {
  const int kend = N - c * CH;
  kbeg = kend - CH > 0 ? kend - CH : 0;
  cnt = kend - kbeg;
}

template <int NS, int NI, bool DX, bool DU, bool LUX, bool F>
__device__ void copy_warps(float* smem, const Args& a, int t) {
  using Ly = Layout<NS, NI, DX, DU, LUX, F>;
  const int N = a.N, nch = (N + Ly::CH - 1) / Ly::CH;
  auto stage = [&](int c) {
    float* buf = smem + (c & 1) * Ly::IN;
    int kbeg, cnt;
    chunk_range<Ly::CH>(c, N, kbeg, cnt);
    const long k0 = kbeg;
    copy_in(buf + Ly::A, a.A + k0 * NS * NS, cnt * NS * NS, t);
    copy_in(buf + Ly::B, a.Bm + k0 * NS * NI, cnt * NS * NI, t);
    copy_in(buf + Ly::LXX, a.lxx + k0 * Ly::WXX, cnt * Ly::WXX, t);
    copy_in(buf + Ly::LUU, a.luu + k0 * Ly::WUU, cnt * Ly::WUU, t);
    if (LUX) copy_in(buf + Ly::LUXO, a.lux + k0 * Ly::WUX, cnt * Ly::WUX, t);
    if (F) copy_in(buf + Ly::FO, a.f + k0 * Ly::WF, cnt * Ly::WF, t);
    copy_in(buf + Ly::LX, a.lx + k0 * NS, cnt * NS, t);
    copy_in(buf + Ly::LU, a.lu + k0 * NI, cnt * NI, t);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  };
  auto write = [&](int c) {
    const float* buf = smem + 2 * Ly::IN + (c & 1) * Ly::OUT;
    int kbeg, cnt;
    chunk_range<Ly::CH>(c, N, kbeg, cnt);
    const long k0 = kbeg;
    copy_out(a.K + k0 * NI * NS, buf + Ly::K, cnt * NI * NS, t);
    copy_out(a.d + k0 * NI, buf + Ly::D, cnt * NI, t);
    copy_out(a.P + k0 * NS * NS, buf + Ly::P, cnt * NS * NS, t);
    copy_out(a.p + k0 * NS, buf + Ly::PV, cnt * NS, t);
  };
  for (int c = 0; c < nch; ++c) {
    if (c >= 2) {
      bar_sync(bar_done(c & 1), Ly::THREADS);  // the compute warps are done with chunk c - 2
      write(c - 2);
    }
    stage(c);
    bar_arrive(bar_full(c & 1), Ly::THREADS);
  }
  for (int c = nch >= 2 ? nch - 2 : 0; c < nch; ++c) {
    bar_sync(bar_done(c & 1), Ly::THREADS);
    write(c);
  }
}

// Where a lane's phase-A operands sit in a staged chunk: column `a` of
// [A B], the vector v (column b of [A B], or f), and the cost term (knot
// j's entry at off + j * knot stride; -1: none).
struct LaneOps {
  int a_off, a_ks, a_rs;
  int v_off, v_ks, v_rs;
  int l_off, l_ks;
};

template <int NS, int NI>
__device__ __forceinline__ void ab_column(int col, int A, int B, int& off, int& ks, int& rs) {
  if (col < NS) off = A + col, ks = NS * NS, rs = NS;
  else off = B + col - NS, ks = NS * NI, rs = NI;
}

template <int NS>
__device__ __forceinline__ void load_lane(const float* in, const LaneOps& o, int j,
                                          float (&ac)[NS], float (&v)[NS], float& l) {
#pragma unroll
  for (int i = 0; i < NS; ++i) ac[i] = in[o.a_off + j * o.a_ks + i * o.a_rs];
#pragma unroll
  for (int i = 0; i < NS; ++i) v[i] = o.v_off >= 0 ? in[o.v_off + j * o.v_ks + i * o.v_rs] : 0.0f;
  l = o.l_off >= 0 ? in[o.l_off + j * o.l_ks] : 0.0f;
}

// One block per launch; saying so lets ptxas use what registers it likes.
template <int NS, int NI, bool DX, bool DU, bool LUX, bool F>
__global__ void __launch_bounds__((Layout<NS, NI, DX, DU, LUX, F>::THREADS), 1)
    riccati_latency_kernel(const Args a) {
  using Ly = Layout<NS, NI, DX, DU, LUX, F>;
  constexpr int NT = Ly::NT;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  if (tid >= Ly::CT) return copy_warps<NS, NI, DX, DU, LUX, F>(smem, a, tid - Ly::CT);

  const int N = a.N, nch = (N + Ly::CH - 1) / Ly::CH;
  const int lane = tid;
  float* const Pc = smem + Ly::XCP;
  float* const pc = smem + Ly::XCV;
  float* const H = smem + Ly::XH;
  float* const G = smem + Ly::XG;
  const float r = *a.reg;

  // the carry at knot N: P_N = lxx_N (a diagonal expanded), p_N = lx_N
  if (lane < NS * NS) {
    const int i = lane / NS, l = lane % NS;
    const float v = DX ? (i == l ? a.lxx[(long)N * NS + i] : 0.0f)
                       : a.lxx[(long)N * NS * NS + lane];
    Pc[lane] = v;
    a.P[(long)N * NS * NS + lane] = v;
  } else if (lane < NS * NS + NS) {
    const int i = lane - NS * NS;
    pc[i] = a.lx[(long)N * NS + i];
    a.p[(long)N * NS + i] = pc[i];
  }

  // phase A item of this lane: H entry (ha, hb), or gradient row ha (grad)
  LaneOps o;
  int ha = 0, hb = 0;
  bool grad = false;
  const bool act_a = lane < Ly::ITEMS_A;
  {
    int t = act_a ? lane : 0;
    o.l_off = -1, o.l_ks = 0;
    if (t < Ly::TRI_X) {  // Qxx (ha <= hb)
      while (t >= NS - ha) t -= NS - ha++;
      hb = ha + t;
      if (!DX) o.l_off = Ly::LXX + ha * NS + hb, o.l_ks = NS * NS;
      else if (ha == hb) o.l_off = Ly::LXX + ha, o.l_ks = NS;
    } else if ((t -= Ly::TRI_X) < NI * NS) {  // Qux (q, c)
      ha = NS + t / NS, hb = t % NS;
      if (LUX) o.l_off = Ly::LUXO + t, o.l_ks = NI * NS;
    } else if ((t -= NI * NS) < Ly::TRI_U) {  // Quu (q1 >= q2)
      int q1 = 0;
      while (t > q1) t -= ++q1;
      ha = NS + q1, hb = NS + t;
      if (!DU) o.l_off = Ly::LUU + q1 * NI + t, o.l_ks = NI * NI;
      else if (q1 == t) o.l_off = Ly::LUU + q1, o.l_ks = NI;
    } else {  // gradient row
      t -= Ly::TRI_U;
      grad = true;
      ha = t;
      o.l_off = t < NS ? Ly::LX + t : Ly::LU + t - NS;
      o.l_ks = t < NS ? NS : NI;
    }
    ab_column<NS, NI>(ha, Ly::A, Ly::B, o.a_off, o.a_ks, o.a_rs);
    if (!grad) ab_column<NS, NI>(hb, Ly::A, Ly::B, o.v_off, o.v_ks, o.v_rs);
    else if (F) o.v_off = Ly::FO, o.v_ks = NS, o.v_rs = 1;
    else o.v_off = -1, o.v_ks = 0, o.v_rs = 0;
  }
  const int h_store = grad ? NT * NT + ha : ha * NT + hb;  // offset from H (G follows H)

  // phase B item of this lane: P entry (bi, bl) (bi <= bl) or p entry bi
  // (pitem); it solves columns X = bi and Y = bl (NS: the d column)
  const bool act_b = lane < Ly::ITEMS_B;
  int bi = 0, bl = 0;
  bool pitem = false;
  {
    int t = act_b ? lane : 0;
    if (t < Ly::TRI_X) {
      while (t >= NS - bi) t -= NS - bi++;
      bl = bi + t;
    } else {
      pitem = true;
      bi = t - Ly::TRI_X;
      bl = NS;
    }
  }
  const int q0_off = pitem ? NT * NT + bi : bi * NT + bl;  // Qx_i or Qxx_il, from H
  // where the item's value goes: the carry (c0, c1) and the staged outputs
  // (o0, o1, knot stride os); the diagonal P items also store their column
  // of K and the item of p_0 the d column (g, knot stride gs, row stride
  // gq). Stores without a target go to the sink, so no store branches.
  int c0 = Ly::SINK, c1 = Ly::SINK, o0 = 0, o1 = 0, os = 0, g = 0, gs = 0, gq = 0;
  if (act_b && pitem) {
    c0 = c1 = Ly::XCV + bi;
    o0 = o1 = Ly::PV + bi, os = NS;
  } else if (act_b) {
    c0 = Ly::XCP + bi * NS + bl, c1 = Ly::XCP + bl * NS + bi;
    o0 = Ly::P + bi * NS + bl, o1 = Ly::P + bl * NS + bi, os = NS * NS;
  }
  const bool gain = act_b && (pitem ? bi == 0 : bi == bl);
  if (gain && pitem) g = Ly::D, gs = NI, gq = 1;
  else if (gain) g = Ly::K + bi, gs = NI * NS, gq = NS;

  float dV0 = 0.0f, dV1 = 0.0f;
  int fail = N;
  compute_sync<Ly::CW>();

  for (int c = 0; c < nch; ++c) {
    const int b = c & 1;
    int kbeg, cnt;
    chunk_range<Ly::CH>(c, N, kbeg, cnt);
    const float* in = smem + b * Ly::IN;
    float* const out = smem + 2 * Ly::IN + b * Ly::OUT;
    float* const sink = smem + Ly::SINK;
    float* const st0 = act_b ? out + o0 : sink;
    float* const st1 = act_b ? out + o1 : sink;
    float* const stg = gain ? out + g : sink;
    bar_sync(bar_full(b), Ly::THREADS);

    float ac[NS], v[NS], lt;
    load_lane<NS>(in, o, cnt - 1, ac, v, lt);
    for (int j = cnt - 1; j >= 0; --j) {
      // phase A: this lane's entry of the Q blocks or of the gradient
      {
        float Pr[NS][NS], pr[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
#pragma unroll
          for (int l = 0; l < NS; ++l) Pr[i][l] = Pc[i * NS + l];
          pr[i] = pc[i];
        }
        float h = lt;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float s = 0.0f;
#pragma unroll
          for (int l = 0; l < NS; ++l) s += Pr[i][l] * v[l];
          h += ac[i] * (grad ? (F ? s + pr[i] : pr[i]) : s);
        }
        if (act_a) H[h_store] = h;
      }
      compute_sync<Ly::CW>();
      // the next knot's operands, read while phase B runs
      load_lane<NS>(in, o, j > 0 ? j - 1 : 0, ac, v, lt);

      // phase B: Cholesky of Quu + reg I in every lane, columns X and Y of
      // [K | d], and this lane's entry of P or p
      {
        float Lc[NI][NI], inv[NI];
        bool ok_knot = true;
#pragma unroll
        for (int jj = 0; jj < NI; ++jj) {
          float piv = H[(NS + jj) * NT + NS + jj] + r;
#pragma unroll
          for (int kk = 0; kk < jj; ++kk) piv -= Lc[jj][kk] * Lc[jj][kk];
          ok_knot = ok_knot && (piv > 0.0f);
          inv[jj] = rsqrt_normal(fmaxf(piv, 1e-30f));  // 1 / L_jj of the guarded pivot
#pragma unroll
          for (int i = jj + 1; i < NI; ++i) {
            float s = H[(NS + i) * NT + NS + jj];
#pragma unroll
            for (int kk = 0; kk < jj; ++kk) s -= Lc[i][kk] * Lc[jj][kk];
            Lc[i][jj] = s * inv[jj];
          }
        }
        if (!ok_knot) fail = kbeg + j;  // knots decrease, so the last write is the smallest

        // right-hand sides: column X = bi of Qux, column Y = bl of Qux or -Qu
        float rx[NI], ry[NI], sx[NI], sy[NI];
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          rx[q] = H[(NS + q) * NT + bi];
          ry[q] = pitem ? -G[NS + q] : H[(NS + q) * NT + bl];
        }
        auto solve = [&](const float (&rhs)[NI], float (&x)[NI]) {
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            float s = rhs[i];
#pragma unroll
            for (int kk = 0; kk < i; ++kk) s -= Lc[i][kk] * x[kk];
            x[i] = s * inv[i];
          }
#pragma unroll
          for (int i = NI - 1; i >= 0; --i) {
            float s = x[i];
#pragma unroll
            for (int kk = i + 1; kk < NI; ++kk) s -= Lc[kk][i] * x[kk];
            x[i] = s * inv[i];
          }
#pragma unroll
          for (int i = 0; i < NI; ++i) x[i] = ok_knot ? x[i] : 0.0f;  // select, not multiply
        };
        solve(rx, sx);
        solve(ry, sy);

        // P_il = Qxx_il - K_i.Qux_l - reg K_i.K_l;  p_i = Qx_i + Qux_i.d + reg K_i.d
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          s1 += pitem ? rx[q] * sy[q] : sx[q] * ry[q];
          s2 += sx[q] * sy[q];
        }
        const float q0 = H[q0_off];
        const float val = pitem ? q0 + s1 + r * s2 : q0 - s1 - r * s2;

        smem[c0] = val;
        smem[c1] = val;
        st0[j * os] = val;
        st1[j * os] = val;
#pragma unroll
        for (int q = 0; q < NI; ++q) stg[j * gs + q * gq] = pitem ? sy[q] : sx[q];
        // dV from the d column (kept by the item of p_0)
        float dQu = 0.0f, dd = 0.0f;
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          dQu += sy[q] * -ry[q];
          dd += sy[q] * sy[q];
        }
        dV0 += dQu;
        dV1 -= 0.5f * (dQu + r * dd);
      }
      compute_sync<Ly::CW>();
    }
    bar_arrive(bar_done(b), Ly::THREADS);
  }

  if (lane == Ly::TRI_X) {  // the item of p_0 carries dV
    a.dV[0] = dV0;
    a.dV[1] = dV1;
    *a.ok = (fail == N);
    *a.fail = fail;
  }
}

template <int NS, int NI, bool DX, bool DU, bool LUX, bool F>
int launch(const Args& a, cudaStream_t s) {
  using Ly = Layout<NS, NI, DX, DU, LUX, F>;
  auto kern = riccati_latency_kernel<NS, NI, DX, DU, LUX, F>;
  const size_t bytes = (size_t)Ly::FLOATS * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<1, Ly::THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int NS, int NI, bool DX, bool DU, bool LUX>
int launch_f(const Args& a, cudaStream_t s) {
  return a.f ? launch<NS, NI, DX, DU, LUX, true>(a, s) : launch<NS, NI, DX, DU, LUX, false>(a, s);
}
template <int NS, int NI, bool DX, bool DU>
int launch_lux(const Args& a, cudaStream_t s) {
  return a.lux ? launch_f<NS, NI, DX, DU, true>(a, s) : launch_f<NS, NI, DX, DU, false>(a, s);
}
template <int NS, int NI>
int launch_shape(const Args& a, cudaStream_t s, bool dx, bool du) {
  if (dx) return du ? launch_lux<NS, NI, true, true>(a, s) : launch_lux<NS, NI, true, false>(a, s);
  return du ? launch_lux<NS, NI, false, true>(a, s) : launch_lux<NS, NI, false, false>(a, s);
}

}  // namespace

// (n, m) is (4, 2), (2, 1), (12, 4), (6, 3), (4, 1) or (3, 2); lux and f may be null (a zero
// cross term, the affine term elided); reg is one float on the device.
extern "C" int riccati_latency_f32(
    const float* A, const float* Bm, const float* lxx, const float* luu,
    const float* lux, const float* f, const float* lx, const float* lu,
    const float* reg, float* K, float* d, float* P, float* p, float* dV,
    bool* ok, int* fail, int N, int n, int m, int diag_x, int diag_u, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const Args a{A, Bm, lxx, luu, lux, f, lx, lu, reg, K, d, P, p, dV, ok, fail, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 4 && m == 2) return launch_shape<4, 2>(a, s, diag_x != 0, diag_u != 0);
  if (n == 2 && m == 1) return launch_shape<2, 1>(a, s, diag_x != 0, diag_u != 0);
  if (n == 12 && m == 4) return launch_shape<12, 4>(a, s, diag_x != 0, diag_u != 0);
  if (n == 6 && m == 3) return launch_shape<6, 3>(a, s, diag_x != 0, diag_u != 0);
  if (n == 4 && m == 1) return launch_shape<4, 1>(a, s, diag_x != 0, diag_u != 0);
  if (n == 3 && m == 2) return launch_shape<3, 2>(a, s, diag_x != 0, diag_u != 0);
  return (int)cudaErrorInvalidValue;
}
