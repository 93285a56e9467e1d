// 16-bit tensor-core passes of the attention backward for Hopper (sm_90a)
// at D in {64, 128}: the dq pass (dq_tc_kernel) and the dk/dv pass
// (dkdv_tc_kernel), built from flash_tc.cuh, for element type E: bf16, or
// fp16 for the fused backward, where every bf16 rounding below is an fp16
// one (an fp16 ds past its range rounds to inf, as .astype(fp16) does).
// The flash backward (flash_dq.cu, flash_dkdv.cu) walks the block lattice
// with them; the fused backward (fused_attention_bwd.cu) walks every block
// of its short sequence with them, skipping only the causally dead ones. Both passes
// own their output rows (no atomics): deterministic.
//
// dq pass. A block owns R = 64·NWG query rows of one (b, h), as NWG
// warpgroups of 64 rows; grid (B·H, S/R), the causally heaviest tiles first.
// Its Q and dO stay in shared memory (bf16, 128-byte swizzled) for the
// whole walk; lse and δ of its two rows stay in each thread's registers.
// The K and V tiles of kv head h/(H/Hkv) come through a cp.async ring of up
// to three kv blocks, the next ones in flight while one computes. Per
// sub-tile of KT keys and warpgroup: S = Q Kᵀ and dP = dO Vᵀ by wgmma into
// f32 registers (both operands K-major); p = exp(S·scale − lse) under the
// causal / window / segment mask and ds = p (dP − δ) per element, rounded
// to bf16 in place as the A fragment of dQ += dS K, a register-A wgmma with
// K read MN-major (as V in P V) — the TPU kernel's rounding point. There is
// no running max, so a kv block of 256 keys is simply taken in sub-tiles.
// dq stays in f32 registers, is scaled once and rounded once. A warpgroup
// whose rows the mask shuts out of a whole sub-tile skips it.
//
// Registers: S and dP (64 x KT each) beside dq (64 x D) in f32. KT = 128 at
// D = 64; KT = 64 at D = 128, where 128-key sub-tiles would pass the 255
// registers a thread may hold.
//
// dk/dv pass: see dkdv_tc_kernel below.
#pragma once

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace flash {

// The blocks one tile walks: a row of the block lattice (ids), or, with
// kDense (the fused backward, which has no lattice), the blocks first ..
// first + count - 1. A template flag, so the lattice walk pays no branch.
template <bool kDense>
struct Walk {
  const int* ids;
  int first, count;
  __device__ __forceinline__ int operator[](int t) const {
    if constexpr (kDense) return first + t;
    else return ids[t];
  }
};

// δ of one row, Σ_d dO·O in f32 from 16-bit dO and O (the row's first
// values): each lane of the quad that shares the row sums a quarter of it.
template <int D, typename E>
__device__ __forceinline__ float row_delta(const E* __restrict__ dout,
                                           const E* __restrict__ out, int t) {
  constexpr int kQ = D / 4;
  const int c0 = (t & 3) * kQ;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kQ; c += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(dout + c0 + c);
    const uint4 y = *reinterpret_cast<const uint4*>(out + c0 + c);
    const uint32_t* xp = reinterpret_cast<const uint32_t*>(&x);
    const uint32_t* yp = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = tc::unpack2<E>(xp[e]), fy = tc::unpack2<E>(yp[e]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
  return tc::quad_sum(acc);
}

// This thread's two query rows of a warpgroup's 64-row tile (r0 for the even
// accumulator register pairs, r1 = r0 + 8): positions, segment ids, -lse·log2(e)
// and δ.
struct QRows {
  int r0, r1, sq0, sq1;
  float nl0, nl1, dl0, dl1;
};
// This thread's two key rows of a warpgroup's 64-row tile, as QRows.
struct KRows {
  int r0, r1, sk0, sk1;
};

// The dq pass's body for one warpgroup's 64 query rows and the KT keys j0 ..
// j0 + KT - 1: S = Q Kᵀ and dP = dO Vᵀ by SS wgmma (both operands
// K-major), p = exp(S·scale - lse) under the mask, ds = p (dP - δ) rounded to
// bf16 in place as the A fragment of dQ += dS K (register-A wgmma, K read
// MN-major). Q and dO are rows q_row .. of swizzled tiles sQ, sdO of RQ
// rows; K and V rows k_row .. of tiles sK, sV of RK rows; segk[c] is the
// segment id of key j0 + c (read only with use_seg); masked: some pair of
// the sub-tile may be masked.
template <int D, int KT, typename E = tc::bf16>
__device__ __forceinline__ void dq_tile(float (&dqa)[D / 2], const Args& a, const QRows& qr,
                                        uint32_t sQ, uint32_t sdO, int RQ, int q_row,
                                        uint32_t sK, uint32_t sV, int RK, int k_row, int j0,
                                        const int* segk, bool use_seg, bool masked, int t) {
  using namespace tc;
  const float sl2 = a.scale * kLog2e;
  float s[KT / 2], dp[KT / 2];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<KT, E>::ss(s, desc_k(sQ, RQ, q_row, kk), desc_k(sK, RK, k_row, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<KT, E>::ss(dp, desc_k(sdO, RQ, q_row, kk), desc_k(sV, RK, k_row, kk), kk);
  wg_commit();
  wg_wait_all();
  hold(s);
  hold(dp);
  uint32_t df[KT / 16][4];
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e, c = acc_col(t, i);  // key columns c, c + 1
      const bool hi = e & 1;                            // row r1
      const float nl = hi ? qr.nl1 : qr.nl0, dl = hi ? qr.dl1 : qr.dl0;
      float p_lo = exp2f(fmaf(s[i], sl2, nl));
      float p_hi = exp2f(fmaf(s[i + 1], sl2, nl));
      if (masked) {
        const int r = hi ? qr.r1 : qr.r0, sq = hi ? qr.sq1 : qr.sq0;
        if (!allowed(a, r, j0 + c, use_seg, sq, use_seg ? segk[c] : 0)) p_lo = 0.f;
        if (!allowed(a, r, j0 + c + 1, use_seg, sq, use_seg ? segk[c + 1] : 0)) p_hi = 0.f;
      }
      // ds.astype(E), ds = p (dp - δ) from the unrounded p
      df[kk][e] = pack2<E>(p_lo * (dp[i] - dl), p_hi * (dp[i + 1] - dl));
    }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) Mma<D, E>::rs(dqa, df[kk], desc_mn(sK, RK, k_row, kk), 1);
  wg_commit();
  wg_wait_all();
  hold(dqa);
  hold(df);
}

// The dk/dv pass's body for one warpgroup's 64 key rows and the 64 queries
// i0 .. i0 + 63: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ by SS wgmma, pᵀ = exp(sᵀ·scale -
// lse) and dsᵀ = pᵀ (dpᵀ - δ), each rounded to bf16 in place as the A
// fragment of dV += Pᵀ dO and dK += dSᵀ Q (register-A wgmmas, dO and Q read
// MN-major). K and V are rows k_row .. of tiles sK, sV of RK rows; Q and dO
// rows q_row .. of tiles sQ, sdO of RQ rows; lse_s[c], delta_s[c], segq[c]
// belong to query i0 + c.
template <int D, typename E = tc::bf16>
__device__ __forceinline__ void dkdv_tile(float (&dka)[D / 2], float (&dva)[D / 2],
                                          const Args& a, const KRows& kr, uint32_t sK,
                                          uint32_t sV, int RK, int k_row, uint32_t sQ,
                                          uint32_t sdO, int RQ, int q_row, int i0,
                                          const float* lse_s, const float* delta_s,
                                          const int* segq, bool use_seg, bool masked, int t) {
  using namespace tc;
  const float sl2 = a.scale * kLog2e;
  float s[32], dp[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<64, E>::ss(s, desc_k(sK, RK, k_row, kk), desc_k(sQ, RQ, q_row, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<64, E>::ss(dp, desc_k(sV, RK, k_row, kk), desc_k(sdO, RQ, q_row, kk), kk);
  wg_commit();
  wg_wait_all();
  hold(s);
  hold(dp);
  uint32_t pf[4][4], df[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e, c = acc_col(t, i);  // query columns c, c + 1
      const int r = (e & 1) ? kr.r1 : kr.r0, sk = (e & 1) ? kr.sk1 : kr.sk0;
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
      float p_lo = exp2f(fmaf(s[i], sl2, -ls.x * kLog2e));
      float p_hi = exp2f(fmaf(s[i + 1], sl2, -ls.y * kLog2e));
      if (masked) {
        if (!allowed(a, i0 + c, r, use_seg, use_seg ? segq[c] : 0, sk)) p_lo = 0.f;
        if (!allowed(a, i0 + c + 1, r, use_seg, use_seg ? segq[c + 1] : 0, sk)) p_hi = 0.f;
      }
      // p.astype(E) and ds.astype(E), ds = p (dp - δ) from the unrounded p
      pf[kk][e] = pack2<E>(p_lo, p_hi);
      df[kk][e] = pack2<E>(p_lo * (dp[i] - dl.x), p_hi * (dp[i + 1] - dl.y));
    }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Mma<D, E>::rs(dva, pf[kk], desc_mn(sdO, RQ, q_row, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Mma<D, E>::rs(dka, df[kk], desc_mn(sQ, RQ, q_row, kk), 1);
  wg_commit();
  wg_wait_all();
  hold(dva);
  hold(dka);
  hold(pf);
  hold(df);
}

// delta [B, H, S] f32: read, or, when out is not null, formed here from the
// stored output as Σ dO·O and written for the dk/dv pass. ids/counts: the
// forward's lattice; kDense: none (ids, counts unread), every causally live
// kv block instead (window 0).
template <int D, int NWG, int KT, bool kDense, typename E>
__global__ void __launch_bounds__(NWG * 128, 1)
dq_tc_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
             const int* __restrict__ seg, const float* __restrict__ lse,
             float* __restrict__ delta, const E* __restrict__ dout, const E* __restrict__ out,
             const int* __restrict__ ids, const int* __restrict__ counts, E* __restrict__ dq,
             Args a, int nst) {
  using namespace tc;
  constexpr int R = NWG * 64, NT = NWG * 128, NO = D / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sQ = aligned_base(smem_raw, &sm);  // [R, D]
  const uint32_t sdO = sQ + R * D * 2;              // [R, D]
  const uint32_t sStage = sdO + R * D * 2;
  const int BK = a.block_kv;
  const uint32_t kv_bytes = BK * D * 2;
  const uint32_t stage_bytes = round1k(2 * kv_bytes + 4 * BK);  // K [BK, D], V [BK, D], seg [BK]

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int qt = gridDim.y - 1 - blockIdx.y;  // later query tiles attend more keys: start them first
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, kh = h / (a.H / a.Hkv);
  const int i0 = qt * R, iw = i0 + 64 * wg;
  const long long q_rs = (long long)a.H * D, kv_rs = (long long)a.Hkv * D;
  const long long q_off = (((long long)b * a.S + i0) * a.H + h) * D;
  const E* k_base = k + ((long long)b * a.S * a.Hkv + kh) * D;
  const E* v_base = v + ((long long)b * a.S * a.Hkv + kh) * D;
  const bool use_seg = seg != nullptr;
  Walk<kDense> walk{nullptr, 0, a.causal ? min(a.nkv(), (i0 + R - 1) / BK + 1) : a.nkv()};
  if constexpr (!kDense) {
    const long long lat = (long long)b * a.nq() + i0 / a.block_q;
    walk = Walk<kDense>{ids + lat * a.nkv(), 0, counts[lat]};
  }

  cp_tile<D, NT>(sQ, R, q + q_off, q_rs, tid);
  cp_tile<D, NT>(sdO, R, dout + q_off, q_rs, tid);
  cp_commit();
  auto issue = [&](int s) {
    const uint32_t st = sStage + (s % nst) * stage_bytes;
    const int kb0 = walk[s] * BK;
    cp_tile<D, NT>(st, BK, k_base + kb0 * kv_rs, kv_rs, tid);
    cp_tile<D, NT>(st + kv_bytes, BK, v_base + kb0 * kv_rs, kv_rs, tid);
    if (use_seg) cp_words<NT>(st + 2 * kv_bytes, seg + (long long)b * a.S + kb0, BK, tid);
  };
  for (int s = 0; s < nst - 1; ++s) {
    if (s < walk.count) issue(s);
    cp_commit();
  }

  // this thread's two query rows: r0 for the even register pairs, r1 = r0 + 8
  QRows qr;
  qr.r0 = iw + acc_row(t, 0);
  qr.r1 = qr.r0 + 8;
  const long long rows = (long long)bh * a.S;
  qr.sq0 = use_seg ? seg[(long long)b * a.S + qr.r0] : 0;
  qr.sq1 = use_seg ? seg[(long long)b * a.S + qr.r1] : 0;
  if (out != nullptr) {
    const long long o0 = (((long long)b * a.S + qr.r0) * a.H + h) * D, o1 = o0 + 8 * q_rs;
    qr.dl0 = row_delta<D, E>(dout + o0, out + o0, t);
    qr.dl1 = row_delta<D, E>(dout + o1, out + o1, t);
    if ((t & 3) == 0) {
      delta[rows + qr.r0] = qr.dl0;
      delta[rows + qr.r1] = qr.dl1;
    }
  } else {
    qr.dl0 = delta[rows + qr.r0];
    qr.dl1 = delta[rows + qr.r1];
  }
  qr.nl0 = -lse[rows + qr.r0] * kLog2e;
  qr.nl1 = -lse[rows + qr.r1] * kLog2e;
  float dqa[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.f;

  for (int tt = 0; tt < walk.count; ++tt) {
    if (tt + nst - 1 < walk.count) issue(tt + nst - 1);
    cp_commit();
    cp_wait(nst - 1);
    fence_async_smem();
    __syncthreads();  // block tt (and Q, dO) landed for every thread
    const uint32_t sK = sStage + (tt % nst) * stage_bytes, sV = sK + kv_bytes;
    const int* segk = reinterpret_cast<const int*>(sm + (sK - sQ) + 2 * kv_bytes);
    const int kb0 = walk[tt] * BK;
    for (int u = 0; u < BK / KT; ++u) {
      const int j0 = kb0 + u * KT;
      const bool empty = (a.causal && j0 > iw + 63) ||
                         (a.window > 0 && iw - (j0 + KT - 1) >= a.window);
      if (empty) continue;  // warpgroup-uniform
      const bool masked = use_seg || (a.causal && j0 + KT - 1 > iw) ||
                          (a.window > 0 && iw + 63 - j0 >= a.window);
      dq_tile<D, KT, E>(dqa, a, qr, sQ, sdO, R, 64 * wg, sK, sV, BK, u * KT, j0, segk + u * KT,
                     use_seg, masked, t);
    }
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] *= a.scale;
  store_acc<D>(dq + (((long long)b * a.S + iw) * a.H + h) * D, q_rs, dqa, t);
}

// dk/dv pass. The TPU program sums over all q blocks and group members in
// one sequence of grid steps. Hopper blocks run in no order, so one block
// owns the whole sum of a tile of R = 64·NWG key rows of one (b, kv head),
// as NWG warpgroups of 64 keys; grid (B·Hkv, S/R), the key tiles with the
// most causal work first. No atomics and no reduction across blocks.
// - Its K and V tiles stay in shared memory for the whole walk. It walks its
//   q blocks (a transposed-lattice row idsT[b, j, :countsT[b, j]], or every
//   causally live one) x the GQA group's q heads in q tiles of 64 rows; each
//   tile's Q, dO, lse, δ (and segment ids) come through a three-stage
//   cp.async ring, two tiles ahead of the one that computes.
// - Per q tile and warpgroup: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ by wgmma into f32
//   registers (64 keys x 64 queries each); pᵀ = exp(sᵀ·scale - lse) and
//   dsᵀ = pᵀ (dpᵀ - δ) per element, each rounded to bf16 in place as the A
//   fragment of dV += Pᵀ dO and dK += dSᵀ Q, register-A wgmmas with dO and
//   Q read transposed from shared memory — the TPU kernel's rounding
//   points. dk and dv stay in f32 registers over every q block and group
//   member (the GQA fold, in f32); dk is scaled once and both are rounded
//   once.
// - A warpgroup whose keys the causal or window mask shuts out of a whole
//   q tile skips it (its p and ds are all 0).
template <int D, int NWG, bool kDense, typename E>
__global__ void __launch_bounds__(NWG * 128, 1)
dkdv_tc_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
               const int* __restrict__ seg, const float* __restrict__ lse,
               const float* __restrict__ delta, const E* __restrict__ dout,
               const int* __restrict__ idsT, const int* __restrict__ countsT,
               E* __restrict__ dk, E* __restrict__ dv, Args a, int nst) {
  using namespace tc;
  constexpr int R = NWG * 64, NT = NWG * 128, NO = D / 2;
  constexpr uint32_t kTileQ = 64 * D * 2;  // a [64, D] 16-bit tile
  // Q [64, D], dO [64, D], lse [64], δ [64], segment ids [64]
  constexpr uint32_t kStage = round1k(2 * kTileQ + 3 * 64 * 4);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sK = aligned_base(smem_raw, &sm);  // [R, D]
  const uint32_t sV = sK + R * D * 2;               // [R, D]
  const uint32_t sStage = sV + R * D * 2;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int bkh = blockIdx.x, b = bkh / a.Hkv, kh = bkh - b * a.Hkv, rep = a.H / a.Hkv;
  const int j0 = blockIdx.y * R, jw = j0 + 64 * wg;
  const long long q_rs = (long long)a.H * D, kv_rs = (long long)a.Hkv * D;
  const long long kv_off = (((long long)b * a.S + j0) * a.Hkv + kh) * D;
  const bool use_seg = seg != nullptr;
  const int first = a.causal ? j0 / a.block_q : 0;  // earlier q blocks see none of these keys
  Walk<kDense> walk{nullptr, first, a.nq() - first};
  if constexpr (!kDense) {
    const long long lat = (long long)b * a.nkv() + j0 / a.block_kv;
    walk = Walk<kDense>{idsT + lat * a.nq(), 0, countsT[lat]};
  }
  const int nsub = a.block_q / 64, per = rep * nsub, n_items = walk.count * per;

  cp_tile<D, NT>(sK, R, k + kv_off, kv_rs, tid);
  cp_tile<D, NT>(sV, R, v + kv_off, kv_rs, tid);
  cp_commit();
  // item n: q block walk[n / per], group member (n % per) / nsub, q tile n % nsub
  auto item_rows = [&](int n, int* h) {
    const int tq = n / per, rem = n - tq * per;
    *h = kh * rep + rem / nsub;
    return walk[tq] * a.block_q + (rem % nsub) * 64;
  };
  auto issue = [&](int n) {
    int h;
    const int i0 = item_rows(n, &h);
    const uint32_t st = sStage + (n % nst) * kStage;
    const long long q_off = (((long long)b * a.S + i0) * a.H + h) * D;
    const long long row_off = ((long long)b * a.H + h) * a.S + i0;
    cp_tile<D, NT>(st, 64, q + q_off, q_rs, tid);
    cp_tile<D, NT>(st + kTileQ, 64, dout + q_off, q_rs, tid);
    cp_words<NT>(st + 2 * kTileQ, lse + row_off, 64, tid);
    cp_words<NT>(st + 2 * kTileQ + 256, delta + row_off, 64, tid);
    if (use_seg) cp_words<NT>(st + 2 * kTileQ + 512, seg + (long long)b * a.S + i0, 64, tid);
  };
  for (int n = 0; n < nst - 1; ++n) {
    if (n < n_items) issue(n);
    cp_commit();
  }

  // this thread's two key rows: r0 for the even register pairs, r1 = r0 + 8
  KRows kr;
  kr.r0 = jw + acc_row(t, 0);
  kr.r1 = kr.r0 + 8;
  kr.sk0 = use_seg ? seg[(long long)b * a.S + kr.r0] : 0;
  kr.sk1 = use_seg ? seg[(long long)b * a.S + kr.r1] : 0;
  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;

  for (int n = 0; n < n_items; ++n) {
    if (n + nst - 1 < n_items) issue(n + nst - 1);
    cp_commit();
    cp_wait(nst - 1);
    fence_async_smem();
    __syncthreads();  // tile n (and K, V) landed for every thread
    int h;
    const int i0 = item_rows(n, &h);
    const uint32_t sQ = sStage + (n % nst) * kStage, sdO = sQ + kTileQ;
    const float* lse_s = reinterpret_cast<const float*>(sm + (sQ - sK) + 2 * kTileQ);
    const bool empty = (a.causal && jw > i0 + 63) ||
                       (a.window > 0 && i0 - (jw + 63) >= a.window);
    if (!empty) {  // warpgroup-uniform
      const bool masked = use_seg || (a.causal && jw + 63 > i0) ||
                          (a.window > 0 && i0 + 63 - jw >= a.window);
      dkdv_tile<D, E>(dka, dva, a, kr, sK, sV, R, 64 * wg, sQ, sdO, 64, 0, i0, lse_s, lse_s + 64,
                   reinterpret_cast<const int*>(lse_s + 128), use_seg, masked, t);
    }
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] *= a.scale;
  const long long wg_off = kv_off + 64LL * wg * kv_rs;
  store_acc<D>(dk + wg_off, kv_rs, dka, t);
  store_acc<D>(dv + wg_off, kv_rs, dva, t);
}

// ---- launchers ---------------------------------------------------------------

// The dq pass with R = 64·NWG query rows a block and KT-key sub-tiles; as
// many cp.async stages of whole kv blocks (up to 3) as shared memory holds.
template <int D, int NWG, int KT, bool kDense, typename E = tc::bf16>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const int* seg,
                         const float* lse, float* delta, const void* dout, const void* out,
                         const int* ids, const int* counts, void* dq, const Args& a,
                         cudaStream_t stream) {
  const uint32_t stage = tc::round1k(2 * a.block_kv * D * 2 + 4 * a.block_kv);
  const uint32_t fixed = tc::kAlignSlack + 2 * NWG * 64 * D * 2;
  int nst = 3;
  while (nst > 1 && fixed + nst * stage > tc::kMaxSmem) --nst;
  const size_t smem = fixed + nst * stage;
  auto kernel = dq_tc_kernel<D, NWG, KT, kDense, E>;
  cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, a.S / (NWG * 64));
  kernel<<<grid, NWG * 128, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), seg, lse,
      delta, static_cast<const E*>(dout), static_cast<const E*>(out), ids, counts,
      static_cast<E*>(dq), a, nst);
  return cudaGetLastError();
}

// The dk/dv pass with R = 64·NWG key rows a block.
template <int D, int NWG, bool kDense, typename E = tc::bf16>
cudaError_t launch_dkdv_tc(const void* q, const void* k, const void* v, const int* seg,
                           const float* lse, const float* delta, const void* dout,
                           const int* idsT, const int* countsT, void* dk, void* dv,
                           const Args& a, cudaStream_t stream) {
  constexpr uint32_t stage = tc::round1k(2 * 64 * D * 2 + 3 * 64 * 4);
  constexpr uint32_t fixed = tc::kAlignSlack + 2 * NWG * 64 * D * 2;
  const int nst = fixed + 3 * stage <= tc::kMaxSmem ? 3 : 2;
  const size_t smem = fixed + nst * stage;
  auto kernel = dkdv_tc_kernel<D, NWG, kDense, E>;
  cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hkv, a.S / (NWG * 64));
  kernel<<<grid, NWG * 128, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), seg, lse,
      delta, static_cast<const E*>(dout), idsT, countsT, static_cast<E*>(dk),
      static_cast<E*>(dv), a, nst);
  return cudaGetLastError();
}

// The dq pass's widest sub-tile at head dim D (kv blocks of 128 keys or more).
template <int D>
constexpr int kDqTile = D == 64 ? 128 : 64;

}  // namespace flash
