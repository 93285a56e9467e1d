// Blocked flash attention, forward, for Hopper.
//
// Replaces: accelerate_tpu/ops/flash_attention.py `_flash_fwd_kernel`
// (launched by `_flash_call_fwd` through pl.pallas_call), the Pallas TPU
// kernel whose grid (B·H, q blocks, kv steps) walks each q block's list of
// active kv blocks from the block lattice (scalar prefetch), carrying the
// f32 online softmax (m, l, acc) in VMEM across the kv steps and writing O
// and the row logsumexp.
//
// What bounds it: operations. At the Llama long-context shape (B=1,
// S=8192, H=16, Hkv=8, D=64, causal, bf16) the attended (query, key) pairs
// are 16 · 8192·8193/2 ≈ 537 M, 4·D flops each: 137 GFLOP, 0.14 ms at the
// bf16 tensor-core peak, against 25 MB of q, k, v, o and lse (7.5 µs at
// 3.35 TB/s). On CUDA-core f32 FMA (67 TFLOP/s) the same work takes ≥ 2 ms.
//
// What the design does about it: two variants, chosen by the launcher
// from dtype and head dim.
//
// bf16 at D in {64, 128} (every training path): tensor cores.
// - One block owns a tile of R = 128 query rows (64 when block_q is not a
//   multiple of 128) of one (b, h), inside one lattice q block, as R/64
//   warpgroups of 64 rows; grid (B·H, S/R), the causally heaviest tiles
//   first. It walks its lattice row ids[b, qi, :counts[b, qi]]: blocks the
//   lattice skips are never read. GQA in-kernel: K/V of kv head
//   h / (H/Hkv) through the BSHD strides, no repeated KV.
// - The kv block's K and V tiles (bf16, 128-byte swizzled, flash_tc.cuh)
//   come through a two-stage cp.async ring: block t+1 is in flight while
//   block t computes.
// - Per kv block and warpgroup: S = Q Kᵀ by wgmma into f32 registers (64 x
//   up to 128 keys); the causal / window / segment mask per element; the
//   row max over the whole block from registers and quad shuffles, the
//   shift clamped to 0 while m is -inf; p in f32 (l sums it unrounded);
//   p rounded to bf16 in place as the A fragment of P V, a register-A
//   wgmma with V read transposed from shared memory. Those are the TPU
//   kernel's rescale and rounding points, so bf16 agrees to the last
//   rounding; no score tile goes through shared memory.
// - block_kv = 256 (or 192) is more scores than one accumulator holds: the
//   block is taken in sub-tiles of 128 (or 64) keys, a first Q Kᵀ pass over
//   them takes the block's row max, a second recomputes each sub-tile's
//   scores and accumulates P V. The main path (block_kv = 128) takes one
//   pass.
// - A warpgroup whose rows the causal or window mask shuts out of a whole
//   kv block skips it: the TPU kernel's step is then the identity.
//
// f32, and D = 256 (on no path): CUDA-core f32 FMA (fused_common.cuh), one
// block of BR query rows holding the kv block's scores in shared memory to
// take the row max, then forming p and accumulating PV tile by tile. In
// f32 it beats SDPA; D = 256 fits no wgmma accumulator beside its scores.
#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ seg, const int* __restrict__ ids,
           const int* __restrict__ counts, T* __restrict__ out, float* __restrict__ lse,
           Args a) {
  using G = Geo<D>;
  extern __shared__ __align__(16) float smem[];
  const int lds = a.block_kv + 1;    // odd row stride of the score tile
  float* Qs = smem;                  // [BR, LD] this block's query rows
  float* KVs = Qs + G::BR * G::LD;   // [BR, LD] a key tile, then a value tile
  float* Ss = KVs + G::BR * G::LD;   // [BR, lds] scores, then rounded p, of one kv block
  __shared__ int seg_q[G::BR], seg_k[G::BR];

  const int qt = gridDim.x - 1 - blockIdx.x;  // later query tiles attend more keys: start them first
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H, kh = h / (a.H / a.Hkv);
  const int i0 = qt * G::BR, qi = i0 / a.block_q;
  const int tr = threadIdx.x / G::TC, tc = threadIdx.x % G::TC;
  const long long q_rs = (long long)a.H * D, kv_rs = (long long)a.Hkv * D;
  const T* k_base = k + ((long long)b * a.S * a.Hkv + kh) * D;
  const T* v_base = v + ((long long)b * a.S * a.Hkv + kh) * D;
  const bool use_seg = seg != nullptr;

  load_tile<T, D>(Qs, q + (((long long)b * a.S + i0) * a.H + h) * D, q_rs);
  if (use_seg && threadIdx.x < G::BR) seg_q[threadIdx.x] = seg[(long long)b * a.S + i0 + threadIdx.x];
  const long long lat = (long long)b * a.nq() + qi;
  const int count = counts[lat];
  const int* blocks = ids + lat * a.nkv();
  const int n_sub = a.block_kv / G::BR;

  float m[4], l[4], o[4][G::DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < G::DC; ++c) o[r][c] = 0.f;
  }

  for (int t = 0; t < count; ++t) {
    const int kb0 = blocks[t] * a.block_kv;
    // scores of the whole kv block, and this thread's part of each row max
    float mb[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int u = 0; u < n_sub; ++u) {
      const int j0 = kb0 + u * G::BR;
      __syncthreads();  // every thread is done with the previous tile and scores
      load_tile<T, D>(KVs, k_base + j0 * kv_rs, kv_rs);
      if (use_seg && threadIdx.x < G::BR) seg_k[threadIdx.x] = seg[(long long)b * a.S + j0 + threadIdx.x];
      __syncthreads();
      float s[4][G::SC];
      tile_nt<D>(s, Qs, KVs, tr, tc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < G::SC; ++c) {
          const int i = tr * 4 + r, j = tc + c * G::TC;
          const bool ok = allowed(a, i0 + i, j0 + j, use_seg, use_seg ? seg_q[i] : 0,
                                  use_seg ? seg_k[j] : 0);
          const float x = ok ? s[r][c] * a.scale : -INFINITY;
          Ss[i * lds + u * G::BR + j] = x;
          mb[r] = fmaxf(mb[r], x);
        }
    }
    // online softmax over the block: rescale by the new max, p rounded to T
    float shift[4], lsum[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float m_new = fmaxf(m[r], row_max<G::TC>(mb[r]));
      // a fully masked prefix keeps m at -inf: exp(-inf - -inf) would be NaN
      shift[r] = isfinite(m_new) ? m_new : 0.f;
      const float alpha = expf(m[r] - shift[r]);
      m[r] = m_new;
      l[r] *= alpha;
      lsum[r] = 0.f;
#pragma unroll
      for (int c = 0; c < G::DC; ++c) o[r][c] *= alpha;
    }
    for (int u = 0; u < n_sub; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < G::SC; ++c) {
          // the same thread wrote this score above: no barrier needed
          float* x = Ss + (tr * 4 + r) * lds + u * G::BR + tc + c * G::TC;
          const float p = expf(*x - shift[r]);
          lsum[r] += p;
          *x = round_to<T>(p);
        }
#pragma unroll
    for (int r = 0; r < 4; ++r) l[r] += row_sum<G::TC>(lsum[r]);
    for (int u = 0; u < n_sub; ++u) {
      __syncthreads();  // p complete; nobody reads the previous tile any more
      load_tile<T, D>(KVs, v_base + (kb0 + u * G::BR) * kv_rs, kv_rs);
      __syncthreads();
      tile_pv<D>(o, Ss + u * G::BR, lds, KVs, tr, tc);
    }
  }

  T* o_base = out + (((long long)b * a.S + i0) * a.H + h) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::DC; ++c)
      o_base[(tr * 4 + r) * q_rs + tc + c * G::TC] = from_f32<T>(o[r][c] / l[r]);
  if (tc == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) lse[(long long)bh * a.S + i0 + tr * 4 + r] = m[r] + logf(l[r]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, const int* ids,
                   const int* counts, void* out, float* lse, const Args& a, cudaStream_t stream) {
  using G = Geo<D>;
  const size_t smem = 2 * G::kTile + sizeof(float) * G::BR * (a.block_kv + 1);
  auto kernel = fwd_kernel<T, D>;
  cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / G::BR, a.B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), seg, ids, counts,
                                           static_cast<T*>(out), lse, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* seg,
                     const int* ids, const int* counts, void* out, float* lse, const Args& a,
                     cudaStream_t stream) {
  FLASH_DISPATCH_D(D, return launch<T, kD>(q, k, v, seg, ids, counts, out, lse, a, stream);)
}

// ---- bf16, D in {64, 128}: tensor cores ------------------------------------

// R = 64·NWG query rows a block, kv sub-tiles of KT keys (the S accumulator
// is 64 x KT a warpgroup); nst = cp.async stages of whole kv blocks.
template <int D, int NWG, int KT>
__global__ void __launch_bounds__(NWG * 128, 1)
fwd_tc_kernel(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
              const tc::bf16* __restrict__ v, const int* __restrict__ seg,
              const int* __restrict__ ids, const int* __restrict__ counts,
              tc::bf16* __restrict__ out, float* __restrict__ lse, Args a, int nst) {
  using namespace tc;
  constexpr int R = NWG * 64, NT = NWG * 128, NS = KT / 2, NO = D / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sQ = aligned_base(smem_raw, &sm);  // [R, D]
  const int BK = a.block_kv;
  const uint32_t kv_bytes = BK * D * 2;
  const uint32_t stage_bytes = round1k(2 * kv_bytes + 4 * BK);  // K [BK, D], V [BK, D], seg [BK]
  const uint32_t sStage = sQ + R * D * 2;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int qt = gridDim.y - 1 - blockIdx.y;  // later query tiles attend more keys: start them first
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, kh = h / (a.H / a.Hkv);
  const int i0 = qt * R, qi = i0 / a.block_q, iw = i0 + 64 * wg;
  const long long q_rs = (long long)a.H * D, kv_rs = (long long)a.Hkv * D;
  const bf16* k_base = k + ((long long)b * a.S * a.Hkv + kh) * D;
  const bf16* v_base = v + ((long long)b * a.S * a.Hkv + kh) * D;
  const bool use_seg = seg != nullptr;
  const long long lat = (long long)b * a.nq() + qi;
  const int count = counts[lat];
  const int* blocks = ids + lat * a.nkv();

  cp_tile<D, NT>(sQ, R, q + (((long long)b * a.S + i0) * a.H + h) * D, q_rs, tid);
  cp_commit();
  auto issue = [&](int s) {
    const uint32_t st = sStage + (s % nst) * stage_bytes;
    const int kb0 = blocks[s] * BK;
    cp_tile<D, NT>(st, BK, k_base + kb0 * kv_rs, kv_rs, tid);
    cp_tile<D, NT>(st + kv_bytes, BK, v_base + kb0 * kv_rs, kv_rs, tid);
    if (use_seg) cp_words<NT>(st + 2 * kv_bytes, seg + (long long)b * a.S + kb0, BK, tid);
  };
  for (int s = 0; s < nst - 1; ++s) {
    if (s < count) issue(s);
    cp_commit();
  }

  // this thread's two query rows: r0 for the even register pairs, r1 = r0 + 8
  const int r0 = iw + acc_row(t, 0), r1 = r0 + 8;
  const int sq0 = use_seg ? seg[(long long)b * a.S + r0] : 0;
  const int sq1 = use_seg ? seg[(long long)b * a.S + r1] : 0;
  const float sl2 = a.scale * kLog2e;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, o[NO], sacc[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  for (int tt = 0; tt < count; ++tt) {
    if (tt + nst - 1 < count) issue(tt + nst - 1);
    cp_commit();
    cp_wait(nst - 1);
    fence_async_smem();
    __syncthreads();  // block tt (and Q) landed for every thread
    const uint32_t sK = sStage + (tt % nst) * stage_bytes, sV = sK + kv_bytes;
    const int* segk = reinterpret_cast<const int*>(sm + (sK - sQ) + 2 * kv_bytes);
    const int kb0 = blocks[tt] * BK;
    const bool empty = (a.causal && kb0 > iw + 63) ||
                       (a.window > 0 && iw - (kb0 + BK - 1) >= a.window);
    if (!empty) {  // warpgroup-uniform
      const bool masked = use_seg || (a.causal && kb0 + BK - 1 > iw) ||
                          (a.window > 0 && iw + 63 - kb0 >= a.window);
      const int nsub = BK / KT;
      // sacc = S of keys kb0 + u·KT .. (raw Q Kᵀ; masked entries -inf)
      auto scores = [&](int u) {
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Mma<KT>::ss(sacc, desc_k(sQ, R, 64 * wg, kk), desc_k(sK, BK, u * KT, kk), kk);
        wg_commit();
        wg_wait_all();
        hold(sacc);
        if (masked) {
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const bool hi = (i >> 1) & 1;
            const int j = u * KT + acc_col(t, i);
            if (!allowed(a, hi ? r1 : r0, kb0 + j, use_seg, hi ? sq1 : sq0,
                         use_seg ? segk[j] : 0))
              sacc[i] = -INFINITY;
          }
        }
      };
      // the row max over the whole kv block (scale > 0: max(s)·scale is
      // the max of the scaled scores)
      float mb0 = -INFINITY, mb1 = -INFINITY;
      for (int u = 0; u < nsub; ++u) {
        scores(u);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          if ((i >> 1) & 1) mb1 = fmaxf(mb1, sacc[i]);
          else mb0 = fmaxf(mb0, sacc[i]);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mb0) * a.scale);
      const float mn1 = fmaxf(m1, quad_max(mb1) * a.scale);
      // a fully masked prefix keeps m at -inf: exp(-inf - -inf) would be NaN
      const float sh0 = isfinite(mn0) ? mn0 : 0.f, sh1 = isfinite(mn1) ? mn1 : 0.f;
      const float al0 = exp2f((m0 - sh0) * kLog2e), al1 = exp2f((m1 - sh1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= ((i >> 1) & 1) ? al1 : al0;
      const float c0 = sh0 * kLog2e, c1 = sh1 * kLog2e;
      for (int u = 0; u < nsub; ++u) {
        if (nsub > 1) scores(u);
        uint32_t pf[KT / 16][4];
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * kk + 2 * e;  // row r0 for e even, r1 for e odd
            const float c = (e & 1) ? c1 : c0;
            const float p_lo = exp2f(fmaf(sacc[i], sl2, -c));
            const float p_hi = exp2f(fmaf(sacc[i + 1], sl2, -c));
            if (e & 1) l1 += p_lo + p_hi;
            else l0 += p_lo + p_hi;
            pf[kk][e] = pack_bf16(p_lo, p_hi);  // p.astype(bf16)
          }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) Mma<D>::rs(o, pf[kk], desc_mn(sV, BK, u * KT, kk), 1);
        wg_commit();
        wg_wait_all();
        hold(o);
        hold(pf);
      }
    }
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] /= ((i >> 1) & 1) ? l1 : l0;
  store_acc<D>(out + (((long long)b * a.S + iw) * a.H + h) * D, q_rs, o, t);
  if ((t & 3) == 0) {
    lse[(long long)bh * a.S + r0] = m0 + logf(l0);
    lse[(long long)bh * a.S + r1] = m1 + logf(l1);
  }
}

template <int D, int NWG, int KT>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* seg, const int* ids,
                      const int* counts, void* out, float* lse, const Args& a,
                      cudaStream_t stream) {
  const uint32_t stage = tc::round1k(2 * a.block_kv * D * 2 + 4 * a.block_kv);
  const uint32_t fixed = tc::kAlignSlack + NWG * 64 * D * 2;
  const int nst = fixed + 2 * stage <= tc::kMaxSmem ? 2 : 1;
  const size_t smem = fixed + nst * stage;
  auto kernel = fwd_tc_kernel<D, NWG, KT>;
  cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, a.S / (NWG * 64));
  kernel<<<grid, NWG * 128, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), seg, ids, counts, static_cast<tc::bf16*>(out), lse, a, nst);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc_d(const void* q, const void* k, const void* v, const int* seg,
                        const int* ids, const int* counts, void* out, float* lse, const Args& a,
                        cudaStream_t s) {
  if (a.block_q % 64 || a.block_kv % 64) return cudaErrorInvalidValue;
  if (a.block_q % 128 == 0)
    return a.block_kv % 128 == 0 ? launch_tc<D, 2, 128>(q, k, v, seg, ids, counts, out, lse, a, s)
                                 : launch_tc<D, 2, 64>(q, k, v, seg, ids, counts, out, lse, a, s);
  return a.block_kv % 128 == 0 ? launch_tc<D, 1, 128>(q, k, v, seg, ids, counts, out, lse, a, s)
                               : launch_tc<D, 1, 64>(q, k, v, seg, ids, counts, out, lse, a, s);
}

}  // namespace flash

// q, out [B,S,H,D]; k, v [B,S,Hkv,D] (dtype: 0 f32, 1 bf16; all contiguous,
// 16-byte aligned); seg [B,S] int32 or null; ids [B, S/block_q, S/block_kv]
// and counts [B, S/block_q] int32 (the block lattice); lse [B,H,S] f32. D in
// {64, 128, 256}; block_q, block_kv multiples of 64, at most 256, dividing
// S; window 0 for none. Returns the launch's cudaError_t (0 on success).
// bf16 at D = 64 and 128 goes to the tensor-core kernel, f32 and D = 256
// to the CUDA-core one.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const void* seg,
                                const void* ids, const void* counts, void* out, void* lse, int B,
                                int S, int H, int Hkv, int D, int dtype, int causal, int window,
                                int block_q, int block_kv, float scale, void* stream) {
  using namespace flash;
  const Args a{B, S, H, Hkv, causal, window, block_q, block_kv, scale};
  if (!args_ok(a, br_of(D))) return cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  const int* id = static_cast<const int*>(ids);
  const int* ct = static_cast<const int*>(counts);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == paged::kBF16 && D == 64) return launch_tc_d<64>(q, k, v, sg, id, ct, out, l, a, s);
  if (dtype == paged::kBF16 && D == 128) return launch_tc_d<128>(q, k, v, sg, id, ct, out, l, a, s);
  if (dtype == paged::kF32) return launch_d<float>(D, q, k, v, sg, id, ct, out, l, a, s);
  if (dtype == paged::kBF16 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, sg, id, ct, out, l, a, s);
  return cudaErrorInvalidValue;
}
