// Blocked flash attention, dk/dv pass of the backward, for Hopper.
//
// Replaces: accelerate_tpu/ops/flash_attention.py `_flash_dkdv_kernel`
// (launched by `_flash_call_bwd` through pl.pallas_call), the Pallas TPU
// kernel whose grid (B·Hkv, kv blocks, q steps · groups) gives one program
// per kv head and kv block, streams every (active q block × GQA group
// member) pair of the transposed lattice in order and accumulates the
// group-summed dk and dv in VMEM.
//
// What bounds it: operations. At the Llama long-context shape (B=1,
// S=8192, H=16, Hkv=8, D=64, causal, bf16): four products over ≈ 537 M
// attended pairs, 8·D flops each — 275 GFLOP, 0.28 ms at the bf16
// tensor-core peak — against ≈ 41 MB of q, k, v, dO, lse, δ, dk and dv.
//
// What the design does about it: two variants, chosen by the launcher
// from dtype and head dim.
//
// bf16 at D in {64, 128} (every training path): tensor cores.
// - The TPU program sums over all q blocks and group members in one
//   sequence of grid steps. Hopper blocks run in no order, so one block owns
//   the whole sum of a tile of R = 128 key rows (64 when block_kv is not a
//   multiple of 128) of one (b, kv head), inside one lattice kv block, as
//   R/64 warpgroups of 64 keys; grid (B·Hkv, S/R), the key tiles with the
//   most causal work first. No atomics and no reduction across blocks:
//   deterministic.
// - Its K and V tiles stay in shared memory (bf16, 128-byte swizzled,
//   flash_tc.cuh) for the whole walk. The block walks its transposed-
//   lattice row idsT[b, j, :countsT[b, j]] x the GQA group's q heads in q
//   tiles of 64 rows; each tile's Q, dO, lse, δ (and segment ids) come
//   through a three-stage cp.async ring, two tiles ahead of the one that
//   computes.
// - Per q tile and warpgroup: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ by wgmma into f32
//   registers (64 keys x 64 queries each); pᵀ = exp(sᵀ·scale - lse) and
//   dsᵀ = pᵀ (dpᵀ - δ) per element, each rounded to bf16 in place as the A
//   fragment of dV += Pᵀ dO and dK += dSᵀ Q, register-A wgmmas with dO and
//   Q read transposed from shared memory — the TPU kernel's rounding
//   points. dk and dv stay in f32 registers over every q block and group
//   member; dk is scaled once and both are rounded once.
// - A warpgroup whose keys the causal or window mask shuts out of a whole
//   q tile skips it (its p and ds are all 0).
//
// f32, and D = 256 (on no path): CUDA-core f32 FMA (fused_common.cuh), one
// block of BR key rows walking the same rows tile by tile with pᵀ and dsᵀ
// staged in shared memory.
#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ seg, const float* __restrict__ lse,
            const float* __restrict__ delta, const T* __restrict__ dout,
            const int* __restrict__ idsT, const int* __restrict__ countsT, T* __restrict__ dk,
            T* __restrict__ dv, Args a) {
  using G = Geo<D>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // [BR, LD] this block's key rows
  float* Vs = Ks + G::BR * G::LD;    // [BR, LD] their values
  float* Qs = Vs + G::BR * G::LD;    // [BR, LD] current query tile
  float* dOs = Qs + G::BR * G::LD;   // [BR, LD] its output gradient
  float* Pt = dOs + G::BR * G::LD;   // [BR, LS] rounded pᵀ (key rows x query columns)
  float* dSt = Pt + G::BR * G::LS;   // [BR, LS] rounded dsᵀ
  __shared__ int seg_q[G::BR], seg_k[G::BR];
  __shared__ float lse_s[G::BR], delta_s[G::BR];

  const int bkh = blockIdx.y, b = bkh / a.Hkv, kh = bkh - b * a.Hkv, rep = a.H / a.Hkv;
  const int j0 = blockIdx.x * G::BR, kvb = j0 / a.block_kv;
  const int tr = threadIdx.x / G::TC, tc = threadIdx.x % G::TC;
  const long long q_rs = (long long)a.H * D, kv_rs = (long long)a.Hkv * D;
  const long long kv_off = (((long long)b * a.S + j0) * a.Hkv + kh) * D;
  const bool use_seg = seg != nullptr;

  load_tile<T, D>(Ks, k + kv_off, kv_rs);
  load_tile<T, D>(Vs, v + kv_off, kv_rs);
  if (use_seg && threadIdx.x < G::BR) seg_k[threadIdx.x] = seg[(long long)b * a.S + j0 + threadIdx.x];
  const long long lat = (long long)b * a.nkv() + kvb;
  const int count = countsT[lat];
  const int* blocks = idsT + lat * a.nq();
  const int n_sub = a.block_q / G::BR;

  float dk_acc[4][G::DC], dv_acc[4][G::DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  for (int t = 0; t < count; ++t) {
    for (int h = kh * rep; h < (kh + 1) * rep; ++h) {
      for (int w = 0; w < n_sub; ++w) {
        const int i0 = blocks[t] * a.block_q + w * G::BR;
        const long long q_off = (((long long)b * a.S + i0) * a.H + h) * D;
        const long long row_off = ((long long)b * a.H + h) * a.S + i0;
        __syncthreads();  // every thread is done with the previous tile
        load_tile<T, D>(Qs, q + q_off, q_rs);
        load_tile<T, D>(dOs, dout + q_off, q_rs);
        if (threadIdx.x < G::BR) {
          if (use_seg) seg_q[threadIdx.x] = seg[(long long)b * a.S + i0 + threadIdx.x];
          lse_s[threadIdx.x] = lse[row_off + threadIdx.x];
          delta_s[threadIdx.x] = delta[row_off + threadIdx.x];
        }
        __syncthreads();
        // sᵀ and dpᵀ: key rows (tr) x query columns (tc)
        float s[4][G::SC], dp[4][G::SC];
        tile_nt<D>(s, Ks, Qs, tr, tc);
        tile_nt<D>(dp, Vs, dOs, tr, tc);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < G::SC; ++c) {
            const int jr = tr * 4 + r, i = tc + c * G::TC, at = jr * G::LS + i;
            const bool ok = allowed(a, i0 + i, j0 + jr, use_seg, use_seg ? seg_q[i] : 0,
                                    use_seg ? seg_k[jr] : 0);
            const float p = expf((ok ? s[r][c] * a.scale : -INFINITY) - lse_s[i]);
            Pt[at] = round_to<T>(p);
            dSt[at] = round_to<T>(p * (dp[r][c] - delta_s[i]));
          }
        __syncthreads();
        tile_nn<D>(dv_acc, Pt, dOs, tr, tc);
        tile_nn<D>(dk_acc, dSt, Qs, tr, tc);
      }
    }
  }
  store_tile<T, D>(dk + kv_off, kv_rs, dk_acc, a.scale, tr, tc);
  store_tile<T, D>(dv + kv_off, kv_rs, dv_acc, 1.f, tr, tc);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, const float* lse,
                   const float* delta, const void* dout, const int* idsT, const int* countsT,
                   void* dk, void* dv, const Args& a, cudaStream_t stream) {
  using G = Geo<D>;
  const size_t smem = 4 * G::kTile + 2 * G::kScore;
  auto kernel = dkdv_kernel<T, D>;
  cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.S / G::BR, a.B * a.Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg, lse,
      delta, static_cast<const T*>(dout), idsT, countsT, static_cast<T*>(dk),
      static_cast<T*>(dv), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* seg,
                     const float* lse, const float* delta, const void* dout, const int* idsT,
                     const int* countsT, void* dk, void* dv, const Args& a, cudaStream_t stream) {
  FLASH_DISPATCH_D(D, return launch<T, kD>(q, k, v, seg, lse, delta, dout, idsT, countsT, dk, dv,
                                           a, stream);)
}

// ---- bf16, D in {64, 128}: tensor cores ------------------------------------

// R = 64·NWG key rows a block; nst cp.async stages of one q tile each.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
dkdv_tc_kernel(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
               const tc::bf16* __restrict__ v, const int* __restrict__ seg,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const tc::bf16* __restrict__ dout, const int* __restrict__ idsT,
               const int* __restrict__ countsT, tc::bf16* __restrict__ dk,
               tc::bf16* __restrict__ dv, Args a, int nst) {
  using namespace tc;
  constexpr int R = NWG * 64, NT = NWG * 128, NO = D / 2;
  constexpr uint32_t kTileQ = 64 * D * 2;  // a [64, D] bf16 tile
  // Q [64, D], dO [64, D], lse [64], δ [64], segment ids [64]
  constexpr uint32_t kStage = round1k(2 * kTileQ + 3 * 64 * 4);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sK = aligned_base(smem_raw, &sm);  // [R, D]
  const uint32_t sV = sK + R * D * 2;               // [R, D]
  const uint32_t sStage = sV + R * D * 2;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int bkh = blockIdx.x, b = bkh / a.Hkv, kh = bkh - b * a.Hkv, rep = a.H / a.Hkv;
  const int j0 = blockIdx.y * R, kvb = j0 / a.block_kv, jw = j0 + 64 * wg;
  const long long q_rs = (long long)a.H * D, kv_rs = (long long)a.Hkv * D;
  const long long kv_off = (((long long)b * a.S + j0) * a.Hkv + kh) * D;
  const bool use_seg = seg != nullptr;
  const long long lat = (long long)b * a.nkv() + kvb;
  const int count = countsT[lat];
  const int* blocks = idsT + lat * a.nq();
  const int nsub = a.block_q / 64, per = rep * nsub, n_items = count * per;

  cp_tile<D, NT>(sK, R, k + kv_off, kv_rs, tid);
  cp_tile<D, NT>(sV, R, v + kv_off, kv_rs, tid);
  cp_commit();
  // item n: q block blocks[n / per], group member (n % per) / nsub, q tile n % nsub
  auto item_rows = [&](int n, int* h) {
    const int tq = n / per, rem = n - tq * per;
    *h = kh * rep + rem / nsub;
    return blocks[tq] * a.block_q + (rem % nsub) * 64;
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
  const int r0 = jw + acc_row(t, 0), r1 = r0 + 8;
  const int sk0 = use_seg ? seg[(long long)b * a.S + r0] : 0;
  const int sk1 = use_seg ? seg[(long long)b * a.S + r1] : 0;
  const float sl2 = a.scale * kLog2e;
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
    const float* delta_s = lse_s + 64;
    const int* segq = reinterpret_cast<const int*>(lse_s + 128);
    const bool empty = (a.causal && jw > i0 + 63) ||
                       (a.window > 0 && i0 - (jw + 63) >= a.window);
    if (!empty) {  // warpgroup-uniform
      const bool masked = use_seg || (a.causal && jw + 63 > i0) ||
                          (a.window > 0 && i0 + 63 - jw >= a.window);
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<64>::ss(s, desc_k(sK, R, 64 * wg, kk), desc_k(sQ, 64, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<64>::ss(dp, desc_k(sV, R, 64 * wg, kk), desc_k(sdO, 64, 0, kk), kk);
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
          const int r = (e & 1) ? r1 : r0, sk = (e & 1) ? sk1 : sk0;
          const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
          float p_lo = exp2f(fmaf(s[i], sl2, -ls.x * kLog2e));
          float p_hi = exp2f(fmaf(s[i + 1], sl2, -ls.y * kLog2e));
          if (masked) {
            if (!allowed(a, i0 + c, r, use_seg, use_seg ? segq[c] : 0, sk)) p_lo = 0.f;
            if (!allowed(a, i0 + c + 1, r, use_seg, use_seg ? segq[c + 1] : 0, sk)) p_hi = 0.f;
          }
          // p.astype(bf16) and ds.astype(bf16), ds = p (dp - δ) from the unrounded p
          pf[kk][e] = pack_bf16(p_lo, p_hi);
          df[kk][e] = pack_bf16(p_lo * (dp[i] - dl.x), p_hi * (dp[i + 1] - dl.y));
        }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Mma<D>::rs(dva, pf[kk], desc_mn(sdO, 64, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Mma<D>::rs(dka, df[kk], desc_mn(sQ, 64, 0, kk), 1);
      wg_commit();
      wg_wait_all();
      hold(dva);
      hold(dka);
      hold(pf);
      hold(df);
    }
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] *= a.scale;
  const long long wg_off = kv_off + 64LL * wg * kv_rs;
  store_acc<D>(dk + wg_off, kv_rs, dka, t);
  store_acc<D>(dv + wg_off, kv_rs, dva, t);
}

template <int D, int NWG>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* seg,
                      const float* lse, const float* delta, const void* dout, const int* idsT,
                      const int* countsT, void* dk, void* dv, const Args& a,
                      cudaStream_t stream) {
  constexpr uint32_t stage = tc::round1k(2 * 64 * D * 2 + 3 * 64 * 4);
  constexpr uint32_t fixed = tc::kAlignSlack + 2 * NWG * 64 * D * 2;
  const int nst = fixed + 3 * stage <= tc::kMaxSmem ? 3 : 2;
  const size_t smem = fixed + nst * stage;
  auto kernel = dkdv_tc_kernel<D, NWG>;
  cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hkv, a.S / (NWG * 64));
  kernel<<<grid, NWG * 128, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), seg, lse, delta, static_cast<const tc::bf16*>(dout), idsT,
      countsT, static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv), a, nst);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc_d(const void* q, const void* k, const void* v, const int* seg,
                        const float* lse, const float* delta, const void* dout, const int* idsT,
                        const int* countsT, void* dk, void* dv, const Args& a, cudaStream_t s) {
  if (a.block_q % 64 || a.block_kv % 64) return cudaErrorInvalidValue;
  if (a.block_kv % 128 == 0)
    return launch_tc<D, 2>(q, k, v, seg, lse, delta, dout, idsT, countsT, dk, dv, a, s);
  return launch_tc<D, 1>(q, k, v, seg, lse, delta, dout, idsT, countsT, dk, dv, a, s);
}

}  // namespace flash

// q, dout [B,S,H,D]; k, v, dk, dv [B,S,Hkv,D] (dtype: 0 f32, 1 bf16; all
// contiguous, 16-byte aligned); seg [B,S] int32 or null; lse and delta
// [B,H,S] f32; idsT [B, S/block_kv, S/block_q] and countsT [B, S/block_kv]
// int32 (the transposed lattice). D in {64, 128, 256}; block_q, block_kv
// multiples of 64, at most 256, dividing S; window 0 for none. Returns the
// launch's cudaError_t (0 on success).
// bf16 at D = 64 and 128 goes to the tensor-core kernel, f32 and D = 256
// to the CUDA-core one.
extern "C" int flash_dkdv_launch(const void* q, const void* k, const void* v, const void* seg,
                                 const void* lse, const void* delta, const void* dout,
                                 const void* idsT, const void* countsT, void* dk, void* dv, int B,
                                 int S, int H, int Hkv, int D, int dtype, int causal, int window,
                                 int block_q, int block_kv, float scale, void* stream) {
  using namespace flash;
  const Args a{B, S, H, Hkv, causal, window, block_q, block_kv, scale};
  if (!args_ok(a, br_of(D))) return cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* id = static_cast<const int*>(idsT);
  const int* ct = static_cast<const int*>(countsT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == paged::kBF16 && D == 64)
    return launch_tc_d<64>(q, k, v, sg, l, dl, dout, id, ct, dk, dv, a, s);
  if (dtype == paged::kBF16 && D == 128)
    return launch_tc_d<128>(q, k, v, sg, l, dl, dout, id, ct, dk, dv, a, s);
  if (dtype == paged::kF32)
    return launch_d<float>(D, q, k, v, sg, l, dl, dout, id, ct, dk, dv, a, s);
  if (dtype == paged::kBF16 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, sg, l, dl, dout, id, ct, dk, dv, a, s);
  return cudaErrorInvalidValue;
}
