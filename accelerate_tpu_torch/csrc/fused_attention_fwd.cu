// Fused short-sequence attention, forward, for Hopper.
//
// Replaces: accelerate_tpu/ops/fused_attention.py `_fwd_kernel` (launched by
// `_fused_fwd` through pl.pallas_call), the Pallas TPU kernel that holds a
// batch block x all heads x the whole S x S score block in VMEM and computes
// QKᵀ → segment/causal mask (NEG_INF = -1e30) → the exact row max → p =
// exp(s - m), l = Σp from the unrounded p → (bf16(p) V) / l in one pass,
// writing O and the row logsumexp m + log l.
//
// What bounds it: bytes. At BERT-base's shape (B=32, S=128, H=12, D=64,
// bf16) it must read q, k, v and write o (6.3 MB each) and the f32 lse:
// ≈ 25.4 MB, 7.6 µs at 3.35 TB/s, against 4·B·H·S²·D = 1.61 GFLOP, 1.6 µs
// at the bf16 tensor-core peak.
//
// What the design does about it: two variants, chosen by the launcher
// from dtype and head dim. Both read q, k, v and write o in the public
// BSHD layout through strides (GQA: kv head h / (H/Hkv)), and both keep
// the TPU kernel's rounding exactly: the exact row max first, p rounded to
// the value type before P V, the division after — an online softmax, as in
// the flash forward, would round p against a running max instead.
//
// bf16 and fp16 at D in {64, 128} (every training path): tensor cores,
// one kernel template over the 16-bit element type E — the wgmma input
// type and the rounding of p and of the output change, nothing else.
// - One warpgroup (128 threads, so 2-3 blocks share an SM) owns 64 query
//   rows of one (b, h): grid (S/64, B·H). Q is copied once into a swizzled
//   bf16 tile (flash_tc.cuh); K and V tiles of KT keys (128 at D = 64, 64
//   at D = 128) come through a two-stage cp.async ring, the next tile in
//   flight while one computes.
// - S ≤ KT (BERT's S = 128): one pass. S = Q Kᵀ by wgmma gives the whole
//   64 x S score block in registers; scale, mask to NEG_INF, the exact row
//   max from the registers and two quad shuffles, p = exp(s - m), l from
//   the unrounded p, p rounded to E in place as the A fragment of O =
//   P V (register-A wgmma, V read transposed from shared memory), o / l.
// - KT < S ≤ 1024: two passes over the key tiles, both on wgmma. The first
//   takes the exact max (Q Kᵀ only, V not loaded), the second recomputes
//   the scores and accumulates P V. Causal key tiles past the query tile
//   are skipped: their p is exactly 0.
//
// f32, and bf16 or fp16 at D in {192, 256} (on no path): CUDA-core f32 FMA
// (fused_common.cuh), the same two passes over f32 tiles of BR rows in
// shared memory; grid (B·H, S/BR).
#include "flash_tc.cuh"
#include "fused_common.cuh"

namespace fused {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ seg, T* __restrict__ out, float* __restrict__ lse, int S,
           int H, int Hkv, int causal, float scale) {
  using G = Geo<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [BR, LD] this block's query rows
  float* KVs = Qs + G::BR * G::LD;  // [BR, LD] the current key tile, then its value tile
  float* Ps = KVs + G::BR * G::LD;  // [BR, LS] rounded p of the current tile
  __shared__ int seg_q[G::BR], seg_k[G::BR];

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, kh = h / (H / Hkv);
  const int i0 = blockIdx.y * G::BR;
  const int tr = threadIdx.x / G::TC, tc = threadIdx.x % G::TC;
  const long long q_rs = (long long)H * D, kv_rs = (long long)Hkv * D;
  const T* k_base = k + ((long long)b * S * Hkv + kh) * D;
  const T* v_base = v + ((long long)b * S * Hkv + kh) * D;

  load_tile<T, D>(Qs, q + (((long long)b * S + i0) * H + h) * D, q_rs);
  if (seg != nullptr && threadIdx.x < G::BR)
    seg_q[threadIdx.x] = seg[(long long)b * S + i0 + threadIdx.x];
  const int n_kv = causal ? i0 / G::BR + 1 : S / G::BR;

  // masked, scaled scores of query tile x key tile j0 into s
  auto scores = [&](float (&s)[4][G::SC], int j0) {
    tile_nt<D>(s, Qs, KVs, tr, tc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < G::SC; ++c) {
        const int i = tr * 4 + r, j = tc + c * G::TC;
        const bool ok = (seg == nullptr || seg_q[i] == seg_k[j]) && (!causal || i0 + i >= j0 + j);
        s[r][c] = ok ? s[r][c] * scale : kNegInf;
      }
  };
  auto load_keys = [&](int j0) {
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, D>(KVs, k_base + j0 * kv_rs, kv_rs);
    if (seg != nullptr && threadIdx.x < G::BR)
      seg_k[threadIdx.x] = seg[(long long)b * S + j0 + threadIdx.x];
    __syncthreads();
  };

  // pass 1: the row max over every key
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int t = 0; t < n_kv; ++t) {
    load_keys(t * G::BR);
    float s[4][G::SC];
    scores(s, t * G::BR);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < G::SC; ++c) m[r] = fmaxf(m[r], s[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = row_max<G::TC>(m[r]);

  // pass 2: p = exp(s - m); l = sum p; o = (round(p) V) / l
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float o[4][G::DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::DC; ++c) o[r][c] = 0.f;
  for (int t = 0; t < n_kv; ++t) {
    const int j0 = t * G::BR;
    load_keys(j0);
    float s[4][G::SC];
    scores(s, j0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < G::SC; ++c) {
        const float p = expf(s[r][c] - m[r]);
        l[r] += p;
        Ps[(tr * 4 + r) * G::LS + tc + c * G::TC] = round_to<T>(p);
      }
    __syncthreads();  // Ps complete, and nobody reads the key tile any more
    load_tile<T, D>(KVs, v_base + j0 * kv_rs, kv_rs);
    __syncthreads();
    tile_nn<D>(o, Ps, KVs, tr, tc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) l[r] = row_sum<G::TC>(l[r]);

  T* o_base = out + (((long long)b * S + i0) * H + h) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::DC; ++c)
      o_base[(tr * 4 + r) * q_rs + tc + c * G::TC] = from_f32<T>(o[r][c] / l[r]);
  if (tc == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) lse[(long long)bh * S + i0 + tr * 4 + r] = m[r] + logf(l[r]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* out,
                   float* lse, int B, int S, int H, int Hkv, int causal, float scale,
                   cudaStream_t stream) {
  using G = Geo<D>;
  const size_t smem = 2 * G::kTile + G::kScore;
  auto kernel = fwd_kernel<T, D>;
  cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, S / G::BR);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), seg, static_cast<T*>(out),
                                           lse, S, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* seg,
                     void* out, float* lse, int B, int S, int H, int Hkv, int causal, float scale,
                     cudaStream_t stream) {
  FUSED_DISPATCH_D(D, return launch<T, kD>(q, k, v, seg, out, lse, B, S, H, Hkv, causal, scale,
                                           stream);)
}

// ---- bf16 and fp16, D in {64, 128}: tensor cores ---------------------------

// One warpgroup: 64 query rows of one (b, h), key tiles of KT keys.
template <int D, int KT, typename E>
__global__ void __launch_bounds__(128)
fwd_tc_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
              const int* __restrict__ seg, E* __restrict__ out, float* __restrict__ lse, int S,
              int H, int Hkv, int causal, float scale) {
  using namespace tc;
  constexpr int NS = KT / 2, NO = D / 2;
  constexpr uint32_t kQ = 64 * D * 2, kKV = KT * D * 2;  // 16-bit tiles [64, D], [KT, D]
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sQ = aligned_base(smem_raw, &sm);  // [64, D]
  const uint32_t sStage = sQ + kQ;                  // 2 x (K [KT, D], V [KT, D])
  const uint32_t sSeg = sStage + 4 * kKV;           // 2 x [KT] int32 segment ids of the keys

  const int t = threadIdx.x;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, kh = h / (H / Hkv);
  const int i0 = qt * 64;
  const long long q_rs = (long long)H * D, kv_rs = (long long)Hkv * D;
  const E* k_base = k + ((long long)b * S * Hkv + kh) * D;
  const E* v_base = v + ((long long)b * S * Hkv + kh) * D;
  const bool use_seg = seg != nullptr;
  // key tiles this query tile attends; with one, a single pass, else the
  // max pass (items 0 .. n-1) then the P V pass (items n .. 2n-1)
  const int n = causal ? min(S / KT, (i0 + 63) / KT + 1) : S / KT;
  const int n_max = n == 1 ? 0 : n, n_items = n_max + n;

  auto issue = [&](int it) {  // item it into stage it % 2
    const int j0 = (it < n_max ? it : it - n_max) * KT;
    const uint32_t st = sStage + (it & 1) * 2 * kKV;
    cp_tile<D, 128>(st, KT, k_base + j0 * kv_rs, kv_rs, t);
    if (it >= n_max) cp_tile<D, 128>(st + kKV, KT, v_base + j0 * kv_rs, kv_rs, t);
    if (use_seg) cp_words<128>(sSeg + (it & 1) * KT * 4, seg + (long long)b * S + j0, KT, t);
  };
  cp_tile<D, 128>(sQ, 64, q + (((long long)b * S + i0) * H + h) * D, q_rs, t);
  issue(0);
  cp_commit();

  // this thread's two query rows: r0 for the even register pairs, r1 = r0 + 8
  const int r0 = i0 + acc_row(t, 0), r1 = r0 + 8;
  const int sq0 = use_seg ? seg[(long long)b * S + r0] : 0;
  const int sq1 = use_seg ? seg[(long long)b * S + r1] : 0;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, o[NO], sacc[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    cp_wait(0);
    fence_async_smem();
    __syncthreads();  // item it landed for every thread; the other stage is free
    if (it + 1 < n_items) issue(it + 1);
    cp_commit();
    const uint32_t sK = sStage + (it & 1) * 2 * kKV, sV = sK + kKV;
    const int* segk = reinterpret_cast<const int*>(sm + (sSeg - sQ) + (it & 1) * KT * 4);
    const int j0 = (it < n_max ? it : it - n_max) * KT;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<KT, E>::ss(sacc, desc_k(sQ, 64, 0, kk), desc_k(sK, KT, 0, kk), kk);
    wg_commit();
    wg_wait_all();
    hold(sacc);
    // scale·s, NEG_INF where the segment or causal mask shuts the pair out
    const bool masked = use_seg || (causal && j0 + KT - 1 > i0);
    float mb0 = -INFINITY, mb1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const bool hi = (i >> 1) & 1;
      float x = sacc[i] * scale;
      if (masked) {
        const int j = acc_col(t, i);
        if ((use_seg && (hi ? sq1 : sq0) != segk[j]) || (causal && j0 + j > (hi ? r1 : r0)))
          x = kNegInf;
      }
      sacc[i] = x;
      if (hi) mb1 = fmaxf(mb1, x);
      else mb0 = fmaxf(mb0, x);
    }
    if (it < n_max) {  // the max pass
      m0 = fmaxf(m0, mb0);
      m1 = fmaxf(m1, mb1);
      continue;
    }
    if (it == n_max) {  // the exact row max, over the quad that shares the row
      m0 = quad_max(fmaxf(m0, mb0));
      m1 = quad_max(fmaxf(m1, mb1));
    }
    uint32_t pf[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;  // row r0 for e even, r1 for e odd
        const float m = (e & 1) ? m1 : m0;
        const float pa = exp2f((sacc[i] - m) * kLog2e), pb = exp2f((sacc[i + 1] - m) * kLog2e);
        if (e & 1) l1 += pa + pb;
        else l0 += pa + pb;
        pf[kk][e] = pack2<E>(pa, pb);  // p.astype(E)
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) Mma<D, E>::rs(o, pf[kk], desc_mn(sV, KT, 0, kk), 1);
    wg_commit();
    wg_wait_all();
    hold(o);
    hold(pf);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] /= ((i >> 1) & 1) ? l1 : l0;
  store_acc<D>(out + (((long long)b * S + i0) * H + h) * D, q_rs, o, t);
  if ((t & 3) == 0) {
    lse[(long long)bh * S + r0] = m0 + logf(l0);
    lse[(long long)bh * S + r1] = m1 + logf(l1);
  }
}

template <int D, int KT, typename E>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* seg, void* out,
                      float* lse, int B, int S, int H, int Hkv, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = tc::kAlignSlack + 64 * D * 2 + 4 * KT * D * 2 + 2 * KT * 4;
  auto kernel = fwd_tc_kernel<D, KT, E>;
  cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(S / 64, B * H), 128, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), seg,
      static_cast<E*>(out), lse, S, H, Hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace fused

// q, out [B,S,H,D]; k, v [B,S,Hkv,D] (dtype: 0 f32, 1 bf16, 2 fp16; all
// contiguous, 16-byte aligned); seg [B,S] int32 or null; lse [B,H,S] f32.
// S % 128 == 0, S <= 1024, D in {64, 128, 192, 256}, H % Hkv == 0. Returns
// the launch's cudaError_t (0 on success). bf16 and fp16 at D = 64 and 128
// go to the tensor-core kernel, f32 and D = 192, 256 to the CUDA-core one.
extern "C" int fused_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          const void* seg, void* out, void* lse, int B, int S,
                                          int H, int Hkv, int D, int dtype, int causal,
                                          float scale, void* stream) {
  using namespace fused;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || S % 128 != 0 || S > 1024)
    return cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == paged::kBF16 && D == 64)
    return launch_tc<64, 128, tc::bf16>(q, k, v, sg, out, l, B, S, H, Hkv, causal, scale, s);
  if (dtype == paged::kBF16 && D == 128)
    return launch_tc<128, 64, tc::bf16>(q, k, v, sg, out, l, B, S, H, Hkv, causal, scale, s);
  if (dtype == paged::kF16 && D == 64)
    return launch_tc<64, 128, tc::f16>(q, k, v, sg, out, l, B, S, H, Hkv, causal, scale, s);
  if (dtype == paged::kF16 && D == 128)
    return launch_tc<128, 64, tc::f16>(q, k, v, sg, out, l, B, S, H, Hkv, causal, scale, s);
  if (dtype == paged::kF32)
    return launch_d<float>(D, q, k, v, sg, out, l, B, S, H, Hkv, causal, scale, s);
  if (dtype == paged::kBF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, sg, out, l, B, S, H, Hkv, causal, scale, s);
  if (dtype == paged::kF16)
    return launch_d<__half>(D, q, k, v, sg, out, l, B, S, H, Hkv, causal, scale, s);
  return cudaErrorInvalidValue;
}
