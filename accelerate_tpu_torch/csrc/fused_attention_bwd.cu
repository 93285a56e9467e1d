// Fused short-sequence attention, backward, for Hopper.
//
// Replaces: accelerate_tpu/ops/fused_attention.py `_bwd_kernel` (launched by
// `_fused_bwd` through pl.pallas_call), the Pallas TPU kernel that
// recomputes P from the saved logsumexp over a batch block x all heads and
// forms dv = Pᵀ dO, dp = dO Vᵀ, δ = Σ dO·O, ds = P (dp − δ), dq = ds K·scale
// and dk = dsᵀ Q·scale in one grid step; the JAX wrapper then sums dk/dv
// over the q heads of each GQA group.
//
// What bounds it: bytes. At BERT-base's shape (B=32, S=128, H=12, D=64,
// bf16) it must read q, k, v, o, dO and lse and write dq, dk, dv: ≈ 50.5 MB,
// 15 µs at 3.35 TB/s, against five products of 2·B·H·S²·D = 4.0 GFLOP,
// 4.1 µs at the bf16 tensor-core peak.
//
// What the design does about it, for now simply:
// - The TPU kernel sums dk and dv over every query inside one grid step.
//   Hopper blocks run in no order, so instead of atomics there are two
//   passes, both launched here, one after the other on the caller's stream:
//   * dq pass, grid (B·H, S/BR): a block owns BR query rows of one head,
//     computes δ for them from the stored output (kept in a scratch buffer
//     for the next pass), walks the key tiles and accumulates dq in f32;
//   * dk/dv pass, grid (B·Hkv, S/BR): a block owns BR key rows of one kv
//     head, walks every query tile of every q head of its GQA group and
//     accumulates dk and dv in f32 registers — the GQA fold happens here,
//     in f32, and dk/dv leave the kernel as [B, S, Hkv, D].
//   Both recompute P from lse. p and ds are rounded to the input dtype
//   before their products, as the TPU kernel does; causal tiles that are
//   wholly masked are skipped (their p and ds are exactly 0).
// - BSHD in and out through strides; products on CUDA-core f32 FMA
//   (fused_common.cuh). Later work: mma/wgmma tiles in bf16, TMA loads.
#include "fused_common.cuh"

namespace fused {

// masked, scaled scores A·Bᵀ of rows (a0 + tr*4 + r) x columns (b0 + tc +
// c*TC); `a_is_query` says which side holds the query positions
template <int D>
__device__ __forceinline__ void masked_scores(float (&s)[4][Geo<D>::SC], const float* A,
                                              const float* B, const int* seg_a, const int* seg_b,
                                              bool use_seg, int causal, bool a_is_query, int a0,
                                              int b0, float scale, int tr, int tc) {
  using G = Geo<D>;
  tile_nt<D>(s, A, B, tr, tc);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::SC; ++c) {
      const int ia = tr * 4 + r, ib = tc + c * G::TC;
      const int qpos = a_is_query ? a0 + ia : b0 + ib, kpos = a_is_query ? b0 + ib : a0 + ia;
      const bool ok = (!use_seg || seg_a[ia] == seg_b[ib]) && (!causal || qpos >= kpos);
      s[r][c] = ok ? s[r][c] * scale : kNegInf;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const int* __restrict__ seg, const float* __restrict__ lse, const T* __restrict__ out,
          const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ delta, int S, int H,
          int Hkv, int causal, float scale) {
  using G = Geo<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [BR, LD] this block's query rows
  float* dOs = Qs + G::BR * G::LD;   // [BR, LD] their output gradient
  float* Ks = dOs + G::BR * G::LD;   // [BR, LD] current key tile
  float* Vs = Ks + G::BR * G::LD;    // [BR, LD] current value tile
  float* dSs = Vs + G::BR * G::LD;   // [BR, LS] rounded ds of the current tile
  __shared__ int seg_q[G::BR], seg_k[G::BR];
  __shared__ float lse_s[G::BR], delta_s[G::BR];

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, kh = h / (H / Hkv);
  const int i0 = blockIdx.y * G::BR;
  const int tr = threadIdx.x / G::TC, tc = threadIdx.x % G::TC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q_rs = (long long)H * D, kv_rs = (long long)Hkv * D;
  const long long q_off = (((long long)b * S + i0) * H + h) * D;
  const T* k_base = k + ((long long)b * S * Hkv + kh) * D;
  const T* v_base = v + ((long long)b * S * Hkv + kh) * D;
  const bool use_seg = seg != nullptr;

  load_tile<T, D>(Qs, q + q_off, q_rs);
  load_tile<T, D>(dOs, dout + q_off, q_rs);
  if (threadIdx.x < G::BR) {
    if (use_seg) seg_q[threadIdx.x] = seg[(long long)b * S + i0 + threadIdx.x];
    lse_s[threadIdx.x] = lse[(long long)bh * S + i0 + threadIdx.x];
  }
  __syncthreads();
  // δ_i = Σ_d dO·O in f32, from the output as stored: one warp per row
  for (int i = warp; i < G::BR; i += kThreads / 32) {
    const T* o_row = out + q_off + i * q_rs;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(dOs[i * G::LD + d], to_f32(o_row[d]), acc);
    acc = paged::warp_sum(acc);
    if (lane == 0) {
      delta_s[i] = acc;
      delta[(long long)bh * S + i0 + i] = acc;
    }
  }

  float acc[4][G::DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::DC; ++c) acc[r][c] = 0.f;
  const int n_kv = causal ? i0 / G::BR + 1 : S / G::BR;
  for (int t = 0; t < n_kv; ++t) {
    const int j0 = t * G::BR;
    __syncthreads();  // every thread is done with the previous tile (and δ is in place)
    load_tile<T, D>(Ks, k_base + j0 * kv_rs, kv_rs);
    load_tile<T, D>(Vs, v_base + j0 * kv_rs, kv_rs);
    if (use_seg && threadIdx.x < G::BR)
      seg_k[threadIdx.x] = seg[(long long)b * S + j0 + threadIdx.x];
    __syncthreads();
    float s[4][G::SC], dp[4][G::SC];
    masked_scores<D>(s, Qs, Ks, seg_q, seg_k, use_seg, causal, true, i0, j0, scale, tr, tc);
    tile_nt<D>(dp, dOs, Vs, tr, tc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < G::SC; ++c) {
        const int i = tr * 4 + r;
        const float p = expf(s[r][c] - lse_s[i]);
        dSs[i * G::LS + tc + c * G::TC] = round_to<T>(p * (dp[r][c] - delta_s[i]));
      }
    __syncthreads();
    tile_nn<D>(acc, dSs, Ks, tr, tc);
  }
  store_tile<T, D>(dq + q_off, q_rs, acc, scale, tr, tc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ seg, const float* __restrict__ lse,
            const T* __restrict__ dout, const float* __restrict__ delta, T* __restrict__ dk,
            T* __restrict__ dv, int S, int H, int Hkv, int causal, float scale) {
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

  const int bkh = blockIdx.x, b = bkh / Hkv, kh = bkh - b * Hkv, rep = H / Hkv;
  const int j0 = blockIdx.y * G::BR;
  const int tr = threadIdx.x / G::TC, tc = threadIdx.x % G::TC;
  const long long q_rs = (long long)H * D, kv_rs = (long long)Hkv * D;
  const long long kv_off = (((long long)b * S + j0) * Hkv + kh) * D;
  const bool use_seg = seg != nullptr;

  load_tile<T, D>(Ks, k + kv_off, kv_rs);
  load_tile<T, D>(Vs, v + kv_off, kv_rs);
  if (use_seg && threadIdx.x < G::BR) seg_k[threadIdx.x] = seg[(long long)b * S + j0 + threadIdx.x];

  float dk_acc[4][G::DC], dv_acc[4][G::DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  const int t_first = causal ? j0 / G::BR : 0;  // earlier query tiles see none of these keys
  for (int h = kh * rep; h < (kh + 1) * rep; ++h) {
    for (int t = t_first; t < S / G::BR; ++t) {
      const int i0 = t * G::BR;
      const long long q_off = (((long long)b * S + i0) * H + h) * D;
      const long long row_off = ((long long)b * H + h) * S + i0;
      __syncthreads();  // every thread is done with the previous tile
      load_tile<T, D>(Qs, q + q_off, q_rs);
      load_tile<T, D>(dOs, dout + q_off, q_rs);
      if (threadIdx.x < G::BR) {
        if (use_seg) seg_q[threadIdx.x] = seg[(long long)b * S + i0 + threadIdx.x];
        lse_s[threadIdx.x] = lse[row_off + threadIdx.x];
        delta_s[threadIdx.x] = delta[row_off + threadIdx.x];
      }
      __syncthreads();
      float s[4][G::SC], dp[4][G::SC];
      masked_scores<D>(s, Ks, Qs, seg_k, seg_q, use_seg, causal, false, j0, i0, scale, tr, tc);
      tile_nt<D>(dp, Vs, dOs, tr, tc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < G::SC; ++c) {
          const int i = tc + c * G::TC, at = (tr * 4 + r) * G::LS + i;
          const float p = expf(s[r][c] - lse_s[i]);
          Pt[at] = round_to<T>(p);
          dSt[at] = round_to<T>(p * (dp[r][c] - delta_s[i]));
        }
      __syncthreads();
      tile_nn<D>(dv_acc, Pt, dOs, tr, tc);
      tile_nn<D>(dk_acc, dSt, Qs, tr, tc);
    }
  }
  store_tile<T, D>(dk + kv_off, kv_rs, dk_acc, scale, tr, tc);
  store_tile<T, D>(dv + kv_off, kv_rs, dv_acc, 1.f, tr, tc);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg,
                   const float* lse, const void* out, const void* dout, void* dq, void* dk,
                   void* dv, float* delta, int B, int S, int H, int Hkv, int causal, float scale,
                   cudaStream_t stream) {
  using G = Geo<D>;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  const size_t smem_dq = 4 * G::kTile + G::kScore;
  auto dq_k = dq_kernel<T, D>;
  cudaError_t err = paged::allow_smem(dq_k, smem_dq);
  if (err != cudaSuccess) return err;
  dq_k<<<dim3(B * H, S / G::BR), kThreads, smem_dq, stream>>>(
      qt, kt, vt, seg, lse, static_cast<const T*>(out), dot, static_cast<T*>(dq), delta, S, H,
      Hkv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_kv = 4 * G::kTile + 2 * G::kScore;
  auto kv_k = dkdv_kernel<T, D>;
  err = paged::allow_smem(kv_k, smem_kv);
  if (err != cudaSuccess) return err;
  kv_k<<<dim3(B * Hkv, S / G::BR), kThreads, smem_kv, stream>>>(
      qt, kt, vt, seg, lse, dot, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* seg,
                     const float* lse, const void* out, const void* dout, void* dq, void* dk,
                     void* dv, float* delta, int B, int S, int H, int Hkv, int causal,
                     float scale, cudaStream_t stream) {
  FUSED_DISPATCH_D(D, return launch<T, kD>(q, k, v, seg, lse, out, dout, dq, dk, dv, delta, B, S,
                                           H, Hkv, causal, scale, stream);)
}

}  // namespace fused

// q, out, dout, dq [B,S,H,D]; k, v, dk, dv [B,S,Hkv,D] (dtype: 0 f32, 1
// bf16; all contiguous, 16-byte aligned); seg [B,S] int32 or null; lse and
// the scratch delta [B,H,S] f32. S % 128 == 0, S <= 1024, D in {64, 128,
// 192, 256}, H % Hkv == 0. Launches the dq pass then the dk/dv pass; returns
// the first failing launch's cudaError_t (0 on success).
extern "C" int fused_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* seg, const void* lse, const void* out,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          void* delta, int B, int S, int H, int Hkv, int D,
                                          int dtype, int causal, float scale, void* stream) {
  using namespace fused;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || S % 128 != 0 || S > 1024)
    return cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == paged::kF32)
    return launch_d<float>(D, q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv, causal,
                           scale, s);
  if (dtype == paged::kBF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv,
                                   causal, scale, s);
  return cudaErrorInvalidValue;
}
