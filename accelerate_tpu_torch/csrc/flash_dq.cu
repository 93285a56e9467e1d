// Blocked flash attention, dq pass of the backward, for Hopper.
//
// Replaces: accelerate_tpu/ops/flash_attention.py `_flash_dq_kernel`
// (launched by `_flash_call_bwd` through pl.pallas_call), the Pallas TPU
// kernel that walks the forward's block lattice again, recomputes
// p = exp(s - lse) from the saved logsumexp, forms ds = p (dO Vᵀ - δ) and
// accumulates dq = Σ ds K · scale in VMEM.
//
// What bounds it: operations. At the Llama long-context shape (B=1,
// S=8192, H=16, Hkv=8, D=64, causal, bf16): three products over ≈ 537 M
// attended pairs, 6·D flops each — 206 GFLOP, 0.21 ms at the bf16
// tensor-core peak — against ≈ 33 MB of q, k, v, dO, lse, δ and dq.
//
// What the design does about it: two variants, chosen by the launcher
// from dtype and head dim. Both walk the q tile's own lattice row
// ids[b, qi, :counts[b, qi]] (skipped blocks are never read; GQA through
// the kv head's strides, no repeated KV), take δ = Σ dO·O from the caller
// (f32, [B, H, S], formed before this pass because the dk/dv pass needs it
// too), round ds to the key dtype before ds K as the TPU kernel does and
// apply the scale once to the f32 sum (the TPU kernel applies it to each
// block's product: the same value up to f32 rounding).
//
// bf16 at D in {64, 128} (every training path): tensor cores, dq_tc_kernel
// in flash_bwd_tc.cuh — S = Q Kᵀ and dP = dO Vᵀ by wgmma, ds rounded in
// registers as the A fragment of dQ += dS K, Q and dO resident in shared
// memory, K and V through a cp.async ring.
//
// f32, and D = 256 (on no path): CUDA-core f32 FMA (fused_common.cuh), one
// block of BR query rows walking the kv blocks in tiles of BR keys with ds
// staged in shared memory.
#include "flash_common.cuh"
#include "flash_bwd_tc.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const int* __restrict__ seg, const float* __restrict__ lse,
          const float* __restrict__ delta, const T* __restrict__ dout,
          const int* __restrict__ ids, const int* __restrict__ counts, T* __restrict__ dq,
          Args a) {
  using G = Geo<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [BR, LD] this block's query rows
  float* dOs = Qs + G::BR * G::LD;   // [BR, LD] their output gradient
  float* Ks = dOs + G::BR * G::LD;   // [BR, LD] current key tile
  float* Vs = Ks + G::BR * G::LD;    // [BR, LD] current value tile
  float* dSs = Vs + G::BR * G::LD;   // [BR, LS] rounded ds of the current tile
  __shared__ int seg_q[G::BR], seg_k[G::BR];
  __shared__ float lse_s[G::BR], delta_s[G::BR];

  const int qt = gridDim.x - 1 - blockIdx.x;  // later query tiles attend more keys: start them first
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H, kh = h / (a.H / a.Hkv);
  const int i0 = qt * G::BR, qi = i0 / a.block_q;
  const int tr = threadIdx.x / G::TC, tc = threadIdx.x % G::TC;
  const long long q_rs = (long long)a.H * D, kv_rs = (long long)a.Hkv * D;
  const long long q_off = (((long long)b * a.S + i0) * a.H + h) * D;
  const T* k_base = k + ((long long)b * a.S * a.Hkv + kh) * D;
  const T* v_base = v + ((long long)b * a.S * a.Hkv + kh) * D;
  const bool use_seg = seg != nullptr;

  load_tile<T, D>(Qs, q + q_off, q_rs);
  load_tile<T, D>(dOs, dout + q_off, q_rs);
  if (threadIdx.x < G::BR) {
    if (use_seg) seg_q[threadIdx.x] = seg[(long long)b * a.S + i0 + threadIdx.x];
    lse_s[threadIdx.x] = lse[(long long)bh * a.S + i0 + threadIdx.x];
    delta_s[threadIdx.x] = delta[(long long)bh * a.S + i0 + threadIdx.x];
  }
  const long long lat = (long long)b * a.nq() + qi;
  const int count = counts[lat];
  const int* blocks = ids + lat * a.nkv();
  const int n_sub = a.block_kv / G::BR;

  float acc[4][G::DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::DC; ++c) acc[r][c] = 0.f;
  for (int t = 0; t < count; ++t) {
    for (int u = 0; u < n_sub; ++u) {
      const int j0 = blocks[t] * a.block_kv + u * G::BR;
      __syncthreads();  // every thread is done with the previous tile (and the row stats are in)
      load_tile<T, D>(Ks, k_base + j0 * kv_rs, kv_rs);
      load_tile<T, D>(Vs, v_base + j0 * kv_rs, kv_rs);
      if (use_seg && threadIdx.x < G::BR) seg_k[threadIdx.x] = seg[(long long)b * a.S + j0 + threadIdx.x];
      __syncthreads();
      float s[4][G::SC], dp[4][G::SC];
      tile_nt<D>(s, Qs, Ks, tr, tc);
      tile_nt<D>(dp, dOs, Vs, tr, tc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < G::SC; ++c) {
          const int i = tr * 4 + r, j = tc + c * G::TC;
          const bool ok = allowed(a, i0 + i, j0 + j, use_seg, use_seg ? seg_q[i] : 0,
                                  use_seg ? seg_k[j] : 0);
          const float p = expf((ok ? s[r][c] * a.scale : -INFINITY) - lse_s[i]);
          dSs[i * G::LS + j] = round_to<T>(p * (dp[r][c] - delta_s[i]));
        }
      __syncthreads();
      tile_nn<D>(acc, dSs, Ks, tr, tc);
    }
  }
  store_tile<T, D>(dq + q_off, q_rs, acc, a.scale, tr, tc);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, const float* lse,
                   const float* delta, const void* dout, const int* ids, const int* counts,
                   void* dq, const Args& a, cudaStream_t stream) {
  using G = Geo<D>;
  const size_t smem = 4 * G::kTile + G::kScore;
  auto kernel = dq_kernel<T, D>;
  cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.S / G::BR, a.B * a.H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg, lse,
      delta, static_cast<const T*>(dout), ids, counts, static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* seg,
                     const float* lse, const float* delta, const void* dout, const int* ids,
                     const int* counts, void* dq, const Args& a, cudaStream_t stream) {
  FLASH_DISPATCH_D(D, return launch<T, kD>(q, k, v, seg, lse, delta, dout, ids, counts, dq, a,
                                           stream);)
}

template <int D>
cudaError_t launch_tc_d(const void* q, const void* k, const void* v, const int* seg,
                        const float* lse, const float* delta, const void* dout, const int* ids,
                        const int* counts, void* dq, const Args& a, cudaStream_t s) {
  if (a.block_q % 64 || a.block_kv % 64) return cudaErrorInvalidValue;
  constexpr int KT = kDqTile<D>;
  float* dl = const_cast<float*>(delta);  // read only: the pass writes δ only when given out
  const bool kv128 = a.block_kv % 128 == 0;
  if (a.block_q % 128 == 0)
    return kv128 ? launch_dq_tc<D, 2, KT, false>(q, k, v, seg, lse, dl, dout, nullptr, ids,
                                                 counts, dq, a, s)
                 : launch_dq_tc<D, 2, 64, false>(q, k, v, seg, lse, dl, dout, nullptr, ids,
                                                 counts, dq, a, s);
  return kv128 ? launch_dq_tc<D, 1, KT, false>(q, k, v, seg, lse, dl, dout, nullptr, ids, counts,
                                               dq, a, s)
               : launch_dq_tc<D, 1, 64, false>(q, k, v, seg, lse, dl, dout, nullptr, ids, counts,
                                               dq, a, s);
}

}  // namespace flash

// q, dout, dq [B,S,H,D]; k, v [B,S,Hkv,D] (dtype: 0 f32, 1 bf16; all
// contiguous, 16-byte aligned); seg [B,S] int32 or null; lse and delta
// [B,H,S] f32; ids [B, S/block_q, S/block_kv] and counts [B, S/block_q]
// int32 (the forward's lattice). D in {64, 128, 256}; block_q, block_kv
// multiples of 64, at most 256, dividing S; window 0 for none. Returns the
// launch's cudaError_t (0 on success).
// bf16 at D = 64 and 128 goes to the tensor-core kernel, f32 and D = 256
// to the CUDA-core one.
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const void* seg,
                               const void* lse, const void* delta, const void* dout,
                               const void* ids, const void* counts, void* dq, int B, int S, int H,
                               int Hkv, int D, int dtype, int causal, int window, int block_q,
                               int block_kv, float scale, void* stream) {
  using namespace flash;
  const Args a{B, S, H, Hkv, causal, window, block_q, block_kv, scale};
  if (!args_ok(a, br_of(D))) return cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* id = static_cast<const int*>(ids);
  const int* ct = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == paged::kBF16 && D == 64)
    return launch_tc_d<64>(q, k, v, sg, l, dl, dout, id, ct, dq, a, s);
  if (dtype == paged::kBF16 && D == 128)
    return launch_tc_d<128>(q, k, v, sg, l, dl, dout, id, ct, dq, a, s);
  if (dtype == paged::kF32)
    return launch_d<float>(D, q, k, v, sg, l, dl, dout, id, ct, dq, a, s);
  if (dtype == paged::kBF16 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, sg, l, dl, dout, id, ct, dq, a, s);
  return cudaErrorInvalidValue;
}
