// Fused short-sequence attention, forward, for Hopper.
//
// Replaces: accelerate_tpu/ops/fused_attention.py `_fwd_kernel` (launched by
// `_fused_fwd` through pl.pallas_call), the Pallas TPU kernel that holds a
// batch block x all heads x the whole S x S score block in VMEM and computes
// QKᵀ → segment/causal mask → softmax → PV in one pass, writing O and the
// row logsumexp.
//
// What bounds it: bytes. At BERT-base's shape (B=32, S=128, H=12, D=64,
// bf16) it must read q, k, v and write o (6.3 MB each) and the f32 lse:
// ≈ 25.4 MB, 7.6 µs at 3.35 TB/s, against 4·B·H·S²·D = 1.61 GFLOP, 1.6 µs
// at the bf16 tensor-core peak.
//
// What the design does about it, for now simply:
// - The S x S block does not fit a Hopper SM (12·1024²·4 bytes at S=1024),
//   so each block owns BR query rows of one (batch, head) — grid (B·H,
//   S/BR) — keeps its Q tile in shared memory and streams K and V tiles of
//   BR rows. q, k, v, o are read and written in the public BSHD layout
//   through strides: no transposes around the kernel.
// - Two passes over the key tiles: the first finds each row's exact max m,
//   the second forms p = exp(s - m), sums l from the unrounded p, rounds p
//   to the value dtype and accumulates PV in f32; o = PV / l. That is the
//   TPU kernel's rounding exactly (p rounded before PV, division after),
//   which an online softmax would not give. Causal key tiles past the
//   query tile's last row are skipped: their p is exactly 0.
// - Products on CUDA-core f32 FMA (fused_common.cuh). Later work: mma/wgmma
//   tiles in bf16 and TMA loads; the kernel is far from its byte bound.
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

}  // namespace fused

// q, out [B,S,H,D]; k, v [B,S,Hkv,D] (dtype: 0 f32, 1 bf16; all contiguous,
// 16-byte aligned); seg [B,S] int32 or null; lse [B,H,S] f32. S % 128 == 0,
// S <= 1024, D in {64, 128, 192, 256}, H % Hkv == 0. Returns the launch's
// cudaError_t (0 on success).
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
  if (dtype == paged::kF32)
    return launch_d<float>(D, q, k, v, sg, out, l, B, S, H, Hkv, causal, scale, s);
  if (dtype == paged::kBF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, sg, out, l, B, S, H, Hkv, causal, scale, s);
  return cudaErrorInvalidValue;
}
