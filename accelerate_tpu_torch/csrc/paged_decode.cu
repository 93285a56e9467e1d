// Paged-attention decode (S = 1) for Hopper.
//
// Replaces: accelerate_tpu/ops/flash_attention.py `_paged_decode_kernel`
// (launched by `paged_attention_decode`), the Pallas TPU kernel that walks a
// row's block table over a (B, W) grid and streams each KV block through
// VMEM with an f32 online softmax.
//
// What bounds it: bytes. One query row per head does 4*D flops per key
// against 4*D bytes of bf16 K and V, about one flop per byte, far below the
// ~295 flops per byte where the H100's tensor cores would become the limit.
// The least time is the live KV bytes over 3.35 TB/s.
//
// What the design does about it: every live KV byte is read once.
// - Grid (B, Hkv): one block per (row, kv head). The G = H / Hkv query
//   heads of a GQA group are rows of the same block and share each KV block
//   loaded into shared memory; the TPU kernel's broadcast of K/V to all H
//   heads is not carried over.
// - The block reads its own table entries and kv_len, and walks only the
//   ceil(kv_len / block_size) live blocks; the dead tail is never loaded.
// - The walk is pipelined kStages deep: the next blocks' cp.async copies
//   are in flight while the current one is folded, so the HBM latency of
//   the dependent table -> KV loads is paid once per row, not per block.
// - Scores, softmax statistics and the accumulator are f32 (CUDA-core FMA);
//   the NaN-guarded shift matches the TPU kernel's.
// Later work: splitting long rows over several blocks (only B * Hkv blocks
// run, fewer than the card's 132 SMs at small batch), TMA, wider copies.
#include "paged_common.cuh"

namespace paged {

// NR = rows per warp: the G heads of the group are rows g = warp + r*kWarps.
template <typename TQ, typename TKV, int DPL, int NR>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ kv_lens, TQ* __restrict__ out, int H, int Hkv,
                    int bs, int W, float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  TKV* stages = reinterpret_cast<TKV*>(smem);
  float* Qs = reinterpret_cast<float*>(smem + kStages * Tile<TKV, D>::bytes(bs));  // [NR*kWarps, D]
  int* table_s = reinterpret_cast<int*>(Qs + NR * kWarps * D);                     // [W]
  const int b = blockIdx.x, kh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int kv_len = kv_lens[b];
  const int nblk = kv_len > 0 ? min((kv_len + bs - 1) / bs, W) : 0;
  // q is [B, 1, H, D]: the group's heads kh*G .. kh*G+G-1 are contiguous
  const TQ* qg = q + ((long long)b * H + (long long)kh * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) Qs[idx] = to_f32(qg[idx]) * scale;
  for (int w = threadIdx.x; w < nblk; w += blockDim.x) table_s[w] = tables[(long long)b * W + w];
  __syncthreads();

  RowState<DPL> st[NR];
  int limit[NR];  // every head of the group attends positions < kv_len
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    st[r].init();
    limit[r] = warp + r * kWarps < G ? kv_len - 1 : -1;
  }
  walk_blocks<TKV, D>(stages, k_pool, v_pool, table_s, nblk, kh, Hkv, bs,
                      [&](const TKV* Ks, const TKV* Vs, int w) {
                        fold_rows<TKV, DPL, NR>(st, Qs + warp * D, limit, Ks, Vs, bs, w * bs,
                                                lane);
                      });

#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int g = warp + r * kWarps;
    if (g < G) {
      TQ* o = out + ((long long)b * H + (long long)kh * G + g) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) o[lane + 32 * i] = from_f32<TQ>(st[r].acc[i] / st[r].l);
    }
  }
}

template <typename TQ, typename TKV, int DPL, int NR>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* kv_lens, void* out, int B, int H, int Hkv, int bs, int W,
                   float scale, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  const size_t smem = kStages * Tile<TKV, D>::bytes(bs) + sizeof(float) * (size_t)NR * kWarps * D +
                      sizeof(int) * (size_t)W;
  auto kernel = paged_decode_kernel<TQ, TKV, DPL, NR>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), tables,
      kv_lens, static_cast<TQ*>(out), H, Hkv, bs, W, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int DPL>
cudaError_t launch_r(const void* q, const void* k, const void* v, const int* tables,
                     const int* kv_lens, void* out, int B, int H, int Hkv, int bs, int W,
                     float scale, cudaStream_t stream) {
  const int G = H / Hkv;  // rows per warp: the fewest that hold the group
  if (G <= kWarps)
    return launch<TQ, TKV, DPL, 1>(q, k, v, tables, kv_lens, out, B, H, Hkv, bs, W, scale, stream);
  if (G <= 2 * kWarps)
    return launch<TQ, TKV, DPL, 2>(q, k, v, tables, kv_lens, out, B, H, Hkv, bs, W, scale, stream);
  return launch<TQ, TKV, DPL, 4>(q, k, v, tables, kv_lens, out, B, H, Hkv, bs, W, scale, stream);
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* tables,
                     const int* kv_lens, void* out, int B, int H, int Hkv, int bs, int W,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_r<TQ, TKV, 1>(q, k, v, tables, kv_lens, out, B, H, Hkv, bs, W, scale, stream);
    case 64: return launch_r<TQ, TKV, 2>(q, k, v, tables, kv_lens, out, B, H, Hkv, bs, W, scale, stream);
    case 128: return launch_r<TQ, TKV, 4>(q, k, v, tables, kv_lens, out, B, H, Hkv, bs, W, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace paged

// q [B,1,H,D] (q_dtype), pools [N,bs,Hkv,D] (kv_dtype), tables [B,W] int32,
// kv_lens [B] int32, out [B,1,H,D] (q_dtype); all contiguous on one device.
// Returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const void* tables, const void* kv_lens, void* out, int B,
                                   int H, int Hkv, int D, int block_size, int W, int q_dtype,
                                   int kv_dtype, float scale, void* stream) {
  using namespace paged;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxRows) return cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_d<float, float>(D, q, k_pool, v_pool, t, lens, out, B, H, Hkv, block_size, W, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, k_pool, v_pool, t, lens, out, B, H, Hkv,
                                                  block_size, W, scale, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch_d<float, __nv_bfloat16>(D, q, k_pool, v_pool, t, lens, out, B, H, Hkv,
                                          block_size, W, scale, s);
  return cudaErrorInvalidValue;
}
