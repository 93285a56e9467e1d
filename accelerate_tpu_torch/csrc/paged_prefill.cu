// Paged-attention chunked prefill (S > 1) for Hopper.
//
// Replaces: accelerate_tpu/ops/flash_attention.py `_paged_prefill_kernel`
// (launched by `paged_attention_prefill`), the Pallas TPU kernel that walks
// a row's block table over a (B, W) grid with an S-row chunk of queries and
// one mask, kv_pos <= q_position, covering in-chunk causality, KV landed by
// earlier chunks and null padding.
//
// What bounds it: operations. At the engine's chunk sizes (S = 128..256)
// each KV block is used by every query of the chunk, so the score and value
// products (4*D flops per query per attended key) outweigh the bytes; the
// least time is those flops over the card's peak for the input type.
//
// What the design does about it, for now simply:
// - Grid (B, H, ceil(S / kTileQ)) with a tile of kTileQ = 16 queries of one
//   head. The block streams its kv head's blocks through shared memory up
//   to the tile's largest q_position and each of the 4 warps folds them into
//   its 4 query rows with the per-query mask.
// - The walk is pipelined kStages deep (cp.async): later KV blocks are
//   copied while the current one is folded, and each warp folds its 4
//   query rows together, sharing every K and V read.
// - f32 accumulation on CUDA-core FMA, one key per lane; the NaN-guarded
//   online softmax matches the TPU kernel's.
// Later work: wgmma tiles over the GQA group (the KV block is read once per
// query head today, G times per kv head), TMA loads.
#include "paged_common.cuh"

namespace paged {

constexpr int kTileQ = kMaxRows;  // 16 query rows per block

template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                     const TKV* __restrict__ v_pool, const int* __restrict__ tables,
                     const int* __restrict__ q_positions, TQ* __restrict__ out, int S, int H,
                     int Hkv, int bs, int W, float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int qpos[kTileQ];
  TKV* stages = reinterpret_cast<TKV*>(smem);
  float* Qs = reinterpret_cast<float*>(smem + kStages * Tile<TKV, D>::bytes(bs));  // [kTileQ, D]
  int* table_s = reinterpret_cast<int*>(Qs + kTileQ * D);                    // [W]
  const int b = blockIdx.x, h = blockIdx.y, t0 = blockIdx.z * kTileQ;
  const int kh = h / (H / Hkv);
  const int nq = min(kTileQ, S - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // q is [B, S, H, D]: query t0 + i of head h
  for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
    const int i = idx / D, d = idx - i * D;
    Qs[idx] = to_f32(q[(((long long)b * S + t0 + i) * H + h) * D + d]) * scale;
  }
  if (threadIdx.x < nq) qpos[threadIdx.x] = q_positions[(long long)b * S + t0 + threadIdx.x];
  __syncthreads();
  int qmax = -1;
  for (int i = 0; i < nq; ++i) qmax = max(qmax, qpos[i]);
  const int nblk = qmax >= 0 ? min(qmax / bs + 1, W) : 0;
  for (int w = threadIdx.x; w < nblk; w += blockDim.x) table_s[w] = tables[(long long)b * W + w];
  __syncthreads();

  RowState<DPL> st[kMaxRowsPerWarp];
  int limit[kMaxRowsPerWarp];  // query i attends positions <= its own
#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r) {
    st[r].init();
    const int i = warp + r * kWarps;
    limit[r] = i < nq ? qpos[i] : -1;
  }
  walk_blocks<TKV, D>(stages, k_pool, v_pool, table_s, nblk, kh, Hkv, bs,
                      [&](const TKV* Ks, const TKV* Vs, int w) {
                        fold_rows<TKV, DPL, kMaxRowsPerWarp>(st, Qs + warp * D, limit, Ks, Vs,
                                                             bs, w * bs, lane);
                      });

#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r) {
    const int i = warp + r * kWarps;
    if (i < nq) {
      TQ* o = out + (((long long)b * S + t0 + i) * H + h) * D;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[lane + 32 * e] = from_f32<TQ>(st[r].acc[e] / st[r].l);
    }
  }
}

template <typename TQ, typename TKV, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* qpos, void* out, int B, int S, int H, int Hkv, int bs, int W,
                   float scale, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  const size_t smem = kStages * Tile<TKV, D>::bytes(bs) + sizeof(float) * (size_t)kTileQ * D +
                      sizeof(int) * (size_t)W;
  auto kernel = paged_prefill_kernel<TQ, TKV, DPL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, H, (S + kTileQ - 1) / kTileQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), tables,
      qpos, static_cast<TQ*>(out), S, H, Hkv, bs, W, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* tables,
                     const int* qpos, void* out, int B, int S, int H, int Hkv, int bs, int W,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<TQ, TKV, 1>(q, k, v, tables, qpos, out, B, S, H, Hkv, bs, W, scale, stream);
    case 64: return launch<TQ, TKV, 2>(q, k, v, tables, qpos, out, B, S, H, Hkv, bs, W, scale, stream);
    case 128: return launch<TQ, TKV, 4>(q, k, v, tables, qpos, out, B, S, H, Hkv, bs, W, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace paged

// q [B,S,H,D] (q_dtype), pools [N,bs,Hkv,D] (kv_dtype), tables [B,W] int32,
// q_positions [B,S] int32, out [B,S,H,D] (q_dtype); all contiguous on one
// device. Returns the launch's cudaError_t (0 on success).
extern "C" int paged_prefill_launch(const void* q, const void* k_pool, const void* v_pool,
                                    const void* tables, const void* q_positions, void* out,
                                    int B, int S, int H, int Hkv, int D, int block_size, int W,
                                    int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace paged;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* qp = static_cast<const int*>(q_positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_d<float, float>(D, q, k_pool, v_pool, t, qp, out, B, S, H, Hkv, block_size, W,
                                  scale, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, k_pool, v_pool, t, qp, out, B, S, H, Hkv,
                                                  block_size, W, scale, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch_d<float, __nv_bfloat16>(D, q, k_pool, v_pool, t, qp, out, B, S, H, Hkv,
                                          block_size, W, scale, s);
  return cudaErrorInvalidValue;
}
