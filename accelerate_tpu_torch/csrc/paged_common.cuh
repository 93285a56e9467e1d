// Shared pieces of the paged-attention kernels (paged_decode.cu,
// paged_prefill.cu): type conversion, warp reductions and the shared-memory
// cap; then, for the prefill's CUDA-core variant, the pipelined cp.async
// walk over a row's block table and the online-softmax fold of a warp's
// query rows.
//
// The walk's shape: a thread block holds up to kWarps * kMaxRowsPerWarp
// query rows that read the SAME kv head, walks that head's KV blocks
// through shared memory one table entry at a time, and each warp folds
// every block into the rows it owns. Later blocks' copies (cp.async, no
// registers held) are in flight while the current one is folded, so a step
// costs about max(copy latency / depth, fold). Scores, softmax statistics
// and the value accumulator are f32 whatever the storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace paged {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRowsPerWarp = 4;  // rows a warp owns: row r of warp w is w + r * kWarps
constexpr int kMaxRows = kWarps * kMaxRowsPerWarp;
constexpr unsigned kFull = 0xffffffffu;

// dtype codes of the C interface (the Python wrappers pass these; fp16
// only to the fused kernels)
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round to nearest even; past fp16's range to inf, as .astype(fp16)
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));  // all but the N newest groups landed
}

// Layout of one KV block of one kv head in shared memory: bs rows of D
// values in the storage type, padded to ld = D + one 4-byte word so a row
// is an odd number of words long — lane j reading row j then hits bank
// (j * odd + d) % 32, free of conflicts when lanes take one key each.
template <typename TKV, int D>
struct Tile {
  static constexpr int kPer = 4 / sizeof(TKV);  // values per 4-byte copy
  static constexpr int kLd = D + kPer;
  static __host__ __device__ size_t bytes(int bs) { return sizeof(TKV) * 2 * (size_t)bs * kLd; }
};

// Start copying pool[phys, j, kh, :] for j < bs of both pools (laid out
// [num_blocks, bs, Hkv, D]) into K rows then V rows at dst.
template <typename TKV, int D>
__device__ __forceinline__ void issue_block(TKV* dst, const TKV* k_pool, const TKV* v_pool,
                                            long long phys, int kh, int Hkv, int bs) {
  using T = Tile<TKV, D>;
  constexpr int kWords = D / T::kPer;
  const long long base = (phys * bs * Hkv + kh) * (long long)D;
  const long long row = (long long)Hkv * D;
  TKV* dst_v = dst + bs * T::kLd;
  for (int idx = threadIdx.x; idx < bs * kWords; idx += blockDim.x) {
    const int j = idx / kWords, w = idx - j * kWords;
    const long long g = base + j * row + w * T::kPer;
    cp_async4(dst + j * T::kLd + w * T::kPer, k_pool + g);
    cp_async4(dst_v + j * T::kLd + w * T::kPer, v_pool + g);
  }
}

constexpr int kStages = 4;  // KV blocks resident or in flight per thread block

// Walk logical blocks 0..nblk-1 of a row whose physical ids are in
// table_s (shared memory), kStages deep: fold(Ks, Vs, w) sees block w
// resident in shared memory while blocks w+1 .. w+kStages-1 are being
// copied, so the HBM latency of a block is hidden behind the folds of the
// blocks before it. `stages` holds kStages * Tile::bytes(bs).
template <typename TKV, int D, typename Fold>
__device__ __forceinline__ void walk_blocks(TKV* stages, const TKV* k_pool, const TKV* v_pool,
                                            const int* table_s, int nblk, int kh, int Hkv,
                                            int bs, Fold fold) {
  using T = Tile<TKV, D>;
  const int stage_elems = 2 * bs * T::kLd;
  for (int w = 0; w < kStages - 1; ++w) {
    if (w < nblk)
      issue_block<TKV, D>(stages + w * stage_elems, k_pool, v_pool, table_s[w], kh, Hkv, bs);
    cp_async_commit();  // one group per block, empty past the end
  }
  for (int w = 0; w < nblk; ++w) {
    const int ahead = w + kStages - 1;
    if (ahead < nblk)
      issue_block<TKV, D>(stages + (ahead % kStages) * stage_elems, k_pool, v_pool,
                          table_s[ahead], kh, Hkv, bs);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // block w has landed for every thread
    TKV* cur = stages + (w % kStages) * stage_elems;
    fold(cur, cur + bs * T::kLd, w);
    __syncthreads();  // every warp is done with block w before its stage is refilled
  }
}

// Online-softmax state of one query row, held by one warp: lane l owns
// output dims l, l + 32, ... (DPL = D / 32 of them).
template <int DPL>
struct RowState {
  float m, l, acc[DPL];
  __device__ __forceinline__ void init() {
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  }
};

// Fold one KV block (Ks/Vs in shared memory, bs rows of stride kLd) into
// the NR query rows a warp owns: row r's scaled f32 query is at
// qs + r * kWarps * D in shared memory, and it attends the key at logical
// position base + j iff base + j <= limit[r] (masked keys weigh exactly 0;
// limit -1 masks a row out). Keys go 32 at a time, one per lane; the NR
// rows share each K and V read and give the FMA chains NR-way parallelism.
template <typename TKV, int DPL, int NR>
__device__ __forceinline__ void fold_rows(RowState<DPL> (&st)[NR], const float* qs,
                                          const int (&limit)[NR], const TKV* Ks, const TKV* Vs,
                                          int bs, int base, int lane) {
  constexpr int D = DPL * 32;
  constexpr int kLd = Tile<TKV, D>::kLd;
  constexpr int kRow = kWarps * D;
  for (int c = 0; c < bs; c += 32) {
    const int j = c + lane;
    float s[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) s[r] = 0.f;
    if (j < bs) {
      const TKV* k = Ks + j * kLd;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = to_f32(k[d]);
#pragma unroll
        for (int r = 0; r < NR; ++r) s[r] = fmaf(qs[r * kRow + d], kd, s[r]);
      }
    }
    float p[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float sr = (j < bs && base + j <= limit[r]) ? s[r] : -INFINITY;
      const float m_new = fmaxf(st[r].m, warp_max(sr));
      // a row with nothing attended yet keeps m at -inf: exp(-inf - -inf)
      // would be NaN, so clamp the shift (as the TPU kernel does)
      const float shift = isfinite(m_new) ? m_new : 0.f;
      const float alpha = expf(st[r].m - shift);
      p[r] = expf(sr - shift);
      st[r].l = st[r].l * alpha + warp_sum(p[r]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) st[r].acc[i] *= alpha;
      st[r].m = m_new;
    }
    const int n = min(32, bs - c);
    for (int jj = 0; jj < n; ++jj) {
      const TKV* v = Vs + (c + jj) * kLd;
      float vd[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vd[i] = to_f32(v[lane + 32 * i]);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float pj = __shfl_sync(kFull, p[r], jj);
#pragma unroll
        for (int i = 0; i < DPL; ++i) st[r].acc[i] = fmaf(pj, vd[i], st[r].acc[i]);
      }
    }
  }
}

// Raise the dynamic shared-memory cap of `kernel` when it needs > 48 KB.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace paged

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
