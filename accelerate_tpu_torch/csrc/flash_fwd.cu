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
// What the design does about it, for now simply:
// - A Hopper block cannot carry state across a grid axis, so the kv walk is
//   a loop inside the block: one block owns BR query rows of one (b, h) —
//   grid (S/BR, B·H), the causally heaviest tiles first — and reads its own
//   lattice row ids[b, qi, :counts[b, qi]] (no scalar prefetch on Hopper).
//   Blocks the lattice skips are never read.
// - GQA in-kernel: the block streams K/V of kv head h / (H/Hkv) straight
//   from the BSHD tensors through strides; no repeated KV exists.
// - The TPU kernel rounds p to the value dtype against the running max of
//   each whole kv block. This kernel keeps the block's BR x block_kv
//   scores in shared memory, takes the row max over all of them, then
//   forms p, rounds it and accumulates PV tile by tile — the same rescale
//   points as the TPU kernel and the plain version, so bf16 agrees to
//   the last rounding. A fully masked prefix keeps m at -inf: the shift is
//   clamped to 0, as on the TPU.
// - Products on CUDA-core f32 FMA (fused_common.cuh), exact for bf16
//   inputs. Later work: mma/wgmma in bf16, TMA loads, a pipelined walk.
#include "flash_common.cuh"

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

}  // namespace flash

// q, out [B,S,H,D]; k, v [B,S,Hkv,D] (dtype: 0 f32, 1 bf16; all contiguous,
// 16-byte aligned); seg [B,S] int32 or null; ids [B, S/block_q, S/block_kv]
// and counts [B, S/block_q] int32 (the block lattice); lse [B,H,S] f32. D in
// {64, 128, 256}; block_q, block_kv multiples of 64, at most 256, dividing
// S; window 0 for none. Returns the launch's cudaError_t (0 on success).
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
  if (dtype == paged::kF32) return launch_d<float>(D, q, k, v, sg, id, ct, out, l, a, s);
  if (dtype == paged::kBF16) return launch_d<__nv_bfloat16>(D, q, k, v, sg, id, ct, out, l, a, s);
  return cudaErrorInvalidValue;
}
