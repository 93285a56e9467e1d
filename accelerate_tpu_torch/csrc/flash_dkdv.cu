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
// bf16 at D in {64, 128} (every training path): tensor cores,
// dkdv_tc_kernel in flash_bwd_tc.cuh. One block owns the whole sum of a
// tile of 128 key rows (64 when block_kv is not a multiple of 128) of one
// (b, kv head), with K and V resident in shared memory; it walks its
// transposed-lattice row idsT[b, j, :countsT[b, j]] x the GQA group's q
// heads in q tiles of 64 rows through a cp.async ring; the four products
// run on wgmma with p and ds rounded to bf16 in registers as A fragments.
// No atomics: deterministic.
//
// f32, and D = 256 (on no path): CUDA-core f32 FMA (fused_common.cuh), one
// block of BR key rows walking the same rows tile by tile with pᵀ and dsᵀ
// staged in shared memory.
#include "flash_common.cuh"
#include "flash_bwd_tc.cuh"

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

template <int D>
cudaError_t launch_tc_d(const void* q, const void* k, const void* v, const int* seg,
                        const float* lse, const float* delta, const void* dout, const int* idsT,
                        const int* countsT, void* dk, void* dv, const Args& a, cudaStream_t s) {
  if (a.block_q % 64 || a.block_kv % 64) return cudaErrorInvalidValue;
  if (a.block_kv % 128 == 0)
    return launch_dkdv_tc<D, 2, false>(q, k, v, seg, lse, delta, dout, idsT, countsT, dk, dv, a, s);
  return launch_dkdv_tc<D, 1, false>(q, k, v, seg, lse, delta, dout, idsT, countsT, dk, dv, a, s);
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
