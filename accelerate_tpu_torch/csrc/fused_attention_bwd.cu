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
// What the design does about it: except at S = 128 (below), two passes,
// both launched here, one after the other on the caller's stream. The TPU
// kernel sums dk and dv over every query inside one grid step; Hopper
// blocks run in no order, so instead of atomics:
// - dq pass, grid (B·H, S/R): a block owns R query rows of one head,
//   computes δ for them from the stored output (kept in a scratch buffer
//   for the next pass), walks the key tiles and accumulates dq in f32;
// - dk/dv pass, grid (B·Hkv, S/R): a block owns R key rows of one kv head,
//   walks every query tile of every q head of its GQA group and accumulates
//   dk and dv in f32 registers — the GQA fold happens here, in f32, and
//   dk/dv leave the kernel as [B, S, Hkv, D].
// Both recompute P from lse; p and ds are rounded to the input dtype before
// their products, as the TPU kernel does; causal tiles that are wholly
// masked are skipped (their p and ds are exactly 0). BSHD in and out
// through strides.
//
// bf16 or fp16 at S = 128 and D = 64 (BERT's shape): one pass,
// bwd1_tc_kernel below, built from the same per-tile bodies
// (flash_bwd_tc.cuh).
//
// bf16 or fp16 at D in {64, 128} otherwise: the flash backward's tensor-core
// passes (flash_bwd_tc.cuh, R = 128) over the dense range of 128-row blocks
// instead of a lattice — products on wgmma, p and ds rounded to bf16 in
// registers, Q/dO (dq pass) or K/V (dk/dv pass) resident in shared memory
// and the other pair through a cp.async ring. The mask is
// the segment ids (padding) and `causal`; a masked score gives p = 0, which
// is what exp(NEG_INF - lse) is for every row that attends a key (every row
// attends itself).
//
// f32, and bf16 or fp16 at D in {192, 256}: CUDA-core f32 FMA
// (fused_common.cuh), R = BR rows a block.
//
// An overflow reaches the gradients. Scaled fp16 cotangents overflow where
// ds is rounded: a finite ds past fp16's range becomes inf, as
// .astype(fp16) makes it, and no select, max or saturating conversion on
// the way to dq, dk and dv turns it back into a finite number. A
// non-finite dO (an overflow upstream) makes δ, ds and that row of dq
// non-finite as in the plain version; only dk and dv of keys whose tiles
// the causal mask skips stay finite there, where the plain version's 0·inf
// gives NaN.
#include "fused_common.cuh"
#include "flash_bwd_tc.cuh"

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

// ---- bf16 and fp16 at S = 128, D = 64: one pass on tensor cores -------------

constexpr int kS1 = 128;  // the one sequence length of the single pass

// One block owns one (b, kv head) and the whole sequence: K, V and the
// segment ids stay in shared memory; each q head of the GQA group brings its
// Q, dO and lse through a two-stage cp.async ring. Per head, warpgroup w
// first takes query rows 64w .. as the dq pass does (δ of its rows from the
// stored output, into shared memory) and stores that head's dq, then key
// rows 64w .. as the dk/dv pass does, summing dk and dv over the group in f32
// registers. One launch reads each input once, where the two passes read q,
// k, v and dO twice: at S = 128 the work is too small to hide a second
// pass's loads.
template <int D, typename E>
__global__ void __launch_bounds__(256, 1)
bwd1_tc_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
               const int* __restrict__ seg, const float* __restrict__ lse,
               const E* __restrict__ out, const E* __restrict__ dout, E* __restrict__ dq,
               E* __restrict__ dk, E* __restrict__ dv, flash::Args a) {
  using namespace tc;
  constexpr int S = kS1, NT = 256, NO = D / 2;
  constexpr uint32_t kTile = S * D * 2;                      // an [S, D] 16-bit tile
  constexpr uint32_t kStage = round1k(2 * kTile + 2 * S * 4);  // Q, dO, lse [S], δ [S]
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sK = aligned_base(smem_raw, &sm);  // [S, D]
  const uint32_t sV = sK + kTile;                   // [S, D]
  const uint32_t sSeg = sV + kTile;                 // [S] int32
  const uint32_t sStage = sSeg + round1k(S * 4);
  const int* segs = reinterpret_cast<const int*>(sm + (sSeg - sK));

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, w0 = 64 * wg;
  const int bkh = blockIdx.x, b = bkh / a.Hkv, kh = bkh - b * a.Hkv, rep = a.H / a.Hkv;
  const long long q_rs = (long long)a.H * D, kv_rs = (long long)a.Hkv * D;
  const long long kv_off = ((long long)b * S * a.Hkv + kh) * D;
  const bool use_seg = seg != nullptr;

  auto issue = [&](int g) {  // q head kh·rep + g into stage g % 2
    const int h = kh * rep + g;
    const uint32_t st = sStage + (g & 1) * kStage;
    const long long q_off = ((long long)b * S * a.H + h) * D;
    cp_tile<D, NT>(st, S, q + q_off, q_rs, tid);
    cp_tile<D, NT>(st + kTile, S, dout + q_off, q_rs, tid);
    cp_words<NT>(st + 2 * kTile, lse + ((long long)b * a.H + h) * S, S, tid);
  };
  cp_tile<D, NT>(sK, S, k + kv_off, kv_rs, tid);
  cp_tile<D, NT>(sV, S, v + kv_off, kv_rs, tid);
  if (use_seg) cp_words<NT>(sSeg, seg + (long long)b * S, S, tid);
  issue(0);
  cp_commit();

  // this thread's two rows of its warpgroup's 64: query rows in the dq part,
  // key rows in the dk/dv part (the same positions)
  flash::QRows qr;
  qr.r0 = w0 + acc_row(t, 0);
  qr.r1 = qr.r0 + 8;
  qr.sq0 = use_seg ? seg[(long long)b * S + qr.r0] : 0;
  qr.sq1 = use_seg ? seg[(long long)b * S + qr.r1] : 0;
  const flash::KRows kr{qr.r0, qr.r1, qr.sq0, qr.sq1};
  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;

  for (int g = 0; g < rep; ++g) {
    if (g + 1 < rep) issue(g + 1);
    cp_commit();
    cp_wait(1);
    fence_async_smem();
    __syncthreads();  // head g (and K, V, segment ids) landed for every thread
    const int h = kh * rep + g;
    const uint32_t sQ = sStage + (g & 1) * kStage, sdO = sQ + kTile;
    float* lse_s = reinterpret_cast<float*>(sm + (sQ - sK) + 2 * kTile);
    float* delta_s = lse_s + S;
    const long long o0 = (((long long)b * S + qr.r0) * a.H + h) * D, o1 = o0 + 8 * q_rs;
    qr.dl0 = flash::row_delta<D, E>(dout + o0, out + o0, t);
    qr.dl1 = flash::row_delta<D, E>(dout + o1, out + o1, t);
    qr.nl0 = -lse_s[qr.r0] * kLog2e;
    qr.nl1 = -lse_s[qr.r1] * kLog2e;
    if ((t & 3) == 0) {
      delta_s[qr.r0] = qr.dl0;
      delta_s[qr.r1] = qr.dl1;
    }
    // dq of query rows w0 .. w0 + 63, over the keys in 64-key sub-tiles
    float dqa[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dqa[i] = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < S; j0 += 64) {
      if (a.causal && j0 > w0 + 63) continue;  // warpgroup-uniform
      const bool masked = use_seg || (a.causal && j0 + 63 > w0);
      flash::dq_tile<D, 64, E>(dqa, a, qr, sQ, sdO, S, w0, sK, sV, S, j0, j0, segs + j0, use_seg,
                            masked, t);
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) dqa[i] *= a.scale;
    store_acc<D>(dq + (((long long)b * S + w0) * a.H + h) * D, q_rs, dqa, t);
    __syncthreads();  // δ of every query row is in delta_s
    // dk, dv of key rows w0 .. w0 + 63, over the queries in 64-row tiles
#pragma unroll
    for (int i0 = 0; i0 < S; i0 += 64) {
      if (a.causal && w0 > i0 + 63) continue;  // warpgroup-uniform
      const bool masked = use_seg || (a.causal && w0 + 63 > i0);
      flash::dkdv_tile<D, E>(dka, dva, a, kr, sK, sV, S, w0, sQ, sdO, S, i0, i0, lse_s + i0,
                          delta_s + i0, segs + i0, use_seg, masked, t);
    }
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] *= a.scale;
  const long long wg_off = kv_off + (long long)w0 * kv_rs;
  store_acc<D>(dk + wg_off, kv_rs, dka, t);
  store_acc<D>(dv + wg_off, kv_rs, dva, t);
}

// bf16 or fp16 (E) at D in {64, 128}: at S = 128 and D = 64 the single
// pass; else the tensor-core dq pass (which also writes δ), then the
// tensor-core dk/dv pass, both over the dense block range.
template <int D, typename E>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* seg,
                      const float* lse, const void* out, const void* dout, void* dq, void* dk,
                      void* dv, float* delta, int B, int S, int H, int Hkv, int causal,
                      float scale, cudaStream_t stream) {
  const flash::Args a{B, S, H, Hkv, causal, 0, 128, 128, scale};
  if constexpr (D == 64) {
    if (S == kS1) {
      constexpr uint32_t tile = kS1 * D * 2;
      constexpr size_t smem = tc::kAlignSlack + 2 * tile + tc::round1k(kS1 * 4) +
                              2 * tc::round1k(2 * tile + 2 * kS1 * 4);
      auto kernel = bwd1_tc_kernel<D, E>;
      cudaError_t err = paged::allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<B * Hkv, 256, smem, stream>>>(
          static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), seg, lse,
          static_cast<const E*>(out), static_cast<const E*>(dout), static_cast<E*>(dq),
          static_cast<E*>(dk), static_cast<E*>(dv), a);
      return cudaGetLastError();
    }
  }
  cudaError_t err = flash::launch_dq_tc<D, 2, flash::kDqTile<D>, true, E>(
      q, k, v, seg, lse, delta, dout, out, nullptr, nullptr, dq, a, stream);
  if (err != cudaSuccess) return err;
  return flash::launch_dkdv_tc<D, 2, true, E>(q, k, v, seg, lse, delta, dout, nullptr, nullptr,
                                              dk, dv, a, stream);
}

}  // namespace fused

// q, out, dout, dq [B,S,H,D]; k, v, dk, dv [B,S,Hkv,D] (dtype: 0 f32, 1
// bf16, 2 fp16; all contiguous, 16-byte aligned); seg [B,S] int32 or null;
// lse and the scratch delta [B,H,S] f32. S % 128 == 0, S <= 1024, D in {64,
// 128, 192, 256}, H % Hkv == 0. Launches the dq pass then the dk/dv pass;
// returns the first failing launch's cudaError_t (0 on success). bf16 and
// fp16 at D = 64 and 128 go to the tensor-core passes, the rest to the
// CUDA-core ones.
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
  if ((dtype == paged::kBF16 || dtype == paged::kF16) && (D == 64 || D == 128)) {
    if (dtype == paged::kBF16 && D == 64)
      return launch_tc<64, tc::bf16>(q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv,
                                     causal, scale, s);
    if (dtype == paged::kBF16)
      return launch_tc<128, tc::bf16>(q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv,
                                      causal, scale, s);
    if (D == 64)
      return launch_tc<64, tc::f16>(q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv,
                                    causal, scale, s);
    return launch_tc<128, tc::f16>(q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv,
                                   causal, scale, s);
  }
  if (dtype == paged::kF32)
    return launch_d<float>(D, q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv, causal,
                           scale, s);
  if (dtype == paged::kBF16 && D == 192)
    return launch<__nv_bfloat16, 192>(q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv,
                                      causal, scale, s);
  if (dtype == paged::kBF16 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv,
                                      causal, scale, s);
  if (dtype == paged::kF16 && D == 192)
    return launch<__half, 192>(q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv, causal,
                               scale, s);
  if (dtype == paged::kF16 && D == 256)
    return launch<__half, 256>(q, k, v, sg, l, out, dout, dq, dk, dv, dl, B, S, H, Hkv, causal,
                               scale, s);
  return cudaErrorInvalidValue;
}
