// Paged-attention chunked prefill (S > 1) for Hopper.
//
// Replaces: accelerate_tpu/ops/flash_attention.py `_paged_prefill_kernel`
// (launched by `paged_attention_prefill`), the Pallas TPU kernel that walks
// a row's block table over a (B, W) grid with an S-row chunk of queries and
// one mask, kv_pos <= q_position, covering in-chunk causality, KV landed by
// earlier chunks and null padding. Its softmax is f32 online with the shift
// clamped to 0 while the running max is -inf, and its P V is an f32 product:
// p is never rounded to the value type.
//
// What bounds it: at the serving shape (B=1, S=256 from position 200,
// H=32 over Hkv=8, D=64, bf16) the bytes (q, out and the live KV, 2.9 MB)
// and the products (4·D flops per attended key and head, 0.95 GFLOP) both
// take about a microsecond at the card's peaks; what a kernel actually
// pays is latency: the walk over a row's blocks is serial.
//
// What the design does about it: two variants, chosen by the launcher.
//
// bf16 q and pools at D in {64, 128}, block size in {8, 16, 32, 64} and
// G = H/Hkv in {1, 2, 4, 8, 16} (the engine's bf16 path): tensor cores.
// - One warpgroup owns one (b, kv head kh) and 64 tile rows: 64/G
//   consecutive queries times the G q heads that read kh, row r = i·G + g,
//   so the G·D values of query i are one contiguous run of q and out.
//   Grid (B, Hkv, ceil(S·G/64)). Each KV block is copied once per tile and
//   read by all G heads (the CUDA-core variant copies it once per head).
// - KV comes in stages of 64 keys (64/bs table blocks, pool rows Hkv·D
//   apart) through a three-stage ring of 16-byte cp.async copies into the
//   swizzled [64, D] tiles of flash_tc.cuh. The walk ends at the tile's
//   largest q_position: later table entries are never read. Keys of the
//   last stage past the walk are zero-filled (0-weighted keys then add
//   0 · 0 to P V, never 0 · stale).
// - S = Q Kᵀ by wgmma (q stays bf16, scores f32), times scale; keys past a
//   row's own q_position get -inf; the online softmax with the TPU kernel's
//   clamp; l sums the unrounded p.
// - P V in split bf16: p = hi + lo, hi = bf16(p), lo = bf16(p - hi), both
//   packed in place into register-A fragments, two wgmmas against the same
//   V tile, f32 accumulation: the TPU kernel's f32 product to about 2⁻¹⁶ of
//   p, where one bf16 rounding of p would be 2⁻⁹ off.
//
// f32, f32 q over a bf16 pool, D = 32 and other block sizes or group
// ratios: CUDA-core f32 FMA. Grid (B, H, ceil(S / 16)), a block holds 16
// queries of one head and streams its kv head's blocks kStages deep
// through shared memory up to the tile's largest q_position (4-byte
// cp.async copies); each of the 4 warps folds them into its 4 query rows
// with the per-query mask, one key per lane.
#include "flash_tc.cuh"
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

// ---- bf16, D in {64, 128}: tensor cores ------------------------------------

constexpr int kTcKeys = 64;    // keys a stage
constexpr int kTcStages = 3;   // stages resident or in flight

// (a, b) as two bf16 pairs whose sum is (a, b) to about 2⁻¹⁶ of each: hi
// rounded to nearest, lo the rounding error rounded again.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = tc::pack_bf16(a, b);
  lo = tc::pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
}

// One warpgroup: 64 tile rows (64/G queries x the G q heads of kv head kh)
// of row b. lg_g = log2(G), lg_bs = log2(block size).
template <int D>
__global__ void __launch_bounds__(128)
prefill_tc_kernel(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k_pool,
                  const tc::bf16* __restrict__ v_pool, const int* __restrict__ tables,
                  const int* __restrict__ q_positions, tc::bf16* __restrict__ out, int S, int H,
                  int Hkv, int lg_g, int lg_bs, int W, float scale) {
  using namespace tc;
  constexpr int NO = D / 2, kChunks = D / 8;
  constexpr uint32_t kTile = kTcKeys * D * 2;  // one [64, D] bf16 tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sQ = aligned_base(smem_raw, &sm);  // [64, D]
  const uint32_t sStage = sQ + kTile;               // kTcStages x (K [64, D], V [64, D])
  int* table_s = reinterpret_cast<int*>(sm + (1 + 2 * kTcStages) * kTile);  // [W]
  __shared__ int part_max[4], part_min[4];

  const int t = threadIdx.x, G = 1 << lg_g, bs = 1 << lg_bs;
  const int b = blockIdx.x, kh = blockIdx.y, t0 = blockIdx.z * (kTcKeys >> lg_g);
  const long long q_rs = (long long)H * D, pool_rs = (long long)Hkv * D;
  // query t0 + i, head kh·G + g is at q_tile + i·q_rs + g·D (the same in out)
  const long long tile_off = (((long long)b * S + t0) * H + (long long)kh * G) * D;
  // tile rows past the chunk repeat its last query: finite, never stored
  auto row_query = [&](int r) { return min(r >> lg_g, S - 1 - t0); };

  for (int idx = t; idx < kTcKeys * kChunks; idx += 128) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    cp_async16(sQ + swz(r, c, kTcKeys),
               q + tile_off + row_query(r) * q_rs + (r & (G - 1)) * D + c * 8);
  }
  // this thread's two rows (r0 for the even accumulator register pairs,
  // r1 = r0 + 8) and the positions they attend up to
  const int r0 = acc_row(t, 0), r1 = r0 + 8;
  const int* qp = q_positions + (long long)b * S + t0;
  const int pos0 = qp[row_query(r0)], pos1 = qp[row_query(r1)];
  const int wmax = __reduce_max_sync(0xffffffffu, max(pos0, pos1));
  const int wmin = __reduce_min_sync(0xffffffffu, min(pos0, pos1));
  if ((t & 31) == 0) {
    part_max[t >> 5] = wmax;
    part_min[t >> 5] = wmin;
  }
  __syncthreads();
  const int qmax = max(max(part_max[0], part_max[1]), max(part_max[2], part_max[3]));
  const int qmin = min(min(part_min[0], part_min[1]), min(part_min[2], part_min[3]));
  const int nblk = qmax >= 0 ? min((qmax >> lg_bs) + 1, W) : 0;
  const int kv_end = nblk << lg_bs;  // keys the walk covers
  const int n_st = (kv_end + kTcKeys - 1) / kTcKeys;
  for (int w = t; w < nblk; w += 128) table_s[w] = tables[(long long)b * W + w];
  __syncthreads();

  auto issue = [&](int s) {  // keys 64s .. 64s + 63 into stage s % kTcStages
    const uint32_t sK = sStage + (s % kTcStages) * 2 * kTile, sV = sK + kTile;
    for (int idx = t; idx < kTcKeys * kChunks; idx += 128) {
      const int r = idx / kChunks, c = idx - r * kChunks, key = s * kTcKeys + r;
      const uint32_t off = swz(r, c, kTcKeys);
      if (key < kv_end) {
        const long long g =
            ((long long)table_s[key >> lg_bs] * bs + (key & (bs - 1))) * pool_rs + kh * D + c * 8;
        cp_async16(sK + off, k_pool + g);
        cp_async16(sV + off, v_pool + g);
      } else {
        *reinterpret_cast<uint4*>(sm + (sK - sQ) + off) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(sm + (sV - sQ) + off) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  for (int s = 0; s < kTcStages - 1; ++s) {  // the first group also holds Q
    if (s < n_st) issue(s);
    cp_commit();
  }

  // key j is attended by a row iff j <= its position and j < kv_end
  const int lim0 = min(pos0, kv_end - 1), lim1 = min(pos1, kv_end - 1);
  const int lim_min = min(qmin, kv_end - 1);
  const float sl2 = scale * kLog2e;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, o[NO], sacc[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    cp_wait(kTcStages - 2);
    fence_async_smem();
    __syncthreads();  // stage st landed for every thread; stage st - 1 is free
    if (st + kTcStages - 1 < n_st) issue(st + kTcStages - 1);
    cp_commit();
    const uint32_t sK = sStage + (st % kTcStages) * 2 * kTile, sV = sK + kTile;
    const int k0 = st * kTcKeys;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<64>::ss(sacc, desc_k(sQ, kTcKeys, 0, kk), desc_k(sK, kTcKeys, 0, kk), kk);
    wg_commit();
    wg_wait_all();
    hold(sacc);
    if (k0 + kTcKeys - 1 > lim_min) {  // some key of the stage is masked for some row
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + acc_col(t, i) > (((i >> 1) & 1) ? lim1 : lim0)) sacc[i] = -INFINITY;
    }
    float mb0 = -INFINITY, mb1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i >> 1) & 1) mb1 = fmaxf(mb1, sacc[i]);
      else mb0 = fmaxf(mb0, sacc[i]);
    }
    // scale > 0: max(s)·scale is the max of the scaled scores
    const float mn0 = fmaxf(m0, quad_max(mb0) * scale), mn1 = fmaxf(m1, quad_max(mb1) * scale);
    // a row with nothing attended yet keeps m at -inf: exp(-inf - -inf)
    // would be NaN, so clamp the shift (as the TPU kernel does)
    const float sh0 = isfinite(mn0) ? mn0 : 0.f, sh1 = isfinite(mn1) ? mn1 : 0.f;
    const float al0 = exp2f((m0 - sh0) * kLog2e), al1 = exp2f((m1 - sh1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= ((i >> 1) & 1) ? al1 : al0;
    const float c0 = sh0 * kLog2e, c1 = sh1 * kLog2e;
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;  // row r0 for e even, r1 for e odd
        const float c = (e & 1) ? c1 : c0;
        const float pa = exp2f(fmaf(sacc[i], sl2, -c)), pb = exp2f(fmaf(sacc[i + 1], sl2, -c));
        if (e & 1) l1 += pa + pb;
        else l0 += pa + pb;
        split_bf16(pa, pb, ph[kk][e], pl[kk][e]);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Mma<D>::rs(o, ph[kk], desc_mn(sV, kTcKeys, 0, kk), 1);
      Mma<D>::rs(o, pl[kk], desc_mn(sV, kTcKeys, 0, kk), 1);
    }
    wg_commit();
    wg_wait_all();
    hold(o);
    hold(ph);
    hold(pl);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int r = acc_row(t, i), qi = r >> lg_g;
    const float l = ((i >> 1) & 1) ? l1 : l0;
    if (t0 + qi < S)
      *reinterpret_cast<uint32_t*>(out + tile_off + qi * q_rs + (r & (G - 1)) * D +
                                   acc_col(t, i)) = pack_bf16(o[i] / l, o[i + 1] / l);
  }
}

__host__ inline int log2_exact(int x) {  // log2 of a power of two, else -1
  return x > 0 && !(x & (x - 1)) ? __builtin_ctz(x) : -1;
}

// The shapes the tensor-core variant takes.
__host__ inline bool tc_shape(int H, int Hkv, int D, int bs) {
  const int lg_g = log2_exact(H / Hkv), lg_bs = log2_exact(bs);
  return (D == 64 || D == 128) && lg_g >= 0 && lg_g <= 4 && lg_bs >= 3 && lg_bs <= 6;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* tables,
                      const int* qpos, void* out, int B, int S, int H, int Hkv, int bs, int W,
                      float scale, cudaStream_t stream) {
  const size_t smem =
      tc::kAlignSlack + (1 + 2 * kTcStages) * (size_t)kTcKeys * D * 2 + sizeof(int) * (size_t)W;
  auto kernel = prefill_tc_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = H / Hkv;
  const dim3 grid(B, Hkv, (S * G + kTcKeys - 1) / kTcKeys);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), tables, qpos, static_cast<tc::bf16*>(out), S, H, Hkv,
      log2_exact(G), log2_exact(bs), W, scale);
  return cudaGetLastError();
}

}  // namespace paged

// q [B,S,H,D] (q_dtype), pools [N,bs,Hkv,D] (kv_dtype), tables [B,W] int32,
// q_positions [B,S] int32, out [B,S,H,D] (q_dtype); all contiguous on one
// device. Returns the launch's cudaError_t (0 on success). bf16 at D = 64
// and 128 with a power-of-two block size of 8 to 64 and H/Hkv a power of two
// up to 16 goes to the tensor-core kernel, the rest to the CUDA-core one.
extern "C" int paged_prefill_launch(const void* q, const void* k_pool, const void* v_pool,
                                    const void* tables, const void* q_positions, void* out,
                                    int B, int S, int H, int Hkv, int D, int block_size, int W,
                                    int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace paged;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* qp = static_cast<const int*>(q_positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kBF16 && kv_dtype == kBF16 && tc_shape(H, Hkv, D, block_size)) {
    if (D == 64)
      return launch_tc<64>(q, k_pool, v_pool, t, qp, out, B, S, H, Hkv, block_size, W, scale, s);
    return launch_tc<128>(q, k_pool, v_pool, t, qp, out, B, S, H, Hkv, block_size, W, scale, s);
  }
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
