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
// At serving shapes a layer's live KV is a few MB, which the card reads in
// about a microsecond: what a kernel pays beyond that is latency (the
// dependent kv_len/table -> KV loads) and SMs left idle.
//
// What the design does about it:
// - Split each row's walk over blocks. Grid (B, Hkv, n_split): split s of
//   row b covers keys [s*C, s*C + C) of the row, wherever its table entries
//   point. C is 32, 64 or 128 keys, picked by the wrapper from shapes alone
//   (`_decode_split_keys`), and n_split = ceil(W*bs / C) — the host never
//   reads kv_lens, which would sync the device on a host-bound path. Every
//   split pays the same fixed chain (launch, kv_len and table, KV, a ticket,
//   the merge), so the largest C that still spreads the grid wins: 128
//   unless the grid would then leave more than three SMs in four without a
//   block (the chip's decode case, B=8 rows x Hkv=8 x 256 keys, gets 128
//   blocks, 96 of them live; one 512-key request gets C=64, 64 blocks).
//   A block whose split starts at or past kv_len returns at once.
// - One load per block: the kv_len, the split's table entries and q in one
//   round trip; then every K and V row of the split is issued at once as
//   16-byte cp.async.cg copies (a kv head's D values are one contiguous
//   64-512 byte run; neighbouring lanes take neighbouring chunks), K and V
//   as two groups, so the block pays the table -> KV latency once and
//   scores K while V lands. Keys past kv_len are never copied.
// - Each of the 8 warps then works alone on its own C/8 keys (no block
//   barrier until the merge): it copies them, scores them against the G
//   heads, takes their softmax in f32 with the TPU kernel's NaN-guarded
//   shift and forms its P V in f32. bf16 q and pools (the engine's path)
//   run both products on tensor cores (mma.sync m16n8k16: the G heads are
//   the 16 A rows, q·kᵀ in f32; p split into bf16 hi + lo, two products
//   into one f32 accumulator, so p is never rounded). f32 and f32 q over
//   bf16 pools run on CUDA cores: D*sizeof/16 lanes share a key, one
//   16-byte chunk each, and their partial dots meet by shuffles — no lane
//   runs a D-deep chain.
// - The warps' (shift, sum, P V) merge into the split's; combine in the
//   same launch: a split writes its f32 partial (m, l, acc[G, D]) to
//   `partials` and takes a ticket from the (b, kh) counter (atom.acq_rel);
//   the block that draws the last ticket merges the partials in f32, writes
//   the output and sets the counter back to 0, so a launch leaves the
//   counters as it found them. A row whose keys fit in one split writes its
//   output directly. One launch a call keeps the engine's launch count at
//   one a layer and step.
// Shared memory: K and V rows padded by 16 bytes, so the 8 rows an
// ldmatrix reads, and the rows the CUDA-core lanes read 16 bytes at a
// time, fall in distinct bank groups.
#include <type_traits>

#include "flash_tc.cuh"
#include "paged_common.cuh"

namespace paged {
namespace decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 16;       // q heads per kv head
constexpr int kMaxHeadsPerPass = 4;  // q heads a lane holds in registers while scoring
constexpr int kMaxSplitKeys = 128;   // the most keys, so table entries, a split takes

// N f32 values from N values at p (16-byte aligned), in 16-byte loads
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[i];
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // bf16 -> f32 is the top half of the word
      x[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
      x[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// Sum HP heads' partial dot products over the NCH lanes of a key (lanes
// that differ in the bits of NCH - 1). Each of the first log2(HP) steps
// halves the heads a lane holds, so together they take HP - 1 shuffles
// where summing every head at every step would take HP log2(HP):
// afterwards lane chunk c holds the whole sum of head c / (NCH / HP).
template <int HP, int NCH>
__device__ __forceinline__ float reduce_heads(float (&s)[HP], int lane) {
  int o = NCH / 2;
  if constexpr (HP == 4) {
    const bool hi = lane & o;
    const float a0 = (hi ? s[2] : s[0]) + __shfl_xor_sync(kFull, hi ? s[0] : s[2], o);
    const float a1 = (hi ? s[3] : s[1]) + __shfl_xor_sync(kFull, hi ? s[1] : s[3], o);
    s[0] = a0;
    s[1] = a1;
    o /= 2;
  }
  if constexpr (HP >= 2) {
    const bool hi = lane & o;
    s[0] = (hi ? s[1] : s[0]) + __shfl_xor_sync(kFull, hi ? s[0] : s[1], o);
    o /= 2;
  }
  float r = s[0];
#pragma unroll
  for (; o > 0; o /= 2) r += __shfl_xor_sync(kFull, r, o);
  return r;
}

// this thread's ticket from a (b, kh) counter: acquire-release at device
// scope, so partials written before it (by any thread of the block, ordered
// by a barrier) are visible to the block that draws the last ticket
__device__ __forceinline__ int take_ticket(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// ---- bf16 q and pools: the warp's products on tensor cores (mma.sync) ----

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_u32(p)));
}
// two f32 as packed bf16 hi = bf16(x) and lo = bf16(x - hi): hi + lo is x
// to about 2^-16 of it, so P V keeps p's f32 value
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  const __nv_bfloat16 l0 = __float2bfloat16(x0 - __bfloat162float(h0));
  const __nv_bfloat16 l1 = __float2bfloat16(x1 - __bfloat162float(h1));
  hi = (uint32_t)__bfloat16_as_ushort(h0) | ((uint32_t)__bfloat16_as_ushort(h1) << 16);
  lo = (uint32_t)__bfloat16_as_ushort(l0) | ((uint32_t)__bfloat16_as_ushort(l1) << 16);
}

// One warp's keys j_w .. j_w + nk - 1 (nk <= 16) of a split against the G
// (<= 16) q heads of a kv head (qa, from load_qa): S = Q Kᵀ as m16n8k16 products (the heads
// are the 16 A rows, zero past G; the keys the N columns), the softmax of
// each head over the warp's keys in registers (row r = lane / 4 holds keys
// 2t, 2t + 1 of each 8-key tile, t = lane % 4: max and sum over the 4
// lanes of a row), then P V with p split into bf16 hi + lo: two products
// into one f32 accumulator. An ldmatrix reads 8 rows of K and 16 of V,
// more than a warp of 4 or 8 keys holds: a lane whose row lies at or past
// nk reads the warp's last live row instead, so a warp reads only rows it
// has copied itself, never rows another warp is filling. Those columns
// never count: their scores are set to -inf before the max and their V
// halves are zeroed in the B fragments.
// Writes the warp's P V [G, D], shift [G] (-inf for a warp with no key)
// and sum [G].
// The G q heads (rows, zero past G) as m16n8k16 A fragments, one per 16
// dims: lane holds rows lane / 4 and + 8, dims 2 (lane % 4) .. and + 8.
template <int D>
__device__ __forceinline__ void load_qa(const __nv_bfloat16* qg, int G, int lane,
                                        uint32_t (&qa)[D / 16][4]) {
  const int r = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int d = 16 * ks + 2 * t;
    qa[ks][0] = r < G ? *reinterpret_cast<const uint32_t*>(qg + r * D + d) : 0u;
    qa[ks][1] = r + 8 < G ? *reinterpret_cast<const uint32_t*>(qg + (r + 8) * D + d) : 0u;
    qa[ks][2] = r < G ? *reinterpret_cast<const uint32_t*>(qg + r * D + d + 8) : 0u;
    qa[ks][3] = r + 8 < G ? *reinterpret_cast<const uint32_t*>(qg + (r + 8) * D + d + 8) : 0u;
  }
}

template <int D>
__device__ __forceinline__ void warp_tc(const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                        const uint32_t (&qa)[D / 16][4], float scale, int G,
                                        int j_w, int nk, float* wacc, float* wm, float* wl,
                                        int lane) {
  constexpr int kLd = D + 8;
  const int r = lane / 4, t = lane % 4;
  const int last = max(nk - 1, 0);  // the warp's last live key (row 0 when it has none)
  // scores of keys 8 nt + 2t, + 1 (nt = 0, 1): s[nt][0..1] row r, [2..3] row r + 8
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    if (8 * nt >= nk) break;  // warp-uniform
    // ldmatrix: lane i gives row j_w + 8 nt + i % 8 (at most the last live
    // one), dims 8 (i / 8) + 32 p
    const int kr = min(8 * nt + lane % 8, last);
    const __nv_bfloat16* krow = Ks + (j_w + kr) * kLd + 8 * (lane / 8);
#pragma unroll
    for (int p = 0; p < D / 32; ++p) {
      uint32_t kb[4];
      ldsm_x4(kb, krow + 32 * p);
      mma_bf16(s[nt], qa[2 * p], kb[0], kb[1]);
      mma_bf16(s[nt], qa[2 * p + 1], kb[2], kb[3]);
    }
  }
  float shift[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows r and r + 8
    float m = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = 8 * nt + 2 * t + e < nk;
        s[nt][2 * h + e] = ok ? s[nt][2 * h + e] * scale : -INFINITY;
        m = fmaxf(m, s[nt][2 * h + e]);
      }
    m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));
    m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
    shift[h] = isfinite(m) ? m : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(s[nt][2 * h + e] - shift[h]);  // exp(-inf) = 0 past nk
        s[nt][2 * h + e] = p;
        sum += p;
      }
    sum += __shfl_xor_sync(kFull, sum, 1);
    l[h] = sum + __shfl_xor_sync(kFull, sum, 2);
  }
  if (t == 0) {
    if (r < G) {
      wm[r] = nk > 0 ? shift[0] : -INFINITY;
      wl[r] = l[0];
    }
    if (r + 8 < G) {
      wm[r + 8] = nk > 0 ? shift[1] : -INFINITY;
      wl[r + 8] = l[1];
    }
  }
  // P as A fragments (keys are the K dim): hi and lo halves
  uint32_t ph[4], pl[4];
  split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
  split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
  split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
  split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
  // the B fragment's halves for keys 2t, 2t + 1 (b0) and 8 + 2t, 9 + 2t (b1)
  const uint32_t keep0 = (2 * t < nk ? 0xffffu : 0u) | (2 * t + 1 < nk ? 0xffff0000u : 0u);
  const uint32_t keep1 =
      (2 * t + 8 < nk ? 0xffffu : 0u) | (2 * t + 9 < nk ? 0xffff0000u : 0u);
  tc::cp_wait(0);  // this lane's V copies have landed
  __syncwarp();
  // ldmatrix.trans: lane i gives row j_w + i % 8 + 8 ((i / 8) % 2) (at most
  // the last live one), dims 8 (i / 16) + 16 q
  const int vr = min(lane % 8 + 8 * ((lane / 8) % 2), last);
  const __nv_bfloat16* vrow = Vs + (j_w + vr) * kLd + 8 * (lane / 16);
#pragma unroll
  for (int q = 0; q < D / 16; ++q) {
    uint32_t vb[4];
    ldsm_x4_t(vb, vrow + 16 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // dims 16 q + 8 h ..
      const uint32_t b0 = vb[2 * h] & keep0, b1 = vb[2 * h + 1] & keep1;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(acc, ph, b0, b1);
      mma_bf16(acc, pl, b0, b1);
      const int d = 16 * q + 8 * h + 2 * t;
      if (r < G) *reinterpret_cast<float2*>(wacc + r * D + d) = make_float2(acc[0], acc[1]);
      if (r + 8 < G)
        *reinterpret_cast<float2*>(wacc + (r + 8) * D + d) = make_float2(acc[2], acc[3]);
    }
  }
}

struct Args {
  const void* q;       // [B, 1, H, D]
  const void* k_pool;  // [N, bs, Hkv, D]
  const void* v_pool;
  const int* tables;   // [B, W]
  const int* kv_lens;  // [B]
  void* out;           // [B, 1, H, D]
  float* partials;     // [B, Hkv, n_split, G * (D + 2)]: acc[G, D], m[G], l[G]
  int* tickets;        // [B, Hkv], 0 between launches
  int H, Hkv, bs, W, C;
  float scale;
};

// Shared memory: K and V rows of D values padded by 16 bytes (so the 8
// rows an ldmatrix reads start in 8 different 16-byte bank groups), then,
// in f32 words: p [G, C + 4] (rows 4
// words longer than C, so the G heads' p of one key sit in different
// banks), each warp's P V [kWarps, G, D], shift [kWarps, G] and sum
// [kWarps, G]; then the split's table entries, int32.
template <typename TKV, int D>
__host__ __device__ __forceinline__ size_t smem_bytes(int G, int C) {
  return 2 * sizeof(TKV) * (size_t)C * (D + 16 / sizeof(TKV)) +
         sizeof(float) * ((size_t)G * (C + 4) + (size_t)kWarps * G * (D + 2)) +
         sizeof(int) * (size_t)kMaxSplitKeys;
}

// bf16 q and pools take the tensor-core path (warp_tc); the rest score on
// CUDA cores, HP = q heads a pass over the split's keys (G rounded up to
// 1, 2 or 4; larger groups take ceil(G / 4) passes).
template <typename TQ, typename TKV, int D, int HP>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const Args a) {
  constexpr int kVec = 16 / sizeof(TKV);  // values in a 16-byte chunk of K or V
  constexpr int kNch = D / kVec;          // lanes sharing one key's row
  constexpr int kKpw = 32 / kNch;         // keys a warp scores at a time
  constexpr int kLd = D + kVec;           // K and V row stride, padded by 16 bytes
  constexpr bool kTc = std::is_same<TQ, __nv_bfloat16>::value &&
                       std::is_same<TKV, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;

  const int G = a.H / a.Hkv, C = a.C, ldp = a.C + 4;
  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane % kNch;  // this lane's 16-byte chunk of a row
  TQ* out = static_cast<TQ*>(a.out) + ((long long)b * a.H + (long long)kh * G) * D;
  const TQ* qg = static_cast<const TQ*>(a.q) + ((long long)b * a.H + (long long)kh * G) * D;

  // one round trip before the KV copies: kv_len, the split's table entries
  // (entries first .. of the row cover keys s0 .. s0 + C - 1) and this
  // lane's part of q (A fragments on the tensor-core path, else its chunk
  // of the first HP heads)
  const int s0 = split * C;
  const int first = s0 / a.bs;
  const int n_ent = min(a.W - 1, (s0 + C - 1) / a.bs) - first + 1;  // <= C
  const int ent = tid < n_ent ? a.tables[(long long)b * a.W + first + tid] : 0;
  float qr[HP][kVec];
  auto load_q = [&](int g0) {
#pragma unroll
    for (int h = 0; h < HP; ++h) {
      if (g0 + h < G) {
        load_f32(qg + (g0 + h) * D + c * kVec, qr[h]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[h][e] *= a.scale;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[h][e] = 0.f;
      }
    }
  };
  uint32_t qa[D / 16][4];
  if constexpr (kTc)
    load_qa<D>(qg, G, lane, qa);
  else
    load_q(0);
  const int kv_len = min(a.kv_lens[b], a.W * a.bs);
  if (kv_len <= 0) {  // nothing attended: acc / l = 0 / 0, as the TPU kernel gives
    if (split == 0)
      for (int i = tid; i < G * D; i += kThreads) out[i] = from_f32<TQ>(__int_as_float(0x7fffffff));
    return;
  }
  if (s0 >= kv_len) return;  // a dead split: nothing to load, no ticket
  const int n_live = (kv_len + C - 1) / C;
  const int nkeys = min(C, kv_len - s0);

  TKV* Ks = reinterpret_cast<TKV*>(smem);              // [C, kLd]
  TKV* Vs = Ks + C * kLd;                              // [C, kLd]
  float* Ps = reinterpret_cast<float*>(Vs + C * kLd);  // [G, ldp]: scores, then p
  float* Wacc = Ps + G * ldp;                          // [kWarps, G, D]
  float* Wm = Wacc + kWarps * G * D;                   // [kWarps, G]
  float* Wl = Wm + kWarps * G;                         // [kWarps, G]
  int* table_s = reinterpret_cast<int*>(Wl + kWarps * G);
  if (tid < n_ent) table_s[tid] = ent;
  __syncthreads();

  // From here to the merge each warp works alone on its own C / kWarps
  // keys: it copies their K and V rows (16-byte chunks, chunk c of key j
  // to lane (j * kNch + c) % 32), scores them, takes their softmax and P V.
  const int kpw = C / kWarps;  // 4, 8 or 16
  const int j_w = warp * kpw;  // the warp's first key
  const int nk = max(0, min(kpw, nkeys - j_w));
  const TKV* pools[2] = {static_cast<const TKV*>(a.k_pool), static_cast<const TKV*>(a.v_pool)};
  const long long key_stride = (long long)a.Hkv * D;
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    TKV* dst = kv == 0 ? Ks : Vs;
    for (int idx = lane; idx < nk * kNch; idx += 32) {
      const int j = j_w + idx / kNch, cc = idx % kNch;
      const int t = s0 + j, e = t / a.bs;
      const long long row = (long long)table_s[e - first] * a.bs + (t - e * a.bs);
      tc::cp_async16(tc::smem_u32(dst + j * kLd + cc * kVec),
                     pools[kv] + row * key_stride + (long long)kh * D + cc * kVec);
    }
    tc::cp_commit();
  }
  tc::cp_wait(1);  // this lane's K copies have landed
  __syncwarp();
  if constexpr (kTc) {
    warp_tc<D>(Ks, Vs, qa, a.scale, G, j_w, nk, Wacc + warp * G * D, Wm + warp * G,
               Wl + warp * G, lane);
  } else {
    // scores s[g, j] = q[g] . k[j], HP heads a pass
    for (int g0 = 0; g0 < G; g0 += HP) {
      if (g0 > 0) load_q(g0);
      for (int jj = 0; jj < nk; jj += kKpw) {  // warp-uniform
        const int j = j_w + jj + lane / kNch;
        const bool ok = jj + lane / kNch < nk;
        float kx[kVec];
        if (ok) {
          load_f32(Ks + j * kLd + c * kVec, kx);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kx[e] = 0.f;
        }
        float sc[HP];
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          sc[h] = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) sc[h] = fmaf(qr[h][e], kx[e], sc[h]);
        }
        const float r = reduce_heads<HP, kNch>(sc, lane);
        const int h = c / (kNch / HP);
        if (ok && c % (kNch / HP) == 0 && g0 + h < G) Ps[(g0 + h) * ldp + j] = r;
      }
    }
    __syncwarp();

    // softmax over the warp's keys, 32 / kpw heads at a time (kpw lanes a
    // head); the shift is clamped to 0 when the max is not finite, as the
    // TPU kernel does. A warp past the split's last key gets shift -inf and
    // weighs 0 in the merge.
    for (int g0 = 0; g0 < G; g0 += 32 / kpw) {
      const int g = g0 + lane / kpw, jj = lane % kpw;
      const bool ok = g < G && jj < nk;
      float* pj = Ps + g * ldp + j_w + jj;
      const float sv = ok ? *pj : -INFINITY;
      float m = sv;
      for (int o = kpw / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
      const float shift = isfinite(m) ? m : 0.f;
      const float p = ok ? expf(sv - shift) : 0.f;
      float l = p;
      for (int o = kpw / 2; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
      if (ok) *pj = p;
      if (jj == 0 && g < G) {
        Wm[warp * G + g] = nk > 0 ? shift : -INFINITY;
        Wl[warp * G + g] = l;
      }
    }
    tc::cp_wait(0);  // this lane's V copies have landed
    __syncwarp();

    // P V over the warp's keys: lane = (head g, 16-byte chunk cc) column(s)
    for (int col = lane; col < G * kNch; col += 32) {
      const int g = col / kNch, cc = col % kNch;
      const float* pg = Ps + g * ldp + j_w;
      const TKV* vc = Vs + j_w * kLd + cc * kVec;
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < nk; ++jj) {
        float vx[kVec];
        load_f32(vc + jj * kLd, vx);
        const float p = pg[jj];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = fmaf(p, vx[e], acc[e]);
      }
      float* wa = Wacc + (warp * G + g) * D + cc * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) wa[e] = acc[e];
    }
  }
  __syncthreads();

  // merge the warps into the split's (m, l, acc[G, D]); warp 0 holds the
  // split's first key, so its shift and hence M is finite
  const int per = G * (D + 2);
  float* part = a.partials + (((long long)b * a.Hkv + kh) * gridDim.z + split) * per;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Wm[w * G + g]);
    float L = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(Wm[w * G + g] - M);
      L = fmaf(wt, Wl[w * G + g], L);
      acc = fmaf(wt, Wacc[(w * G + g) * D + i % D], acc);
    }
    if (n_live == 1) {
      out[i] = from_f32<TQ>(acc / L);
    } else {
      part[i] = acc;
      if (i % D == 0) {
        part[G * D + g] = M;
        part[G * D + G + g] = L;
      }
    }
  }
  if (n_live == 1) return;

  // the last split of (b, kh) to arrive merges the partials
  __syncthreads();  // every thread's partial is written before the ticket
  if (tid == 0) {
    int* ticket = a.tickets + (long long)b * a.Hkv + kh;
    last_s = take_ticket(ticket) == n_live - 1;
    if (last_s) *ticket = 0;  // every live split has counted: reset for the next launch
  }
  __syncthreads();
  if (!last_s) return;

  // each output value merges the n_live partials online in f32, 8 splits'
  // loads issued at a time
  const float* base = a.partials + ((long long)b * a.Hkv + kh) * gridDim.z * per;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float M = -INFINITY, L = 0.f, acc = 0.f;
    for (int s = 0; s < n_live; s += 8) {
      float m[8], l[8], x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* ps = base + (s + u) * per;
        const bool ok = s + u < n_live;
        m[u] = ok ? __ldcg(ps + G * D + g) : -INFINITY;
        l[u] = ok ? __ldcg(ps + G * D + G + g) : 0.f;
        x[u] = ok ? __ldcg(ps + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        // split 0 comes first and its M is finite, so M_new is finite and
        // the weights below are never NaN
        const float M_new = fmaxf(M, m[u]);
        const float old_w = expf(M - M_new), w = expf(m[u] - M_new);
        L = L * old_w + l[u] * w;
        acc = acc * old_w + x[u] * w;
        M = M_new;
      }
    }
    out[i] = from_f32<TQ>(acc / L);
  }
}

template <typename TQ, typename TKV, int D, int HP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int n_split = (a.W * a.bs + a.C - 1) / a.C;
  if (B <= 0 || n_split <= 0) return cudaSuccess;
  if (n_split > 65535 || a.Hkv > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<TKV, D>(a.H / a.Hkv, a.C);
  auto kernel = paged_decode_kernel<TQ, TKV, D, HP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, a.Hkv, n_split), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_g(const Args& a, int B, cudaStream_t stream) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {  // the tensor-core path takes every G
    return launch<TQ, TKV, D, 1>(a, B, stream);
  } else {
    const int G = a.H / a.Hkv;
    if (G == 1) return launch<TQ, TKV, D, 1>(a, B, stream);
    if (G == 2) return launch<TQ, TKV, D, 2>(a, B, stream);
    return launch<TQ, TKV, D, kMaxHeadsPerPass>(a, B, stream);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_g<TQ, TKV, 32>(a, B, stream);
    case 64: return launch_g<TQ, TKV, 64>(a, B, stream);
    case 128: return launch_g<TQ, TKV, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace decode
}  // namespace paged

// q [B,1,H,D] (q_dtype), pools [N,bs,Hkv,D] (kv_dtype, 16-byte aligned),
// tables [B,W] int32, kv_lens [B] int32, out [B,1,H,D] (q_dtype); partials
// f32 of at least B*Hkv*ceil(W*bs/split_keys)*(H/Hkv)*(D+2) words and
// tickets int32 [B*Hkv] all 0 (the launch leaves them 0); split_keys in
// {32, 64, 128}. All on one device. Returns the launch's cudaError_t (0 on
// success).
extern "C" int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const void* tables, const void* kv_lens, void* out,
                                   void* partials, void* tickets, int B, int H, int Hkv, int D,
                                   int block_size, int W, int split_keys, int q_dtype,
                                   int kv_dtype, float scale, void* stream) {
  using namespace paged;
  using namespace paged::decode;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroups || block_size <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  if (split_keys != 32 && split_keys != 64 && split_keys != 128) return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, static_cast<const int*>(tables),
               static_cast<const int*>(kv_lens), out, static_cast<float*>(partials),
               static_cast<int*>(tickets), H, Hkv, block_size, W, split_keys, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32) return launch_d<float, float>(a, B, D, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(a, B, D, s);
  if (q_dtype == kF32 && kv_dtype == kBF16) return launch_d<float, __nv_bfloat16>(a, B, D, s);
  return cudaErrorInvalidValue;
}
