// Shared pieces of the fused short-sequence attention kernels
// (fused_attention_fwd.cu, fused_attention_bwd.cu): tile geometry, loading
// a BSHD tile into shared memory as f32, and the two register-blocked tile
// products every pass is built from.
//
// A thread block of 256 threads works on square tiles of BR query or key
// rows (BR = 64 for D = 64, 32 for larger D so that four [BR, D] f32 tiles
// fit in shared memory). The threads form a TR x TC grid: thread (tr, tc)
// owns tile rows tr*4 .. tr*4+3 and the columns tc, tc + TC, ... of every
// tile it produces, so a row's values are spread over the TC neighbouring
// lanes of one warp (a half or a whole warp) and a row reduction is a few
// shuffles. Tiles are f32 in shared memory with an odd row stride, so the
// column reads of one warp hit distinct banks. Products run on CUDA-core
// f32 FMA: exact for bf16 inputs, f32 accumulation, the same arithmetic as
// the TPU kernels' dot_general with preferred_element_type=f32.
#pragma once

#include "paged_common.cuh"

namespace fused {

using paged::from_f32;
using paged::to_f32;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Geo {
  static constexpr int BR = D <= 64 ? 64 : 32;  // rows of a query or key tile
  static constexpr int TR = BR / 4;             // thread rows, 4 tile rows each
  static constexpr int TC = kThreads / TR;      // thread columns (16 or 32 lanes)
  static constexpr int LD = D + 1;              // f32 row stride of a [BR, D] tile
  static constexpr int LS = BR + 1;             // f32 row stride of a [BR, BR] tile
  static constexpr int SC = BR / TC;            // columns of a [BR, BR] tile per thread
  static constexpr int DC = D / TC;             // columns of a [BR, D] tile per thread
  static constexpr size_t kTile = sizeof(float) * BR * LD;
  static constexpr size_t kScore = sizeof(float) * BR * LS;
};

// x rounded to the storage type T and back: where the TPU kernels call
// .astype(input dtype) on an f32 value
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Reduce over the TC lanes that share one thread row (aligned lane groups).
template <int TC>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = TC / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
template <int TC>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TC / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Rows [0, BR) of one head of a BSHD tensor into an f32 [BR, LD] tile:
// `src` points at the tile's first row, rows are `rs` elements apart and D
// elements long. 16-byte loads, neighbouring threads on neighbouring bytes.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long rs) {
  using G = Geo<D>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < G::BR * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, w = idx - r * kPerRow;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + r * rs + w * kVec));
    const T* vals = reinterpret_cast<const T*>(&raw);
    float* o = dst + r * G::LD + w * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = to_f32(vals[e]);
  }
}

// acc[r][c] = sum_d A[tr*4 + r][d] * B[tc + TC*c][d]: a [BR, BR] tile of
// A Bᵀ from two [BR, LD] tiles.
template <int D>
__device__ __forceinline__ void tile_nt(float (&acc)[4][Geo<D>::SC], const float* A,
                                        const float* B, int tr, int tc) {
  using G = Geo<D>;
  const float* a = A + tr * 4 * G::LD;
  const float* b = B + tc * G::LD;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::SC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[G::SC];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[r * G::LD + d];
#pragma unroll
    for (int c = 0; c < G::SC; ++c) bv[c] = b[c * G::TC * G::LD + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < G::SC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// acc[r][c] += sum_j P[tr*4 + r][j] * B[j][tc + TC*c]: a [BR, D] tile of
// P B from a [BR, LS] tile P and a [BR, LD] tile B.
template <int D>
__device__ __forceinline__ void tile_nn(float (&acc)[4][Geo<D>::DC], const float* P,
                                        const float* B, int tr, int tc) {
  using G = Geo<D>;
  const float* p = P + tr * 4 * G::LS;
  const float* b = B + tc;
#pragma unroll 4
  for (int j = 0; j < G::BR; ++j) {
    float pv[4], bv[G::DC];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = p[r * G::LS + j];
#pragma unroll
    for (int c = 0; c < G::DC; ++c) bv[c] = b[j * G::LD + c * G::TC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < G::DC; ++c) acc[r][c] = fmaf(pv[r], bv[c], acc[r][c]);
  }
}

// Write a [BR, D] register tile, times `mul`, as T into rows of a BSHD
// tensor (`dst` at the tile's first row, rows `rs` elements apart).
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* dst, long long rs, const float (&acc)[4][Geo<D>::DC],
                                           float mul, int tr, int tc) {
  using G = Geo<D>;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::DC; ++c)
      dst[(tr * 4 + r) * rs + tc + c * G::TC] = from_f32<T>(acc[r][c] * mul);
}

// Kernel templates for each head dim in the envelope (D % 64 == 0, <= 256).
#define FUSED_DISPATCH_D(D, ...)                          \
  switch (D) {                                            \
    case 64: { constexpr int kD = 64; __VA_ARGS__ }       \
    case 128: { constexpr int kD = 128; __VA_ARGS__ }     \
    case 192: { constexpr int kD = 192; __VA_ARGS__ }     \
    case 256: { constexpr int kD = 256; __VA_ARGS__ }     \
    default: return cudaErrorInvalidValue;                \
  }

}  // namespace fused
