// Shared pieces of the blocked flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkdv.cu), on top of the fused kernels' tile geometry
// and products (fused_common.cuh): the element mask, the lattice walk's
// arguments, and a product whose left tile has a runtime row stride.
//
// The lattice (ops/flash_attention.py `_block_lattice`) is in blocks of
// block_q query rows and block_kv key rows; a thread block of the CUDA-core
// variants works on tiles of BR rows (Geo<D>::BR: 64 for D = 64, 32 above),
// so both block sizes are multiples of BR and a tile never straddles two
// lattice blocks. The tensor-core variants (bf16, D = 64 and 128) take
// their pieces from flash_tc.cuh and tiles of 64 or 128 rows.
#pragma once

#include "fused_common.cuh"

namespace flash {

using fused::Geo;
using fused::kThreads;
using fused::load_tile;
using fused::round_to;
using fused::row_max;
using fused::row_sum;
using fused::store_tile;
using fused::tile_nn;
using fused::tile_nt;
using paged::to_f32;
using paged::from_f32;

// The static part of one flash call, as the Python wrapper passes it.
struct Args {
  int B, S, H, Hkv;
  int causal;   // 0 or 1
  int window;   // 0: none; else attend iff 0 <= qpos - kpos < window (with causal)
  int block_q, block_kv;
  float scale;
  __host__ __device__ int nq() const { return S / block_q; }
  __host__ __device__ int nkv() const { return S / block_kv; }
};

// Whether query position qpos may attend key position kpos with segment ids
// sq and sk (use_seg false: ids ignored) — the TPU kernels' `_allow_mask`.
__device__ __forceinline__ bool allowed(const Args& a, int qpos, int kpos, bool use_seg, int sq,
                                        int sk) {
  return (!a.causal || kpos <= qpos) && (a.window <= 0 || qpos - kpos < a.window) &&
         (!use_seg || sq == sk);
}

// acc[r][c] += sum_j P[tr*4 + r][j] * B[j][tc + TC*c] for j < BR: tile_nn with
// P's row stride ldp given at run time (a slice of a wider score tile).
template <int D>
__device__ __forceinline__ void tile_pv(float (&acc)[4][Geo<D>::DC], const float* P, int ldp,
                                        const float* B, int tr, int tc) {
  using G = Geo<D>;
  const float* p = P + tr * 4 * ldp;
  const float* b = B + tc;
#pragma unroll 4
  for (int j = 0; j < G::BR; ++j) {
    float pv[4], bv[G::DC];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = p[r * ldp + j];
#pragma unroll
    for (int c = 0; c < G::DC; ++c) bv[c] = b[j * G::LD + c * G::TC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < G::DC; ++c) acc[r][c] = fmaf(pv[r], bv[c], acc[r][c]);
  }
}

// Checks every launcher makes before it launches.
inline bool args_ok(const Args& a, int br) {
  return a.B > 0 && a.Hkv > 0 && a.H % a.Hkv == 0 && a.S > 0 && a.block_q > 0 &&
         a.block_kv > 0 && a.block_q % br == 0 && a.block_kv % br == 0 && a.block_kv <= 256 &&
         a.block_q <= 256 && a.S % a.block_q == 0 && a.S % a.block_kv == 0 && a.window >= 0;
}

// Kernel templates for each head dim the flash kernels take (the JAX
// package's `_flash_supported` dims).
#define FLASH_DISPATCH_D(D, ...)                          \
  switch (D) {                                            \
    case 64: { constexpr int kD = 64; __VA_ARGS__ }       \
    case 128: { constexpr int kD = 128; __VA_ARGS__ }     \
    case 256: { constexpr int kD = 256; __VA_ARGS__ }     \
    default: return cudaErrorInvalidValue;                \
  }

inline int br_of(int D) { return D <= 64 ? 64 : 32; }

}  // namespace flash
