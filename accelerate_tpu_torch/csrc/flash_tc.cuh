// 16-bit tensor-core pieces of the flash kernels for Hopper (sm_90a):
// swizzled tiles in shared memory filled by cp.async, the wgmma
// descriptors that read them, the m64nNk16 16-bit -> f32 wgmma wrappers
// (both operands from shared memory, or A from registers), their
// fence / commit / wait discipline, and the accumulator -> A-fragment
// conversion that rounds to the element type. flash_fwd.cu and
// flash_bwd_tc.cuh (the backward's dq and dk/dv passes, for the flash and
// the fused backward) build their bf16 variants from these; the fused
// kernels also their fp16 ones. The element type E (bf16 or fp16, default
// bf16) changes only the wgmma's input type (.bf16 or .f16) and the
// rounding of the A fragments and outputs: the swizzle, the descriptors
// and the fragment layouts are the same for every 16-bit type.
//
// Tile layout. An [R, D] bf16 tile (R rows of D values, D a multiple of
// 64) is kept as D/64 column blocks of [R, 64], each row of a column block
// one 128-byte line whose eight 16-byte chunks are permuted chunk ^ (row %
// 8): the 128-byte swizzle (Swizzle<3,4,3>) that a wgmma descriptor of
// layout type 1 reads. Tiles start 1024-byte aligned, so the swizzle,
// which the hardware takes from address bits 7-9, matches row % 8.
//
// Such a tile serves two ways:
// - K-major (the product's K runs along the tile's D columns: Q and K in
//   Q Kᵀ, K and Q in K Qᵀ): k step kk of 16 columns starts at column block
//   kk / 4, 32 bytes per step inside the 128-byte line; 8-row groups are
//   1024 bytes apart (SBO).
// - MN-major (K runs along the tile's rows: V in P V, dO in Pᵀ dO, Q in
//   dSᵀ Q; read transposed): k step kk of 16 rows starts 16 lines (2048
//   bytes) further; 8-row groups 1024 bytes apart (SBO), column blocks of
//   64 outputs R·128 bytes apart (LBO).
//
// Accumulator layout (m64nNk16, f32, N/2 registers a thread): thread t of
// the warpgroup holds d[i] at row 16·(t/32) + (t%32)/4 + 8·((i/2)%2) and
// column 8·(i/4) + 2·(t%4) + i%2. The A fragment of a register-A wgmma has
// the same rows and, for k step kk, columns 16kk .. 16kk+15 as four bf16
// pairs: so accumulator registers 8kk + 2e and 8kk + 2e + 1 (e < 4), or
// values computed from them, rounded pairwise to bf16 by pack_bf16, are
// register e of that fragment with no data movement.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous copies ---------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's newest copy groups are in flight
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}
// make shared-memory writes of the generic proxy (cp.async, st.shared)
// visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of 16-byte chunk c (of D/8 in a row) of row r in a swizzled
// [R, D] tile
__device__ __forceinline__ uint32_t swz(int r, int c, int R) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Start copying rows [0, R) of a row-major 16-bit source (rows `rs`
// elements apart, D values each) into the swizzled tile at shared address
// dst; the NT threads of the block share the 16-byte chunks, neighbours on
// neighbouring global bytes.
template <int D, int NT, typename E>
__device__ __forceinline__ void cp_tile(uint32_t dst, int R, const E* __restrict__ src,
                                        long long rs, int tid) {
  static_assert(sizeof(E) == 2, "tiles hold 16-bit elements");
  constexpr int kChunks = D / 8;
  for (int i = tid; i < R * kChunks; i += NT) {
    const int r = i / kChunks, c = i - r * kChunks;
    cp_async16(dst + swz(r, c, R), src + r * rs + c * 8);
  }
}

// Start copying n 4-byte words (n a multiple of 4, src 16-byte aligned).
template <int NT>
__device__ __forceinline__ void cp_words(uint32_t dst, const void* __restrict__ src, int n,
                                         int tid) {
  for (int i = tid; i < n / 4; i += NT)
    cp_async16(dst + 16 * i, static_cast<const char*>(src) + 16 * i);
}

// ---- descriptors -------------------------------------------------------------

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);  // 128-byte swizzle
}
// K-major operand: rows row0 .. of a swizzled tile of R rows, k step kk
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int R, int row0, int kk) {
  return desc(tile + (kk >> 2) * (R * 128) + row0 * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major operand: k step kk (16 rows from row0) of a swizzled tile of R rows
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int R, int row0, int kk) {
  return desc(tile + (row0 + 16 * kk) * 128, R * 128, 1024);
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// After wg_wait_all: ties every register a finished wgmma read or wrote to
// a point after the wait, so the compiler neither reads an accumulator
// early nor reuses an A-fragment register while the product may still
// read it.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// m64nNk16 E x E -> f32 (E bf16 or fp16). ss: A [64, 16] K-major and B
// [16, N] K-major through descriptors; d = A B + (acc ? d : 0). rs: A from
// registers, B MN-major (transposed) through a descriptor; d = A B + (acc ?
// d : 0). The instruction text differs only in the input type, TY.
#define TC_D32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define TC_D64 \
  TC_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
  "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), \
  "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define TC_R32                                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define TC_R64                                                                            \
  TC_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define TC_SS(N, TY, REGS, OUTS, P, A, B)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS     \
               "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"                                     \
               : OUTS                                                                      \
               : "l"(da), "l"(db), "r"(acc))
#define TC_RS(N, TY, REGS, OUTS, P, A, B)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS     \
               "}, {" A "}, " B ", p, 1, 1, 1;\n}\n"                                      \
               : OUTS                                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))

template <int N, typename E = bf16>
struct Mma;

template <typename E>
struct Mma<64, E> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    if constexpr (std::is_same<E, f16>::value)
      TC_SS(64, "f16", TC_R32, TC_D32, "%34", "%32", "%33");
    else
      TC_SS(64, "bf16", TC_R32, TC_D32, "%34", "%32", "%33");
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    if constexpr (std::is_same<E, f16>::value)
      TC_RS(64, "f16", TC_R32, TC_D32, "%37", "%32, %33, %34, %35", "%36");
    else
      TC_RS(64, "bf16", TC_R32, TC_D32, "%37", "%32, %33, %34, %35", "%36");
  }
};

template <typename E>
struct Mma<128, E> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    if constexpr (std::is_same<E, f16>::value)
      TC_SS(128, "f16", TC_R64, TC_D64, "%66", "%64", "%65");
    else
      TC_SS(128, "bf16", TC_R64, TC_D64, "%66", "%64", "%65");
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    if constexpr (std::is_same<E, f16>::value)
      TC_RS(128, "f16", TC_R64, TC_D64, "%69", "%64, %65, %66, %67", "%68");
    else
      TC_RS(128, "bf16", TC_R64, TC_D64, "%69", "%64, %65, %66, %67", "%68");
  }
};

#undef TC_SS
#undef TC_RS
#undef TC_R64
#undef TC_R32
#undef TC_D64
#undef TC_D32

// pair (lo, hi) rounded to bf16 (round to nearest even) in one 32-bit
// register, lo in the low half: where the TPU kernels call .astype(bf16)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// the same for element type E: fp16 rounds to nearest even too, and a
// value past fp16's range becomes inf (no saturation), as .astype(fp16)
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<E, f16>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    return pack_bf16(lo, hi);
  }
}
// two E values of one 32-bit word as f32 (lo, hi)
template <typename E>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (std::is_same<E, f16>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// Coordinates of accumulator register i inside the warpgroup's 64-row tile.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// Reduce over the four lanes of a quad (the lanes that share a row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Write a warpgroup's [64, D] accumulator as E (bf16 or fp16) into rows
// of a row-major tensor (dst at the warpgroup's first row, rows rs apart).
template <int D, typename E>
__device__ __forceinline__ void store_acc(E* __restrict__ dst, long long rs,
                                          const float (&d)[D / 2], int t) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2)
    *reinterpret_cast<uint32_t*>(dst + acc_row(t, i) * rs + acc_col(t, i)) =
        pack2<E>(d[i], d[i + 1]);
}

// Bytes of dynamic shared memory a kernel asks for: its layout plus the
// slack that lets it align its first tile to 1024 bytes.
constexpr uint32_t kAlignSlack = 1024;
constexpr uint32_t kMaxSmem = 232448;  // dynamic shared memory a block may use on Hopper
__host__ __device__ constexpr uint32_t round1k(uint32_t x) { return (x + 1023u) & ~1023u; }

// The first 1024-byte aligned shared address of the dynamic buffer, and
// the generic pointer to it.
__device__ __forceinline__ uint32_t aligned_base(unsigned char* raw, unsigned char** ptr) {
  const uint32_t a = smem_u32(raw);
  const uint32_t base = (a + 1023u) & ~1023u;
  *ptr = raw + (base - a);
  return base;
}

}  // namespace tc
