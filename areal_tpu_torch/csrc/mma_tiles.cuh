// Warp-level tile helpers for bf16 tensor-core kernels on Hopper (sm_90a):
// mma.sync m16n8k16 (bf16 in, f32 accumulate), ldmatrix fragment loads from
// padded shared-memory tiles, and cp.async copies with zero-fill.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4; each 32-bit register holds two bf16, lower index in the low
// half):
//   A (16 x 16, row major)  a0 (g, 2t..2t+1)      a1 (g + 8, 2t..2t+1)
//                           a2 (g, 2t+8..2t+9)    a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, k x n)       b0 (2t..2t+1, g)      b1 (2t+8..2t+9, g)
//   C (16 x 8, f32)         c0, c1 (g, 2t..2t+1)  c2, c3 (g + 8, 2t..2t+1)
// The C fragments of two neighbouring n8 tiles are, rounded and packed in
// pairs, the A fragment of one k16 chunk (pack_a_from_c): a product's
// result feeds the next product from registers.
//
// Shared tiles are row major with a row stride of HD + 8 bf16 (a multiple
// of 16 bytes that is 16 bytes past a multiple of 128), so the eight 16-byte
// rows an ldmatrix phase reads fall in eight different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tiles {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from global to shared memory that does not wait; with
// valid == false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// The same for one 4-byte word (sources that are only 4-byte aligned).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy ROWS x HD bf16 rows from a strided global source into a padded
// shared tile (row stride HD + 8) with 16-byte cp.async copies by NT
// threads; rows at or past `valid` are zero-filled and not read.
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void cp_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              size_t row_stride, int valid) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  constexpr int LDS = HD + 8;
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += NT) {
    const int row = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    const bool in = row < valid;
    cp_async_16(dst + row * LDS + col, in ? src + row * row_stride + col : src, in);
  }
}

// ldmatrix: four 8 x 8 b16 matrices whose row addresses lanes 0-7, 8-15,
// 16-23 and 24-31 give; register i gets matrix i's (lane / 4, 2 (lane % 4)
// ..+1) elements, or with .trans its (2 (lane % 4)..+1, lane / 4) elements.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// A fragment of rows row0..row0+15, columns k0..k0+15 of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (n0..n0+7 in b[0], b[1]; n0+8..n0+15 in
// b[2], b[3]) over k0..k0+15, from a tile stored [n][k] (B = tile^T): the
// K of Q K^T, the Q of K Q^T.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                          int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (B = tile), through ldmatrix.trans:
// the K of dS K, the dO of P^T dO.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                          int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// c += a b on one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k16 chunk `kc` from the C fragments of n8 tiles 2 kc
// and 2 kc + 1, rounded to bf16.
template <int NT>
__device__ __forceinline__ void pack_a_from_c(uint32_t (&a)[4], const float (&c)[NT][4], int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// The (lowest, highest) segment-id ranges of two tiles share an id.
__device__ __forceinline__ bool ranges_meet(int2 a, int2 b) {
  return max(a.x, b.x) <= min(a.y, b.y);
}

}  // namespace tiles
