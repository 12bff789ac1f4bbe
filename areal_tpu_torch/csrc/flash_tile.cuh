// The attention mainloop of the tiled kernels on Hopper (sm_90a), shared by
// the packed flash forward (flash_attn.cu) and the chunk mode of paged
// decode (paged_decode.cu). Only the K/V loader and the mask differ between
// them; the arithmetic of a (16 query rows, 64 kv rows) step is here.
//
// A CTA is four warps; warp w owns query rows 16 w .. 16 w + 15 of the
// CTA's 64-row tile and keeps, in registers:
//   qf  the rows' q as mma A fragments, loaded once from a padded shared
//       tile through ldmatrix;
//   o   the [16, HD] f32 output accumulator (C fragments, HD / 8 n8 tiles);
//   m   the running row max of scale * log2(e) * q.k (rows g and g + 8 of
//       this lane; the quad of lanes sharing a row holds equal copies);
//   l   this lane's share of the running row sum of p (summed over the quad
//       once, at the end).
// One step against a kv tile in shared memory ([64][HD + 8] bf16):
//   S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 sums), 16 x 64 a warp;
//   masked entries become -inf; the row max moves and rescales o and l;
//   p = exp2(s - m) in f32 (ex2.approx; 0 where masked); l += p;
//   O += P V, with P rounded to bf16 and packed from the S accumulators
//   straight into A fragments (tiles::pack_a_from_c): no P tile in shared
//   memory. P's bf16 rounding is the one the JAX kernel makes (p cast to
//   v's dtype) and the backward kernels repeat; l sums the f32 p.
// A row that meets no key keeps m = NEG_INF (finite, so m - m_new is 0, not
// nan) and l = 0: it writes out = 0 and lse = NEG_INF, as padding rows did
// before and as the backward expects (it masks before exp(s - lse)).

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace flash {

constexpr int BQ = 64;         // query rows per CTA tile (16 per warp)
constexpr int BK = 64;         // kv rows per tile
constexpr int NTHREADS = 128;  // four warps
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x by the SFU (ex2.approx, flush-to-zero); 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct Tile {
  static constexpr int LDS = HD + 8;       // padded bf16 row stride
  static constexpr int ELEMS = BQ * LDS;   // bf16 elements of one 64-row tile
};

template <int HD>
struct WarpRows {
  static constexpr int KC = HD / 16;  // k16 chunks over hd
  static constexpr int ND = HD / 8;   // n8 tiles over hd
  static constexpr int NS = BK / 8;   // n8 tiles over the kv columns of S
  static constexpr int LDS = Tile<HD>::LDS;

  uint32_t qf[KC][4];
  float o[ND][4];
  float m[2];
  float l[2];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // This warp's 16 rows of the padded q tile `sQ`, starting at `row0`.
  __device__ __forceinline__ void load_q(const __nv_bfloat16* sQ, int row0) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) tiles::load_a(qf[kc], sQ, LDS, row0, kc * 16);
  }

  // One kv tile. `ok(hh, c)`: row g + 8 hh of this lane may see kv column c
  // (0..63) of the tile. scale_log2 = softmax scale * log2(e).
  template <class Mask>
  __device__ __forceinline__ void step(const __nv_bfloat16* sK, const __nv_bfloat16* sV,
                                       float scale_log2, Mask ok) {
    const int t4 = threadIdx.x & 3;
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        tiles::load_b_nk(b, sK, LDS, np * 16, kc * 16);
        tiles::mma_bf16(s[2 * np], qf[kc], b[0], b[1]);
        tiles::mma_bf16(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    }

    // Mask and row max: c0, c1 are row g, c2, c3 row g + 8; columns
    // n * 8 + 2 t4 + {0, 1}.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hh + e];
          x = ok(hh, n * 8 + 2 * t4 + e) ? x * scale_log2 : -INFINITY;
          mx[hh] = fmaxf(mx[hh], x);
        }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      alpha[hh] = exp2_approx(m[hh] - mx[hh]);
      m[hh] = mx[hh];
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float p = exp2_approx(s[n][e] - m[hh]);  // exp2(-inf) = 0 where masked
        s[n][e] = p;
        l[hh] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P (rounded to bf16) is the A operand from registers.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      tiles::pack_a_from_c<NS>(a, s, kc);
#pragma unroll
      for (int dd = 0; dd < ND / 2; ++dd) {
        uint32_t b[4];
        tiles::load_b_kn(b, sV, LDS, kc * 16, dd * 16);
        tiles::mma_bf16(o[2 * dd], a, b[0], b[1]);
        tiles::mma_bf16(o[2 * dd + 1], a, b[2], b[3]);
      }
    }
  }

  // After the last step: l summed over the quad, and the natural-log
  // logsumexp of rows g and g + 8 (NEG_INF for a row that met no key).
  __device__ __forceinline__ void finish(float (&lse)[2]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      lse[hh] = l[hh] > 0.f ? (m[hh] + log2f(l[hh])) * LN2 : NEG_INF;
    }
  }

  // Row g + 8 hh of O / l as bf16 at `dst` (the row's first element); 0
  // for a row that met no key. Call after finish().
  __device__ __forceinline__ void store_row(__nv_bfloat16* dst, int hh) const {
    const int t4 = threadIdx.x & 3;
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
  }
};

}  // namespace flash
