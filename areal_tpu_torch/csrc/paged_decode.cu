// Paged decode attention over a KV page pool, for Hopper (sm_90a).
//
// Two entry points from one set of templates:
//   paged_decode_bf16 - bf16 pool. Takes the role of jax's stock TPU paged
//     attention kernel (areal_tpu/engine/paged.py:paged_decode_attention,
//     impl="kernel", pak.paged_attention).
//   paged_decode_int8 - int8 pool with squeezed f32 scales. Replaces
//     areal_tpu/ops/pallas/paged_decode_int8.py:int8_paged_decode_attention
//     (body _kernel), dequantizing as int8 * s / 127.5.
//
// What it computes: for each row b and q head h, attention of the one query
// q[b, h] over the first lengths[b] tokens of the row's sequence, whose token
// t lives at pool page page_indices[b, t / pg], offset t % pg, under kv head
// h / group.
//
// Each entry point picks one of two modes from the page table's row stride:
//
// Decode mode (row stride P: one page row per sequence, one new token each).
//   What bounds it on the H100: bytes. Each token's K and V rows are read
//   once per kv head and used by the `group` q heads of that head, ~2 *
//   group flops per byte; the floor is sum(lengths) * Hkv * hd * 2 * bytes
//   over 3.35 TB/s. What the design does about it:
//   - split-K over pages: the grid is (kv head, sequence, split), and split
//     s owns pages [s * pps, (s + 1) * pps). The split count comes from the
//     shapes and the SM count (engine/paged.py:split_plan, about four CTAs
//     an SM), never from the lengths, so the host never waits on the
//     device; a split that starts past its sequence's length exits at once
//     with l = 0. Each CTA computes the group's q heads over its pages, so
//     each K/V row is read once. The group is a template argument (2, 4, 6
//     or 8 heads, the next at or above the model's): registers hold q and
//     the accumulator of every head, and at group 6 and hd 128 a CTA fits
//     in 168 registers a thread, three CTAs an SM.
//   - loads of 16 bytes a lane (8 for int8): a token's row is spread over
//     hd / 8 lanes, so one warp load covers 2 tokens (4 for hd 64), and each
//     lane has UNR K and UNR V loads in flight before it multiplies.
//   - online softmax in registers, warps merged in shared memory at the end;
//     with more than one split, each CTA writes its f32 partial (m, l,
//     acc[hd]) to scratch and a combine kernel merges the splits in split
//     order into bf16 out (no atomics: two runs are bit-equal).
//   - int8 pools move pg * (hd + 4) bytes per (head, page) instead of 2 * pg
//     * hd; the dequantization scale is applied once per token after the
//     dot product (K) and folded into p (V), in f32.
//
// Chunk mode (row stride 0: the rows are consecutive tokens of one prompt
// sharing one page row, chunked prefill).
//   What bounds it: operations; the K/V are shared by every row. What the
//   design does about it: a CTA takes 64 consecutive rows of one q head and
//   runs the flash forward's tensor-core mainloop (flash_tile.cuh) over the
//   page row's 64-token kv tiles, each tile gathered once for all 64 rows
//   through page_indices with 16-byte cp.async copies into a two-stage ring
//   (a tile may span pages: pg = 16 puts four pages in one tile). The mask
//   is token < lengths[row], per row; nothing else is assumed of the rows'
//   lengths. For the int8 pool the loader copies the int8 rows and scales,
//   then dequantizes them into the bf16 shared tile: K and V are rounded to
//   bf16 once before the products, where the plain version dequantizes in
//   f32. P is rounded to bf16 before P V, as in the forward.
//
// Layouts (contiguous): q [B, Hq, hd] bf16; pools [Hkv, N, pg, hd] (bf16,
// or int8 data plus f32 scales [Hkv, N, pg]); lengths [B] int32; page
// indices [B, P] int32 read with a row stride (P or 0); out [B, Hq, hd]
// bf16; partials, decode mode with n_splits > 1, f32 [B, Hq, n_splits, 2]
// (m, l) followed by [B, Hq, n_splits, hd] (acc).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int NWARPS = 4;  // decode-mode CTA
constexpr int NTHREADS = NWARPS * 32;
constexpr int G_MAX = 8;  // largest GQA group (q heads per kv head) taken
constexpr int UNR = 4;    // K and V loads in flight per lane
constexpr float NEG_INF = flash::NEG_INF;
constexpr float KV_INT8_MAX = 127.5f;  // areal_tpu_torch/ops/quant_const.py

// Eight consecutive values of one K or V row: 16 bytes of bf16 or 8 bytes
// of int8, loaded with one instruction.
template <typename KV>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void to_float(float (&x)[8]) const {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Row8<int8_t> {
  uint2 w = make_uint2(0u, 0u);
  __device__ __forceinline__ void load(const int8_t* p) { w = *reinterpret_cast<const uint2*>(p); }
  __device__ __forceinline__ void to_float(float (&x)[8]) const {
    const uint32_t u[2] = {w.x, w.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = (float)(int8_t)(u[i >> 2] >> (8 * (i & 3)));
  }
};

// ---------------------------------------------------------------------------
// Decode mode: one CTA per (kv head, sequence, split).
// ---------------------------------------------------------------------------

template <typename KV, int HD, int G>
__global__ void __launch_bounds__(NTHREADS)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const KV* __restrict__ k_pool, const float* __restrict__ k_scales,
                   const KV* __restrict__ v_pool, const float* __restrict__ v_scales,
                   const int* __restrict__ lengths, const int* __restrict__ page_indices,
                   int pi_row_stride, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ partials, int Hq, int N, int pg, int P, int group,
                   int pages_per_split, float scale_log2) {
  constexpr int LPT = HD / 8;   // lanes per token row (8 values a lane)
  constexpr int TPW = 32 / LPT; // tokens per warp load
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int S = gridDim.z;
  const int B = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / LPT;        // this lane's token within a warp load
  const int d0 = (lane % LPT) * 8;   // this lane's first dim
  const int h0 = hk * group;

  __shared__ float s_m[NWARPS][G];
  __shared__ float s_l[NWARPS][G];
  __shared__ float s_acc[NWARPS][G][HD];

  int len = lengths[b];
  len = len < 0 ? 0 : (len > P * pg ? P * pg : len);
  const int t0 = sp * pages_per_split * pg;
  const int t1 = min(t0 + pages_per_split * pg, len);
  float* part_ml = partials;
  float* part_acc = partials + (size_t)B * Hq * S * 2;

  if (t0 >= t1) {  // nothing of this sequence in this split
    if (S > 1) {
      for (int g = threadIdx.x; g < group; g += NTHREADS) {
        part_ml[(((size_t)b * Hq + h0 + g) * S + sp) * 2] = NEG_INF;
        part_ml[(((size_t)b * Hq + h0 + g) * S + sp) * 2 + 1] = 0.f;
      }
    } else {
      for (int i = threadIdx.x; i < group * HD; i += NTHREADS)
        out[((size_t)b * Hq + h0) * HD + i] = __float2bfloat16(0.f);
    }
    return;
  }

  // This lane's dims of the group's q heads, scaled to log2 units.
  float qv[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      Row8<__nv_bfloat16> r;
      r.load(q + ((size_t)b * Hq + h0 + g) * HD + d0);
      r.to_float(qv[g]);
#pragma unroll
      for (int d = 0; d < 8; ++d) qv[g][d] *= scale_log2;
    } else {
#pragma unroll
      for (int d = 0; d < 8; ++d) qv[g][d] = 0.f;
    }
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[g][d] = 0.f;
  }

  const int* prow = page_indices + (size_t)b * pi_row_stride;
  const size_t head_off = (size_t)hk * N;

  // Each warp takes TPW * UNR consecutive tokens a step, all its loads
  // issued before the first is used; the warps interleave.
  for (int tb = t0 + warp * TPW * UNR; tb < t1; tb += NWARPS * TPW * UNR) {
    Row8<KV> kr[UNR], vr[UNR];  // zero where no token is loaded
    float ks[UNR], vs[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int t = tb + u * TPW + sub;
      if (t < t1) {
        const size_t tok = (head_off + prow[t / pg]) * pg + (t % pg);
        kr[u].load(k_pool + tok * HD + d0);
        vr[u].load(v_pool + tok * HD + d0);
        if constexpr (sizeof(KV) == 1) {
          ks[u] = k_scales[tok] / KV_INT8_MAX;
          vs[u] = v_scales[tok] / KV_INT8_MAX;
        } else {
          ks[u] = vs[u] = 1.f;
        }
      } else {
        ks[u] = vs[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      if (tb + u * TPW >= t1) break;  // no token of this load in range (warp-uniform)
      const bool valid = tb + u * TPW + sub < t1;
      float kx[8], vx[8];
      kr[u].to_float(kx);
      vr[u].to_float(vx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= group) break;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < 8; ++d) s += qv[g][d] * kx[d];
        // Sum over the token's LPT lanes: every lane of it ends with the sum.
#pragma unroll
        for (int off = LPT / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        s = valid ? s * ks[u] : -INFINITY;
        // Max over the warp load's TPW tokens: m stays equal on all lanes.
        float mx = s;
#pragma unroll
        for (int off = LPT; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = flash::exp2_approx(m[g] - m_new);
        const float p = flash::exp2_approx(s - m_new);  // 0 for a token out of range
        m[g] = m_new;
        l[g] = l[g] * alpha + p;
        const float pv = valid ? p * vs[u] : 0.f;
#pragma unroll
        for (int d = 0; d < 8; ++d) acc[g][d] = acc[g][d] * alpha + pv * vx[d];
      }
    }
  }

  // Sum each lane's share over the warp's token slots (m is warp-uniform),
  // then merge the warps in shared memory.
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = LPT; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[g][d] += __shfl_xor_sync(0xffffffffu, acc[g][d], off);
    }
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
    if (sub == 0) {
#pragma unroll
      for (int d = 0; d < 8; ++d) s_acc[warp][g][d0 + d] = acc[g][d];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * HD; i += NTHREADS) {
    const int g = i / HD;
    const int d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float c = s_l[w][g] == 0.f ? 0.f : flash::exp2_approx(s_m[w][g] - mx);
      lsum += s_l[w][g] * c;
      o += s_acc[w][g][d] * c;
    }
    const size_t bh = (size_t)b * Hq + h0 + g;
    if (S == 1) {
      out[bh * HD + d] = __float2bfloat16(lsum > 0.f ? o / lsum : 0.f);
    } else {
      part_acc[(bh * S + sp) * HD + d] = o;
      if (d == 0) {
        part_ml[(bh * S + sp) * 2] = mx;
        part_ml[(bh * S + sp) * 2 + 1] = lsum;
      }
    }
  }
}

// Merge the splits of one (sequence, q head) in split order: one thread a
// dim. A split with l = 0 (empty) is skipped; its acc is never read.
template <int HD>
__global__ void __launch_bounds__(HD)
paged_combine_kernel(const float* __restrict__ partials, __nv_bfloat16* __restrict__ out,
                     int S) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = gridDim.x;
  const int B = gridDim.y;
  const int d = threadIdx.x;
  const size_t bh = (size_t)b * Hq + h;
  const float* ml = partials + bh * S * 2;
  const float* acc = partials + (size_t)B * Hq * S * 2 + bh * S * HD;
  float mx = NEG_INF;
  for (int s = 0; s < S; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  float lsum = 0.f, o = 0.f;
  for (int s = 0; s < S; ++s) {
    const float l = ml[2 * s + 1];
    if (l > 0.f) {
      const float c = flash::exp2_approx(ml[2 * s] - mx);
      lsum += l * c;
      o += acc[(size_t)s * HD + d] * c;
    }
  }
  out[bh * HD + d] = __float2bfloat16(lsum > 0.f ? o / lsum : 0.f);
}

// ---------------------------------------------------------------------------
// Chunk mode: one CTA per (64-row tile, q head).
// ---------------------------------------------------------------------------

using flash::BK;
using flash::BQ;

template <typename KV, int HD>
struct ChunkSmem;

// bf16 pool: the page rows land in the two-stage ring of bf16 tiles that
// the mainloop reads.
template <int HD>
struct ChunkSmem<__nv_bfloat16, HD> {
  static constexpr int ELEMS = flash::Tile<HD>::ELEMS;
  static constexpr size_t bytes() { return (1 + 2 * 2) * ELEMS * sizeof(__nv_bfloat16); }
};

// int8 pool: a two-stage ring of int8 rows and scales, dequantized into one
// pair of bf16 tiles before each step.
template <int HD>
struct ChunkSmem<int8_t, HD> {
  static constexpr int ELEMS = flash::Tile<HD>::ELEMS;
  static constexpr int STAGE = 2 * BK * HD;  // K and V int8 rows of one stage
  static constexpr size_t bytes() {
    return (1 + 2) * ELEMS * sizeof(__nv_bfloat16) + 2 * STAGE + 2 * 2 * BK * sizeof(float);
  }
};

// Copy kv rows k0 .. k0 + 63 of one kv head (`pool` points at the head's
// first page) into `dst` through the page row, 16 bytes a copy; rows at or
// past `valid` are zero-filled and not read. `lds` is the destination's row
// stride in elements of KV.
template <typename KV, int HD>
__device__ __forceinline__ void cp_page_rows(KV* dst, int lds, const KV* pool,
                                             const int* page_row, int pg, int k0, int valid) {
  constexpr int PER = 16 / sizeof(KV);  // elements a copy
  constexpr int CHUNKS = HD / PER;
  for (int c = threadIdx.x; c < BK * CHUNKS; c += flash::NTHREADS) {
    const int row = c / CHUNKS;
    const int col = (c % CHUNKS) * PER;
    const int t = k0 + row;
    const bool in = t < valid;
    const KV* src = pool;
    if (in) src += ((size_t)page_row[t / pg] * pg + t % pg) * HD + col;
    tiles::cp_async_16(dst + row * lds + col, src, in);
  }
}

template <typename KV, int HD>
__global__ void __launch_bounds__(flash::NTHREADS)
paged_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                   const KV* __restrict__ k_pool, const float* __restrict__ k_scales,
                   const KV* __restrict__ v_pool, const float* __restrict__ v_scales,
                   const int* __restrict__ lengths, const int* __restrict__ page_row,
                   __nv_bfloat16* __restrict__ out, int B, int Hq, int Hkv, int N, int pg,
                   int P, float scale_log2) {
  constexpr bool INT8 = sizeof(KV) == 1;
  constexpr int ELEMS = flash::Tile<HD>::ELEMS;
  constexpr int LDS = flash::Tile<HD>::LDS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + ELEMS;                  // bf16: [2 stages][ELEMS]; int8: [ELEMS]
  __nv_bfloat16* sV = sK + (INT8 ? 1 : 2) * ELEMS;
  int8_t* s8 = reinterpret_cast<int8_t*>(sV + (INT8 ? 1 : 2) * ELEMS);  // int8: [2][K, V][BK][HD]
  float* s8scale = reinterpret_cast<float*>(s8 + 2 * 2 * BK * HD);      // int8: [2][K, V][BK]
  __shared__ int s_len[flash::NTHREADS / 32];

  const int b0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const size_t head_tok = (size_t)hk * N * pg;  // first token slot of the kv head

  // This thread's two rows' lengths, and the CTA's longest.
  int qlen[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = b0 + warp * 16 + g + 8 * hh;
    const int n = row < B ? lengths[row] : 0;
    qlen[hh] = n < 0 ? 0 : (n > P * pg ? P * pg : n);
  }
  int mlen = max(qlen[0], qlen[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mlen = max(mlen, __shfl_xor_sync(0xffffffffu, mlen, off));
  if ((tid & 31) == 0) s_len[warp] = mlen;
  __syncthreads();
  mlen = max(max(s_len[0], s_len[1]), max(s_len[2], s_len[3]));
  const int n_tiles = (mlen + BK - 1) / BK;

  flash::WarpRows<HD> w;
  w.clear();

  if (n_tiles > 0) {
    auto load_kv = [&](int stage, int j) {
      const int k0 = j * BK;
      if constexpr (INT8) {
        int8_t* st = s8 + stage * 2 * BK * HD;
        cp_page_rows<KV, HD>(reinterpret_cast<KV*>(st), HD, k_pool + head_tok * HD, page_row,
                             pg, k0, mlen);
        cp_page_rows<KV, HD>(reinterpret_cast<KV*>(st + BK * HD), HD, v_pool + head_tok * HD,
                             page_row, pg, k0, mlen);
        for (int c = tid; c < 2 * BK; c += flash::NTHREADS) {
          const int t = k0 + (c % BK);
          const bool in = t < mlen;
          const float* src = c < BK ? k_scales : v_scales;
          const size_t tok = in ? head_tok + (size_t)page_row[t / pg] * pg + t % pg : 0;
          tiles::cp_async_4(s8scale + stage * 2 * BK + c, src + tok, in);
        }
      } else {
        cp_page_rows<KV, HD>(reinterpret_cast<KV*>(sK + stage * ELEMS), LDS,
                             k_pool + head_tok * HD, page_row, pg, k0, mlen);
        cp_page_rows<KV, HD>(reinterpret_cast<KV*>(sV + stage * ELEMS), LDS,
                             v_pool + head_tok * HD, page_row, pg, k0, mlen);
      }
    };
    // int8: dequantize a landed stage into the bf16 tiles, 16 values a step.
    auto dequantize = [&](int stage) {
      const int8_t* st = s8 + stage * 2 * BK * HD;
      const float* sc = s8scale + stage * 2 * BK;
      for (int c = tid; c < 2 * BK * (HD / 16); c += flash::NTHREADS) {
        const int kv = c / (BK * (HD / 16));  // 0: K, 1: V
        const int row = (c / (HD / 16)) % BK;
        const int col = (c % (HD / 16)) * 16;
        const float s = sc[kv * BK + row] / KV_INT8_MAX;
        const uint4 raw = *reinterpret_cast<const uint4*>(st + (kv * BK + row) * HD + col);
        const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t packed[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t word = u[i >> 1] >> (16 * (i & 1));
          packed[i] = tiles::pack_bf16((float)(int8_t)(word & 0xff) * s,
                                       (float)(int8_t)((word >> 8) & 0xff) * s);
        }
        uint4* dst = reinterpret_cast<uint4*>((kv ? sV : sK) + row * LDS + col);
        dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      }
    };

    // Rows b0 .. b0 + 63 of q head h: row stride Hq * hd; rows past B zero.
    tiles::cp_tile_async<BQ, HD, flash::NTHREADS>(sQ, q + ((size_t)b0 * Hq + h) * HD,
                                                  (size_t)Hq * HD, B - b0);
    load_kv(0, 0);
    tiles::cp_async_commit();

    for (int j = 0, stage = 0; j < n_tiles; ++j, stage ^= 1) {
      if (j + 1 < n_tiles) load_kv(stage ^ 1, j + 1);
      tiles::cp_async_commit();
      tiles::cp_async_wait<1>();
      __syncthreads();
      if (j == 0) w.load_q(sQ, warp * 16);
      const __nv_bfloat16* cK = sK;
      const __nv_bfloat16* cV = sV;
      if constexpr (INT8) {
        dequantize(stage);
        __syncthreads();
      } else {
        cK += stage * ELEMS;
        cV += stage * ELEMS;
      }
      const int k0 = j * BK;
      w.step(cK, cV, scale_log2, [&](int hh, int c) { return k0 + c < qlen[hh]; });
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
  }

  float row_lse[2];
  w.finish(row_lse);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = b0 + warp * 16 + g + 8 * hh;
    if (row < B) w.store_row(out + ((size_t)row * Hq + h) * HD, hh);
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <typename KV, int HD, int G>
int launch_decode(const void* q, const void* kd, const float* ks, const void* vd,
                  const float* vs, const int* lengths, const int* page_indices,
                  int pi_row_stride, void* out, void* partials, int B, int Hq, int Hkv, int N,
                  int pg, int P, int n_splits, int pages_per_split, float scale_log2,
                  cudaStream_t stream) {
  dim3 grid(Hkv, B, n_splits);
  paged_split_kernel<KV, HD, G><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kd), ks,
      static_cast<const KV*>(vd), vs, lengths, page_indices, pi_row_stride,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partials), Hq, N, pg, P,
      Hq / Hkv, pages_per_split, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  paged_combine_kernel<HD><<<dim3(Hq, B), HD, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<__nv_bfloat16*>(out), n_splits);
  return (int)cudaGetLastError();
}

template <typename KV, int HD>
int launch_chunk(const void* q, const void* kd, const float* ks, const void* vd,
                 const float* vs, const int* lengths, const int* page_row, void* out, int B,
                 int Hq, int Hkv, int N, int pg, int P, float scale_log2, cudaStream_t stream) {
  const size_t smem = ChunkSmem<KV, HD>::bytes();
  auto kernel = paged_chunk_kernel<KV, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + BQ - 1) / BQ, Hq);
  kernel<<<grid, flash::NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kd), ks,
      static_cast<const KV*>(vd), vs, lengths, page_row, static_cast<__nv_bfloat16*>(out), B,
      Hq, Hkv, N, pg, P, scale_log2);
  return (int)cudaGetLastError();
}

template <typename KV>
int dispatch(const void* q, const void* kd, const float* ks, const void* vd,
             const float* vs, const int* lengths, const int* page_indices,
             int pi_row_stride, void* out, void* partials, int B, int Hq, int Hkv, int N,
             int pg, int hd, int P, int n_splits, int pages_per_split, float scale,
             cudaStream_t stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > G_MAX || Hq > 65535 || pg <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const float sl2 = scale * flash::LOG2E;
  if (pi_row_stride == 0) {  // chunk mode
    if (hd == 128) return launch_chunk<KV, 128>(q, kd, ks, vd, vs, lengths, page_indices, out,
                                                B, Hq, Hkv, N, pg, P, sl2, stream);
    if (hd == 64) return launch_chunk<KV, 64>(q, kd, ks, vd, vs, lengths, page_indices, out,
                                              B, Hq, Hkv, N, pg, P, sl2, stream);
    return (int)cudaErrorInvalidValue;
  }
  // Decode mode: the splits must cover [0, P) with none empty by shape.
  if (B > 65535 || n_splits < 1 || n_splits > 65535 || pages_per_split < 1 ||
      (long long)(n_splits - 1) * pages_per_split >= P ||
      (long long)n_splits * pages_per_split < P || (n_splits > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  const int group = Hq / Hkv;
#define ARGS q, kd, ks, vd, vs, lengths, page_indices, pi_row_stride, out, partials, B, Hq, \
             Hkv, N, pg, P, n_splits, pages_per_split, sl2, stream
  if (hd == 128) {
    if (group <= 2) return launch_decode<KV, 128, 2>(ARGS);
    if (group <= 4) return launch_decode<KV, 128, 4>(ARGS);
    if (group <= 6) return launch_decode<KV, 128, 6>(ARGS);
    return launch_decode<KV, 128, G_MAX>(ARGS);
  }
  if (hd == 64) {
    if (group <= 2) return launch_decode<KV, 64, 2>(ARGS);
    if (group <= 4) return launch_decode<KV, 64, 4>(ARGS);
    if (group <= 6) return launch_decode<KV, 64, 6>(ARGS);
    return launch_decode<KV, 64, G_MAX>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                 const int* lengths, const int* page_indices,
                                 int pi_row_stride, void* out, void* partials, int B, int Hq,
                                 int Hkv, int N, int pg, int hd, int P, int n_splits,
                                 int pages_per_split, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pool, nullptr, v_pool, nullptr, lengths, page_indices,
                                 pi_row_stride, out, partials, B, Hq, Hkv, N, pg, hd, P,
                                 n_splits, pages_per_split, scale,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int paged_decode_int8(const void* q, const void* k_data, const float* k_scales,
                                 const void* v_data, const float* v_scales,
                                 const int* lengths, const int* page_indices,
                                 int pi_row_stride, void* out, void* partials, int B, int Hq,
                                 int Hkv, int N, int pg, int hd, int P, int n_splits,
                                 int pages_per_split, float scale, void* stream) {
  return dispatch<int8_t>(q, k_data, k_scales, v_data, v_scales, lengths, page_indices,
                          pi_row_stride, out, partials, B, Hq, Hkv, N, pg, hd, P, n_splits,
                          pages_per_split, scale, static_cast<cudaStream_t>(stream));
}
