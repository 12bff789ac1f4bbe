// Packed causal GQA flash attention, backward pass, for Hopper (sm_90a).
//
// Replaces areal_tpu/ops/pallas/flash_attn.py:_bwd: the dq pallas_call
// (body _dq_kernel) and the dk/dv pallas_call (body _dkv_kernel). On the GPU
// the two kernels also take the backward role that jax's stock splash kernel
// had on the TPU (areal_tpu/ops/attention.py:splash_packed_attention).
//
// What they compute, with p recomputed from the forward's saved logsumexp:
//   s_ij  = scale * q_i . k_j            mask(i, j) as in the forward
//   p_ij  = mask ? exp(s_ij - lse_i) : 0
//   ds_ij = p_ij * (dout_i . v_j - delta_i) * scale,  delta_i = dout_i . out_i
//   dq_i  = sum_j ds_ij k_j
//   dv_j  = sum_i p_ij dout_i            dk_j = sum_i ds_ij q_i
// dk and dv sum over the q heads of the kv head's GQA group. p is rounded to
// bf16 before p^T dout and ds before ds k and ds^T q, sums are f32, outputs
// bf16: the arithmetic of the JAX kernels. The mask is applied before the
// exponential is used: a padding row carries lse = -1e30, where exp(s - lse)
// overflows. Padding rows get dq = 0 exactly and add nothing to dk / dv.
//
// What bounds them on the H100: operations. The backward does five products
// per causal (i, j) pair (these two kernels recompute s and dout.v, seven in
// all) against one read of q, k, v, out, dout and one write of dq, dk, dv.
//
// What the design does about it:
// - Tensor cores. Every product is mma.sync m16n8k16 (bf16 in, f32 sums)
//   on 64 x 64 tiles, four warps a CTA, each warp owning 16 rows of the
//   output tile; operands come from padded shared tiles through ldmatrix
//   (mma_tiles.cuh). The dq kernel computes S = Q K^T and dP = dO V^T; P and
//   dS are formed in the accumulator registers and, rounded to bf16, are
//   the A operand of dQ += dS K without leaving registers. The dk/dv kernel
//   computes the transposed tiles S^T = K Q^T and dP^T = V dO^T, so P^T and
//   dS^T land in registers row-major in the kv rows and feed dV += P^T dO
//   and dK += dS^T Q the same way. No score tile touches shared memory.
// - Pipelined loads. Tiles arrive by cp.async (16-byte copies, zero-filled
//   past T) into a two-stage ring: the next kv tile (dq kernel) or the next
//   q / dout tile with its segment ids, positions, lse and delta (dk/dv
//   kernel) is in flight while the current one is multiplied.
// - Segment-aware tile skip. `ranges` holds, for each 64-token tile of each
//   row, the lowest and the highest positive segment id in it (an empty
//   range for a tile of padding; ops/attention.py:tile_segment_ranges). A
//   (q tile, kv tile) pair is computed only if it is causal (kv tile <= q
//   tile) and the two ranges meet; any other pair is all mask and would add
//   exact zeros, so skipping it changes no bit of the outputs. A q tile
//   whose range meets no kv tile writes dq = 0 without a loop; a kv tile
//   likewise writes dk = dv = 0. The tile is BQ = BK = 64 rows; the library
//   reports it (flash_attn_bwd_tile) so the ranges are built for it.
// - Counting launches: given a non-null `tile_pairs` (one zeroed int per CTA
//   of the grid), the launcher picks the kernel's counting instantiation
//   (COUNT), in which thread 0 of each CTA adds one to its own slot per
//   (q tile, kv tile) product the CTA runs (no atomics), so a test can hold
//   the pairs the kernel computed against the plain predicate and its
//   outputs against the main path's. The main path's instantiation has no
//   counter code.
// - Determinism: each output tile is summed inside one CTA in a fixed
//   order and written once, with no atomics, so two runs are bit-equal:
//   dq by one CTA per (q tile, q head, row) over its live kv tiles; dk/dv by
//   one CTA per (kv tile, kv head, row) over the group's q heads and their
//   live q tiles, so traffic stays [Hkv, T, hd].
// - Order: under one long sequence the last q tile (dq) and the first kv
//   tile (dk/dv) have the most live pairs, so those CTAs are launched first.
//   With packed sequences a tile's work is bounded by its sequences'
//   lengths and no order is known without reading the data; the launch
//   order is then harmless.
//
// Any T is taken (the ragged last tile is masked), hd in {64, 128} and Hq a
// multiple of Hkv.
//
// Layouts (all contiguous): q, dout, dq [R, T, Hq, hd] bf16; k, v, dk, dv
// [R, T, Hkv, hd] bf16; seg, pos [R, T] int32; lse, delta [R, Hq, T] f32;
// ranges [R, ceil(T / 64), 2] int32; tile_pairs, if given, [grid size] int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using tiles::cp_async_4;
using tiles::cp_async_commit;
using tiles::cp_async_wait;
using tiles::cp_tile_async;
using tiles::load_a;
using tiles::load_b_kn;
using tiles::load_b_nk;
using tiles::mma_bf16;
using tiles::pack_a_from_c;
using tiles::ranges_meet;

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // kv rows per tile (== BQ: kv tile j is causal for q tile i iff j <= i)
constexpr int NTHREADS = 128;  // four warps, 16 tile rows each

// Counting instantiations only: one more (q tile, kv tile) product run by
// this CTA.
template <bool COUNT>
__device__ __forceinline__ void count_pair(int* tile_pairs) {
  if (COUNT && threadIdx.x == 0)
    ++tile_pairs[blockIdx.x + (size_t)gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z)];
}

template <int HD>
struct Tile {
  static constexpr int LDS = HD + 8;  // padded bf16 row stride
  static constexpr int TILE = BQ * LDS;  // bf16 elements of one 64-row tile
  static constexpr size_t dq_smem_bytes() {
    return (2 + 2 * 2) * TILE * sizeof(__nv_bfloat16)  // Q, dO; K, V x 2 stages
           + 2 * 2 * BK * sizeof(int);                 // kv seg, pos x 2 stages
  }
  static constexpr size_t dkv_smem_bytes() {
    return (2 + 2 * 2) * TILE * sizeof(__nv_bfloat16)  // K, V; Q, dO x 2 stages
           + 2 * 4 * BQ * sizeof(int);                 // q seg, pos, lse, delta x 2
  }
};

// ---------------------------------------------------------------------------
// dq: one CTA per (q tile, q head, row).
// ---------------------------------------------------------------------------

template <int HD, bool COUNT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const int* __restrict__ seg, const int* __restrict__ pos,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int2* __restrict__ ranges,
                    __nv_bfloat16* __restrict__ dq, int* tile_pairs,
                    int T, int Hq, int Hkv, float scale) {
  constexpr int LDS = Tile<HD>::LDS;
  constexpr int TILE = Tile<HD>::TILE;
  constexpr int KC = HD / 16;  // k16 chunks over hd
  constexpr int ND = HD / 8;   // n8 tiles over hd
  constexpr int NS = BK / 8;   // n8 tiles over the kv columns of S

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + TILE;
  __nv_bfloat16* sK = sdO + TILE;     // [2 stages][TILE]
  __nv_bfloat16* sV = sK + 2 * TILE;  // [2 stages][TILE]
  int* sKst = reinterpret_cast<int*>(sV + 2 * TILE);  // [2 stages][seg BK, pos BK]

  const int nt = gridDim.x;
  const int qt = nt - 1 - blockIdx.x;  // heaviest (last) q tile first
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t q_row_stride = (size_t)Hq * HD;
  const size_t kv_row_stride = (size_t)Hkv * HD;
  const size_t q_off = ((size_t)r * T + q0) * q_row_stride + (size_t)h * HD;
  const __nv_bfloat16* k_base = k + (size_t)r * T * kv_row_stride + (size_t)hk * HD;
  const __nv_bfloat16* v_base = v + (size_t)r * T * kv_row_stride + (size_t)hk * HD;
  const int* seg_r = seg + (size_t)r * T;
  const int* pos_r = pos + (size_t)r * T;
  const size_t stat_off = ((size_t)r * Hq + h) * T;
  const int2* rng = ranges + (size_t)r * nt;

  // Live kv tiles: causal (j <= qt) and meeting the q tile's segment range.
  const int2 qrange = rng[qt];
  int first = 0;
  while (first <= qt && !ranges_meet(rng[first], qrange)) ++first;
  int last = qt;
  while (last >= first && !ranges_meet(rng[last], qrange)) --last;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (first <= last) {
    auto load_kv = [&](int stage, int j) {
      const int k0 = j * BK;
      cp_tile_async<BK, HD, NTHREADS>(sK + stage * TILE, k_base + (size_t)k0 * kv_row_stride,
                                      kv_row_stride, T - k0);
      cp_tile_async<BK, HD, NTHREADS>(sV + stage * TILE, v_base + (size_t)k0 * kv_row_stride,
                                      kv_row_stride, T - k0);
      for (int c = tid; c < 2 * BK; c += NTHREADS) {
        const int row = k0 + (c % BK);
        const bool in = row < T;
        const int* src = c < BK ? seg_r : pos_r;
        cp_async_4(sKst + stage * 2 * BK + c, in ? src + row : seg_r, in);
      }
    };

    cp_tile_async<BQ, HD, NTHREADS>(sQ, q + q_off, q_row_stride, T - q0);
    cp_tile_async<BQ, HD, NTHREADS>(sdO, dout + q_off, q_row_stride, T - q0);
    load_kv(0, first);
    cp_async_commit();

    // This thread's two q rows: g and g + 8 of its warp's 16.
    int qseg[2], qpos[2];
    float qlse[2], qdelta[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + warp * 16 + g + 8 * hh;
      const bool in = row < T;
      qseg[hh] = in ? seg_r[row] : 0;
      qpos[hh] = in ? pos_r[row] : 0;
      qlse[hh] = in ? lse[stat_off + row] : 0.f;
      qdelta[hh] = in ? delta[stat_off + row] : 0.f;
    }

    int j = first, stage = 0;
    while (true) {
      int next = j + 1;
      while (next <= last && !ranges_meet(rng[next], qrange)) ++next;
      if (next <= last) load_kv(stage ^ 1, next);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the tile just requested has landed
      __syncthreads();
      count_pair<COUNT>(tile_pairs);

      const __nv_bfloat16* cK = sK + stage * TILE;
      const __nv_bfloat16* cV = sV + stage * TILE;
      const int* cseg = sKst + stage * 2 * BK;
      const int* cpos = cseg + BK;

      // S = Q K^T and dP = dO V^T on this warp's 16 rows x 64 kv columns.
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = 0.f;
          dp[n][e] = 0.f;
        }
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t aq[4], ao[4];
        load_a(aq, sQ, LDS, warp * 16, kc * 16);
        load_a(ao, sdO, LDS, warp * 16, kc * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          load_b_nk(b, cK, LDS, np * 16, kc * 16);
          mma_bf16(s[2 * np], aq, b[0], b[1]);
          mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
          load_b_nk(b, cV, LDS, np * 16, kc * 16);
          mma_bf16(dp[2 * np], ao, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], ao, b[2], b[3]);
        }
      }

      // dS in place of S: c0, c1 are row g, c2, c3 row g + 8; columns
      // n * 8 + 2 t4 + {0, 1}.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int c = n * 8 + 2 * t4;
        const int2 ks = *reinterpret_cast<const int2*>(cseg + c);
        const int2 kp = *reinterpret_cast<const int2*>(cpos + c);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ksg = e ? ks.y : ks.x;
            const int kps = e ? kp.y : kp.x;
            const bool ok = (qseg[hh] > 0) && (ksg == qseg[hh]) && (qpos[hh] >= kps);
            const float p = ok ? __expf(s[n][2 * hh + e] * scale - qlse[hh]) : 0.f;
            s[n][2 * hh + e] = ok ? p * (dp[n][2 * hh + e] - qdelta[hh]) * scale : 0.f;
          }
      }

      // dQ += dS K: dS (rounded to bf16) is the A operand from registers.
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        uint32_t a[4];
        pack_a_from_c<NS>(a, s, kc);
#pragma unroll
        for (int dd = 0; dd < ND / 2; ++dd) {
          uint32_t b[4];
          load_b_kn(b, cK, LDS, kc * 16, dd * 16);
          mma_bf16(acc[2 * dd], a, b[0], b[1]);
          mma_bf16(acc[2 * dd + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
      if (next > last) break;
      j = next;
      stage ^= 1;
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row >= T) continue;
    __nv_bfloat16* o = dq + ((size_t)r * T + row) * q_row_stride + (size_t)h * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one CTA per (kv tile, kv head, row).
// ---------------------------------------------------------------------------

template <int HD, bool COUNT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const int* __restrict__ seg, const int* __restrict__ pos,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int2* __restrict__ ranges,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int* tile_pairs,
                     int T, int Hq, int Hkv, float scale) {
  constexpr int LDS = Tile<HD>::LDS;
  constexpr int TILE = Tile<HD>::TILE;
  constexpr int KC = HD / 16;  // k16 chunks over hd
  constexpr int ND = HD / 8;   // n8 tiles over hd
  constexpr int NS = BQ / 8;   // n8 tiles over the q columns of S^T

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + TILE;
  __nv_bfloat16* sQ = sV + TILE;       // [2 stages][TILE]
  __nv_bfloat16* sdO = sQ + 2 * TILE;  // [2 stages][TILE]
  int* sQst = reinterpret_cast<int*>(sdO + 2 * TILE);  // [2][seg, pos, lse, delta][BQ]

  const int nt = gridDim.x;
  const int kt = blockIdx.x;  // heaviest (first) kv tile first
  const int hk = blockIdx.y;
  const int r = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = kt * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t q_row_stride = (size_t)Hq * HD;
  const size_t kv_row_stride = (size_t)Hkv * HD;
  const size_t kv_off = ((size_t)r * T + k0) * kv_row_stride + (size_t)hk * HD;
  const int* seg_r = seg + (size_t)r * T;
  const int* pos_r = pos + (size_t)r * T;
  const int2* rng = ranges + (size_t)r * nt;

  // Live q tiles: causal (it >= kt) and meeting the kv tile's segment
  // range; the same for every q head of the group.
  const int2 krange = rng[kt];
  int first = kt;
  while (first < nt && !ranges_meet(rng[first], krange)) ++first;
  int last = nt - 1;
  while (last >= first && !ranges_meet(rng[last], krange)) --last;

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] = 0.f;
      acc_v[n][e] = 0.f;
    }

  if (first <= last) {
    auto load_q = [&](int stage, int h, int it) {
      const int q0 = it * BQ;
      const size_t q_off = ((size_t)r * T + q0) * q_row_stride + (size_t)h * HD;
      cp_tile_async<BQ, HD, NTHREADS>(sQ + stage * TILE, q + q_off, q_row_stride, T - q0);
      cp_tile_async<BQ, HD, NTHREADS>(sdO + stage * TILE, dout + q_off, q_row_stride, T - q0);
      const size_t stat_off = ((size_t)r * Hq + h) * T;
      for (int c = tid; c < 4 * BQ; c += NTHREADS) {
        const int which = c / BQ;
        const int row = q0 + (c % BQ);
        const bool in = row < T;
        const void* src = which == 0   ? static_cast<const void*>(seg_r + row)
                          : which == 1 ? static_cast<const void*>(pos_r + row)
                          : which == 2 ? static_cast<const void*>(lse + stat_off + row)
                                       : static_cast<const void*>(delta + stat_off + row);
        cp_async_4(sQst + stage * 4 * BQ + c, in ? src : static_cast<const void*>(seg_r), in);
      }
    };

    cp_tile_async<BK, HD, NTHREADS>(sK, k + kv_off, kv_row_stride, T - k0);
    cp_tile_async<BK, HD, NTHREADS>(sV, v + kv_off, kv_row_stride, T - k0);
    load_q(0, hk * group, first);
    cp_async_commit();

    // This thread's two kv rows: g and g + 8 of its warp's 16.
    int kseg[2], kpos[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = k0 + warp * 16 + g + 8 * hh;
      const bool in = row < T;
      kseg[hh] = in ? seg_r[row] : 0;  // 0 never equals a live q segment
      kpos[hh] = in ? pos_r[row] : 0;
    }

    int gi = 0, it = first, stage = 0;
    while (true) {
      // The next (head, q tile) pair: the next live q tile of this head,
      // else the first of the next head.
      int g2 = gi, it2 = it + 1;
      while (it2 <= last && !ranges_meet(rng[it2], krange)) ++it2;
      if (it2 > last) {
        ++g2;
        it2 = first;
      }
      const bool more = g2 < group;
      if (more) load_q(stage ^ 1, hk * group + g2, it2);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      count_pair<COUNT>(tile_pairs);

      const __nv_bfloat16* cQ = sQ + stage * TILE;
      const __nv_bfloat16* cdO = sdO + stage * TILE;
      const int* cseg = sQst + stage * 4 * BQ;
      const int* cpos = cseg + BQ;
      const float* clse = reinterpret_cast<const float*>(cseg + 2 * BQ);
      const float* cdelta = reinterpret_cast<const float*>(cseg + 3 * BQ);

      // S^T = K Q^T on this warp's 16 kv rows x 64 q columns.
      float st[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        load_a(a, sK, LDS, warp * 16, kc * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          load_b_nk(b, cQ, LDS, np * 16, kc * 16);
          mma_bf16(st[2 * np], a, b[0], b[1]);
          mma_bf16(st[2 * np + 1], a, b[2], b[3]);
        }
      }

      // P^T in place (f32), and the mask as one bit per accumulator entry:
      // c0, c1 are kv row g, c2, c3 kv row g + 8; q columns n * 8 + 2 t4 + {0, 1}.
      uint32_t live = 0u;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int c = n * 8 + 2 * t4;
        const int2 qs = *reinterpret_cast<const int2*>(cseg + c);
        const int2 qp = *reinterpret_cast<const int2*>(cpos + c);
        const float2 ql = *reinterpret_cast<const float2*>(clse + c);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qsg = e ? qs.y : qs.x;
            const int qps = e ? qp.y : qp.x;
            const float qls = e ? ql.y : ql.x;
            const bool ok = (qsg > 0) && (kseg[hh] == qsg) && (qps >= kpos[hh]);
            st[n][2 * hh + e] = ok ? __expf(st[n][2 * hh + e] * scale - qls) : 0.f;
            live |= (ok ? 1u : 0u) << (n * 4 + 2 * hh + e);
          }
      }

      // dV += P^T dO: P^T (rounded to bf16) is the A operand from registers.
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t a[4];
        pack_a_from_c<NS>(a, st, kc);
#pragma unroll
        for (int dd = 0; dd < ND / 2; ++dd) {
          uint32_t b[4];
          load_b_kn(b, cdO, LDS, kc * 16, dd * 16);
          mma_bf16(acc_v[2 * dd], a, b[0], b[1]);
          mma_bf16(acc_v[2 * dd + 1], a, b[2], b[3]);
        }
      }

      // dP^T = V dO^T.
      float dpt[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        load_a(a, sV, LDS, warp * 16, kc * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          load_b_nk(b, cdO, LDS, np * 16, kc * 16);
          mma_bf16(dpt[2 * np], a, b[0], b[1]);
          mma_bf16(dpt[2 * np + 1], a, b[2], b[3]);
        }
      }

      // dS^T in place of dP^T, from the f32 P^T.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 qd = *reinterpret_cast<const float2*>(cdelta + n * 8 + 2 * t4);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 2 * hh + e;
            const bool ok = (live >> (n * 4 + idx)) & 1u;
            dpt[n][idx] = ok ? st[n][idx] * (dpt[n][idx] - (e ? qd.y : qd.x)) * scale : 0.f;
          }
      }

      // dK += dS^T Q.
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t a[4];
        pack_a_from_c<NS>(a, dpt, kc);
#pragma unroll
        for (int dd = 0; dd < ND / 2; ++dd) {
          uint32_t b[4];
          load_b_kn(b, cQ, LDS, kc * 16, dd * 16);
          mma_bf16(acc_k[2 * dd], a, b[0], b[1]);
          mma_bf16(acc_k[2 * dd + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
      if (!more) break;
      gi = g2;
      it = it2;
      stage ^= 1;
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k0 + warp * 16 + g + 8 * hh;
    if (row >= T) continue;
    const size_t off = ((size_t)r * T + row) * kv_row_stride + (size_t)hk * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(acc_k[n][2 * hh], acc_k[n][2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(acc_v[n][2 * hh], acc_v[n][2 * hh + 1]);
    }
  }
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const int* seg, const int* pos, const float* lse,
              const float* delta, const int* ranges, void* dq, int* tile_pairs,
              int R, int T, int Hq, int Hkv, float scale, cudaStream_t stream) {
  const size_t smem = Tile<HD>::dq_smem_bytes();
  auto kernel = tile_pairs ? flash_bwd_dq_kernel<HD, true> : flash_bwd_dq_kernel<HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, Hq, R);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      seg, pos, lse, delta, reinterpret_cast<const int2*>(ranges),
      static_cast<__nv_bfloat16*>(dq), tile_pairs, T, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const int* seg, const int* pos, const float* lse,
               const float* delta, const int* ranges, void* dk, void* dv,
               int* tile_pairs, int R, int T, int Hq, int Hkv, float scale,
               cudaStream_t stream) {
  const size_t smem = Tile<HD>::dkv_smem_bytes();
  auto kernel = tile_pairs ? flash_bwd_dkv_kernel<HD, true> : flash_bwd_dkv_kernel<HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BK - 1) / BK, Hkv, R);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      seg, pos, lse, delta, reinterpret_cast<const int2*>(ranges),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), tile_pairs, T, Hq,
      Hkv, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int R, int Hq, int Hkv) {
  return Hkv <= 0 || Hq % Hkv != 0 || R > 65535 || Hq > 65535;
}

}  // namespace

extern "C" int flash_attn_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const int* seg,
                                      const int* pos, const float* lse,
                                      const float* delta, const int* ranges,
                                      void* dq, int* tile_pairs, int R, int T,
                                      int Hq, int Hkv, int hd, float scale,
                                      void* stream) {
  if (R <= 0 || T <= 0) return 0;
  if (bad_shape(R, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_dq<128>(q, k, v, dout, seg, pos, lse, delta, ranges, dq, tile_pairs, R, T,
                          Hq, Hkv, scale, s);
  if (hd == 64)
    return launch_dq<64>(q, k, v, dout, seg, pos, lse, delta, ranges, dq, tile_pairs, R, T,
                         Hq, Hkv, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const int* seg,
                                       const int* pos, const float* lse,
                                       const float* delta, const int* ranges,
                                       void* dk, void* dv, int* tile_pairs, int R,
                                       int T, int Hq, int Hkv, int hd, float scale,
                                       void* stream) {
  if (R <= 0 || T <= 0) return 0;
  if (bad_shape(R, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_dkv<128>(q, k, v, dout, seg, pos, lse, delta, ranges, dk, dv, tile_pairs,
                           R, T, Hq, Hkv, scale, s);
  if (hd == 64)
    return launch_dkv<64>(q, k, v, dout, seg, pos, lse, delta, ranges, dk, dv, tile_pairs,
                          R, T, Hq, Hkv, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Rows per q tile and per kv tile (BQ == BK): the block `ranges` is built for.
extern "C" int flash_attn_bwd_tile() { return BQ; }
