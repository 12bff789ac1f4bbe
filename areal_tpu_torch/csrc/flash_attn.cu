// Packed causal GQA flash attention, forward pass, for Hopper (sm_90a).
//
// Replaces areal_tpu/ops/pallas/flash_attn.py:_fwd (body _fwd_kernel), and
// on the GPU also takes the prefill role that jax's stock splash kernel had
// on the TPU (areal_tpu/ops/attention.py:splash_packed_attention).
//
// What it computes, for each packed row r, q head h and token i:
//   out[r, i, h] = softmax_j(scale * q_i . k_j  masked) @ v_j
//   mask(i, j)   = seg[i] == seg[j] && pos[i] >= pos[j] && seg[i] > 0
// with the kv head h / group (GQA), plus the f32 natural-log logsumexp of
// each row (read by the backward). A fully masked (padding) row writes
// out = 0 and lse = -1e30.
//
// What bounds it on the H100: operations. Causal attention does
// 2 * n^2 * hd * Hq flops for a sequence of n tokens against one read of
// its q/k/v and one write of out; at n = 1024 that is ~500 flops per byte,
// above the card's ~295 bf16 flops-per-byte ridge.
//
// What the design does about it:
// - Tensor cores. S = Q K^T and O += P V run as mma.sync m16n8k16 bf16
//   tiles with f32 sums, four warps a CTA, each owning 16 rows of the 64-row
//   q tile, its q fragments, online-softmax state and [16, hd] output in
//   registers (the mainloop of flash_tile.cuh). P goes from the S
//   accumulators, rounded to bf16, into the A operand of P V: the [T, T]
//   score matrix never leaves registers. The one rounding point beyond the
//   inputs' is P to bf16, where the JAX kernel casts p to v's dtype.
// - Pipelined loads. K and V tiles with their segment ids and positions
//   arrive by cp.async (16-byte copies, 4-byte words for ids and positions,
//   zero-filled past T) into a two-stage ring: the next live kv tile is in
//   flight while the current one is multiplied. Q is loaded once, through
//   the second stage's K buffer, before the ring starts.
// - Occupancy. With Q staged in the ring, a CTA takes 70 KB of shared
//   memory (hd 128), and __launch_bounds__(128, 3) holds it to 168
//   registers, so three CTAs share an SM: twelve warps to hide the
//   latency of the mma / ldmatrix chains and of the barrier per tile. The
//   counting build is held to the same bound.
// - Segment-aware tile skip, as in the backward (flash_attn_bwd.cu): q
//   tile i runs kv tile j only if j <= i and the two tiles' segment-id
//   ranges (`ranges`, ops/attention.py:tile_segment_ranges) meet. A skipped
//   pair is all mask, so the skip changes no bit of the outputs. A q tile
//   of padding writes out = 0 and lse = -1e30 without touching K/V. The
//   tile is 64 rows for both kernels; the library reports it
//   (flash_attn_fwd_tile) and the wrapper builds one range tensor per call
//   for the forward and its backward.
// - Counting launches: given a non-null `tile_pairs` (one zeroed int per
//   CTA), the launcher picks the counting instantiation (COUNT), in which
//   thread 0 of each CTA adds one to its own slot per (q tile, kv tile)
//   step it runs (no atomics).
// - Determinism: each output tile is computed by one CTA in a fixed order
//   and written once, so two runs (remat runs the forward twice) are
//   bit-equal. The heaviest (last) q tiles are launched first.
//
// Any T is taken (the ragged last tile is masked), hd in {64, 128} and Hq a
// multiple of Hkv.
//
// Layouts (all contiguous): q [R, T, Hq, hd] bf16; k, v [R, T, Hkv, hd]
// bf16; seg, pos [R, T] int32; ranges [R, ceil(T / 64), 2] int32; out
// [R, T, Hq, hd] bf16; lse [R, Hq, T] f32; tile_pairs, if given, [grid
// size] int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "mma_tiles.cuh"

namespace {

using flash::BK;
using flash::BQ;
using flash::NTHREADS;
using tiles::cp_async_4;
using tiles::cp_async_commit;
using tiles::cp_async_wait;
using tiles::cp_tile_async;
using tiles::ranges_meet;

constexpr int CTAS_PER_SM = 3;

template <int HD>
constexpr size_t smem_bytes() {
  return 2 * 2 * flash::Tile<HD>::ELEMS * sizeof(__nv_bfloat16)  // K, V x 2 stages (and Q)
         + 2 * 2 * BK * sizeof(int);                            // kv seg, pos x 2 stages
}

template <int HD, bool COUNT>
__global__ void __launch_bounds__(NTHREADS, CTAS_PER_SM)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ seg, const int* __restrict__ pos,
                 const int2* __restrict__ ranges,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int* tile_pairs, int T, int Hq, int Hkv, float scale_log2) {
  constexpr int ELEMS = flash::Tile<HD>::ELEMS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2 stages][ELEMS]
  __nv_bfloat16* sV = sK + 2 * ELEMS;                                // [2 stages][ELEMS]
  int* sKst = reinterpret_cast<int*>(sV + 2 * ELEMS);  // [2 stages][seg BK, pos BK]
  __nv_bfloat16* sQ = sK + ELEMS;  // stage 1's K buffer, until the first tile is in registers

  const int nt = gridDim.x;
  const int qt = nt - 1 - blockIdx.x;  // heaviest (last) q tile first
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;

  const size_t q_row_stride = (size_t)Hq * HD;
  const size_t kv_row_stride = (size_t)Hkv * HD;
  const __nv_bfloat16* k_base = k + (size_t)r * T * kv_row_stride + (size_t)hk * HD;
  const __nv_bfloat16* v_base = v + (size_t)r * T * kv_row_stride + (size_t)hk * HD;
  const int* seg_r = seg + (size_t)r * T;
  const int* pos_r = pos + (size_t)r * T;
  const int2* rng = ranges + (size_t)r * nt;

  // Live kv tiles: causal (j <= qt) and meeting the q tile's segment
  // range. The first and the last are found by all threads in one pass
  // over the row's ranges (not a chain of dependent loads).
  __shared__ int s_first[NTHREADS / 32], s_last[NTHREADS / 32];
  const int2 qrange = rng[qt];
  int lo = qt + 1, hi = -1;
  for (int jj = tid; jj <= qt; jj += NTHREADS)
    if (ranges_meet(rng[jj], qrange)) {
      lo = min(lo, jj);
      hi = max(hi, jj);
    }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((tid & 31) == 0) {
    s_first[warp] = lo;
    s_last[warp] = hi;
  }
  __syncthreads();
  const int first = min(min(s_first[0], s_first[1]), min(s_first[2], s_first[3]));
  const int last = max(max(s_last[0], s_last[1]), max(s_last[2], s_last[3]));

  flash::WarpRows<HD> w;
  w.clear();

  if (first <= last) {
    auto load_kv = [&](int stage, int j) {
      const int k0 = j * BK;
      cp_tile_async<BK, HD, NTHREADS>(sK + stage * ELEMS, k_base + (size_t)k0 * kv_row_stride,
                                      kv_row_stride, T - k0);
      cp_tile_async<BK, HD, NTHREADS>(sV + stage * ELEMS, v_base + (size_t)k0 * kv_row_stride,
                                      kv_row_stride, T - k0);
      for (int c = tid; c < 2 * BK; c += NTHREADS) {
        const int row = k0 + (c % BK);
        const bool in = row < T;
        const int* src = c < BK ? seg_r : pos_r;
        cp_async_4(sKst + stage * 2 * BK + c, in ? src + row : seg_r, in);
      }
    };

    cp_tile_async<BQ, HD, NTHREADS>(sQ, q + ((size_t)r * T + q0) * q_row_stride + (size_t)h * HD,
                                    q_row_stride, T - q0);
    load_kv(0, first);
    cp_async_commit();

    // This thread's two q rows: g and g + 8 of its warp's 16.
    int qseg[2], qpos[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + warp * 16 + g + 8 * hh;
      const bool in = row < T;
      qseg[hh] = in ? seg_r[row] : 0;
      qpos[hh] = in ? pos_r[row] : 0;
    }
    // Q to registers before stage 1 is refilled.
    cp_async_wait<0>();
    __syncthreads();
    w.load_q(sQ, warp * 16);
    __syncthreads();

    int j = first, stage = 0;
    while (true) {
      int next = j + 1;
      while (next <= last && !ranges_meet(rng[next], qrange)) ++next;
      if (next <= last) load_kv(stage ^ 1, next);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the tile just requested has landed
      __syncthreads();
      if (COUNT && tid == 0)
        ++tile_pairs[blockIdx.x + (size_t)gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z)];

      const int* cseg = sKst + stage * 2 * BK;
      const int* cpos = cseg + BK;
      w.step(sK + stage * ELEMS, sV + stage * ELEMS, scale_log2, [&](int hh, int c) {
        return qseg[hh] > 0 && cseg[c] == qseg[hh] && qpos[hh] >= cpos[c];
      });
      __syncthreads();  // every warp is done with this stage before it is refilled
      if (next > last) break;
      j = next;
      stage ^= 1;
    }
  }

  float row_lse[2];
  w.finish(row_lse);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row >= T) continue;
    w.store_row(out + ((size_t)r * T + row) * q_row_stride + (size_t)h * HD, hh);
    if ((tid & 3) == 0) lse[((size_t)r * Hq + h) * T + row] = row_lse[hh];
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const int* seg, const int* pos,
           const int* ranges, void* out, float* lse, int* tile_pairs, int R, int T, int Hq,
           int Hkv, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  auto kernel = tile_pairs ? flash_fwd_kernel<HD, true> : flash_fwd_kernel<HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, Hq, R);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg, pos, reinterpret_cast<const int2*>(ranges),
      static_cast<__nv_bfloat16*>(out), lse, tile_pairs, T, Hq, Hkv, scale * flash::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   const int* seg, const int* pos, const int* ranges,
                                   void* out, float* lse, int* tile_pairs, int R, int T,
                                   int Hq, int Hkv, int hd, float scale, void* stream) {
  if (R <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || R > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128>(q, k, v, seg, pos, ranges, out, lse, tile_pairs, R, T, Hq, Hkv, scale, s);
  if (hd == 64)
    return launch<64>(q, k, v, seg, pos, ranges, out, lse, tile_pairs, R, T, Hq, Hkv, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Rows per q tile and per kv tile (BQ == BK): the block `ranges` is built
// for. The backward's library reports the same tile (flash_attn_bwd_tile).
extern "C" int flash_attn_fwd_tile() { return BQ; }
