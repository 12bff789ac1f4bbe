// W8A16 matmul for Hopper (sm_90a): C[M, N] = (A[M, K] @ Wq[K, N]) * s[N],
// A and C bf16, Wq int8 row major [in, out], s float32 per output channel.
//
// Replaces no TPU kernel. The reference's quantized matmul
// (areal_tpu/ops/wquant.py:qmat, `(h @ wq.astype(cdt)) * s.astype(cdt)`) is
// an XLA fusion: the int8-to-bf16 convert is folded into the matmul's operand
// read. PyTorch has no such fusion, so the plain version writes a bf16 copy
// of the weight and reads it again (~2.5x the bytes of the bf16 weight it
// replaces). This kernel reads the int8 codes once.
//
// What bounds it on the H100: bytes. The decode path runs it at M = 16 (plain
// decode) or 80 (speculative decode at draft length 4) rows, so a weight byte
// feeds 2M operations, far below the card's ~295 operations a byte.
//
// What the design does about it.
// - A CTA owns a 64-column slice of N, all (up to 128) rows of an M block,
//   and a range of 64-deep K chunks. Its warps split the 64 columns (16
//   each) and run every m16 row tile of the block, so each weight byte is
//   read from device memory once; the small A is re-read from L2.
// - Each K chunk of A (bf16) and Wq (int8) arrives by cp.async into a ring
//   of STAGES buffers, STAGES - 1 chunks ahead of the one multiplied, so
//   each CTA keeps ~12 KB of the weight in flight. The int8 tile is
//   converted to bf16 in shared memory (every int8 value is exact in bf16)
//   and fed to mma.sync m16n8k16 with float32 accumulation through the
//   ldmatrix helpers of mma_tiles.cuh.
// - The grid covers small-N layers (wk, wv: N = 256 gives 4 column slices)
//   by splitting K: the host's plan (ops/wquant.w8a16_plan) picks the splits
//   from the shapes and the SM count only. Each split writes float32
//   partials, and a second kernel sums them in split order, so two runs are
//   bit-equal (no atomics).
// - Epilogue as the plain version rounds: the product to bf16, then times
//   the scale rounded to bf16, rounded to bf16.
// - Ragged edges: rows past M, K past its end and columns past N are
//   zero-filled on load and masked on store. Whole 16-byte copies need
//   K % 8 == 0 (A) and N % 16 == 0 (Wq) with 16-byte aligned bases; other
//   shapes load element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int NT = 128;        // threads a CTA (4 warps)
constexpr int BN = 64;         // columns a CTA
constexpr int BK = 64;         // K depth of a chunk
constexpr int MB = 128;        // rows of an M block (8 m16 tiles)
constexpr int LDA = BK + 8;    // bf16 row stride of the A tiles
constexpr int LDW8 = BN + 16;  // byte row stride of the int8 tiles
constexpr int LDWB = BN + 8;   // bf16 row stride of the converted tile
constexpr int STAGES = 4;      // chunks in the cp.async ring

struct Args {
  const __nv_bfloat16* a;
  const int8_t* w;
  const float* s;
  __nv_bfloat16* c;
  float* part;  // [splits, M, N] float32 partials, or null with one split
  int M, K, N;
  int per;      // K chunks a split
  int vec_a, vec_w;
};

template <int MT>
struct Smem {
  __nv_bfloat16 a[STAGES][MT * 16][LDA];
  int8_t w[STAGES][BK][LDW8];
  __nv_bfloat16 wb[BK][LDWB];
};

// Issue the copies of K chunk `k0` of the A rows m0.. and of the Wq columns
// n0.. into stage buffers `as` and `ws`.
template <int MT>
__device__ __forceinline__ void load_chunk(__nv_bfloat16 (*as)[LDA], int8_t (*ws)[LDW8],
                                           const Args& p, int m0, int n0, int k0) {
  constexpr int ACH = BK / 8;  // 16-byte chunks an A row
#pragma unroll
  for (int c = threadIdx.x; c < MT * 16 * ACH; c += NT) {
    const int r = c / ACH, col = (c % ACH) * 8;
    const int m = m0 + r, k = k0 + col;
    __nv_bfloat16* d = &as[r][col];
    if (p.vec_a) {
      const bool in = m < p.M && k < p.K;
      tiles::cp_async_16(d, in ? p.a + (size_t)m * p.K + k : p.a, in);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (m < p.M && k + j < p.K) ? p.a[(size_t)m * p.K + k + j] : __float2bfloat16(0.f);
    }
  }
  constexpr int WCH = BN / 16;  // 16-byte chunks a Wq row
#pragma unroll
  for (int c = threadIdx.x; c < BK * WCH; c += NT) {
    const int r = c / WCH, col = (c % WCH) * 16;
    const int k = k0 + r, n = n0 + col;
    int8_t* d = &ws[r][col];
    if (p.vec_w) {
      const bool in = k < p.K && n < p.N;
      tiles::cp_async_16(d, in ? p.w + (size_t)k * p.N + n : p.w, in);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        d[j] = (k < p.K && n + j < p.N) ? p.w[(size_t)k * p.N + n + j] : (int8_t)0;
    }
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The plain version's epilogue: bf16(bf16(acc) * bf16(s)).
__device__ __forceinline__ __nv_bfloat16 scale_out(float acc, float s) {
  return __float2bfloat16_rn(bf16_round(acc) * bf16_round(s));
}

template <int MT>
__global__ void __launch_bounds__(NT) w8a16_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MT>& sm = *reinterpret_cast<Smem<MT>*>(smem_raw);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MB;
  const int split = blockIdx.z;
  const int k_chunks = (p.K + BK - 1) / BK;
  const int c_begin = split * p.per;
  const int c_end = min(k_chunks, c_begin + p.per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp * 16;  // this warp's columns in the tile

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  // Prologue: chunks c_begin .. c_begin + STAGES - 2 in flight. One commit
  // group a chunk slot, empty past the split's end, so the wait below
  // always leaves the STAGES - 2 younger chunks in flight.
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (c_begin + j < c_end) load_chunk<MT>(sm.a[j], sm.w[j], p, m0, n0, (c_begin + j) * BK);
    tiles::cp_async_commit();
  }
  for (int ci = c_begin; ci < c_end; ++ci) {
    const int st = (ci - c_begin) % STAGES;
    tiles::cp_async_wait<STAGES - 2>();  // chunk ci has landed
    __syncthreads();  // ... for every thread, and stage (ci - 1) is free
    {
      const int nc = ci + STAGES - 1;
      const int ns = (nc - c_begin) % STAGES;
      if (nc < c_end) load_chunk<MT>(sm.a[ns], sm.w[ns], p, m0, n0, nc * BK);
      tiles::cp_async_commit();
    }
    // int8 -> bf16, four codes a word (exact).
#pragma unroll
    for (int i = threadIdx.x; i < BK * BN / 4; i += NT) {
      const int r = i / (BN / 4), col = (i % (BN / 4)) * 4;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(&sm.w[st][r][col]);
      const float x0 = (float)(int8_t)(v & 0xff), x1 = (float)(int8_t)((v >> 8) & 0xff);
      const float x2 = (float)(int8_t)((v >> 16) & 0xff), x3 = (float)(int8_t)(v >> 24);
      uint32_t* d = reinterpret_cast<uint32_t*>(&sm.wb[r][col]);
      d[0] = tiles::pack_bf16(x0, x1);
      d[1] = tiles::pack_bf16(x2, x3);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t b[4];
      tiles::load_b_kn(b, &sm.wb[0][0], LDWB, kk * 16, wn);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        tiles::load_a(a, &sm.a[st][0][0], LDA, mt * 16, kk * 16);
        tiles::mma_bf16(acc[mt][0], a, b[0], b[1]);
        tiles::mma_bf16(acc[mt][1], a, b[2], b[3]);
      }
    }
    // The next iteration's first barrier orders these reads of wb and of
    // stage st before they are overwritten.
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + mt * 16 + g + (j >> 1) * 8;
        const int n = n0 + wn + nt * 8 + 2 * t + (j & 1);
        if (m >= p.M || n >= p.N) continue;
        if (p.part) {
          p.part[((size_t)split * p.M + m) * p.N + n] = acc[mt][nt][j];
        } else {
          p.c[(size_t)m * p.N + n] = scale_out(acc[mt][nt][j], p.s[n]);
        }
      }
    }
  }
}

// Sum the splits' partials in split order, then the epilogue.
__global__ void w8a16_reduce_kernel(const float* part, const float* s, __nv_bfloat16* c, int M,
                                    int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float acc = part[i];
  for (int sp = 1; sp < splits; ++sp) acc += part[(size_t)sp * total + i];
  c[i] = scale_out(acc, s[i % N]);
}

template <int MT>
int launch(const Args& p, int splits, cudaStream_t stream) {
  const int bytes = (int)sizeof(Smem<MT>);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(w8a16_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p.N + BN - 1) / BN, (p.M + MB - 1) / MB, splits);
  w8a16_kernel<MT><<<grid, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C = (A @ Wq) * s. `part` is [splits, M, N] float32 scratch when splits > 1
// (null otherwise); `per` is the K chunks (of 64) a split.
extern "C" int w8a16_matmul_bf16(const void* a, const void* w, const float* s, void* c,
                                 float* part, int M, int K, int N, int splits, int per,
                                 int vec_a, int vec_w, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || splits < 1 || per < 1 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((splits - 1) * per >= (K + BK - 1) / BK) return (int)cudaErrorInvalidValue;
  Args p{static_cast<const __nv_bfloat16*>(a), static_cast<const int8_t*>(w), s,
         static_cast<__nv_bfloat16*>(c), splits > 1 ? part : nullptr, M, K, N, per,
         vec_a, vec_w};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = (M < MB ? M + 15 : MB) / 16;  // m16 tiles of the first (widest) M block
  int rc;
  switch (mt) {
    case 1: rc = launch<1>(p, splits, st); break;
    case 2: rc = launch<2>(p, splits, st); break;
    case 3: rc = launch<3>(p, splits, st); break;
    case 4: rc = launch<4>(p, splits, st); break;
    case 5: rc = launch<5>(p, splits, st); break;
    case 6: rc = launch<6>(p, splits, st); break;
    case 7: rc = launch<7>(p, splits, st); break;
    default: rc = launch<8>(p, splits, st); break;
  }
  if (rc != 0 || splits == 1) return rc;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  w8a16_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      part, s, static_cast<__nv_bfloat16*>(c), M, N, splits);
  return (int)cudaGetLastError();
}
