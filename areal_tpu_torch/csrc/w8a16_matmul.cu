// W8A16 matmul for Hopper (sm_90a): C[M, N] = bf16(bf16(A @ Wq) * bf16(s)),
// A [M, K] and C bf16 row major, Wq int8 [K, N] packed into tiles (below),
// s float32 per output channel, float32 sums.
//
// Replaces no TPU kernel. The reference's quantized matmul
// (areal_tpu/ops/wquant.py:44-51, qmat's `(h @ wq.astype(cdt)) *
// s.astype(cdt)`) is an XLA fusion: the int8-to-bf16 convert is folded into
// the matmul's operand read. PyTorch has no such fusion, so the plain version
// writes a bf16 copy of the weight and reads it again. This kernel reads the
// int8 codes once.
//
// What bounds it on the H100: bytes. The decode path runs it at M = 16 (plain
// decode) or 80 (speculative decode at draft length 4) rows, so a weight byte
// feeds 2M operations, far below the card's ~295 operations a byte; one
// decode step of R1-Distill-Qwen-1.5B streams 1.55 GB of int8 weights.
//
// What the design does about it.
// - Operands swapped: the kernel computes C^T = Wq^T A^T, so a tile's 64
//   output channels fill wgmma's 64 rows and the step's rows are wgmma's N
//   (MB, a multiple of 16 up to 256; above 256 the grid covers row blocks).
//   Sixteen rows are not padded to 64.
// - Weights by bulk copy, converted in registers. The wrapper packs each
//   weight once (ops/wquant.pack_codes): zero-padded to whole 64 x 64 chunks,
//   each chunk's 4096 bytes in the order in which a consumer warpgroup's
//   threads hold wgmma's A fragment, 32 bytes a thread (the padding also
//   makes every family's shapes legal for 16-byte bulk copies: gpt2's head
//   has 50257 columns). A producer warp keeps a ring of `stages` stages
//   (an even number) of `cps` chunks in flight with cp.async.bulk and
//   mbarriers. A consumer reads its 32 bytes with two 16-byte loads,
//   releases the stage, turns each int8 into bf16 with byte permutes and
//   one float subtraction (2^23 + u - (2^23 + 128), u the code with its
//   sign bit flipped: exact, the bf16 is the float's upper half) and issues
//   the chunk's four wgmma from registers as one group. No shared-memory
//   round trip of the converted tile, no barrier among the consumers a
//   chunk.
// - Two consumer warpgroups take the ring's stages in turn, each summing
//   its chunks of the tile apart: ptxas keeps wgmma asynchronous only if no
//   fragment is written while a group is open, so one warpgroup converts
//   while the other's products run. At a tile's end warpgroup 0 stores its
//   sums to a tile buffer in shared memory and warpgroup 1 adds its own (a
//   fixed order).
// - Epilogue warps take each finished tile from its buffer while the
//   consumers go on: the plain version's rounding (the product to bf16,
//   times the scale rounded to bf16, rounded to bf16), stored row by row of
//   C in pairs of channels. With K split, each split's epilogue stores a
//   float32 partial and the tile's last split to arrive (a counter in
//   global memory, reset by that CTA) sums them in split order: two runs
//   are bit-equal, and no value is accumulated by an atomic. A CTA's last
//   tile the 256 consumer threads finish themselves (its partials read with
//   eight times the loads in flight of one warp): most CTAs of the smaller
//   layers own one or two tiles, so that tile's epilogue is their tail.
// - Activations staged once a CTA: the producer loads the CTA's rows and K
//   slice of A by TMA, one box a chunk (a 3D view of A whose box lands in
//   wgmma's K-major core-matrix layout without swizzle), each on its own
//   barrier, so the first products need only the first chunk; the slice
//   stays while the CTA walks its column tiles. TMA zero-fills past M and
//   K, as the packed weight is zero past K; the wrapper pads A's rows to a
//   multiple of 8 (16 bytes, which TMA's row stride needs) and copies an A
//   that is not 16-byte aligned, so every shape takes this one path.
// - About one CTA an SM (the plan, ops/wquant.w8a16_plan): CTA b takes row
//   block rb, K split `split` (whole chunks; more than one where the A slice
//   would not fit, or where splitting evens the CTAs' work) and every
//   groups-th column tile from its group, so the CTAs stream neighbouring
//   tiles; all from the shapes and the card, so the same shapes always
//   reduce in the same order.
// - Grouped projections (wq|wk|wv, w_gate|w_up) are one packed matrix with
//   their columns side by side: one launch, one output whose column ranges
//   the wrapper hands back as views.
// - What binds it now (chip_smoke.py's parity phase and --w8a16-sweep,
//   PERF.md row 8): at 16 rows a launch's fixed cost (start, the ring's
//   first fill, the last tile's epilogue) at the small layers; at 80 rows
//   the epilogue of K-split tiles (partials through L2, a fence and a count
//   a tile) and the consumers' conversion, which the two warpgroups overlap
//   with each other's products but not with their own.

#include <cuda.h>  // CUtensorMap; the driver's encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_rs.cuh"

namespace {

constexpr int TN = 64;              // output channels a column tile (wgmma's M)
constexpr int CK = 64;              // K depth of a packed chunk
constexpr int CHUNK = TN * CK;      // bytes of a packed chunk
constexpr int WG = 128;             // threads a warpgroup
constexpr int NCONS = 2 * WG;       // consumer threads: two warpgroups
constexpr int PRODUCER = NCONS;     // the producer warp's first thread
constexpr int MAX_STAGES = 16;
constexpr int MAX_SMEM = 232448;    // a CTA's shared memory on the H100

struct Args {
  const __nv_bfloat16* a;  // [M, K]
  const uint8_t* w;        // packed [T, C, CHUNK]
  const float* s;          // [N]
  __nv_bfloat16* c;        // [M, N]
  float* ws;               // [n_rb, T, splits, TN * MB] partials, or null
  int* cnt;                // [n_rb, T] zeroed counters, or null
  int M, K, N, T, C;
  int splits, groups, stages, cps, cmax;
  int vec_c;
};

// Epilogue warps, each with its own tile buffer: four for narrow row
// blocks, whose tiles come fast, fewer for wide ones, whose buffers are
// large.
// The tile buffers' barriers: WG0's sums written (half), WG1's added
// (full), read by the epilogue warp (empty).
template <int MB>
struct Epi {
  static constexpr int warps = MB <= 64 ? 4 : MB <= 96 ? 3 : 2;
  static constexpr int threads = NCONS + 32 + 32 * warps;  // consumers, producer, epilogue
};

// Shared memory: the weight ring, the A slice, the epilogue warps' tile
// buffers (float32, in xb_index order), and the barriers: the ring's full
// and empty, the tile buffers' half, full and empty, one a chunk of the A
// slice; a flag.
__host__ __device__ constexpr int ring_bytes(int stages, int cps) { return stages * cps * CHUNK; }
__host__ __device__ constexpr int a_bytes(int mb, int cmax) { return cmax * CK * mb * 2; }
__host__ __device__ constexpr int tile_bytes(int mb) { return TN * mb * 4; }
__host__ __device__ constexpr int smem_bytes(int mb, int epi, int cmax, int stages, int cps) {
  return ring_bytes(stages, cps) + a_bytes(mb, cmax) + epi * tile_bytes(mb) +
         (2 * stages + 3 * epi + cmax) * 8 + 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One bulk copy global -> shared that completes `bytes` on barrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A 3D tensor copy global -> shared that completes on barrier `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Barrier among the consumer warpgroups only (id 0 is __syncthreads').
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NCONS) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Four int8 codes (bytes of v, low first) -> two bf16 pairs, exactly: the
// code with its sign bit flipped, u, is placed in the low byte of the float
// 2^23 + u, and 2^23 + 128 subtracted; the result's low 16 bits are zero.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  constexpr float kBias = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kBias;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// wgmma descriptor of a K-major operand without swizzle: 8 x 16-byte core
// matrices, SBO bytes between neighbours along N, LBO along K.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage q of the ring, chunk `pos` of it, for the warpgroup's thread wt:
// read its 32 bytes, release the stage after its last chunk, wait until
// the warpgroup's previous products are done (they read frag), convert,
// and issue the chunk's four k16 products as one group. The descriptors
// and fragments are pinned before the fence, so no other instruction
// defines a product's input while a group is open, and ptxas keeps the
// products asynchronous; the other warpgroup converts meanwhile.
template <int MB>
__device__ __forceinline__ void consume_chunk(float (&acc)[MB / 2], uint32_t (&frag)[4][4],
                                              uint32_t chunk, uint32_t a_chunk, uint32_t empty,
                                              bool release, uint32_t a_bar, int wt) {
  constexpr uint32_t LBO = MB * 16;  // bytes between K-neighbouring core matrices
  constexpr uint32_t SBO = 128;      // ... and row-neighbouring ones
  const uint4 v0 = lds128(chunk + wt * 16);
  const uint4 v1 = lds128(chunk + (WG + wt) * 16);
  if (release) mbar_arrive(empty);
  uint64_t desc[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    desc[kk] = kmajor_desc(a_chunk + 2 * kk * LBO, LBO, SBO);
    asm volatile("" : "+l"(desc[kk]));
  }
  wgmma::wait<0>();
  int8x4_to_bf16(v0.x, frag[0][0], frag[0][1]);
  int8x4_to_bf16(v0.y, frag[0][2], frag[0][3]);
  int8x4_to_bf16(v0.z, frag[1][0], frag[1][1]);
  int8x4_to_bf16(v0.w, frag[1][2], frag[1][3]);
  int8x4_to_bf16(v1.x, frag[2][0], frag[2][1]);
  int8x4_to_bf16(v1.y, frag[2][2], frag[2][3]);
  int8x4_to_bf16(v1.z, frag[3][0], frag[3][1]);
  int8x4_to_bf16(v1.w, frag[3][2], frag[3][3]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(frag[kk][r]));
  mbar_wait(a_bar, 0);  // this chunk of the A slice has landed
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma::RS<MB>::mma(acc, frag[kk], desc[kk]);
  wgmma::commit();
}

// A tile buffer holds fragment j of warpgroup thread wt (warp w = wt / 32,
// r = wt % 32 = 4 g + t) at j * 128 + 32 w + ((r + 2 w + h) & 31), h =
// (j >> 1) & 1: rotated within each warp's 32 words, so the consumers'
// stores and the epilogue's row reads (64 channels of one row) each meet
// 32 banks.
__device__ __forceinline__ int xb_index(int j, int wt) {
  const int w = wt >> 5;
  return j * WG + 32 * w + (((wt & 31) + 2 * w + ((j >> 1) & 1)) & 31);
}

// Row m, channel n of a tile (the wgmma D layout, wgmma_rs.cuh).
__device__ __forceinline__ int tile_index(int m, int n) {
  const int j = 4 * (m >> 3) + 2 * ((n >> 3) & 1) + (m & 1);
  return xb_index(j, 32 * (n >> 4) + 4 * (n & 7) + ((m & 7) >> 1));
}

// Tile t from buffer `xb`, by `nthreads` threads (idx its thread's index):
// one epilogue warp while the consumers go on, or, for the CTA's last tile,
// the consumers (ALL), whose flag is `flag`. With K
// splits, store this split's partial and, if it is the tile's last to
// arrive, sum all splits in split order into `xb` (PB float4 a thread of
// two splits in flight); then the plain version's rounding, row by row of
// C, two channels a lane.
template <int MB, bool ALL>
__device__ __forceinline__ void epilogue_tile(float* xb, const Args& p, int rb, int split, int t,
                                              int m0, int rows, int idx, int nthreads,
                                              int* flag, float sa, float sb) {
  constexpr int E4 = TN * MB / 4;  // float4 of a tile
  constexpr int PB = 8;
  float4* x4 = reinterpret_cast<float4*>(xb);
  if (p.splits > 1) {
    float4* part = reinterpret_cast<float4*>(p.ws + ((size_t)(rb * p.T + t) * p.splits) * (4 * E4));
    for (int i = idx; i < E4; i += nthreads) __stcg(part + (size_t)split * E4 + i, x4[i]);
    if (ALL) consumers_sync(1); else __syncwarp();
    int last = 0;
    if (idx == 0) {
      int* ctr = p.cnt + rb * p.T + t;
      __threadfence();  // this split's partial before the count
      last = atomicAdd(ctr, 1) == p.splits - 1;
      if (last) {
        __threadfence();  // the other splits' partials after it
        *ctr = 0;         // ready for the next launch
      }
      if (ALL) *flag = last;
    }
    if (ALL) {
      consumers_sync(1);
      last = *flag;
    } else {
      last = __shfl_sync(0xffffffffu, last, 0);
    }
    if (!last) return;
    for (int i0 = idx; i0 < E4; i0 += nthreads * PB) {
      float4 v[PB];
#pragma unroll
      for (int b = 0; b < PB; ++b) {
        const int i = i0 + nthreads * b;
        if (i < E4) v[b] = split == 0 ? x4[i] : __ldcg(part + i);
      }
      for (int sp = 1; sp < p.splits; sp += 2) {
        const bool two = sp + 1 < p.splits;
        float4 u[PB], w[PB];
#pragma unroll
        for (int b = 0; b < PB; ++b) {
          const int i = i0 + nthreads * b;
          if (i >= E4) continue;
          u[b] = sp == split ? x4[i] : __ldcg(part + (size_t)sp * E4 + i);
          if (two) w[b] = sp + 1 == split ? x4[i] : __ldcg(part + (size_t)(sp + 1) * E4 + i);
        }
#pragma unroll
        for (int b = 0; b < PB; ++b) {
          v[b].x += u[b].x, v[b].y += u[b].y, v[b].z += u[b].z, v[b].w += u[b].w;
          if (two) v[b].x += w[b].x, v[b].y += w[b].y, v[b].z += w[b].z, v[b].w += w[b].w;
        }
      }
#pragma unroll
      for (int b = 0; b < PB; ++b)
        if (i0 + nthreads * b < E4) x4[i0 + nthreads * b] = v[b];
    }
    if (ALL) consumers_sync(1); else __syncwarp();
  }
  const int lane = idx & 31, warp = idx >> 5, nwarps = nthreads >> 5;
  const int na = t * TN + 2 * lane, nb = na + 1;
  const int ia = tile_index(0, 2 * lane), ib = tile_index(0, 2 * lane + 1);
  const bool pair = p.vec_c && nb < p.N;
#pragma unroll 4
  for (int m = warp; m < rows; m += nwarps) {
    // Rows m and m + 1 sit 128 apart within a group of 8 (j & 1), m and
    // m + 2 one word apart (t), groups of 8 at 4 * 128 (j >> 2).
    const int rm = (m >> 3) * 4 * WG + (m & 1) * WG + ((m & 7) >> 1);
    const float xa = xb[(ia & ~31) + ((ia + rm) & 31) + (rm & ~31)];
    const float xb_ = xb[(ib & ~31) + ((ib + rm) & 31) + (rm & ~31)];
    const __nv_bfloat16 ya = __float2bfloat16_rn(bf16_round(xa) * sa);
    const __nv_bfloat16 yb = __float2bfloat16_rn(bf16_round(xb_) * sb);
    __nv_bfloat16* dst = p.c + (size_t)(m0 + m) * p.N + na;
    if (pair) {
      __nv_bfloat162 y;
      y.x = ya, y.y = yb;
      *reinterpret_cast<__nv_bfloat162*>(dst) = y;
    } else {
      if (na < p.N) dst[0] = ya;
      if (nb < p.N) dst[1] = yb;
    }
  }
}

// A lane's two channels' scales of tile t, rounded to bf16.
__device__ __forceinline__ float2 lane_scales(const Args& p, int t, int lane) {
  const int na = t * TN + 2 * lane, nb = na + 1;
  return make_float2(na < p.N ? bf16_round(p.s[na]) : 0.f, nb < p.N ? bf16_round(p.s[nb]) : 0.f);
}

template <int MB>
__global__ void __launch_bounds__(Epi<MB>::threads, 1)
    w8a16_kernel(const __grid_constant__ CUtensorMap a_map, const Args p) {
  constexpr int NEPI = Epi<MB>::warps;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* a_s = ring + ring_bytes(p.stages, p.cps);
  float* xbuf = reinterpret_cast<float*>(a_s + a_bytes(MB, p.cmax));
  // full[stages], empty[stages], xhalf[NEPI], xfull[NEPI], xempty[NEPI]
  uint64_t* bars = reinterpret_cast<uint64_t*>(xbuf + NEPI * TN * MB);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * p.stages;
  const uint32_t xhalf0 = empty0 + 8 * p.stages, xfull0 = xhalf0 + 8 * NEPI;
  const uint32_t xempty0 = xfull0 + 8 * NEPI, abar0 = xempty0 + 8 * NEPI;
  int* flag = reinterpret_cast<int*>(bars + 2 * p.stages + 3 * NEPI + p.cmax);

  // This CTA's row block, K split, and column tiles grp, grp + groups, ...
  // (at any moment the CTAs stream neighbouring tiles).
  const int b = blockIdx.x;
  const int grp = b % p.groups, split = (b / p.groups) % p.splits;
  const int rb = b / (p.groups * p.splits);
  const int ntiles = (p.T - grp + p.groups - 1) / p.groups;
  const int c_lo = split * p.C / p.splits, c_hi = (split + 1) * p.C / p.splits;
  const int m0 = rb * MB, rows = min(MB, p.M - m0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, WG);
    }
    for (int e = 0; e < NEPI; ++e) {
      mbar_init(xhalf0 + 8 * e, WG);
      mbar_init(xfull0 + 8 * e, WG);
      mbar_init(xempty0 + 8 * e, 32);
    }
    for (int i = 0; i < p.cmax; ++i) mbar_init(abar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nck = c_hi - c_lo;                 // chunks of a tile in this split
  const int nst = (nck + p.cps - 1) / p.cps;   // ring stages of a tile

  const int tl = grp + (ntiles - 1) * p.groups;  // the CTA's last tile
  float* xl = xbuf + ((ntiles - 1) % NEPI) * TN * MB;

  if (tid >= PRODUCER + 32) {
    // Epilogue warp e takes the CTA's tiles e, e + NEPI, ... but the last,
    // which the consumers finish together (no tile of theirs is left).
    const int e = (tid - PRODUCER - 32) >> 5, lane = tid & 31;
    for (int ti = e; ti < ntiles - 1; ti += NEPI) {
      const int t = grp + ti * p.groups;
      const float2 sc = lane_scales(p, t, lane);
      mbar_wait(xfull0 + 8 * e, (ti / NEPI) & 1);
      epilogue_tile<MB, false>(xbuf + e * TN * MB, p, rb, split, t, m0, rows, lane, 32, flag,
                               sc.x, sc.y);
      mbar_arrive(xempty0 + 8 * e);
    }
    return;
  }

  if (tid >= PRODUCER) {
    // Producer: one thread streams the tiles' chunks through the ring.
    if (tid != PRODUCER) return;
    // The A slice first, a chunk (MB rows x 64 K) a box, each on its
    // barrier: [k / 8][m][k % 8], the consumers' core-matrix layout.
    for (int i = 0; i < nck; ++i) {
      mbar_expect_tx(abar0 + 8 * i, (uint32_t)a_bytes(MB, 1));
      tma_load_3d(smem_u32(a_s + (size_t)i * a_bytes(MB, 1)), &a_map, 0, m0,
                  (c_lo + i) * (CK / 8), abar0 + 8 * i);
    }
    int q = 0;
    for (int ti = 0; ti < ntiles; ++ti) {
      const int t = grp + ti * p.groups;
      for (int c = c_lo; c < c_hi; c += p.cps, ++q) {
        const int nch = min(p.cps, c_hi - c);
        const int st = q % p.stages, use = q / p.stages;
        if (use > 0) mbar_wait(empty0 + 8 * st, (use - 1) & 1);
        const uint32_t bytes = (uint32_t)nch * CHUNK;
        mbar_expect_tx(full0 + 8 * st, bytes);
        bulk_load(smem_u32(ring + (size_t)st * p.cps * CHUNK),
                  p.w + ((size_t)t * p.C + c) * CHUNK, bytes, full0 + 8 * st);
      }
    }
    return;
  }

  // Consumers: two warpgroups; ring stage q goes to warpgroup q % 2 (the
  // ring has an even number of stages, so a slot always feeds the same
  // warpgroup, which has consumed the slot's previous fill), which
  // sums its chunks of the tile apart. At a tile's end warpgroup 0 writes
  // its sums to the tile's buffer and warpgroup 1 adds its own (a fixed
  // order), and the epilogue warp takes the tile from there.

  const int cw = tid / WG, wt = tid % WG;
  const uint32_t ring_base = smem_u32(ring), a_base = smem_u32(a_s);
  float acc[MB / 2];
  uint32_t frag[4][4];
  for (int ti = 0, q0 = 0; ti < ntiles; ++ti, q0 += nst) {
#pragma unroll
    for (int j = 0; j < MB / 2; ++j) {
      acc[j] = 0.f;
      wgmma::fence_operand(acc[j]);
    }
    for (int k = (q0 + cw) % 2 == 0 ? 0 : 1; k < nst; k += 2) {
      const int q = q0 + k, st = q % p.stages;
      mbar_wait(full0 + 8 * st, (q / p.stages) & 1);
      const int nch = min(p.cps, nck - k * p.cps);
      for (int ch = 0; ch < nch; ++ch) {
        const int i = k * p.cps + ch;  // chunk within the tile, and the A slice
        consume_chunk<MB>(acc, frag, ring_base + (uint32_t)(st * p.cps + ch) * CHUNK,
                          a_base + (uint32_t)i * (CK / 8) * (MB * 16), empty0 + 8 * st,
                          ch == nch - 1, abar0 + 8 * i, wt);
      }
    }
    wgmma::wait<0>();
#pragma unroll
    for (int j = 0; j < MB / 2; ++j) wgmma::fence_operand(acc[j]);
    // Hand the tile to its epilogue warp and go on with the next one; the
    // last tile the consumers finish themselves.
    const int e = ti % NEPI, use = ti / NEPI;
    float* xb = xbuf + e * TN * MB;
    if (cw == 0) {
      if (use > 0) mbar_wait(xempty0 + 8 * e, (use - 1) & 1);
#pragma unroll
      for (int j = 0; j < MB / 2; ++j) xb[xb_index(j, wt)] = acc[j];
      mbar_arrive(xhalf0 + 8 * e);
    } else {
      mbar_wait(xhalf0 + 8 * e, use & 1);
#pragma unroll
      for (int j = 0; j < MB / 2; ++j) xb[xb_index(j, wt)] += acc[j];
      if (ti < ntiles - 1) mbar_arrive(xfull0 + 8 * e);
    }
  }
  const float2 sc = lane_scales(p, tl, tid & 31);
  consumers_sync(1);
  epilogue_tile<MB, true>(xl, p, rb, split, tl, m0, rows, tid, NCONS, flag, sc.x, sc.y);
}

template <int MB>
int launch(const CUtensorMap& a_map, const Args& p, int n_rb, cudaStream_t stream) {
  const int bytes = smem_bytes(MB, Epi<MB>::warps, p.cmax, p.stages, p.cps);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // Raised once a device to the most a CTA may take (a host call a launch
  // is the decode step's time: the step is host bound).
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(w8a16_kernel<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised[dev] = true;
  }
  w8a16_kernel<MB><<<n_rb * p.splits * p.groups, Epi<MB>::threads, bytes, stream>>>(a_map, p);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, or null where the runtime does not
// give it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A [M, K] as a 3D tensor: (8 elements of K, M rows, K / 8 blocks), whose
// box (8, mb, 8) is one chunk of a CTA's A slice in core-matrix order.
bool a_tensor_map(CUtensorMap* map, const void* a, int M, int K, int mb) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {8, (cuuint64_t)M, (cuuint64_t)(K / 8)};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, 16};
  const cuuint32_t box[3] = {8, (cuuint32_t)mb, CK / 8};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(a), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

// C = (A @ Wq) * s with Wq packed (ops/wquant.pack_codes) and A's rows
// 16-byte aligned (K a multiple of 8, `a` 16-byte aligned). The plan
// (ops/wquant.w8a16_plan): `mb` rows a row block (wgmma's N) and `n_rb`
// row blocks, `splits` K splits, `groups` column-tile ranges, a ring of
// `stages` stages of `cps` chunks. With splits > 1, `ws` holds
// n_rb * T * splits * 64 * mb floats and `cnt` n_rb * T zeroed ints.
extern "C" int w8a16_matmul_bf16(const void* a, const void* w, const float* s, void* c,
                                 float* ws, int* cnt, int M, int K, int N, int mb, int n_rb,
                                 int splits, int groups, int stages, int cps, int vec_c,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int T = (N + TN - 1) / TN, C = (K + CK - 1) / CK;
  if (K <= 0 || K % 8 || reinterpret_cast<uintptr_t>(a) % 16 || n_rb < 1 || mb * n_rb < M ||
      mb * (n_rb - 1) >= M)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > C || groups < 1 || groups > T) return (int)cudaErrorInvalidValue;
  // An even ring: each slot feeds one warpgroup, whose parity waits are
  // then never a phase ahead of the slot's barrier.
  if (stages < 2 || stages > MAX_STAGES || stages % 2 || cps < 1)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (ws == nullptr || cnt == nullptr)) return (int)cudaErrorInvalidValue;
  Args p{static_cast<const __nv_bfloat16*>(a), static_cast<const uint8_t*>(w), s,
         static_cast<__nv_bfloat16*>(c), splits > 1 ? ws : nullptr, splits > 1 ? cnt : nullptr,
         M, K, N, T, C, splits, groups, stages, cps, (C + splits - 1) / splits, vec_c};
  CUtensorMap a_map{};
  if (!a_tensor_map(&a_map, a, M, K, mb)) return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mb) {
    case 16: return launch<16>(a_map, p, n_rb, st);
    case 32: return launch<32>(a_map, p, n_rb, st);
    case 48: return launch<48>(a_map, p, n_rb, st);
    case 64: return launch<64>(a_map, p, n_rb, st);
    case 80: return launch<80>(a_map, p, n_rb, st);
    case 96: return launch<96>(a_map, p, n_rb, st);
    case 128: return launch<128>(a_map, p, n_rb, st);
    case 160: return launch<160>(a_map, p, n_rb, st);
    case 192: return launch<192>(a_map, p, n_rb, st);
    case 256: return launch<256>(a_map, p, n_rb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
