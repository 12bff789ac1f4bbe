// Packed causal GQA flash attention, forward pass, for Hopper (sm_90a).
//
// Replaces areal_tpu/ops/pallas/flash_attn.py:_fwd (body _fwd_kernel), and
// on the GPU also takes the prefill role that jax's stock splash kernel had
// on the TPU (areal_tpu/ops/attention.py:splash_packed_attention).
//
// What it computes, for each packed row r, q head h and token i:
//   out[r, i, h] = softmax_j(scale * q_i . k_j  masked) @ v_j
//   mask(i, j)   = seg[i] == seg[j] && pos[i] >= pos[j] && seg[i] > 0
// with the kv head h / group (GQA), plus the f32 logsumexp of each row
// (kept for the later backward). A fully masked (padding) row writes 0.
//
// What bounds it on the H100: operations. Causal attention does
// 2 * T^2 * hd * Hq flops per packed row against 4 * T * hd * (Hq + Hkv)
// bytes of q/k/v/out traffic; at T = 1024 that is ~500 flops per byte,
// above the card's ~295 bf16 flops-per-byte ridge.
//
// What the design does about it: q, k and v tiles stay in shared memory
// and the softmax state in registers, so the [T, T] score matrix never
// reaches device memory (the online softmax of the JAX kernel); kv tiles
// past the q tile's last row are skipped (causal tile skip, valid because
// packed sequences are contiguous with ascending positions). This first
// version multiplies with FMA loops in f32 on 64 x 64 tiles, one CTA per
// (q tile, q head, row); tensor cores (mma / wgmma) and TMA are later work.
//
// Differences from the TPU kernel, by design: any T is taken (the ragged
// last tile is masked) instead of T % 128 == 0, and hd in {64, 128} is
// taken natively instead of being zero-padded to 128 lanes.
//
// Layouts (all contiguous): q [R, T, Hq, hd] bf16; k, v [R, T, Hkv, hd]
// bf16; seg, pos [R, T] int32; out [R, T, Hq, hd] bf16; lse [R, Hq, T] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // kv rows per tile
constexpr int NTHREADS = 128; // 16 row groups x 8 column lanes
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Tile {
  static constexpr int LDS = HD + 8;  // padded bf16 row stride (bank spread)
  static constexpr int LDP = BK + 1;  // padded f32 row stride of P
  static constexpr size_t smem_bytes() {
    return 3 * BQ * LDS * sizeof(__nv_bfloat16)  // Q, K, V tiles
           + BQ * LDP * sizeof(float)            // P tile
           + 2 * BK * sizeof(int);               // kv seg, kv pos
  }
};

// Copy `rows` x HD bf16 from a strided global source into a padded smem
// tile with 16-byte loads; rows at or past `valid` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t row_stride, int valid) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BQ * CHUNKS; c += NTHREADS) {
    int row = c / CHUNKS;
    int col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid) {
      val = *reinterpret_cast<const uint4*>(src + row * row_stride + col);
    }
    *reinterpret_cast<uint4*>(dst + row * Tile<HD>::LDS + col) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ seg, const int* __restrict__ pos,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int T, int Hq, int Hkv, float scale) {
  constexpr int LDS = Tile<HD>::LDS;
  constexpr int LDP = Tile<HD>::LDP;
  constexpr int DPT = HD / 8;  // output dims per thread (pairs at 2*tx)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LDS;
  __nv_bfloat16* sV = sK + BK * LDS;
  float* sP = reinterpret_cast<float*>(sV + BK * LDS);
  int* sKseg = reinterpret_cast<int*>(sP + BQ * LDP);
  int* sKpos = sKseg + BK;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int group = Hq / Hkv;
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 7;   // column lane

  const size_t q_row_stride = (size_t)Hq * HD;
  const size_t kv_row_stride = (size_t)Hkv * HD;
  const __nv_bfloat16* q_base = q + ((size_t)r * T + q0) * q_row_stride + (size_t)h * HD;
  const __nv_bfloat16* k_base = k + (size_t)r * T * kv_row_stride + (size_t)hk * HD;
  const __nv_bfloat16* v_base = v + (size_t)r * T * kv_row_stride + (size_t)hk * HD;
  const int* seg_r = seg + (size_t)r * T;
  const int* pos_r = pos + (size_t)r * T;

  load_tile<HD>(sQ, q_base, q_row_stride, T - q0);

  int qseg[4], qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = q0 + ty * 4 + i;
    qseg[i] = row < T ? seg_r[row] : 0;
    qpos[i] = row < T ? pos_r[row] : 0;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  // Causal tile skip: kv tiles past the q tile's last row hold only later
  // tokens of the stream. BQ == BK, so that is tiles 0 .. qt.
  const int n_tiles = qt + 1;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // previous tile's readers are done with sK/sV/sP
    load_tile<HD>(sK, k_base + (size_t)k0 * kv_row_stride, kv_row_stride, T - k0);
    load_tile<HD>(sV, v_base + (size_t)k0 * kv_row_stride, kv_row_stride, T - k0);
    for (int c = tid; c < BK; c += NTHREADS) {
      bool ok = k0 + c < T;
      sKseg[c] = ok ? seg_r[k0 + c] : -1;  // -1 never equals a q segment
      sKpos[c] = ok ? pos_r[k0 + c] : 0;
    }
    __syncthreads();

    // S = Q K^T on this thread's 4 rows x 8 columns (cols tx + 8*jj).
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 2) {
      float2 a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sQ + (ty * 4 + i) * LDS + d));
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        b[jj] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sK + (tx + 8 * jj) * LDS + d));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          s[i][jj] += a[i].x * b[jj].x + a[i].y * b[jj].y;
    }

    // Mask, online softmax (the JAX kernel's _compute), P to shared memory.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned ok_bits = 0u;
      float row_max = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        int c = tx + 8 * jj;
        bool ok = (qseg[i] > 0) && (sKseg[c] == qseg[i]) && (qpos[i] >= sKpos[c]);
        s[i][jj] = ok ? s[i][jj] * scale : NEG_INF;
        ok_bits |= (ok ? 1u : 0u) << jj;
        row_max = fmaxf(row_max, s[i][jj]);
      }
      // The 8 column lanes of a row are adjacent lanes of one warp.
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 4));
      float m_new = fmaxf(m[i], row_max);
      float alpha = __expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float p = ((ok_bits >> jj) & 1u) ? __expf(s[i][jj] - m_new) : 0.f;
        row_sum += p;
        // P.V runs on bf16-rounded P, as the JAX kernel casts p to v's type.
        sP[(ty * 4 + i) * LDP + tx + 8 * jj] =
            __bfloat162float(__float2bfloat16(p));
      }
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 4);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();

    // acc += P V on this thread's 4 rows x DPT dims (pairs at 2*tx + 16*dd).
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int dd = 0; dd < DPT / 2; ++dd) {
        float2 vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sV + c * LDS + 2 * tx + 16 * dd));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * dd] += p[i] * vv.x;
          acc[i][2 * dd + 1] += p[i] * vv.y;
        }
      }
    }
  }

  // Finalize: a row with no valid key (padding) writes 0 (the JAX safe_l).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = q0 + ty * 4 + i;
    if (row >= T) continue;
    float safe_l = l[i] == 0.f ? 1.f : l[i];
    float inv = 1.f / safe_l;
    __nv_bfloat16* o = out + ((size_t)r * T + row) * q_row_stride + (size_t)h * HD;
#pragma unroll
    for (int dd = 0; dd < DPT / 2; ++dd) {
      *reinterpret_cast<__nv_bfloat162*>(o + 2 * tx + 16 * dd) =
          __floats2bfloat162_rn(acc[i][2 * dd] * inv, acc[i][2 * dd + 1] * inv);
    }
    if (tx == 0) lse[((size_t)r * Hq + h) * T + row] = m[i] + logf(safe_l);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const int* seg,
           const int* pos, void* out, float* lse, int R, int T, int Hq,
           int Hkv, float scale, cudaStream_t stream) {
  const size_t smem = Tile<HD>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, Hq, R);
  flash_fwd_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg, pos,
      static_cast<__nv_bfloat16*>(out), lse, T, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   const int* seg, const int* pos, void* out,
                                   float* lse, int R, int T, int Hq, int Hkv,
                                   int hd, float scale, void* stream) {
  if (R <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || R > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch<128>(q, k, v, seg, pos, out, lse, R, T, Hq, Hkv, scale, s);
  if (hd == 64) return launch<64>(q, k, v, seg, pos, out, lse, R, T, Hq, Hkv, scale, s);
  return (int)cudaErrorInvalidValue;
}
