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
// What the design does about it. The TPU grids run in order and carry their
// sums in VMEM scratch across an "arbitrary" axis; CUDA blocks run in
// parallel, so that loop moves inside the CTA and each output is written
// once, with no atomics (the result is deterministic):
//   dq:    one CTA per (q tile, q head, row) loops over kv tiles 0 .. qt;
//   dk/dv: one CTA per (kv tile, kv head, row) loops over the group's q
//          heads and the q tiles qt .. last, so traffic is [Hkv, T, hd].
// The score tile never reaches device memory. Products are FMA loops in f32
// on 64 x 64 tiles; tensor cores (mma / wgmma) and TMA are later work. The
// dk/dv CTA has 256 threads so that its two [64, hd] f32 accumulators take
// 64 registers a thread. Heavy tiles are scheduled first.
//
// Any T is taken (the ragged last tile is masked) and hd in {64, 128}.
//
// Layouts (all contiguous): q, dout, dq [R, T, Hq, hd] bf16; k, v, dk, dv
// [R, T, Hkv, hd] bf16; seg, pos [R, T] int32; lse, delta [R, Hq, T] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // kv rows per tile
constexpr int LDP = BK + 1;  // padded f32 row stride of the P / dS tiles

template <int HD>
struct Tile {
  static constexpr int LDS = HD + 8;  // padded bf16 row stride (bank spread)
  static constexpr size_t dq_smem_bytes() {
    return 4 * BQ * LDS * sizeof(__nv_bfloat16)  // Q, dO, K, V tiles
           + BQ * LDP * sizeof(float)            // dS tile
           + 2 * BK * sizeof(int);               // kv seg, kv pos
  }
  static constexpr size_t dkv_smem_bytes() {
    return 4 * BQ * LDS * sizeof(__nv_bfloat16)  // K, V, Q, dO tiles
           + 2 * BQ * LDP * sizeof(float);       // P and dS tiles
  }
};

// Copy 64 x HD bf16 from a strided global source into a padded smem tile
// with 16-byte loads; rows at or past `valid` are zero-filled.
template <int HD, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t row_stride, int valid) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BQ * CHUNKS; c += NT) {
    int row = c / CHUNKS;
    int col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid) {
      val = *reinterpret_cast<const uint4*>(src + row * row_stride + col);
    }
    *reinterpret_cast<uint4*>(dst + row * Tile<HD>::LDS + col) = val;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// s[i][jj] += A[row0 + i] . B[tx + 8 jj] and t[i][jj] += C[row0 + i] . D[tx + 8 jj]
// over HD, for RPT rows of the 64-row tiles A, C and 8 rows of B, D.
template <int HD, int RPT>
__device__ __forceinline__ void two_products(
    const __nv_bfloat16* A, const __nv_bfloat16* B, const __nv_bfloat16* C,
    const __nv_bfloat16* D, int row0, int tx, float (&s)[RPT][8],
    float (&t)[RPT][8]) {
  constexpr int LDS = Tile<HD>::LDS;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      s[i][jj] = 0.f;
      t[i][jj] = 0.f;
    }
#pragma unroll 2
  for (int d = 0; d < HD; d += 2) {
    float2 a[RPT], c[RPT], b[8], e[8];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      a[i] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(A + (row0 + i) * LDS + d));
      c[i] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(C + (row0 + i) * LDS + d));
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      b[jj] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(B + (tx + 8 * jj) * LDS + d));
      e[jj] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(D + (tx + 8 * jj) * LDS + d));
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[i][jj] += a[i].x * b[jj].x + a[i].y * b[jj].y;
        t[i][jj] += c[i].x * e[jj].x + c[i].y * e[jj].y;
      }
  }
}

// ---------------------------------------------------------------------------
// dq: one CTA per (q tile, q head, row); 128 threads = 16 row groups of 4
// rows x 8 column lanes.
// ---------------------------------------------------------------------------

constexpr int DQ_THREADS = 128;

template <int HD>
__global__ void __launch_bounds__(DQ_THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const int* __restrict__ seg, const int* __restrict__ pos,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int T, int Hq, int Hkv,
                    float scale) {
  constexpr int LDS = Tile<HD>::LDS;
  constexpr int DPT = HD / 8;  // output dims per thread (pairs at 2*tx)
  constexpr int RPT = 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + BQ * LDS;
  __nv_bfloat16* sK = sdO + BQ * LDS;
  __nv_bfloat16* sV = sK + BK * LDS;
  float* sDS = reinterpret_cast<float*>(sV + BK * LDS);
  int* sKseg = reinterpret_cast<int*>(sDS + BQ * LDP);
  int* sKpos = sKseg + BK;

  // The last q tile loops over the most kv tiles: schedule it first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;

  const size_t q_row_stride = (size_t)Hq * HD;
  const size_t kv_row_stride = (size_t)Hkv * HD;
  const size_t q_off = ((size_t)r * T + q0) * q_row_stride + (size_t)h * HD;
  const __nv_bfloat16* k_base = k + (size_t)r * T * kv_row_stride + (size_t)hk * HD;
  const __nv_bfloat16* v_base = v + (size_t)r * T * kv_row_stride + (size_t)hk * HD;
  const int* seg_r = seg + (size_t)r * T;
  const int* pos_r = pos + (size_t)r * T;
  const size_t stat_off = ((size_t)r * Hq + h) * T;

  load_tile<HD, DQ_THREADS>(sQ, q + q_off, q_row_stride, T - q0);
  load_tile<HD, DQ_THREADS>(sdO, dout + q_off, q_row_stride, T - q0);

  int qseg[RPT], qpos[RPT];
  float qlse[RPT], qdelta[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    int row = q0 + ty * RPT + i;
    bool in = row < T;
    qseg[i] = in ? seg_r[row] : 0;
    qpos[i] = in ? pos_r[row] : 0;
    qlse[i] = in ? lse[stat_off + row] : 0.f;
    qdelta[i] = in ? delta[stat_off + row] : 0.f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;

  // Causal tile skip, as the forward: kv tiles 0 .. qt (BQ == BK).
  for (int j = 0; j <= qt; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // previous tile's readers are done with sK/sV/sDS
    load_tile<HD, DQ_THREADS>(sK, k_base + (size_t)k0 * kv_row_stride, kv_row_stride, T - k0);
    load_tile<HD, DQ_THREADS>(sV, v_base + (size_t)k0 * kv_row_stride, kv_row_stride, T - k0);
    for (int c = tid; c < BK; c += DQ_THREADS) {
      bool in = k0 + c < T;
      sKseg[c] = in ? seg_r[k0 + c] : -1;  // -1 never equals a q segment
      sKpos[c] = in ? pos_r[k0 + c] : 0;
    }
    __syncthreads();

    float s[RPT][8], dp[RPT][8];
    two_products<HD, RPT>(sQ, sK, sdO, sV, ty * RPT, tx, s, dp);

#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        int c = tx + 8 * jj;
        bool ok = (qseg[i] > 0) && (sKseg[c] == qseg[i]) && (qpos[i] >= sKpos[c]);
        float p = ok ? __expf(s[i][jj] * scale - qlse[i]) : 0.f;
        float ds = ok ? p * (dp[i][jj] - qdelta[i]) * scale : 0.f;
        sDS[(ty * RPT + i) * LDP + c] = round_bf16(ds);
      }
    __syncthreads();

    // acc += dS K on this thread's 4 rows x DPT dims (pairs at 2*tx + 16*dd).
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float w[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) w[i] = sDS[(ty * RPT + i) * LDP + c];
#pragma unroll
      for (int dd = 0; dd < DPT / 2; ++dd) {
        float2 kk = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sK + c * LDS + 2 * tx + 16 * dd));
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][2 * dd] += w[i] * kk.x;
          acc[i][2 * dd + 1] += w[i] * kk.y;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    int row = q0 + ty * RPT + i;
    if (row >= T) continue;
    __nv_bfloat16* o = dq + ((size_t)r * T + row) * q_row_stride + (size_t)h * HD;
#pragma unroll
    for (int dd = 0; dd < DPT / 2; ++dd) {
      *reinterpret_cast<__nv_bfloat162*>(o + 2 * tx + 16 * dd) =
          __floats2bfloat162_rn(acc[i][2 * dd], acc[i][2 * dd + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one CTA per (kv tile, kv head, row); 256 threads = 32 row groups of
// 2 rows x 8 column lanes.
// ---------------------------------------------------------------------------

constexpr int DKV_THREADS = 256;

template <int HD>
__global__ void __launch_bounds__(DKV_THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const int* __restrict__ seg, const int* __restrict__ pos,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int T, int Hq, int Hkv,
                     float scale) {
  constexpr int LDS = Tile<HD>::LDS;
  constexpr int DPT = HD / 8;
  constexpr int RPT = 2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BK * LDS;
  __nv_bfloat16* sQ = sV + BK * LDS;
  __nv_bfloat16* sdO = sQ + BQ * LDS;
  float* sP = reinterpret_cast<float*>(sdO + BQ * LDS);
  float* sDS = sP + BQ * LDP;

  // kv tile 0 loops over the most q tiles: blockIdx.x == 0 goes first.
  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int r = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = kt * BK;
  const int nq = (T + BQ - 1) / BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;

  const size_t q_row_stride = (size_t)Hq * HD;
  const size_t kv_row_stride = (size_t)Hkv * HD;
  const size_t kv_off = ((size_t)r * T + k0) * kv_row_stride + (size_t)hk * HD;
  const int* seg_r = seg + (size_t)r * T;
  const int* pos_r = pos + (size_t)r * T;

  load_tile<HD, DKV_THREADS>(sK, k + kv_off, kv_row_stride, T - k0);
  load_tile<HD, DKV_THREADS>(sV, v + kv_off, kv_row_stride, T - k0);

  // Segment and position of this thread's 8 kv columns (tx + 8 jj).
  int kseg[8], kpos[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    int c = k0 + tx + 8 * jj;
    bool in = c < T;
    kseg[jj] = in ? seg_r[c] : -1;  // -1 never equals a q segment
    kpos[jj] = in ? pos_r[c] : 0;
  }

  float acc_k[RPT][DPT], acc_v[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      acc_k[i][d] = 0.f;
      acc_v[i][d] = 0.f;
    }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t stat_off = ((size_t)r * Hq + h) * T;
    // Causal tile skip: q tiles before the kv tile hold only earlier tokens.
    for (int it = kt; it < nq; ++it) {
      const int q0 = it * BQ;
      const size_t q_off = ((size_t)r * T + q0) * q_row_stride + (size_t)h * HD;
      __syncthreads();  // previous tile's readers are done with sQ/sdO/sP/sDS
      load_tile<HD, DKV_THREADS>(sQ, q + q_off, q_row_stride, T - q0);
      load_tile<HD, DKV_THREADS>(sdO, dout + q_off, q_row_stride, T - q0);
      int qseg[RPT], qpos[RPT];
      float qlse[RPT], qdelta[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        int row = q0 + ty * RPT + i;
        bool in = row < T;
        qseg[i] = in ? seg_r[row] : 0;
        qpos[i] = in ? pos_r[row] : 0;
        qlse[i] = in ? lse[stat_off + row] : 0.f;
        qdelta[i] = in ? delta[stat_off + row] : 0.f;
      }
      __syncthreads();

      float s[RPT][8], dp[RPT][8];
      two_products<HD, RPT>(sQ, sK, sdO, sV, ty * RPT, tx, s, dp);

#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          bool ok = (qseg[i] > 0) && (kseg[jj] == qseg[i]) && (qpos[i] >= kpos[jj]);
          float p = ok ? __expf(s[i][jj] * scale - qlse[i]) : 0.f;
          float ds = ok ? p * (dp[i][jj] - qdelta[i]) * scale : 0.f;
          int at = (ty * RPT + i) * LDP + tx + 8 * jj;
          sP[at] = round_bf16(p);
          sDS[at] = round_bf16(ds);
        }
      __syncthreads();

      // dv += P^T dO and dk += dS^T Q on this thread's 2 kv rows x DPT dims.
#pragma unroll 4
      for (int row = 0; row < BQ; ++row) {
        float pw[RPT], dw[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pw[i] = sP[row * LDP + ty * RPT + i];
          dw[i] = sDS[row * LDP + ty * RPT + i];
        }
#pragma unroll
        for (int dd = 0; dd < DPT / 2; ++dd) {
          float2 oo = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sdO + row * LDS + 2 * tx + 16 * dd));
          float2 qq = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sQ + row * LDS + 2 * tx + 16 * dd));
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            acc_v[i][2 * dd] += pw[i] * oo.x;
            acc_v[i][2 * dd + 1] += pw[i] * oo.y;
            acc_k[i][2 * dd] += dw[i] * qq.x;
            acc_k[i][2 * dd + 1] += dw[i] * qq.y;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    int row = k0 + ty * RPT + i;
    if (row >= T) continue;
    size_t off = ((size_t)r * T + row) * kv_row_stride + (size_t)hk * HD;
#pragma unroll
    for (int dd = 0; dd < DPT / 2; ++dd) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 2 * tx + 16 * dd) =
          __floats2bfloat162_rn(acc_k[i][2 * dd], acc_k[i][2 * dd + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 2 * tx + 16 * dd) =
          __floats2bfloat162_rn(acc_v[i][2 * dd], acc_v[i][2 * dd + 1]);
    }
  }
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const int* seg, const int* pos, const float* lse,
              const float* delta, void* dq, int R, int T, int Hq, int Hkv,
              float scale, cudaStream_t stream) {
  const size_t smem = Tile<HD>::dq_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, Hq, R);
  flash_bwd_dq_kernel<HD><<<grid, DQ_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      seg, pos, lse, delta, static_cast<__nv_bfloat16*>(dq), T, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const int* seg, const int* pos, const float* lse,
               const float* delta, void* dk, void* dv, int R, int T, int Hq,
               int Hkv, float scale, cudaStream_t stream) {
  const size_t smem = Tile<HD>::dkv_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BK - 1) / BK, Hkv, R);
  flash_bwd_dkv_kernel<HD><<<grid, DKV_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      seg, pos, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int R, int Hq, int Hkv) {
  return Hkv <= 0 || Hq % Hkv != 0 || R > 65535 || Hq > 65535;
}

}  // namespace

extern "C" int flash_attn_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const int* seg,
                                      const int* pos, const float* lse,
                                      const float* delta, void* dq, int R, int T,
                                      int Hq, int Hkv, int hd, float scale,
                                      void* stream) {
  if (R <= 0 || T <= 0) return 0;
  if (bad_shape(R, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_dq<128>(q, k, v, dout, seg, pos, lse, delta, dq, R, T, Hq, Hkv, scale, s);
  if (hd == 64)
    return launch_dq<64>(q, k, v, dout, seg, pos, lse, delta, dq, R, T, Hq, Hkv, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const int* seg,
                                       const int* pos, const float* lse,
                                       const float* delta, void* dk, void* dv,
                                       int R, int T, int Hq, int Hkv, int hd,
                                       float scale, void* stream) {
  if (R <= 0 || T <= 0) return 0;
  if (bad_shape(R, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_dkv<128>(q, k, v, dout, seg, pos, lse, delta, dk, dv, R, T, Hq, Hkv, scale, s);
  if (hd == 64)
    return launch_dkv<64>(q, k, v, dout, seg, pos, lse, delta, dk, dv, R, T, Hq, Hkv, scale, s);
  return (int)cudaErrorInvalidValue;
}
