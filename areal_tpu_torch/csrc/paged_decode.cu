// Paged decode attention over a KV page pool, for Hopper (sm_90a).
//
// Two entry points from one template:
//   paged_decode_bf16 - bf16 pool. Takes the role of jax's stock TPU paged
//     attention kernel (areal_tpu/engine/paged.py:paged_decode_attention,
//     impl="kernel", pak.paged_attention).
//   paged_decode_int8 - int8 pool with squeezed f32 scales. Replaces
//     areal_tpu/ops/pallas/paged_decode_int8.py:int8_paged_decode_attention
//     (body _kernel), dequantizing in registers as int8 * s / 127.5.
//
// What it computes: for each sequence b and q head h, attention of the one
// new query q[b, h] over the first lengths[b] tokens of the sequence, whose
// token t lives at pool page page_indices[b, t / pg], offset t % pg, under
// kv head h / group.
//
// What bounds it on the H100: bytes. Each token's K and V rows are read
// once per kv head and used by the `group` q heads of that head, so the
// kernel does ~2 * group flops per byte read; decode is far below the
// card's bf16 ridge, and the floor is sum(lengths) * Hkv * hd * 2 * bytes
// over 3.35 TB/s.
//
// What the design does about it:
//  - one CTA per (kv head, sequence) computes all `group` q heads, so each
//    K/V row is loaded from device memory once, not once per q head;
//  - the loop stops at lengths[b]: no page past the length is read (the TPU
//    kernel still DMAs those pages);
//  - each warp walks tokens with 32 lanes across hd (coalesced row loads,
//    8 bytes per lane for bf16 at hd = 128, 4 for int8) and keeps an online
//    softmax in registers; the 8 warps' partial states merge once in shared
//    memory at the end;
//  - int8 pools move pg * (hd + 4) bytes per (head, page) instead of
//    2 * pg * hd, dequantized in registers.
// Split-K across CTAs for long sequences at small batch is later work.
//
// Layouts (contiguous): q [B, Hq, hd] bf16; pools [Hkv, N, pg, hd] (bf16,
// or int8 data plus f32 scales [Hkv, N, pg]); lengths [B] int32; page
// indices [B, P] int32 read with a row stride (0 broadcasts one page row to
// every sequence, the chunked-prefill case); out [B, Hq, hd] bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int G_MAX = 8;  // largest GQA group (q heads per kv head) taken
constexpr int UNR = 4;    // tokens in flight per warp
constexpr float NEG_INF = -1e30f;
constexpr float KV_INT8_MAX = 127.5f;  // areal_tpu_torch/ops/quant_const.py

// One token's K (or V) row slice owned by this lane, as f32. `tok` is the
// token's flat index into the pool ((kv head * N + page) * pg + offset).
template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* pool, const float*,
                                         size_t tok, int lane, float (&x)[DPL]) {
  const __nv_bfloat16* p = pool + tok * (32 * DPL) + lane * DPL;
#pragma unroll
  for (int d = 0; d < DPL; d += 2) {
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + d));
    x[d] = f.x;
    x[d + 1] = f.y;
  }
}

template <int DPL>
__device__ __forceinline__ void load_row(const int8_t* pool, const float* scales,
                                         size_t tok, int lane, float (&x)[DPL]) {
  const int8_t* p = pool + tok * (32 * DPL) + lane * DPL;
  const float s = scales[tok] / KV_INT8_MAX;
  if constexpr (DPL == 4) {
    const char4 w = *reinterpret_cast<const char4*>(p);
    x[0] = (float)w.x * s;
    x[1] = (float)w.y * s;
    x[2] = (float)w.z * s;
    x[3] = (float)w.w * s;
  } else {
#pragma unroll
    for (int d = 0; d < DPL; ++d) x[d] = (float)p[d] * s;
  }
}

template <typename KV, int HD, int G>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const KV* __restrict__ k_pool, const float* __restrict__ k_scales,
                    const KV* __restrict__ v_pool, const float* __restrict__ v_scales,
                    const int* __restrict__ lengths,
                    const int* __restrict__ page_indices, int pi_row_stride,
                    __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int N,
                    int pg, int P, int group, float scale) {
  constexpr int DPL = HD / 32;  // dims per lane
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  __shared__ float s_m[NWARPS][G];
  __shared__ float s_l[NWARPS][G];
  __shared__ float s_acc[NWARPS][G][HD];

  // This lane's slice of the group's q heads, pre-scaled, in f32.
  float qv[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int d = 0; d < DPL; ++d) qv[g][d] = 0.f;
    if (g < group) {
      const __nv_bfloat16* qp = q + ((size_t)b * Hq + hk * group + g) * HD + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) qv[g][d] = __bfloat162float(qp[d]) * scale;
    }
  }

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  }

  int len = lengths[b];
  len = len < 0 ? 0 : (len > P * pg ? P * pg : len);
  const int* prow = page_indices + (size_t)b * pi_row_stride;
  const size_t head_off = (size_t)hk * N;

  // Each warp takes UNR consecutive tokens per step so that UNR row loads
  // are in flight at once; the warps interleave by UNR-token strides.
  for (int t0 = warp * UNR; t0 < len; t0 += NWARPS * UNR) {
    float kx[UNR][DPL], vx[UNR][DPL];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int t = t0 + u;
      if (t < len) {
        const size_t tok = (head_off + prow[t / pg]) * pg + (t % pg);
        load_row<DPL>(k_pool, k_scales, tok, lane, kx[u]);
        load_row<DPL>(v_pool, v_scales, tok, lane, vx[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      if (t0 + u >= len) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= group) break;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) s += qv[g][d] * kx[u][d];
        // Butterfly all-reduce: every lane ends with the identical sum, so
        // the per-lane copies of m and l stay equal.
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        const float m_new = fmaxf(m[g], s);
        const float alpha = __expf(m[g] - m_new);
        const float p = __expf(s - m_new);
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] = acc[g][d] * alpha + p * vx[u][d];
      }
    }
  }

  // Merge the warps' partial softmax states.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d) s_acc[warp][g][lane * DPL + d] = acc[g][d];
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
      float c = s_l[w][g] == 0.f ? 0.f : __expf(s_m[w][g] - mx);
      lsum += s_l[w][g] * c;
      o += s_acc[w][g][d] * c;
    }
    out[((size_t)b * Hq + hk * group + g) * HD + d] =
        __float2bfloat16(lsum > 0.f ? o / lsum : 0.f);
  }
}

template <typename KV, int HD, int G>
int launch(const void* q, const void* kd, const float* ks, const void* vd,
           const float* vs, const int* lengths, const int* page_indices,
           int pi_row_stride, void* out, int B, int Hq, int Hkv, int N, int pg,
           int P, float scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  paged_decode_kernel<KV, HD, G><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kd), ks,
      static_cast<const KV*>(vd), vs, lengths, page_indices, pi_row_stride,
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, N, pg, P, Hq / Hkv, scale);
  return (int)cudaGetLastError();
}

template <typename KV>
int dispatch(const void* q, const void* kd, const float* ks, const void* vd,
             const float* vs, const int* lengths, const int* page_indices,
             int pi_row_stride, void* out, int B, int Hq, int Hkv, int N,
             int pg, int hd, int P, float scale, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || pg <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, kd, ks, vd, vs, lengths, page_indices, pi_row_stride, out, B, Hq, Hkv, N, pg, P, scale, s
  if (hd == 128) {
    if (group <= 2) return launch<KV, 128, 2>(ARGS);
    if (group <= 4) return launch<KV, 128, 4>(ARGS);
    if (group <= G_MAX) return launch<KV, 128, G_MAX>(ARGS);
  } else if (hd == 64) {
    if (group <= 2) return launch<KV, 64, 2>(ARGS);
    if (group <= 4) return launch<KV, 64, 4>(ARGS);
    if (group <= G_MAX) return launch<KV, 64, G_MAX>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const int* lengths,
                                 const int* page_indices, int pi_row_stride,
                                 void* out, int B, int Hq, int Hkv, int N,
                                 int pg, int hd, int P, float scale,
                                 void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pool, nullptr, v_pool, nullptr, lengths,
                                 page_indices, pi_row_stride, out, B, Hq, Hkv,
                                 N, pg, hd, P, scale, stream);
}

extern "C" int paged_decode_int8(const void* q, const void* k_data,
                                 const float* k_scales, const void* v_data,
                                 const float* v_scales, const int* lengths,
                                 const int* page_indices, int pi_row_stride,
                                 void* out, int B, int Hq, int Hkv, int N,
                                 int pg, int hd, int P, float scale,
                                 void* stream) {
  return dispatch<int8_t>(q, k_data, k_scales, v_data, v_scales, lengths,
                          page_indices, pi_row_stride, out, B, Hq, Hkv, N, pg,
                          hd, P, scale, stream);
}
