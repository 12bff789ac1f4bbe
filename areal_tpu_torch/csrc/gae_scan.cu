// Reverse affine scan per row, the core of GAE, for Hopper (sm_90a).
//
// Replaces areal_tpu/ops/pallas/gae_scan.py:segment_scan_reverse (body
// _scan_kernel).
//
// What it computes, for each row r of a, b [R, T] f32:
//   x[r, t] = a[r, t] * x[r, t + 1] + b[r, t],  t = T-1 .. 0,  x[r, T] = 0
// The segment structure of packed rows lives in a (0 at segment ends) and b
// (0 on padding), so the kernel is a plain scan.
//
// What bounds it on the H100: bytes. 12 bytes move per element (a and b
// read, x written) for two flops.
//
// What the design does about it. The TPU kernel walks time blocks on a
// sequential grid and carries x between blocks in VMEM scratch; CUDA blocks
// run in parallel, so nothing may carry between them. Rows are independent:
// one CTA owns a whole row. Each thread composes the affine maps of a
// contiguous chunk of the row serially into one map (A, B), the CTA scans
// the per-thread maps from the right in shared memory (log2 steps), and
// each thread then walks its chunk again from its incoming x. a and b are
// read from device memory once (the second walk hits L1 / L2), x is written
// once, and no [R, T] intermediate exists. Any R and T are taken. With few
// long rows most SMs idle; a decoupled look-back across CTAs is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per CTA (one CTA per row)

__global__ void __launch_bounds__(NT)
gae_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ x, int T) {
  __shared__ float sA[NT];
  __shared__ float sB[NT];

  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * T;
  const float* ar = a + row;
  const float* br = b + row;
  float* xr = x + row;

  const int chunk = (T + NT - 1) / NT;
  const int lo = min(tid * chunk, T);
  const int hi = min(lo + chunk, T);

  // This thread's chunk as one map: x[lo] = A * x[hi] + B.
  float A = 1.f, B = 0.f;
  for (int t = hi - 1; t >= lo; --t) {
    float at = ar[t];
    B = at * B + br[t];
    A = at * A;
  }
  sA[tid] = A;
  sB[tid] = B;
  __syncthreads();

  // Inclusive scan from the right: after it, (sA, sB)[i] composes the chunks
  // of threads i .. NT-1 (the chunk of thread i is the outer map).
  for (int s = 1; s < NT; s <<= 1) {
    float A2 = 1.f, B2 = 0.f;
    if (tid + s < NT) {
      A2 = sA[tid + s];
      B2 = sB[tid + s];
    }
    __syncthreads();
    B = B + A * B2;
    A = A * A2;
    sA[tid] = A;
    sB[tid] = B;
    __syncthreads();
  }

  // x past the row's end is 0, so x[hi] is the B of the chunks to the right.
  float xt = tid + 1 < NT ? sB[tid + 1] : 0.f;
  for (int t = hi - 1; t >= lo; --t) {
    xt = ar[t] * xt + br[t];
    xr[t] = xt;
  }
}

}  // namespace

extern "C" int gae_scan_f32(const float* a, const float* b, float* x, int R,
                            int T, void* stream) {
  if (R <= 0 || T <= 0) return 0;
  gae_scan_kernel<<<R, NT, 0, static_cast<cudaStream_t>(stream)>>>(a, b, x, T);
  return (int)cudaGetLastError();
}
