// Reverse affine scan per row, the core of GAE, for Hopper (sm_90a).
//
// Replaces areal_tpu/ops/pallas/gae_scan.py:segment_scan_reverse (body
// _scan_kernel), and with it the elementwise work around that scan in
// areal_tpu/ops/gae.py:packed_gae.
//
// What it computes, for each row r of [R, T] f32:
//   x[r, t] = a[r, t] * x[r, t + 1] + b[r, t],  t = T-1 .. 0,  x[r, T] = 0
// Two entries instantiate one kernel body:
// - gae_scan_f32 reads a and b and writes x;
// - packed_gae_f32 reads rewards, values, bootstraps (f32) and segment ids
//   (int32), builds a and b in a prologue exactly as
//   ops/gae._gae_affine_elems does (a one-element halo to the right gives
//   seg[t+1] and values[t+1], 0 past the row's end), and writes
//   adv = valid ? x : 0 and returns = valid ? x + values : 0.
//
// What bounds it on the H100: bytes, 12 an element for the scan and 24 for
// the fused entry, for a handful of flops.
//
// What the design does about it.
// - Each thread holds E = 4 consecutive elements in registers (float4
//   loads where rows are 16-byte aligned, T % 4 == 0; scalar loads
//   otherwise), so a warp's loads are coalesced and every input is read
//   from device memory once and every output written once.
// - A CTA scans a chunk of NT * E elements at once: each thread composes
//   its elements into one affine map, a warp scans those maps from the
//   right with __shfl_down_sync, and one step through shared memory joins
//   the warps.
// - The host's plan (ops/gae.gae_plan) gives each CTA a tile of a row.
//   When a row is short (a few chunks) or the rows give every SM a CTA, a
//   tile is the whole row, and the CTA walks its chunks from the right,
//   carrying x between them and loading the next chunk before it scans the
//   current one. Otherwise a row is split into
//   tiles of one chunk across CTAs. Each such CTA publishes its tile's
//   aggregate map to scratch, stamps a flag with the launch's epoch, and
//   composes the aggregates of all tiles to its right in a fixed order
//   (groups of 32 aligned at the row's end, a fixed shuffle tree in each)
//   to get its incoming x. No step depends on which CTA finished first, so
//   two runs are bit-equal; the decoupled look-back shortcut (take a
//   successor's inclusive prefix when it is ready) would give that up.
// - Forward progress: CTAs take tiles from an atomic ticket, within each
//   row the rightmost tile first, so every tile a CTA waits on belongs to
//   a CTA that is already running. The launch's last ticket resets the
//   counter, and the epoch (a counter in the wrapper) makes older flags
//   stale, so no memset runs per launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;          // threads a CTA
constexpr int E = 4;             // consecutive elements a thread
constexpr int CHUNK = NT * E;    // elements a CTA scans at once (ops/gae.CHUNK)
constexpr int NW = NT / 32;      // warps a CTA
constexpr unsigned FULL = 0xffffffffu;

// x_in = A * x_out + B: the map of a run of elements, from the x just right
// of the run to the x at its first element.
struct Map {
  float A, B;
};

// outer after inner: outer.A * (inner.A * x + inner.B) + outer.B
__device__ __forceinline__ Map compose(Map outer, Map inner) {
  return {outer.A * inner.A, outer.A * inner.B + outer.B};
}

__device__ __forceinline__ Map shfl_down(Map m, int s) {
  return {__shfl_down_sync(FULL, m.A, s), __shfl_down_sync(FULL, m.B, s)};
}

// Lane l ends with the composite of lanes l .. 31, by a fixed tree.
__device__ __forceinline__ Map warp_scan_right(Map m, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    Map r = shfl_down(m, s);
    if (lane + s < 32) m = compose(m, r);
  }
  return m;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// E consecutive values from p[t..t+E) of a row of length T, 0 past its end.
template <class V>
__device__ __forceinline__ void load_run(const V* p, int t, int T, bool vec, V (&out)[E]) {
  if (vec) {  // T % 4 == 0 and t % 4 == 0, so t < T means t + 3 < T
    if (t < T) {
      if constexpr (std::is_same_v<V, float>) {
        float4 q = __ldcs(reinterpret_cast<const float4*>(p + t));
        out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
      } else {
        int4 q = __ldcs(reinterpret_cast<const int4*>(p + t));
        out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) out[i] = V(0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = t + i < T ? __ldcs(p + t + i) : V(0);
  }
}

__device__ __forceinline__ void store_run(float* p, int t, int T, bool vec, const float (&v)[E]) {
  if (vec) {
    if (t < T) __stcs(reinterpret_cast<float4*>(p + t), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (t + i < T) __stcs(p + t + i, v[i]);
  }
}

// Where a launch's tiles live and how they meet.
struct Plan {
  int T;
  int tile;        // elements a CTA owns: a multiple of CHUNK
  int tiles;       // tiles a row; 1, or ceil(T / CHUNK) with tile == CHUNK
  float2* agg;     // [R * tiles] tile aggregates (A, B)
  unsigned* flags; // [R * tiles] the epoch that published each aggregate
  unsigned* ticket;
  unsigned epoch;
};

struct ScanIO {
  const float* a;
  const float* b;
  float* x;
  struct Elems {
    float a[E], b[E];
  };
  __device__ __forceinline__ void load(Elems& e, size_t row, int t, int T, bool vec,
                                       int lane) const {
    load_run(a + row, t, T, vec, e.a);
    load_run(b + row, t, T, vec, e.b);
  }
  __device__ __forceinline__ void affine(const Elems& e, float (&av)[E], float (&bv)[E],
                                         int lane) const {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      av[i] = e.a[i];
      bv[i] = e.b[i];
    }
  }
  __device__ __forceinline__ void store(const Elems& e, const float (&xv)[E], size_t row,
                                        int t, int T, bool vec) const {
    store_run(x + row, t, T, vec, xv);
  }
};

struct PackedIO {
  const float* rew;
  const float* val;
  const int* seg;
  const float* boot;
  float* adv;
  float* ret;
  float gamma, gamma_lam;
  struct Elems {
    float r[E], v[E], bt[E];
    int s[E];
    int s_next;    // seg and values one past this thread's run: lane 31's
    float v_next;  // halo (the other lanes take their neighbour's)
  };
  __device__ __forceinline__ void load(Elems& e, size_t row, int t, int T, bool vec,
                                       int lane) const {
    load_run(rew + row, t, T, vec, e.r);
    load_run(val + row, t, T, vec, e.v);
    load_run(boot + row, t, T, vec, e.bt);
    load_run(seg + row, t, T, vec, e.s);
    e.s_next = 0;  // shift_left's fill past the row's end
    e.v_next = 0.f;
    if (lane == 31 && t + E < T) {
      e.s_next = __ldg(seg + row + t + E);
      e.v_next = __ldg(val + row + t + E);
    }
  }
  // _gae_affine_elems: same = seg[t] == seg[t+1] and valid; V(s_{t+1}) the
  // next value inside the segment, the bootstrap at its end;
  // a = same ? gamma * lam : 0, b = valid ? r + gamma * V(s_{t+1}) - v : 0.
  __device__ __forceinline__ void affine(const Elems& e, float (&av)[E], float (&bv)[E],
                                         int lane) const {
    int sn = __shfl_down_sync(FULL, e.s[0], 1);
    float vn = __shfl_down_sync(FULL, e.v[0], 1);
    if (lane == 31) {
      sn = e.s_next;
      vn = e.v_next;
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int s1 = i + 1 < E ? e.s[i + 1] : sn;
      const float v1 = i + 1 < E ? e.v[i + 1] : vn;
      const bool valid = e.s[i] > 0;
      const bool same = valid && e.s[i] == s1;
      const float vt = same ? v1 : e.bt[i];
      const float delta = __fsub_rn(__fadd_rn(e.r[i], __fmul_rn(gamma, vt)), e.v[i]);
      av[i] = same ? gamma_lam : 0.f;
      bv[i] = valid ? delta : 0.f;
    }
  }
  __device__ __forceinline__ void store(const Elems& e, const float (&xv)[E], size_t row,
                                        int t, int T, bool vec) const {
    float a_out[E], r_out[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const bool valid = e.s[i] > 0;
      a_out[i] = valid ? xv[i] : 0.f;
      r_out[i] = valid ? __fadd_rn(xv[i], e.v[i]) : 0.f;
    }
    store_run(adv + row, t, T, vec, a_out);
    store_run(ret + row, t, T, vec, r_out);
  }
};

// x just right of tile `tile` of a row: the aggregates of tiles tile+1 ..
// tiles-1 composed and applied to x = 0, in groups of 32 from the row's
// end. Run by one whole warp; every lane returns the same value.
__device__ float look_right(const Plan& p, size_t first, int tile, int lane) {
  float x = 0.f;
  for (int hi = p.tiles; hi > tile + 1; hi -= 32) {
    const int k = hi - 32 + lane;
    Map m = {1.f, 0.f};
    if (k > tile) {
      while (ld_acquire(p.flags + first + k) != p.epoch) __nanosleep(32);
      const float2 v = __ldcg(p.agg + first + k);
      m = {v.x, v.y};
    }
    m = warp_scan_right(m, lane);
    const float A = __shfl_sync(FULL, m.A, 0), B = __shfl_sync(FULL, m.B, 0);
    x = A * x + B;
  }
  return x;
}

template <class IO>
__device__ __forceinline__ void scan_rows(const IO& io, const Plan& p) {
  __shared__ Map sW[NW];
  __shared__ float sX;
  __shared__ unsigned sTicket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int row, tile;
  if (p.tiles == 1) {
    row = blockIdx.x;
    tile = 0;
  } else {
    if (tid == 0) {
      const unsigned t = atomicAdd(p.ticket, 1u);
      if (t == gridDim.x - 1) atomicExch(p.ticket, 0u);  // every ticket is taken
      sTicket = t;
    }
    __syncthreads();
    row = (int)(sTicket / p.tiles);
    tile = p.tiles - 1 - (int)(sTicket % p.tiles);
  }
  const int T = p.T;
  const bool vec = (T & 3) == 0;
  const size_t rbase = (size_t)row * T;
  const int lo = tile * p.tile;
  const int nchunks = (min(lo + p.tile, T) - lo + CHUNK - 1) / CHUNK;

  typename IO::Elems cur, nxt;
  int t0 = lo + (nchunks - 1) * CHUNK + tid * E;
  io.load(cur, rbase, t0, T, vec, lane);
  float carry = 0.f;  // x just right of the current chunk
  for (int c = nchunks - 1; c >= 0; --c, t0 -= CHUNK) {
    if (c > 0) io.load(nxt, rbase, t0 - CHUNK, T, vec, lane);
    float av[E], bv[E];
    io.affine(cur, av, bv, lane);
    Map m = {1.f, 0.f};  // this thread's run
#pragma unroll
    for (int i = E - 1; i >= 0; --i) m = compose({av[i], bv[i]}, m);
    m = warp_scan_right(m, lane);
    Map ex = shfl_down(m, 1);  // the lanes right of this one
    if (lane == 31) ex = {1.f, 0.f};
    if (lane == 0) sW[warp] = m;
    __syncthreads();
    // The warps right of this one, then on through the rest: every thread
    // composes the same sequence, so all hold the same chunk aggregate.
    Map w = {1.f, 0.f};
#pragma unroll
    for (int v = NW - 1; v > warp; --v) w = compose(sW[v], w);
    Map agg = w;
    for (int v = warp; v >= 0; --v) agg = compose(sW[v], agg);

    if (p.tiles > 1) {  // one chunk a tile: publish, then look right
      const size_t first = (size_t)row * p.tiles;
      if (tid == 0 && tile > 0) {
        __stcg(p.agg + first + tile, make_float2(agg.A, agg.B));
        __threadfence();
        st_relaxed(p.flags + first + tile, p.epoch);
      }
      if (warp == 0 && tile + 1 < p.tiles) {
        const float x = look_right(p, first, tile, lane);
        if (lane == 0) sX = x;
      }
      __syncthreads();
      if (tile + 1 < p.tiles) carry = sX;
    }

    float x = ex.A * (w.A * carry + w.B) + ex.B;  // x just right of this thread's run
    float xv[E];
#pragma unroll
    for (int i = E - 1; i >= 0; --i) {
      x = av[i] * x + bv[i];
      xv[i] = x;
    }
    io.store(cur, xv, rbase, t0, T, vec);
    carry = agg.A * carry + agg.B;
    if (c > 0) {
      cur = nxt;
      __syncthreads();  // sW is written again by the next chunk
    }
  }
}

__global__ void __launch_bounds__(NT) gae_scan_kernel(ScanIO io, Plan p) { scan_rows(io, p); }

__global__ void __launch_bounds__(NT) packed_gae_kernel(PackedIO io, Plan p) {
  scan_rows(io, p);
}

// cudaErrorInvalidValue unless the plan tiles every row exactly once.
int check_plan(int R, int T, int tile, int tiles) {
  if (tile <= 0 || tile % CHUNK || tiles <= 0 || (tiles > 1 && tile != CHUNK) ||
      (long long)tile * (tiles - 1) >= T || (long long)tile * tiles < T ||
      (long long)R * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

Plan make_plan(int T, int tile, int tiles, void* agg, void* flags, void* ticket,
               unsigned epoch) {
  return Plan{T, tile, tiles, static_cast<float2*>(agg), static_cast<unsigned*>(flags),
              static_cast<unsigned*>(ticket), epoch};
}

}  // namespace

// tile, tiles: ops/gae.gae_plan; agg [R * tiles] float2, flags [R * tiles]
// and ticket (one word, 0 before the first launch) are scratch the wrapper
// keeps per device and stream; epoch changes every launch and is never 0.
extern "C" int gae_scan_f32(const float* a, const float* b, float* x, int R, int T, int tile,
                            int tiles, void* agg, void* flags, void* ticket, unsigned epoch,
                            void* stream) {
  if (R <= 0 || T <= 0) return 0;
  if (int rc = check_plan(R, T, tile, tiles)) return rc;
  gae_scan_kernel<<<R * tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      ScanIO{a, b, x}, make_plan(T, tile, tiles, agg, flags, ticket, epoch));
  return (int)cudaGetLastError();
}

extern "C" int packed_gae_f32(const float* rewards, const float* values, const int* seg,
                              const float* bootstrap, float* adv, float* ret, float gamma,
                              float gamma_lam, int R, int T, int tile, int tiles, void* agg,
                              void* flags, void* ticket, unsigned epoch, void* stream) {
  if (R <= 0 || T <= 0) return 0;
  if (int rc = check_plan(R, T, tile, tiles)) return rc;
  packed_gae_kernel<<<R * tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      PackedIO{rewards, values, seg, bootstrap, adv, ret, gamma, gamma_lam},
      make_plan(T, tile, tiles, agg, flags, ticket, epoch));
  return (int)cudaGetLastError();
}
