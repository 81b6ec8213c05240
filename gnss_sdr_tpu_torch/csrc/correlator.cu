// One-period multi-tap correlator (K3): carrier wipeoff, soft-interpolated
// code replica and T tap dot products for C channels, with no loop closure,
// a thread-block cluster of R CTAs per channel.
//
// Replaces the TPU kernel gnss_sdr_tpu/ops/correlator.py, make_correlator
// (pallas_call at :191). It computes the same function, with the replica
// in the same three-chip ramp form (cm/c0/cp, correlator.py:114-146), not
// the same way: no [rows, 128] sample layout, no (row, lane) decomposition
// of the code lookup into Q row-broadcast gathers.
//
// What bounds it on the H100: latency. One launch is one code period of
// C channels, about 2600 samples each: C x 2600 x 8 B of samples read
// once, and per sample one sincos plus T replica lookups and 2T products.
// At the eager engine's C = 8 that is ~170 KB, well under a microsecond at
// 3.35 TB/s; what a launch pays for is the start-up, the dependent loads
// (samples, chip table) and the reduction across the channel's threads.
//
// What the design does about it: grid R * C with a thread-block cluster of
// R CTAs per channel (cudaLaunchKernelEx), R from
// ops/track_kernel_blocked.py::cluster_shape (8 at C <= 16, 1 at C >= 67 on
// 132 SMs), so that a few channels still spread over most SMs. CTA r takes
// the contiguous, copy-aligned slice [r * S, min((r + 1) * S, N)) of the
// period. Before its first barrier every thread issues its sample loads as
// 16-byte float4 pairs (two samples each; float2 where the row is not
// 16-byte aligned), then its float4 of the channel's 128-padded chip table
// (two with the data prompt), so the table staging overlaps the samples'
// latency. The per-sample step is csrc/track_loop.cuh's: the reduced-range
// __sincosf, the comparison code wrap, and the ramp weights multiplied by
// one reciprocal code step. Each warp shuffles its 2T (+2) sums into shared
// memory; one cluster barrier; rank 0's first warp adds the R x 8 warp
// partials over distributed shared memory in rank order (the same bits on
// every run, no atomics) and stores the 128-lane row as float4s; a closing
// cluster barrier keeps every CTA resident until rank 0 has read it.

#include "track_loop.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PAIRS = 4;   // sample pairs a thread has in flight at a time

struct Offsets {
  float v[MAX_TAPS];
};

// the three-chip soft replica at one tap phase: each chip transition ramps
// linearly over one sample (width = the code step in chips, applied as its
// reciprocal inv_step)
template <bool INTERP>
__device__ __forceinline__ float replica3(const float* code, int len,
                                          float tap_ph, float inv_step) {
  const float fl = floorf(tap_ph);
  const int m = wrap_index((int)fl, len);
  const float c0 = code[m];
  if (!INTERP) return c0;
  const float cm = code[m == 0 ? len - 1 : m - 1];
  const float cp = code[m == len - 1 ? 0 : m + 1];
  const float frac = tap_ph - fl;
  const float ramp_in = fminf(fmaxf(frac * inv_step + 0.5f, 0.0f), 1.0f);
  const float ramp_out =
      fminf(fmaxf((frac - 1.0f) * inv_step + 0.5f, 0.0f), 1.0f);
  return cm + (c0 - cm) * ramp_in + (cp - c0) * ramp_out;
}

// samples 2j and 2j + 1 of a slice of `len` samples at xs (zeros past it):
// one float4 where xs is 16-byte aligned, else two float2
__device__ __forceinline__ float4 load_pair(const float2* __restrict__ xs,
                                            int len, int j, bool vec) {
  const int i = 2 * j;
  if (i + 1 < len) {
    if (vec) return reinterpret_cast<const float4*>(xs)[j];
    const float2 a = xs[i], b = xs[i + 1];
    return make_float4(a.x, a.y, b.x, b.y);
  }
  if (i < len) {
    const float2 a = xs[i];
    return make_float4(a.x, a.y, 0.0f, 0.0f);
  }
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// the per-channel NCO scalars of one launch
struct Nco {
  float rem, step, inv_step, ph0, dstep, n_valid;
};

// sample k's contribution to the NS sums (masked past n_valid)
template <int T, bool INTERP, bool PILOT>
__device__ __forceinline__ void accumulate(float xr, float xi, int k,
                                           const float* code,
                                           const float* dcode, int len,
                                           const Offsets& offs, const Nco& q,
                                           float* acc) {
  const float kf = (float)k;
  if (!(kf < q.n_valid)) return;
  float sw, cw;
  // phase ramps as single-rounded multiply-adds, as the plain version
  sincos_reduced(fmaf(q.dstep, kf, q.ph0), &sw, &cw);
  const float wr = xr * cw + xi * sw;
  const float wi = xi * cw - xr * sw;
  const float cph = fmaf(q.step, kf, q.rem);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float r = replica3<INTERP>(code, len, cph + offs.v[t], q.inv_step);
    acc[2 * t] += wr * r;
    acc[2 * t + 1] += wi * r;
  }
  if (PILOT) {
    const float r =
        replica3<INTERP>(dcode, len, cph + offs.v[T / 2], q.inv_step);
    acc[2 * T] += wr * r;
    acc[2 * T + 1] += wi * r;
  }
}

template <int T, bool INTERP, bool PILOT>
__global__ void __launch_bounds__(THREADS)
correlator_kernel(const float2* __restrict__ x, int n,
                  const float* __restrict__ codes,
                  const float* __restrict__ dcodes, int lpad, int code_len,
                  const float* __restrict__ scalars, float* __restrict__ out,
                  const Offsets offs, int ranks, int width) {
  namespace cg = cooperative_groups;
  constexpr int NS = 2 * T + (PILOT ? 2 : 0);
  // [lpad] chips (+ [lpad] data chips)
  extern __shared__ float4 s_code4[];
  __shared__ float s_part[WARPS][NS];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / ranks;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lo = rank * width;
  const int len = min(max(n - lo, 0), width);
  const float2* xs = x + (size_t)c * n + lo;
  const bool vec = (reinterpret_cast<uintptr_t>(xs) & 15) == 0;
  const int npairs = (len + 1) / 2;

  // this thread's first samples, then its share of the tables
  float4 v[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
    v[p] = load_pair(xs, len, tid + p * THREADS, vec);
  const float* sc = scalars + (size_t)c * 8;
  Nco q;
  q.rem = sc[0];
  q.step = sc[1];
  q.ph0 = sc[2];
  q.dstep = sc[3];
  q.n_valid = sc[4];
  const int q4 = lpad / 4;
  const float4* cg4 =
      reinterpret_cast<const float4*>(codes + (size_t)c * lpad);
  const float4* dg4 =
      reinterpret_cast<const float4*>(dcodes + (size_t)c * lpad);
  for (int i = tid; i < q4; i += THREADS) {
    s_code4[i] = cg4[i];
    if (PILOT) s_code4[q4 + i] = dg4[i];
  }
  q.inv_step = __frcp_rn(q.step);
  float acc[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) acc[j] = 0.0f;
  __syncthreads();

  const float* code = reinterpret_cast<const float*>(s_code4);
  const float* dcode = code + lpad;
  for (int base = 0; base < npairs; base += PAIRS * THREADS) {
    if (base > 0) {
#pragma unroll
      for (int p = 0; p < PAIRS; ++p)
        v[p] = load_pair(xs, len, base + tid + p * THREADS, vec);
    }
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int i = 2 * (base + tid + p * THREADS);
      if (i < len)
        accumulate<T, INTERP, PILOT>(v[p].x, v[p].y, lo + i, code, dcode,
                                     code_len, offs, q, acc);
      if (i + 1 < len)
        accumulate<T, INTERP, PILOT>(v[p].z, v[p].w, lo + i + 1, code,
                                     dcode, code_len, offs, q, acc);
    }
  }

#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float a = acc[j];
    for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
    if (lane == 0) s_part[warp][j] = a;
  }
  cluster.sync();

  if (rank == 0 && warp == 0) {
    // lane j < NS adds sum j over the ranks, then the warps, in order
    float a = 0.0f;
    if (lane < NS) {
      for (int r = 0; r < ranks; ++r) {
        const float* part = cluster.map_shared_rank(&s_part[0][0], r);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) a += part[w * NS + lane];
      }
    }
    // lane l stores row lanes 4l .. 4l + 3 (zeros from NS on)
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float b = __shfl_sync(0xffffffffu, a, (4 * lane + k) & 31);
      e[k] = 4 * lane + k < NS ? b : 0.0f;
    }
    reinterpret_cast<float4*>(out + (size_t)c * LANES)[lane] =
        make_float4(e[0], e[1], e[2], e[3]);
  }
  // no CTA leaves while rank 0 may still read its partials
  cluster.sync();
}

template <int T, bool INTERP, bool PILOT>
cudaError_t launch(const float2* x, int n, const float* codes,
                   const float* dcodes, int lpad, int code_len,
                   const float* scalars, float* out, int c,
                   const Offsets& offs, int ranks, int width,
                   cudaStream_t stream) {
  auto* kernel = correlator_kernel<T, INTERP, PILOT>;
  const size_t smem = (size_t)lpad * sizeof(float) * (PILOT ? 2 : 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * ranks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, n, codes, dcodes, lpad,
                                     code_len, scalars, out, offs, ranks,
                                     width);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int T>
cudaError_t dispatch(int interp, int pilot, const float2* x, int n,
                     const float* codes, const float* dcodes, int lpad,
                     int code_len, const float* scalars, float* out, int c,
                     const Offsets& offs, int ranks, int width,
                     cudaStream_t s) {
  if (interp && pilot)
    return launch<T, true, true>(x, n, codes, dcodes, lpad, code_len, scalars,
                                 out, c, offs, ranks, width, s);
  if (interp)
    return launch<T, true, false>(x, n, codes, dcodes, lpad, code_len,
                                  scalars, out, c, offs, ranks, width, s);
  if (pilot)
    return launch<T, false, true>(x, n, codes, dcodes, lpad, code_len,
                                  scalars, out, c, offs, ranks, width, s);
  return launch<T, false, false>(x, n, codes, dcodes, lpad, code_len, scalars,
                                 out, c, offs, ranks, width, s);
}

}  // namespace

// x: float2 [C, n]; codes/dcodes: f32 [C, lpad] (chips in [0, code_len),
// lpad a multiple of 4, rows 16-byte aligned); scalars: f32 [C, 8] = rem,
// code step, phase0, phase step, n_valid; out: f32 [C, 1, 128]; offsets:
// host f32 [num_taps]; ranks CTAs per channel (a power of two <= 8) each
// covering `width` samples (even, ranks * width >= n).
extern "C" int gnss_correlator(const void* x, int n, const void* codes,
                               const void* dcodes, int lpad, int code_len,
                               const void* scalars, void* out, int c,
                               const void* offsets, int num_taps,
                               int interp_code, int track_pilot, int ranks,
                               int width, void* stream) {
  if (n <= 0 || code_len <= 0 || code_len > lpad || lpad % 4 != 0
      || !valid_cluster_shape(c, ranks, width, n))
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  const float* ho = static_cast<const float*>(offsets);
  for (int t = 0; t < MAX_TAPS; ++t) offs.v[t] = t < num_taps ? ho[t] : 0.0f;
  const float2* xp = static_cast<const float2*>(x);
  const float* cp = static_cast<const float*>(codes);
  const float* dp = static_cast<const float*>(dcodes);
  const float* sp = static_cast<const float*>(scalars);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_taps == 3)
    return (int)dispatch<3>(interp_code, track_pilot, xp, n, cp, dp, lpad,
                            code_len, sp, op, c, offs, ranks, width, s);
  if (num_taps == 5)
    return (int)dispatch<5>(interp_code, track_pilot, xp, n, cp, dp, lpad,
                            code_len, sp, op, c, offs, ranks, width, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* gnss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
