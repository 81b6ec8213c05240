// Primitive-cost probe (P1): eleven kernel bodies, each inside a K-period
// loop, whose marginal cost per period over the baseline calibrates the
// design of the fused trackers on this card.
//
// Replaces the TPU microbenchmarks of tools/mosaic_probe.py (pcall at :50,
// the kernels of :64-189). Each variant computes the same function on the
// same shapes: a (BR = 704, 128) float32 tile, C = 32 channels of
// ROWS_P = 22 rows, x = (4096, 128) float32 in device memory:
//   0 baseline     v = src + acc
//   1 gather1      one per-lane gather along the 128 lanes
//   2 gather3      three gathers at idx, idx+1, idx+2 (clipped)
//   3 qloop8       the TPU's 8-pass q-row select; its index r stays below
//                  128 and exactly one pass matches, so on this card it is
//                  the one gather it computes
//   4 sincos       cos(v) + sin(v)
//   5 vec20        20 x (v * 1.000001 + 1e-8)
//   6 matreduce    the (32, 704) @ (704, 128) selection product, i.e. each
//                  channel's column sums over its 22 rows
//   7 lanereduce8  8 lane reductions of each row, scaled by 1..8
//   8 staging      2 x C copies of 22 rows from row 100 into shared memory
//   9 narrow       150 multiply-adds on a (32, 1) vector
//  10 out store    rows x[0:32] + acc into a (32, 200, 128) buffer
//
// The shape of the TPU harness changes in one way: the (704, 128) tile is
// 360 KB, more than one CTA's shared memory (227 KB), so each channel is one
// CTA that holds its 22 x 128 slice (11 KB) in shared memory and consumes
// sum(v) with a block-wide sum. The accumulator acc = acc + sum(v) * 1e-20
// + 1 is therefore per channel, where the TPU's scalar acc couples all 704
// rows. Besides the (8, 128) output (channel 0's acc, ~K for every
// variant), each channel writes its float32 sum(v) at the first and the last
// period to sums[c][0..1], which the plain versions compute too
// (gnss_sdr_tpu_torch/tools/mosaic_probe.py). Built with -fmad=false, so the
// multiply-add chains round as their plain versions do.
//
// What bounds it on the H100: latency and issue, not bytes. The loop is
// sequential over K = 2000 periods with one block-wide sum (one barrier,
// double-buffered partials) per period; each period touches 11 KB of shared
// memory per CTA, and 32 CTAs occupy 32 of 132 SMs, as 32 channels would.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int C = 32;
constexpr int ROWS_P = 22;
constexpr int LANES = 128;
constexpr int TILE = ROWS_P * LANES;      // one channel's slice
constexpr int THREADS = 128;              // one thread per lane
constexpr int WARPS = THREADS / 32;
constexpr int OUT_ROWS = 200;

enum Variant {
  BASELINE = 0, GATHER1, GATHER3, QLOOP8, SINCOS, VEC20, MATREDUCE,
  LANEREDUCE8, STAGING, NARROW, OUTSTORE, NUM_VARIANTS
};

// per-lane index in [0, 128) (mosaic_probe.py:85-91)
__device__ __forceinline__ float lane_idx(int lane, int i) {
  const float base = (float)lane * 0.97f;
  float idxf = base + 1.0f * (float)(i % 31);
  return idxf - 128.0f * floorf(idxf * (1.0f / 128.0f));
}

// sum over the block, the same value in every thread; `red` alternates
// between two buffers from one period to the next, so one barrier a period
// suffices
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return (red[0] + red[1]) + (red[2] + red[3]);
}

// this thread's share of sum(v) for variant V at period i
template <int V>
__device__ __forceinline__ float body(int i, float acc, const float* s,
                                      int tid) {
  float part = 0.0f;
  if (V == BASELINE) {
#pragma unroll
    for (int r = 0; r < ROWS_P; ++r) part += s[r * LANES + tid] + acc;
  } else if (V == GATHER1) {
    const int idx = (int)lane_idx(tid, i);
#pragma unroll
    for (int r = 0; r < ROWS_P; ++r) part += s[r * LANES + idx] + acc;
  } else if (V == GATHER3) {
    const int i0 = (int)lane_idx(tid, i);
    const int i1 = min(i0 + 1, LANES - 1), i2 = min(i0 + 2, LANES - 1);
#pragma unroll
    for (int r = 0; r < ROWS_P; ++r) {
      const float* row = s + r * LANES;
      part += ((row[i0] + acc) + (row[i1] + acc)) + (row[i2] + acc);
    }
  } else if (V == QLOOP8) {
    const float idxf = lane_idx(tid, i) * 8.0f;          // 0..1023
    const float q = floorf(idxf * (1.0f / 128.0f));
    const int rr = (int)(idxf - q * 128.0f);
#pragma unroll
    for (int r = 0; r < ROWS_P; ++r) part += s[r * LANES + rr] + acc;
  } else if (V == SINCOS) {
#pragma unroll
    for (int r = 0; r < ROWS_P; ++r) {
      float sn, cs;
      sincosf(s[r * LANES + tid] + acc, &sn, &cs);
      part += cs + sn;
    }
  } else if (V == VEC20) {
#pragma unroll
    for (int r = 0; r < ROWS_P; ++r) {
      float v = s[r * LANES + tid] + acc;
#pragma unroll
      for (int j = 0; j < 20; ++j) v = v * 1.000001f + 1e-8f;
      part += v;
    }
  } else if (V == MATREDUCE) {
    // v[c, lane] = sum over the channel's rows
#pragma unroll
    for (int r = 0; r < ROWS_P; ++r) part += s[r * LANES + tid] + acc;
  } else if (V == LANEREDUCE8) {
    // warp w reduces rows w, w + 4, ...; lane 0 collects v[row, 0..7]
    const int warp = tid >> 5, ln = tid & 31;
    for (int r = warp; r < ROWS_P; r += WARPS) {
      const float* row = s + r * LANES;
      const float a0 = row[ln] + acc, a1 = row[ln + 32] + acc;
      const float a2 = row[ln + 64] + acc, a3 = row[ln + 96] + acc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = 1.0f + (float)j;
        float q = ((a0 * f + a1 * f) + a2 * f) + a3 * f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          q += __shfl_xor_sync(0xffffffffu, q, o);
        if (ln == 0) part += q;
      }
    }
  }
  return part;
}

__device__ __forceinline__ void record(float* sums, int c, int i, int K,
                                       float total) {
  if (threadIdx.x != 0) return;
  if (i == 0) sums[2 * c] = total;
  if (i == K - 1) sums[2 * c + 1] = total;
}

// variants 0-7: the preloaded slice, v per period, consumed by a block sum
// (mosaic_probe.py:64-78)
template <int V>
__global__ void __launch_bounds__(THREADS)
probe_variant(const float* __restrict__ x, float* __restrict__ out,
              float* __restrict__ sums, int K) {
  __shared__ float s_src[TILE];
  __shared__ float s_red[2][WARPS];
  const int c = blockIdx.x, tid = threadIdx.x;
  for (int j = tid; j < TILE; j += THREADS)
    s_src[j] = x[(size_t)c * TILE + j];
  __syncthreads();
  float acc = 0.0f;
  for (int i = 0; i < K; ++i) {
    const float total = block_sum(body<V>(i, acc, s_src, tid), s_red[i & 1]);
    record(sums, c, i, K, total);
    acc = acc + total * 1e-20f + 1.0f;
  }
  if (c == 0)
    for (int j = tid; j < 8 * LANES; j += THREADS) out[j] = acc;
}

// variant 8 (mosaic_probe.py:149-166): each period copies rows
// [r0, r0 + 22) and [r0 + 1, r0 + 23) of x into shared memory, r0 from the
// accumulator (100), and consumes the first copy
__global__ void __launch_bounds__(THREADS)
probe_staging(const float* __restrict__ x, float* __restrict__ out,
              float* __restrict__ sums, int K) {
  __shared__ float s_a[TILE], s_b[TILE];
  __shared__ float s_red[2][WARPS];
  const int c = blockIdx.x, tid = threadIdx.x;
  float acc = 0.0f;
  for (int i = 0; i < K; ++i) {
    const int r0 = (int)(100.0f + acc * 1e-20f);
    for (int j = tid; j < TILE; j += THREADS) {
      s_a[j] = x[(size_t)r0 * LANES + j];
      s_b[j] = x[(size_t)(r0 + 1) * LANES + j];
    }
    float part = 0.0f;
    for (int j = tid; j < TILE; j += THREADS) part += s_a[j];
    const float total = block_sum(part, s_red[i & 1]);
    record(sums, c, i, K, total);
    acc = acc + total * 1e-20f + 1.0f;
  }
  if (c == 0)
    for (int j = tid; j < 8 * LANES; j += THREADS) out[j] = acc + s_b[j];
}

// variant 9 (mosaic_probe.py:169-178): one warp, lane c carries x[c, 0]
// through 150 multiply-adds a period; sums[c] holds v after the first and
// the last period
__global__ void __launch_bounds__(32)
probe_narrow(const float* __restrict__ x, float* __restrict__ out,
             float* __restrict__ sums, int K) {
  const int c = threadIdx.x;
  float v = x[(size_t)c * LANES];
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < 150; ++j) v = v * 1.000001f + 1e-8f;
    if (i == 0) sums[2 * c] = v;
    if (i == K - 1) sums[2 * c + 1] = v;
  }
  if (c < 8)
    for (int l = 0; l < LANES; ++l) out[c * LANES + l] = v * 1.0f;
}

// variant 10 (mosaic_probe.py:181-189): row c of x plus the accumulator
// into big[c, i % 200, :] every period; sums[c] holds the row's sum at the
// first and the last period
__global__ void __launch_bounds__(THREADS)
probe_outstore(const float* __restrict__ x, float* __restrict__ out,
               float* __restrict__ sums, float* __restrict__ big, int K) {
  __shared__ float s_red[2][WARPS];
  const int c = blockIdx.x, tid = threadIdx.x;
  const float xv = x[(size_t)c * LANES + tid];
  float acc = 0.0f;
  for (int i = 0; i < K; ++i) {
    const float row = xv + acc;
    big[((size_t)c * OUT_ROWS + i % OUT_ROWS) * LANES + tid] = row;
    if (i == 0 || i == K - 1)
      record(sums, c, i, K, block_sum(row, s_red[i & 1]));
    acc = acc + 1.0f;
  }
  if (c == 0)
    for (int r = 0; r < 8; ++r)
      out[r * LANES + tid] = acc + big[(size_t)r * LANES + tid];
}

}  // namespace

// x: f32 [4096, 128]; out: f32 [8, 128]; sums: f32 [32, 2]; big: f32
// [32, 200, 128] (variant 10 only, else may be null); K >= 1.
extern "C" int gnss_probe(int variant, const void* x_, void* out_,
                          void* sums_, void* big_, int K, void* stream) {
  if (K < 1 || variant < 0 || variant >= NUM_VARIANTS)
    return (int)cudaErrorInvalidValue;
  if (variant == OUTSTORE && big_ == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(x_);
  float* out = static_cast<float*>(out_);
  float* sums = static_cast<float*>(sums_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case BASELINE: probe_variant<BASELINE><<<C, THREADS, 0, s>>>(x, out, sums, K); break;
    case GATHER1: probe_variant<GATHER1><<<C, THREADS, 0, s>>>(x, out, sums, K); break;
    case GATHER3: probe_variant<GATHER3><<<C, THREADS, 0, s>>>(x, out, sums, K); break;
    case QLOOP8: probe_variant<QLOOP8><<<C, THREADS, 0, s>>>(x, out, sums, K); break;
    case SINCOS: probe_variant<SINCOS><<<C, THREADS, 0, s>>>(x, out, sums, K); break;
    case VEC20: probe_variant<VEC20><<<C, THREADS, 0, s>>>(x, out, sums, K); break;
    case MATREDUCE: probe_variant<MATREDUCE><<<C, THREADS, 0, s>>>(x, out, sums, K); break;
    case LANEREDUCE8: probe_variant<LANEREDUCE8><<<C, THREADS, 0, s>>>(x, out, sums, K); break;
    case STAGING: probe_staging<<<C, THREADS, 0, s>>>(x, out, sums, K); break;
    case NARROW: probe_narrow<<<1, 32, 0, s>>>(x, out, sums, K); break;
    case OUTSTORE:
      probe_outstore<<<C, THREADS, 0, s>>>(x, out, sums,
                                           static_cast<float*>(big_), K);
      break;
  }
  return (int)cudaGetLastError();
}
