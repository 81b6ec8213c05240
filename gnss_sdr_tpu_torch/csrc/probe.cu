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
//   4 sincos       cos(v) + sin(v), by the trackers' sincos_reduced
//   5 vec20        20 x (v * 1.000001 + 1e-8)
//   6 matreduce    the (32, 704) @ (704, 128) selection product, i.e. each
//                  channel's column sums over its 22 rows
//   7 lanereduce8  8 lane reductions of each row, scaled by 1..8
//   8 staging      2 x C copies of 22 rows from row 100 into shared memory
//   9 narrow       150 multiply-adds on a (32, 1) vector
//  10 out store    rows x[0:32] + acc into a (32, 200, 128) buffer
//
// The mapping is the trackers' (csrc/track_loop.cuh::cluster_track_kernel):
// one channel is a thread-block cluster of R CTAs of eight warps (R from
// ops/track_kernel_blocked.py::cluster_shape, 4 at C = 32 on 132 SMs; R = 1
// is one CTA with a CTA barrier). Each CTA stages the channel's whole
// 22 x 128 slice (11 KB) once, so that a gather may read any lane of a row,
// and computes its 1/R share of the 2816 elements every period: thread t
// of rank q takes lane t % 128 of rows g, g + 2R, g + 4R, ... with
// g = 2q + t / 128, into two independent partials. A period's total is
// consumed as the trackers consume their taps: warp partials into a slot
// chosen by the period's parity, one cluster barrier, then every warp reads
// the R x 8 partials over distributed shared memory (lane j adds partials
// j and j + 32, partial p being rank p / 8's warp p % 8) and adds them by
// one fixed shuffle tree, so every CTA
// gets the same bits of the total and hence of acc; rank 0 records the
// sums; a last cluster barrier before exit. The accumulator acc = acc +
// sum(v) * 1e-20 + 1 is per channel, where the TPU's scalar acc couples all
// 704 rows (the 360 KB tile does not fit one CTA). Besides the (8, 128)
// output (channel 0's acc, ~K for every variant), each channel writes its
// float32 sum(v) at the first and the last period to sums[c][0..1], which
// the plain versions compute too (gnss_sdr_tpu_torch/tools/mosaic_probe.py).
// Built with -fmad=false, so the multiply-add chains round as their plain
// versions do; the only fmaf is sincos_reduced's range reduction.
//
// What bounds it on the H100: the loop-carried chain, not bytes or
// operations. Period i + 1 needs acc, hence the whole cluster's total of
// period i, so each period costs the body's dependent operations, the
// two shuffle trees, one cluster barrier and one DSMEM read. The rows of
// a period are independent, which the 8R warps per channel and the two
// partials per thread hide. staging's row r0 = int(100 + acc * 1e-20) also
// depends on the previous period's acc, so its copies cannot run a period
// ahead: each period waits for its own copy.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_util.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int C = 32;
constexpr int ROWS_P = 22;
constexpr int LANES = 128;
constexpr int TILE = ROWS_P * LANES;      // one channel's slice
constexpr int THREADS = 256;              // eight warps, as the trackers'
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

// sum over the warp by a butterfly: every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int cta_rank() {
  return (int)cg::this_cluster().block_rank();
}

// The channel's total of this period from each thread's partial, the same
// bits in every thread of the R CTAs: warp sums into `slot` (this period's
// parity slot), one barrier (the cluster's, or the CTA's at R = 1), then
// lane j of every warp adds partials j, j + 32, ... in that order (partial
// p is rank p / 8's warp p % 8; R x 8 = 64 of them at R = 8) and the warp
// adds the lanes' sums by the butterfly.
template <int R>
__device__ __forceinline__ float consume(float part, float* slot) {
  constexpr int N = R * WARPS;
  part = warp_sum(part);
  const int lane = threadIdx.x & 31;
  if (lane == 0) slot[threadIdx.x >> 5] = part;
  float v = 0.0f;
  if constexpr (R == 1) {
    __syncthreads();
    if (lane < WARPS) v = slot[lane];
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
#pragma unroll
    for (int m = 0; m < (N + 31) / 32; ++m) {
      const int p = lane + 32 * m;
      if (p < N) v += cluster.map_shared_rank(slot, p / WARPS)[p % WARPS];
    }
  }
  return warp_sum(v);
}

// no CTA of the cluster leaves while another may still read its partials
template <int R>
__device__ __forceinline__ void cluster_exit() {
  if constexpr (R > 1) cg::this_cluster().sync();
}

__device__ __forceinline__ void record(float* sums, int c, int i, int K,
                                       float total) {
  if (threadIdx.x != 0) return;
  if (i == 0) sums[2 * c] = total;
  if (i == K - 1) sums[2 * c + 1] = total;
}

// this thread's share of sum(v) for variants 0-6 at period i: lane l of
// rows g, g + 2R, ... (for matreduce a partial column sum of lane l). The
// rows are unrolled without a branch (a row past the slice reads the last
// row and adds 0), so that their chains overlap.
template <int V, int R>
__device__ __forceinline__ float body(int i, float acc, const float* s, int l,
                                      int g) {
  constexpr int NK = (ROWS_P + 2 * R - 1) / (2 * R);
  int c0 = l, c1 = l, c2 = l;                // the lanes read in each row
  if (V == GATHER1 || V == GATHER3) c0 = (int)lane_idx(l, i);
  if (V == GATHER3) {
    c1 = min(c0 + 1, LANES - 1);
    c2 = min(c0 + 2, LANES - 1);
  }
  if (V == QLOOP8) {
    const float idxf = lane_idx(l, i) * 8.0f;           // 0..1023
    const float q = floorf(idxf * (1.0f / 128.0f));
    c0 = (int)(idxf - q * 128.0f);
  }
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int r = g + 2 * R * k;
    const float* row = s + min(r, ROWS_P - 1) * LANES;
    float v;
    if (V == GATHER3) {
      v = ((row[c0] + acc) + (row[c1] + acc)) + (row[c2] + acc);
    } else if (V == SINCOS) {
      float sn, cs;
      sincos_reduced(row[l] + acc, &sn, &cs);
      v = cs + sn;
    } else if (V == VEC20) {
      v = row[l] + acc;
#pragma unroll
      for (int j = 0; j < 20; ++j) v = v * 1.000001f + 1e-8f;
    } else {                                  // baseline, gathers, matreduce
      v = row[c0] + acc;
    }
    v = r < ROWS_P ? v : 0.0f;
    if (k & 1) p1 += v; else p0 += v;
  }
  return p0 + p1;
}

// this warp's share of variant 7: warp gw of the cluster's 8R takes rows
// gw, gw + 8R, ... (unrolled as in body); each lane holds four lanes of the
// row, and the eight scaled sums go through one shuffle tree together;
// lane 0 keeps them
template <int R>
__device__ __forceinline__ float lanereduce8(float acc, const float* s,
                                             int gw) {
  constexpr int NK = (ROWS_P + R * WARPS - 1) / (R * WARPS);
  const int ln = threadIdx.x & 31;
  float part = 0.0f;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int r = gw + R * WARPS * k;
    const float* row = s + min(r, ROWS_P - 1) * LANES;
    const float a0 = row[ln] + acc, a1 = row[ln + 32] + acc;
    const float a2 = row[ln + 64] + acc, a3 = row[ln + 96] + acc;
    float q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = 1.0f + (float)j;
      q[j] = ((a0 * f + a1 * f) + a2 * f) + a3 * f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] += __shfl_xor_sync(0xffffffffu, q[j], o);
    }
    const float v =
        ((q[0] + q[1]) + (q[2] + q[3])) + ((q[4] + q[5]) + (q[6] + q[7]));
    if (ln == 0 && r < ROWS_P) part += v;
  }
  return part;
}

// variants 0-7: the staged slice, v per period, consumed by the cluster
// (mosaic_probe.py:64-78)
template <int V, int R>
__global__ void __launch_bounds__(THREADS)
probe_variant(const float* __restrict__ x, float* __restrict__ out,
              float* __restrict__ sums, int K) {
  __shared__ __align__(16) float s_src[TILE];
  __shared__ float s_part[2][WARPS];
  const int q = R == 1 ? 0 : cta_rank();
  const int c = blockIdx.x / R, tid = threadIdx.x;
  const float4* src4 = reinterpret_cast<const float4*>(x + (size_t)c * TILE);
  float4* s4 = reinterpret_cast<float4*>(s_src);
  for (int j = tid; j < TILE / 4; j += THREADS) s4[j] = src4[j];
  __syncthreads();
  const int l = tid % LANES, g = 2 * q + tid / LANES;
  const int gw = q * WARPS + (tid >> 5);
  float acc = 0.0f;
  for (int i = 0; i < K; ++i) {
    float part;
    if constexpr (V == LANEREDUCE8) part = lanereduce8<R>(acc, s_src, gw);
    else part = body<V, R>(i, acc, s_src, l, g);
    const float total = consume<R>(part, s_part[i & 1]);
    if (q == 0) record(sums, c, i, K, total);
    acc = acc + total * 1e-20f + 1.0f;
  }
  cluster_exit<R>();
  if (c == 0 && q == 0)
    for (int j = tid; j < 8 * LANES; j += THREADS) out[j] = acc;
}

// variant 8 (mosaic_probe.py:149-166): each period copies rows
// [r0, r0 + 22) and [r0 + 1, r0 + 23) of x into shared memory, r0 from the
// accumulator (100), and consumes the first copy. CTA q copies and sums its
// share, elements [q S, (q + 1) S) of each block, S = 2816 / R: one thread
// issues two cp.async.bulk copies (11264 / R bytes each, 16-byte aligned at
// r0 * 512 + q * S * 4) on one mbarrier and every thread waits on it. (The
// threads' own float4 copy with a CTA barrier was slower at the rule's R;
// PERF.md keeps both times.) The next period's copy is issued after the
// consume's barrier, when no thread reads s_a any more. Rank 0 of channel 0
// reads the second copy's first 8 rows over DSMEM for `out`.
template <int R>
__global__ void __launch_bounds__(THREADS)
probe_staging(const float* __restrict__ x, float* __restrict__ out,
              float* __restrict__ sums, int K) {
  constexpr int S = TILE / R;
  __shared__ __align__(16) float s_a[S];
  __shared__ __align__(16) float s_b[S];
  __shared__ float s_part[2][WARPS];
  __shared__ __align__(8) uint64_t full;
  const int q = R == 1 ? 0 : cta_rank();
  const int c = blockIdx.x / R, tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  float acc = 0.0f;
  for (int i = 0; i < K; ++i) {
    const int r0 = (int)(100.0f + acc * 1e-20f);
    const float* a = x + (size_t)r0 * LANES + q * S;
    if (tid == 0) {
      mbar_arrive_tx(&full, 2u * S * (uint32_t)sizeof(float));
      bulk_load(s_a, a, S * sizeof(float), &full);
      bulk_load(s_b, a + LANES, S * sizeof(float), &full);
    }
    mbar_wait(&full, i & 1);
    // elements tid, tid + 256, ... of the share, unrolled as in body
    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int m = 0; m < (S + THREADS - 1) / THREADS; ++m) {
      const int j = tid + THREADS * m;
      const float v = j < S ? s_a[min(j, S - 1)] : 0.0f;
      if (m & 1) p1 += v; else p0 += v;
    }
    const float total = consume<R>(p0 + p1, s_part[i & 1]);
    if (q == 0) record(sums, c, i, K, total);
    acc = acc + total * 1e-20f + 1.0f;
  }
  if (c == 0 && q == 0) {
    for (int j = tid; j < 8 * LANES; j += THREADS) {
      float b;
      if constexpr (R == 1) b = s_b[j];
      else b = cg::this_cluster().map_shared_rank(&s_b[0], j / S)[j % S];
      out[j] = acc + b;
    }
  }
  cluster_exit<R>();
}

// variant 9 (mosaic_probe.py:169-178): one warp, lane c carries x[c, 0]
// through 150 multiply-adds a period; sums[c] holds v after the first and
// the last period. The TPU's (32, 1) vector is one warp's lanes, so this
// body takes no cluster: it is its own chain of 300 dependent operations.
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
// into big[c, i % 200, :] every period, CTA q storing lanes [q W, (q + 1) W)
// with W = 128 / R; sums[c] holds the row's sum at the first and the last
// period (the only periods that consume, each in its own slot)
template <int R>
__global__ void __launch_bounds__(THREADS)
probe_outstore(const float* __restrict__ x, float* __restrict__ out,
               float* __restrict__ sums, float* __restrict__ big, int K) {
  constexpr int W = LANES / R;
  __shared__ float s_part[2][WARPS];
  const int q = R == 1 ? 0 : cta_rank();
  const int c = blockIdx.x / R, tid = threadIdx.x;
  const bool mine = tid < W;
  const int l = q * W + tid;
  const float xv = mine ? x[(size_t)c * LANES + l] : 0.0f;
  float acc = 0.0f;
  for (int i = 0; i < K; ++i) {
    const float row = xv + acc;
    if (mine) big[((size_t)c * OUT_ROWS + i % OUT_ROWS) * LANES + l] = row;
    if (i == 0 || i == K - 1) {
      const float total = consume<R>(mine ? row : 0.0f, s_part[i == 0 ? 0 : 1]);
      if (q == 0) record(sums, c, i, K, total);
    }
    acc = acc + 1.0f;
  }
  cluster_exit<R>();
  if (c == 0 && mine)
    for (int r = 0; r < 8; ++r)
      out[r * LANES + l] = acc + big[(size_t)r * LANES + l];
}

// grid C * R in clusters of R CTAs (a plain launch at R = 1)
template <typename... Exp, typename... Act>
cudaError_t launch(void (*kernel)(Exp...), int ranks, cudaStream_t s,
                   Act&&... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ranks);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
}

template <int R>
cudaError_t launch_variant(int variant, const float* x, float* out,
                           float* sums, float* big, int K, cudaStream_t s) {
  switch (variant) {
    case BASELINE: return launch(probe_variant<BASELINE, R>, R, s, x, out, sums, K);
    case GATHER1: return launch(probe_variant<GATHER1, R>, R, s, x, out, sums, K);
    case GATHER3: return launch(probe_variant<GATHER3, R>, R, s, x, out, sums, K);
    case QLOOP8: return launch(probe_variant<QLOOP8, R>, R, s, x, out, sums, K);
    case SINCOS: return launch(probe_variant<SINCOS, R>, R, s, x, out, sums, K);
    case VEC20: return launch(probe_variant<VEC20, R>, R, s, x, out, sums, K);
    case MATREDUCE: return launch(probe_variant<MATREDUCE, R>, R, s, x, out, sums, K);
    case LANEREDUCE8: return launch(probe_variant<LANEREDUCE8, R>, R, s, x, out, sums, K);
    case STAGING: return launch(probe_staging<R>, R, s, x, out, sums, K);
    case OUTSTORE: return launch(probe_outstore<R>, R, s, x, out, sums, big, K);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: f32 [4096, 128], 16-byte aligned; out: f32 [8, 128]; sums: f32
// [32, 2]; big: f32 [32, 200, 128] (variant 10 only, else may be null);
// K >= 1; ranks: CTAs per channel, a power of two <= 8 (narrow, one warp,
// ignores it).
extern "C" int gnss_probe(int variant, const void* x_, void* out_,
                          void* sums_, void* big_, int K, int ranks,
                          void* stream) {
  if (K < 1 || variant < 0 || variant >= NUM_VARIANTS || ranks < 1
      || ranks > 8 || (ranks & (ranks - 1)) != 0
      || (reinterpret_cast<uintptr_t>(x_) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (variant == OUTSTORE && big_ == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(x_);
  float* out = static_cast<float*>(out_);
  float* sums = static_cast<float*>(sums_);
  float* big = static_cast<float*>(big_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (variant == NARROW) {
    probe_narrow<<<1, 32, 0, s>>>(x, out, sums, K);
    e = cudaSuccess;
  } else if (ranks == 1) {
    e = launch_variant<1>(variant, x, out, sums, big, K, s);
  } else if (ranks == 2) {
    e = launch_variant<2>(variant, x, out, sums, big, K, s);
  } else if (ranks == 4) {
    e = launch_variant<4>(variant, x, out, sums, big, K, s);
  } else {
    e = launch_variant<8>(variant, x, out, sums, big, K, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
