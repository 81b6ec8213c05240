// Fused K-period GPS tracker (K1): closed-loop DLL/PLL/FLL tracking of C
// channels over K code periods in one launch, a thread-block cluster of R
// CTAs per channel.
//
// Replaces the TPU kernel gnss_sdr_tpu/ops/track_kernel_blocked.py,
// make_fused_tracker_blocked (pallas_call at :740). It computes what that
// kernel computes (:323-653), with the same scalar slots and output lanes
// (ops/slots.py), not how: no bit-packed shifted code tables, no channel
// padding, no selection matmuls, no double-buffered window DMA, no
// [rows, 128] sample layout, no polynomial atan/sincos.
//
// What bounds it on the H100: latency. The loop is sequential over periods
// (period i+1's NCO needs period i's correlations), and one period of one
// channel is only ~2600 samples: about 2600 x 8 B of window reads, which
// would take well under a microsecond at 3.35 TB/s. At the receiver's
// C = 8 one CTA per channel would leave 124 of 132 SMs idle, and each period
// pays for its samples' arithmetic, the tap reduction and a serial
// discriminator/loop-filter section.
//
// What the design does about it: grid R * C, launched with a cluster of R
// CTAs per channel (cudaLaunchKernelEx), R the largest power of two <= 8
// with R * C <= the card's SM count, 132 on an H100 SXM
// (ops/track_kernel_blocked.py::cluster_shape, which halves R while the occupancy query says the C clusters do not fit at
// once). CTA r takes samples [r * S, min((r + 1) * S, n)) of each period
// and stages its slice of the next period into a two-slot shared-memory
// ring exactly as K2 does (one producer warp, cp.async.bulk on an
// mbarrier; csrc/track_loop.cuh), while its 8 consumer warps run the
// staged per-sample step on the current one. Each consumer warp writes its
// tap partials into its CTA's shared memory, in a slot chosen by the
// period's parity; then one cluster barrier; then warp 0 of every CTA reads
// the R x 8 partials over distributed shared memory in rank order (so every
// CTA gets the same bits), runs the closure redundantly, and hands the next
// period's geometry to its CTA through one __syncthreads; rank 0 stores the
// row. One cluster barrier and one CTA barrier a period.

#include <cooperative_groups.h>

#include "track_loop.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NCW = 8;                    // consumer warps
constexpr int THREADS = (NCW + 1) * 32;   // + the producer warp

template <int T, bool INTERP>
__global__ void __launch_bounds__(THREADS)
track_blocked_kernel(const float2* __restrict__ window,
                     const float* __restrict__ codes,
                     const float* __restrict__ scalars,
                     const int* __restrict__ pos_in,
                     float* __restrict__ out, const Params P,
                     const RingShape R, int ranks) {
  // [2][slotw] ring slots, then [code_len] code table
  extern __shared__ float4 smem4[];
  float2* ring = reinterpret_cast<float2*>(smem4);
  float* s_code = reinterpret_cast<float*>(ring + 2 * R.slotw);
  __shared__ uint64_t full[2], empty[2];
  __shared__ float s_part[2][NCW][2 * T];
  __shared__ __align__(16) float s_row[LANES];
  __shared__ Geo s_geo;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / ranks;
  const int lo = rank * R.width;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < P.code_len; i += THREADS)
    s_code[i] = codes[(size_t)c * P.code_len + i];
  for (int i = tid; i < LANES; i += THREADS) s_row[i] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], NCW);
    }
    mbar_init_fence();
  }
  const bool en = scalars[(size_t)c * P.ns + S_EN] > 0.5f;

  // warp 0 carries the loop state
  State<T> st;
  if (warp == 0) {
    load_state<T>(st, scalars + (size_t)c * P.ns, pos_in[c], P);
    period_geometry(st, P);
    if (lane == 0) s_geo = geo_of(st, P);
  }
  __syncthreads();

  float offs[T];
#pragma unroll
  for (int t = 0; t < T; ++t) offs[t] = P.offs[t];

  int g_next = 0;
  for (int it = 0; it < P.n_periods; ++it) {
    const Geo g = s_geo;
    const int len = min(max(g.n - lo, 0), R.width);
    if (warp == NCW) {
      g_next = ring_produce_period(window, P.window_len, ring, full, empty,
                                   R, g_next, it, P.n_periods, lo, g.pos,
                                   en ? g.pos + g.n : g.pos, lane);
    } else {
      float acc_re[T], acc_im[T];
#pragma unroll
      for (int t = 0; t < T; ++t) acc_re[t] = acc_im[t] = 0.0f;
      ring_consume_period<T, INTERP>(window, ring, full, empty, R, s_code,
                                     P.code_len, offs, g, it, lo, len, tid,
                                     NCW * 32, lane, acc_re, acc_im);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        for (int o = 16; o > 0; o >>= 1) {
          acc_re[t] += __shfl_down_sync(0xffffffffu, acc_re[t], o);
          acc_im[t] += __shfl_down_sync(0xffffffffu, acc_im[t], o);
        }
        if (lane == 0) {
          s_part[it & 1][warp][2 * t] = acc_re[t];
          s_part[it & 1][warp][2 * t + 1] = acc_im[t];
        }
      }
    }
    cluster.sync();

    if (warp == 0) {
      // lane j < 2T adds tap j over the ranks, then the warps, in order
      float v = 0.0f;
      if (lane < 2 * T) {
        for (int q = 0; q < ranks; ++q) {
          const float* part = cluster.map_shared_rank(&s_part[it & 1][0][0], q);
          for (int w = 0; w < NCW; ++w) v += part[w * 2 * T + lane];
        }
      }
      float taps[2 * T];
#pragma unroll
      for (int j = 0; j < 2 * T; ++j)
        taps[j] = __shfl_sync(0xffffffffu, v, j);
      close_loop<T>(st, P, taps, (rank == 0 && lane == 0) ? s_row : nullptr);
      period_geometry(st, P);
      if (lane == 0) s_geo = geo_of(st, P);
      if (rank == 0) {
        __syncwarp();
        reinterpret_cast<float4*>(
            out + ((size_t)c * P.n_periods + it) * LANES)[lane] =
            reinterpret_cast<const float4*>(s_row)[lane];
      }
    }
    __syncthreads();
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
}

template <int T, bool INTERP>
cudaLaunchConfig_t config(int c, int ranks, const RingShape& R,
                          const Params& P, cudaStream_t stream,
                          cudaLaunchAttribute* attr, cudaError_t* err) {
  const size_t smem = (size_t)2 * R.slotw * sizeof(float2)
                      + (size_t)P.code_len * sizeof(float);
  *err = cudaSuccess;
  if (smem > 48 * 1024)
    *err = cudaFuncSetAttribute(track_blocked_kernel<T, INTERP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * ranks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int T, bool INTERP>
cudaError_t launch(const float2* window, const float* codes,
                   const float* scalars, const int* pos, float* out, int c,
                   int ranks, int width, const Params& P,
                   cudaStream_t stream) {
  const RingShape R = ring_shape(width);
  cudaLaunchAttribute attr;
  cudaError_t e;
  const cudaLaunchConfig_t cfg =
      config<T, INTERP>(c, ranks, R, P, stream, &attr, &e);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, track_blocked_kernel<T, INTERP>, window,
                         codes, scalars, pos, out, P, R, ranks);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int T, bool INTERP>
cudaError_t max_clusters(int c, int ranks, int width, const Params& P,
                         int* n) {
  cudaLaunchAttribute attr;
  cudaError_t e;
  const cudaLaunchConfig_t cfg =
      config<T, INTERP>(c, ranks, ring_shape(width), P, 0, &attr, &e);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(n, track_blocked_kernel<T, INTERP>,
                                        &cfg);
}

bool valid_shape(int c, int ranks, int width, int n_max) {
  return c > 0 && ranks >= 1 && ranks <= 8 && (ranks & (ranks - 1)) == 0
         && width > 0 && width % COPY_ALIGN == 0
         && (long long)ranks * width >= n_max;
}

}  // namespace

// window (complex64 [L] as float2), codes (f32 [C, code_len]), scalars
// (f32 [C, ns]), pos (int32 [C]), out (f32 [C, K, 128]); ranks CTAs per
// channel (a power of two <= 8) each covering `width` samples of a period
// (even, ranks * width >= n_max).
extern "C" int gnss_track_blocked(const void* window, int window_len,
                                  const void* codes, int code_len,
                                  const void* scalars, int ns, const void* pos,
                                  void* out, int c, int n_periods, int n_max,
                                  const void* params, int num_taps,
                                  int pll_order, int dll_order,
                                  int interp_code, int ranks, int width,
                                  void* stream) {
  if (num_taps != 3 || !valid_shape(c, ranks, width, n_max))
    return (int)cudaErrorInvalidValue;
  const Params P = make_params(static_cast<const float*>(params), num_taps,
                               window_len, code_len, ns, n_periods, n_max,
                               pll_order, dll_order);
  const float2* w = static_cast<const float2*>(window);
  const float* cd = static_cast<const float*>(codes);
  const float* sc = static_cast<const float*>(scalars);
  const int* ps = static_cast<const int*>(pos);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = interp_code
      ? launch<3, true>(w, cd, sc, ps, o, c, ranks, width, P, s)
      : launch<3, false>(w, cd, sc, ps, o, c, ranks, width, P, s);
  return (int)e;
}

// How many clusters of `ranks` CTAs (slices of `width` samples, a
// `code_len`-chip table) the card holds at once, into *n.
extern "C" int gnss_track_blocked_max_clusters(int c, int code_len,
                                               int n_max, int interp_code,
                                               int ranks, int width,
                                               int* n) {
  if (!valid_shape(c, ranks, width, n_max)) return (int)cudaErrorInvalidValue;
  Params P = {};
  P.code_len = code_len;
  P.n_max = n_max;
  const cudaError_t e = interp_code
      ? max_clusters<3, true>(c, ranks, width, P, n)
      : max_clusters<3, false>(c, ranks, width, P, n);
  return (int)e;
}
