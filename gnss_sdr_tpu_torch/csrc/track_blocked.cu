// Fused K-period GPS tracker: closed-loop DLL/PLL/FLL tracking of C
// channels over K code periods in one launch.
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
// channel is only ~2600 samples: about 2600 x 8 B of window reads and
// ~2600 x (sincos + 3 taps) of arithmetic. At C = 8 the launch fills 8 of
// 132 SMs, and each period pays two block-wide barriers plus a serial
// discriminator/loop-filter section on one thread. The bytes (C*K*n*8 B)
// would take well under a microsecond per period at 3.35 TB/s.
//
// What the design does about it: one CTA per channel stays resident for all
// K periods, so the loop state never leaves registers and the launch cost
// is paid once per K periods. The channel's code table sits in shared
// memory. Each thread strides over the period's samples (coalesced float2
// reads of the complex64 stream at pos + k), forms the carrier wipeoff with
// sincosf and the soft-interpolated replica at T taps, and keeps 2T partial
// sums; a warp-shuffle plus shared-memory reduce feeds one thread, which
// runs the per-channel section in float32 exactly as the plain version
// writes it and broadcasts the next period's geometry through shared
// memory. The file is compiled with -fmad=false so that the period-length
// rule (round, then correct a negative remnant) rounds like the plain
// version and n and pos agree exactly. The two per-sample phase ramps
// (carrier phase and code phase) are explicit fmaf, rounded once, as the
// plain version rounds them: an ulp of code phase at ~1000 chips moves the
// soft replica's ramp weight by ~1e-4. The per-sample step and the
// per-channel section live in csrc/track_loop.cuh, shared with K2
// (csrc/track_full.cu), which maps the same loop onto one warp per channel.

#include "track_loop.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int T, bool INTERP>
__global__ void __launch_bounds__(THREADS)
track_blocked_kernel(const float2* __restrict__ window,
                     const float* __restrict__ codes,
                     const float* __restrict__ scalars,
                     const int* __restrict__ pos_in,
                     float* __restrict__ out, const Params P) {
  extern __shared__ float s_code[];          // [code_len]
  __shared__ float s_red[WARPS][2 * T];
  __shared__ float s_row[LANES];
  __shared__ float s_geo[4];                 // rem, code_step, phase, dstep
  __shared__ int s_pos, s_n;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < P.code_len; i += THREADS)
    s_code[i] = codes[(size_t)c * P.code_len + i];
  for (int i = tid; i < LANES; i += THREADS) s_row[i] = 0.0f;

  State<T> st;
  if (tid == 0) {
    load_state<T>(st, scalars + (size_t)c * P.ns, pos_in[c], P);
    period_geometry(st, P);
    s_pos = st.pos;
    s_n = (int)st.n;
    s_geo[0] = st.rem;
    s_geo[1] = st.code_step;
    s_geo[2] = st.phase;
    s_geo[3] = (TWO_PI * P.inv_fs) * st.dop;
  }
  __syncthreads();

  float offs[T];
#pragma unroll
  for (int t = 0; t < T; ++t) offs[t] = P.offs[t];

  for (int it = 0; it < P.n_periods; ++it) {
    const int pos = s_pos, n = s_n;
    const float rem = s_geo[0], step = s_geo[1];
    const float ph0 = s_geo[2], dstep = s_geo[3];
    float acc_re[T], acc_im[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc_re[t] = acc_im[t] = 0.0f;

    for (int k = tid; k < n; k += THREADS)
      accumulate_sample<T, INTERP>(window, s_code, P, offs, pos, k, rem, step,
                                   ph0, dstep, acc_re, acc_im);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      for (int o = 16; o > 0; o >>= 1) {
        acc_re[t] += __shfl_down_sync(0xffffffffu, acc_re[t], o);
        acc_im[t] += __shfl_down_sync(0xffffffffu, acc_im[t], o);
      }
      if (lane == 0) {
        s_red[warp][2 * t] = acc_re[t];
        s_red[warp][2 * t + 1] = acc_im[t];
      }
    }
    __syncthreads();

    if (tid == 0) {
      float taps[2 * T];
      for (int j = 0; j < 2 * T; ++j) {
        float v = 0.0f;
        for (int w = 0; w < WARPS; ++w) v += s_red[w][j];
        taps[j] = v;
      }
      close_loop<T>(st, P, taps, s_row);
      period_geometry(st, P);
      s_pos = st.pos;
      s_n = (int)st.n;
      s_geo[0] = st.rem;
      s_geo[1] = st.code_step;
      s_geo[2] = st.phase;
      s_geo[3] = (TWO_PI * P.inv_fs) * st.dop;
    }
    __syncthreads();
    if (tid < LANES)
      out[((size_t)c * P.n_periods + it) * LANES + tid] = s_row[tid];
  }
}

template <int T, bool INTERP>
cudaError_t launch(const float2* window, const float* codes,
                   const float* scalars, const int* pos, float* out, int c,
                   const Params& P, cudaStream_t stream) {
  const size_t smem = (size_t)P.code_len * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        track_blocked_kernel<T, INTERP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  track_blocked_kernel<T, INTERP><<<c, THREADS, smem, stream>>>(
      window, codes, scalars, pos, out, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gnss_track_blocked(const void* window, int window_len,
                                  const void* codes, int code_len,
                                  const void* scalars, int ns, const void* pos,
                                  void* out, int c, int n_periods, int n_max,
                                  const void* params, int num_taps,
                                  int pll_order, int dll_order,
                                  int interp_code, void* stream) {
  if (num_taps != 3 || c <= 0) return (int)cudaErrorInvalidValue;
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
      ? launch<3, true>(w, cd, sc, ps, o, c, P, s)
      : launch<3, false>(w, cd, sc, ps, o, c, P, s);
  return (int)e;
}
