// Per-channel fused K-period GPS tracker (K2): closed-loop DLL/PLL/FLL
// tracking of C channels over K code periods in one launch, one warp per
// channel.
//
// Replaces the TPU kernel gnss_sdr_tpu/ops/track_kernel.py,
// make_fused_tracker_full (pallas_call at :937), which runs one grid
// program per channel. It computes what that kernel computes (:565-904)
// for the GPS modes, with the same scalar slots and output lanes
// (ops/slots.py), and what K1 (csrc/track_blocked.cu) computes on the same
// inputs: the two kernels share the per-sample step and the per-channel
// section (csrc/track_loop.cuh) and differ only in how the loop is mapped
// onto the card. No qloop/window2 replica, no [rows, 128] sample layout,
// no Cephes atan or Cody-Waite sincos: sincosf, atanf and atan2f.
//
// What bounds it on the H100: latency, as for K1. The loop is sequential
// over periods, and one period of one channel is ~2600 samples; the bytes
// (C*K*n*8 B of stream) would take well under a microsecond per period at
// 3.35 TB/s.
//
// What the design does about it: one warp carries one channel through all
// K periods, several warps (channels) to a CTA. Each lane strides over the
// period's samples (about 82 a lane at 2602; coalesced float2 reads of the
// complex64 stream at pos + k) and keeps the 2T tap partial sums in
// registers. A __shfl_xor_sync butterfly leaves the same sums in every
// lane (each step adds the same two values in either order, so all lanes
// agree bit for bit), and every lane runs the loop closure redundantly:
// the period loop has no block barrier and no one-thread section, only
// __syncwarp around the row store. The channel's code row is staged once
// into shared memory (4 KB a warp at 1023 chips); the 128-float output row
// is assembled in shared memory and stored as one float4 a lane. Against
// K1 (256 threads a channel, two barriers and a one-thread closure a
// period) it trades 8x fewer threads per channel for no barriers. Built
// with -fmad=false like K1, so the period lengths and positions agree
// exactly with the plain version.

#include "track_loop.cuh"

namespace {

constexpr int WARPS = 4;                  // channels per CTA
constexpr int THREADS = WARPS * 32;

template <int T, bool INTERP>
__global__ void __launch_bounds__(THREADS)
track_full_kernel(const float2* __restrict__ window,
                  const float* __restrict__ codes,
                  const float* __restrict__ scalars,
                  const int* __restrict__ pos_in,
                  float* __restrict__ out, const Params P, int n_channels) {
  // [WARPS][LANES] output rows, then [WARPS][code_len] code rows
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + warp;
  if (c >= n_channels) return;            // whole warp; no block barrier
  float* s_row = smem + warp * LANES;
  float* s_code = smem + WARPS * LANES + warp * P.code_len;

  for (int i = lane; i < P.code_len; i += 32)
    s_code[i] = codes[(size_t)c * P.code_len + i];
  for (int i = lane; i < LANES; i += 32) s_row[i] = 0.0f;
  __syncwarp();

  State<T> st;
  load_state<T>(st, scalars + (size_t)c * P.ns, pos_in[c], P);
  period_geometry(st, P);

  float offs[T];
#pragma unroll
  for (int t = 0; t < T; ++t) offs[t] = P.offs[t];

  for (int it = 0; it < P.n_periods; ++it) {
    const int pos = st.pos, n = (int)st.n;
    const float dstep = (TWO_PI * P.inv_fs) * st.dop;
    float acc_re[T], acc_im[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc_re[t] = acc_im[t] = 0.0f;

    // one warp has no other warps to hide its latency behind: unrolled,
    // four samples' loads, sincosf and divisions are in flight at once
    // (each lane still adds its samples in k order)
#pragma unroll 4
    for (int k = lane; k < n; k += 32)
      accumulate_sample<T, INTERP>(window, s_code, P, offs, pos, k, st.rem,
                                   st.code_step, st.phase, dstep, acc_re,
                                   acc_im);
    float taps[2 * T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      for (int o = 16; o > 0; o >>= 1) {
        acc_re[t] += __shfl_xor_sync(0xffffffffu, acc_re[t], o);
        acc_im[t] += __shfl_xor_sync(0xffffffffu, acc_im[t], o);
      }
      taps[2 * t] = acc_re[t];
      taps[2 * t + 1] = acc_im[t];
    }

    // every lane holds the same state and writes the same row values
    close_loop<T>(st, P, taps, s_row);
    period_geometry(st, P);
    __syncwarp();
    reinterpret_cast<float4*>(out + ((size_t)c * P.n_periods + it) * LANES)
        [lane] = reinterpret_cast<const float4*>(s_row)[lane];
    __syncwarp();
  }
}

template <int T, bool INTERP>
cudaError_t launch(const float2* window, const float* codes,
                   const float* scalars, const int* pos, float* out, int c,
                   const Params& P, cudaStream_t stream) {
  const size_t smem =
      (size_t)WARPS * (LANES + P.code_len) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        track_full_kernel<T, INTERP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (c + WARPS - 1) / WARPS;
  track_full_kernel<T, INTERP><<<blocks, THREADS, smem, stream>>>(
      window, codes, scalars, pos, out, P, c);
  return cudaGetLastError();
}

}  // namespace

// The arguments are gnss_track_blocked's (csrc/track_blocked.cu).
extern "C" int gnss_track_full(const void* window, int window_len,
                               const void* codes, int code_len,
                               const void* scalars, int ns, const void* pos,
                               void* out, int c, int n_periods, int n_max,
                               const void* params, int num_taps,
                               int pll_order, int dll_order, int interp_code,
                               void* stream) {
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
