// Per-channel fused K-period tracker (K2): closed-loop DLL/PLL/FLL
// tracking of C channels over K code periods in one launch, one CTA per
// channel fed by a shared-memory sample ring.
//
// Replaces the TPU kernel gnss_sdr_tpu/ops/track_kernel.py,
// make_fused_tracker_full (pallas_call at :937), which runs one grid
// program per channel. It computes what that kernel computes (:565-904):
// T = 3 or 5 taps (NELP or VEML), the pilot/secondary mode with the data
// prompt, and FDMA (the carrier offset in the step, the ramp reduced mod
// 2 pi, :494, :590, :622-628, :833-836); with the same scalar slots and
// output lanes
// (ops/slots.py), and what K1 (csrc/track_blocked.cu) computes on the same
// inputs: the two kernels share the per-sample step, the sample ring and
// the per-channel section (csrc/track_loop.cuh) and differ only in how a
// channel is spread over the card. No qloop/window2 replica, no [rows, 128]
// sample layout, no Cephes atan or Cody-Waite sincos.
//
// What bounds it on the H100: latency. The loop is sequential over periods
// (period i+1's NCO needs period i's correlations); one period of one
// channel is ~2600 samples, whose bytes (8 B each) would take well under a
// microsecond at 3.35 TB/s. A period costs the dependent sample loads, the
// per-sample arithmetic spread over the CTA, one barrier and the serial
// closure (atanf, atan2f, two sqrtf, divisions).
//
// What the design does about it: grid C, one CTA of 8 consumer warps and
// 1 producer warp per channel, resident for all K periods. The producer
// warp stages each period's n_max samples into a two-slot ring in shared
// memory with cp.async.bulk completing on an mbarrier, one period ahead:
// the next period starts at pos + n (or pos for a disabled channel), known
// when the current one starts. The consumer warps wait on the slot's
// barrier, run the cheaper per-sample step (comparison code wrap, the
// reciprocal code step, reduced-range __sincosf, FMA contraction) from
// shared memory, and reduce with shuffles into a partial slot chosen by the
// period's parity. One CTA barrier a period; after it every thread adds the
// partials in the same fixed order and runs close_loop and period_geometry
// itself, so all threads hold bit-identical state and no second barrier is
// needed. One warp stores the 128-float row as float4s. The channel's code
// table stays in shared memory (4 KB at 1023 chips, 40 KB at 10230); in
// pilot mode the data code and the two secondary rows join it. The ring
// holds a whole period: at Galileo E1's 16000 samples (4 Msps) two chunks
// of 8002, 2 x 8004 x 8 B = 128 KB, with the two 8184-unit tables about
// 190 KB of the H100's 227 KB a block; a shape past the card's limit is
// refused (gnss_track_full_smem), never run another way.

#include "track_loop.cuh"

namespace {

template <int T, bool INTERP, bool PILOT, bool FDMA>
__global__ void __launch_bounds__(RING_THREADS)
track_full_kernel(const float2* __restrict__ window,
                  const float* __restrict__ codes,
                  const float* __restrict__ scalars,
                  const int* __restrict__ pos_in,
                  float* __restrict__ out, const Params P,
                  const RingShape R, const PilotOf<PILOT> pilot) {
  constexpr int NT = 2 * (T + (PILOT ? 1 : 0));   // sums a period
  // [2][slotw] ring slots, then the tables (track_smem_bytes)
  extern __shared__ float4 smem4[];
  float2* ring = reinterpret_cast<float2*>(smem4);
  float* s_code = reinterpret_cast<float*>(ring + 2 * R.slotw);
  const float* s_dcode = s_code + P.code_len;
  const float* s_sec = s_dcode + P.code_len;
  __shared__ uint64_t full[2], empty[2];
  __shared__ float s_part[2][NCW][NT];
  __shared__ __align__(16) float s_row[LANES];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < P.code_len; i += RING_THREADS)
    s_code[i] = codes[(size_t)c * P.code_len + i];
  if constexpr (PILOT)
    stage_pilot(pilot, c, P.code_len, s_code + P.code_len, tid,
                RING_THREADS);
  for (int i = tid; i < LANES; i += RING_THREADS) s_row[i] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  State<T> st;
  load_state<T, FDMA>(st, scalars + (size_t)c * P.ns, pos_in[c], P);
  period_geometry(st, P);
  const bool en = st.en > 0.5f;

  float offs[T];
#pragma unroll
  for (int t = 0; t < T; ++t) offs[t] = P.offs[t];

  int g_next = 0;
  for (int it = 0; it < P.n_periods; ++it) {
    const Geo g = geo_of<FDMA>(st, P);
    const int len = min(g.n, R.width);
    if (warp == NCW) {
      g_next = ring_produce_period(window, P.window_len, ring, full, empty,
                                   R, g_next, it, P.n_periods, 0, g.pos,
                                   en ? g.pos + g.n : g.pos, lane);
    } else {
      float acc_re[NT / 2], acc_im[NT / 2];
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) acc_re[t] = acc_im[t] = 0.0f;
      ring_consume_period<T, INTERP, PILOT, FDMA>(
          window, ring, full, empty, R, s_code, s_dcode, P.code_len, offs, g,
          it, 0, len, tid, NCW * 32, lane, acc_re, acc_im);
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) {
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
    __syncthreads();

    // every thread: the same sums in the same order, the same closure
    float taps[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float v = 0.0f;
      for (int w = 0; w < NCW; ++w) v += s_part[it & 1][w][j];
      taps[j] = v;
    }
    close_loop<T, PILOT, FDMA>(st, P, pilot, taps,
                               tid == 0 ? s_row : nullptr, s_sec,
                               s_sec + SEC_MAX);
    period_geometry(st, P);
    if (warp == 0) {
      __syncwarp();
      reinterpret_cast<float4*>(out + ((size_t)c * P.n_periods + it) * LANES)
          [lane] = reinterpret_cast<const float4*>(s_row)[lane];
      __syncwarp();
    }
  }
}

// the ring of K2: one slice of a whole period
inline RingShape full_ring(int n_max) {
  return ring_shape((n_max + COPY_ALIGN - 1) / COPY_ALIGN * COPY_ALIGN);
}

template <int T, bool PILOT, bool FDMA>
cudaError_t launch(bool interp, const float2* window, const float* codes,
                   const float* scalars, const int* pos, float* out, int c,
                   const Params& P, const Pilot& pl, cudaStream_t stream) {
  PilotOf<PILOT> pilot{};
  if constexpr (PILOT) pilot = pl;
  const RingShape R = full_ring(P.n_max);
  const size_t smem = track_smem_bytes(R, P.code_len, PILOT);
  cudaError_t e = interp
      ? allow_smem(track_full_kernel<T, true, PILOT, FDMA>, smem)
      : allow_smem(track_full_kernel<T, false, PILOT, FDMA>, smem);
  if (e != cudaSuccess) return e;
  if (interp)
    track_full_kernel<T, true, PILOT, FDMA>
        <<<c, RING_THREADS, smem, stream>>>(window, codes, scalars, pos, out,
                                            P, R, pilot);
  else
    track_full_kernel<T, false, PILOT, FDMA>
        <<<c, RING_THREADS, smem, stream>>>(window, codes, scalars, pos, out,
                                            P, R, pilot);
  return cudaGetLastError();
}

template <int T, bool PILOT, bool FDMA>
cudaError_t smem(bool interp, const Params& P, int* need, int* limit) {
  const size_t b = track_smem_bytes(full_ring(P.n_max), P.code_len, PILOT);
  return interp
      ? allow_smem(track_full_kernel<T, true, PILOT, FDMA>, b, need, limit)
      : allow_smem(track_full_kernel<T, false, PILOT, FDMA>, b, need, limit);
}

// the instantiation for (num_taps, pilot, fdma)
#define GNSS_FULL_PILOT(FN, T, FD, ...)                                    \
  (pilot ? FN<T, true, FD>(__VA_ARGS__) : FN<T, false, FD>(__VA_ARGS__))
#define GNSS_FULL_TAPS(FN, FD, ...)                                        \
  (num_taps == 3 ? GNSS_FULL_PILOT(FN, 3, FD, __VA_ARGS__)                 \
                 : GNSS_FULL_PILOT(FN, 5, FD, __VA_ARGS__))
#define GNSS_FULL_SWITCH(FN, ...)                                          \
  (fdma ? GNSS_FULL_TAPS(FN, true, __VA_ARGS__)                            \
        : GNSS_FULL_TAPS(FN, false, __VA_ARGS__))

}  // namespace

// The arguments are gnss_track_blocked's (csrc/track_blocked.cu) without
// the cluster size and slice width.
extern "C" int gnss_track_full(const void* window, int window_len,
                               const void* codes, int code_len,
                               const void* scalars, int ns, const void* pos,
                               void* out, int c, int n_periods, int n_max,
                               const void* params, int num_taps,
                               int pll_order, int dll_order, int interp_code,
                               int track_pilot, int fdma_flag,
                               const void* dcodes, const void* sec_p,
                               const void* sec_d, const int* sec,
                               void* stream) {
  if ((num_taps != 3 && num_taps != 5) || c <= 0)
    return (int)cudaErrorInvalidValue;
  const Params P = make_params(static_cast<const float*>(params), num_taps,
                               window_len, code_len, ns, n_periods, n_max,
                               pll_order, dll_order);
  const bool pilot = track_pilot != 0;
  const bool fdma = fdma_flag != 0;
  Pilot pl = {};
  if (pilot && !make_pilot(pl, dcodes, sec_p, sec_d, sec))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = GNSS_FULL_SWITCH(
      launch, interp_code != 0, static_cast<const float2*>(window),
      static_cast<const float*>(codes), static_cast<const float*>(scalars),
      static_cast<const int*>(pos), static_cast<float*>(out), c, P, pl,
      static_cast<cudaStream_t>(stream));
  return (int)e;
}

// The shared memory one K2 CTA needs for periods of at most n_max samples
// (*need, bytes, static included) and the card's opt-in limit per block
// (*limit); returns cudaErrorInvalidValue when need > limit.
extern "C" int gnss_track_full_smem(int code_len, int interp_code,
                                    int num_taps, int track_pilot,
                                    int fdma_flag, int n_max, int* need,
                                    int* limit) {
  if ((num_taps != 3 && num_taps != 5) || n_max <= 0)
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.code_len = code_len;
  P.n_max = n_max;
  const bool pilot = track_pilot != 0;
  const bool fdma = fdma_flag != 0;
  return (int)GNSS_FULL_SWITCH(smem, interp_code != 0, P, need, limit);
}
