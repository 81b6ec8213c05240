// Simple fused K-period tracker (K4): the one-period CDMA loop of C
// channels over K code periods in one launch, one CTA per channel.
//
// Replaces the TPU kernel gnss_sdr_tpu/ops/track_kernel.py,
// make_fused_tracker (pallas_call at :407). It computes what that kernel
// computes (:184-392) on the plain [C, L] chip table, with the same [C, 10]
// scalar block and output lanes 0..2T-1 and 10-19: per period the period
// length from the code NCO, carrier wipeoff, the soft replica at T = 3 or 5
// taps, then a Costas PLL (atanf), a NELP (T = 3) or VEML (T = 5) DLL, loop
// filters of order 1-3 whose constants were rounded on the host, and the
// carrier-aided code NCO. Unlike K1 it has no enabled gating (slot 7 is
// never read: every channel advances), no extended integration, no FLL,
// and it carries the position as float32 (slot 0, lane 17).
//
// What bounds it on the H100: latency, as for K1. Period i+1's NCO needs
// period i's correlations, and one period of one channel is ~2600 samples;
// the bytes (C*K*n*8 B of stream) would take well under a microsecond per
// period at 3.35 TB/s.
//
// What the design does about it: K1's mapping (csrc/track_blocked.cu), which
// runs 6x faster than one warp per channel (K2) at C = 8 on the H100
// (PERF.md). One CTA per
// channel stays resident for all K periods with the channel's chip row in
// shared memory (40 KB at 10230 chips); 256 threads stride over the
// period's samples through the shared per-sample step (csrc/track_loop.cuh:
// coalesced float2 reads at pos + k, sincosf wipeoff, the soft replica with
// its two ramps as single-rounded fmaf), a warp-shuffle plus shared-memory
// reduce feeds one thread, which runs K4's own closure in float32 in the
// plain version's order and broadcasts the next period's geometry. Built
// with -fmad=false so that the period-length rule rounds as written and the
// period lengths and positions agree exactly with the plain version.

#include "track_loop.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// one loop filter's float32 constants (ops/track_kernel.py::
// _filter_constants): 4 bw, w0^2, 1.414 w0, w0^3, 1.1 w0 w0, 2.4 w0
struct Filter {
  float k1, w0sq, kp2, w0cu, k3a, k3b;
  int order;
};

inline Filter make_filter(const float* hp, int order) {
  return Filter{hp[0], hp[1], hp[2], hp[3], hp[4], hp[5], order};
}

// loop state of one channel; rem, dcode and the geometry fields are what
// period_geometry reads and writes
struct SimpleState {
  float pos, rem, dcode, phase, dop;
  float pll_i1, pll_i2, dll_i1, dll_i2;
  float delta, code_step, n;
};

// track_kernel.py:331-350; the integrators pass through where the order
// does not use them
__device__ __forceinline__ float filter_step(const Filter& F, float err,
                                             float t_int, float& i1,
                                             float& i2) {
  if (F.order == 1) return F.k1 * err;
  if (F.order == 2) {
    i1 = i1 + F.w0sq * err * t_int;
    return i1 + F.kp2 * err;
  }
  i2 = i2 + F.w0cu * err * t_int;
  i1 = i1 + t_int * (i2 + F.k3a * err);
  return i1 + F.k3b * err;
}

__device__ __forceinline__ float tap_mag(const float* taps, int t) {
  return sqrtf(taps[2 * t] * taps[2 * t] + taps[2 * t + 1] * taps[2 * t + 1]);
}

// discriminators, loop filters and NCO advance of one period
// (track_kernel.py:307-382); writes lanes 0..2T-1 and 10-19 of the row
template <int T>
__device__ void close_simple(SimpleState& s, const Params& P,
                             const Filter& pll, const Filter& dll,
                             const float* taps, float* row) {
  constexpr int p = T / 2;
  const float p_re = taps[2 * p], p_im = taps[2 * p + 1];
  const float carr_err = atanf(p_im / nz(p_re)) / TWO_PI;
  const float e_mag = tap_mag(taps, p - 1), l_mag = tap_mag(taps, p + 1);
  float num, den;
  if constexpr (T == 5) {
    const float ve = tap_mag(taps, 0), vl = tap_mag(taps, 4);
    num = (e_mag + ve) - (l_mag + vl);
    den = (e_mag + ve) + (l_mag + vl);
  } else {
    num = e_mag - l_mag;
    den = e_mag + l_mag;
  }
  const float code_err = 0.5f * num / fmaxf(den, 1e-20f);

  const float t_int = s.n * P.inv_fs;
  const float pll_out = filter_step(pll, carr_err, t_int, s.pll_i1, s.pll_i2);
  const float dll_out = filter_step(dll, code_err, t_int, s.dll_i1, s.dll_i2);

  // the phase advances at the Doppler in force during the period
  float phase = s.phase + (TWO_PI * P.inv_fs) * s.dop * s.n;
  phase = phase - TWO_PI * floorf(phase / TWO_PI);
  const float dcode = pll_out * P.aid_ratio - dll_out;
  const float rem = fmaxf(
      s.rem + ((s.n - P.spcf) * s.code_step + P.c0 + P.spcf * s.delta), 0.0f);
  const float pos = s.pos + s.n;

  for (int j = 0; j < 2 * T; ++j) row[j] = taps[j];
  row[LANE_N] = s.n;
  row[LANE_DOPPLER] = pll_out;
  row[LANE_DCODE] = dcode;
  row[LANE_REM] = rem;
  row[LANE_PHASE] = phase;
  row[LANE_PLL_I1] = s.pll_i1;
  row[LANE_DLL_I1] = s.dll_i1;
  row[LANE_POS] = pos;
  row[LANE_PLL_I2] = s.pll_i2;
  row[LANE_DLL_I2] = s.dll_i2;

  s.pos = pos;
  s.rem = rem;
  s.dcode = dcode;
  s.phase = phase;
  s.dop = pll_out;
}

template <int T, bool INTERP>
__global__ void __launch_bounds__(THREADS)
track_simple_kernel(const float2* __restrict__ window,
                    const float* __restrict__ codes,
                    const float* __restrict__ scalars,
                    float* __restrict__ out, const Params P, const Filter pll,
                    const Filter dll) {
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
  // lanes 20-127 (and 2T..9) stay zero
  for (int i = tid; i < LANES; i += THREADS) s_row[i] = 0.0f;

  SimpleState st;
  if (tid == 0) {
    // [pos, rem, dcode, phase, doppler, pll_i1, dll_i1, enabled, pll_i2,
    //  dll_i2]; slot 7 is not read
    const float* sc = scalars + (size_t)c * P.ns;
    st.pos = sc[0];
    st.rem = sc[1];
    st.dcode = sc[2];
    st.phase = sc[3];
    st.dop = sc[4];
    st.pll_i1 = sc[5];
    st.dll_i1 = sc[6];
    st.pll_i2 = sc[8];
    st.dll_i2 = sc[9];
    period_geometry(st, P);
    s_pos = (int)st.pos;
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
      close_simple<T>(st, P, pll, dll, taps, s_row);
      period_geometry(st, P);
      s_pos = (int)st.pos;
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
                   const float* scalars, float* out, int c, const Params& P,
                   const Filter& pll, const Filter& dll, cudaStream_t stream) {
  const size_t smem = (size_t)P.code_len * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        track_simple_kernel<T, INTERP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  track_simple_kernel<T, INTERP><<<c, THREADS, smem, stream>>>(
      window, codes, scalars, out, P, pll, dll);
  return cudaGetLastError();
}

template <int T>
cudaError_t dispatch(bool interp, const float2* w, const float* cd,
                     const float* sc, float* o, int c, const Params& P,
                     const Filter& pll, const Filter& dll, cudaStream_t s) {
  return interp ? launch<T, true>(w, cd, sc, o, c, P, pll, dll, s)
                : launch<T, false>(w, cd, sc, o, c, P, pll, dll, s);
}

}  // namespace

// window: float2 [window_len] (complex64); codes: f32 [C, code_len];
// scalars: f32 [C, 10]; out: f32 [C, n_periods, 128]; params: host f32[32]
// (ops/track_kernel.py::launch_simple): K1's layout in 0..7, tap offsets
// in 8..12, PLL filter constants in 16..21, DLL filter constants in 22..27.
extern "C" int gnss_track_simple(const void* window, int window_len,
                                 const void* codes, int code_len,
                                 const void* scalars, void* out, int c,
                                 int n_periods, int n_max, const void* params,
                                 int num_taps, int pll_order, int dll_order,
                                 int interp_code, void* stream) {
  if ((num_taps != 3 && num_taps != 5) || c <= 0)
    return (int)cudaErrorInvalidValue;
  const float* hp = static_cast<const float*>(params);
  const Params P = make_params(hp, num_taps, window_len, code_len, 10,
                               n_periods, n_max, pll_order, dll_order);
  const Filter pll = make_filter(hp + 16, pll_order);
  const Filter dll = make_filter(hp + 22, dll_order);
  const float2* w = static_cast<const float2*>(window);
  const float* cd = static_cast<const float*>(codes);
  const float* sc = static_cast<const float*>(scalars);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = num_taps == 3
      ? dispatch<3>(interp_code != 0, w, cd, sc, o, c, P, pll, dll, s)
      : dispatch<5>(interp_code != 0, w, cd, sc, o, c, P, pll, dll, s);
  return (int)e;
}
