// Simple fused K-period tracker (K4): the one-period CDMA loop of C
// channels over K code periods in one launch, a thread-block cluster of R
// CTAs per channel.
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
// What the design does about it: K1's mapping, by running K1's kernel.
// csrc/track_loop.cuh's cluster_track_kernel spreads each channel over a
// thread-block cluster of R CTAs (R from ops/track_kernel_blocked.py::
// cluster_shape, the occupancy query taken with K4's shared memory: the
// ring and up to a 10230-chip table), each staging its slice of every
// period through a shared-memory ring a period ahead and running the staged
// per-sample step (comparison code wrap, reciprocal code step, reduced-range
// __sincosf); one cluster barrier and a DSMEM gather in rank order a
// period. This file supplies K4's loop policy: its state, its loader and
// its closure close_simple, whose sums are written with
// __fadd_rn/__fsub_rn/__fmul_rn so that it rounds as its plain version
// does under FMA contraction (period lengths and positions stay exact).

#include "track_loop.cuh"

namespace {

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
    i1 = __fadd_rn(i1, F.w0sq * err * t_int);
    return __fadd_rn(i1, F.kp2 * err);
  }
  i2 = __fadd_rn(i2, F.w0cu * err * t_int);
  i1 = __fadd_rn(i1, t_int * __fadd_rn(i2, F.k3a * err));
  return __fadd_rn(i1, F.k3b * err);
}

__device__ __forceinline__ float tap_mag(const float* taps, int t) {
  return sqrtf(__fadd_rn(__fmul_rn(taps[2 * t], taps[2 * t]),
                         __fmul_rn(taps[2 * t + 1], taps[2 * t + 1])));
}

// discriminators, loop filters and NCO advance of one period
// (track_kernel.py:307-382); writes lanes 0..2T-1 and 10-19 of the row
// unless row is null
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
  float phase = __fadd_rn(s.phase, (TWO_PI * P.inv_fs) * s.dop * s.n);
  phase = __fsub_rn(phase, __fmul_rn(TWO_PI, floorf(phase / TWO_PI)));
  const float dcode = __fsub_rn(__fmul_rn(pll_out, P.aid_ratio), dll_out);
  const float rem = fmaxf(
      __fadd_rn(s.rem,
                __fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(s.n, P.spcf),
                                              s.code_step), P.c0),
                          __fmul_rn(P.spcf, s.delta))), 0.0f);
  const float pos = s.pos + s.n;

  if (row != nullptr) {
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
  }

  s.pos = pos;
  s.rem = rem;
  s.dcode = dcode;
  s.phase = phase;
  s.dop = pll_out;
}

// K4's loop policy for cluster_track_kernel
template <int NT>
struct SimpleLoop {
  static constexpr int T = NT;
  static constexpr bool PILOT = false;
  static constexpr bool FDMA = false;
  using St = SimpleState;
  Filter pll, dll;
  // no enabled gating: every channel advances
  __device__ static bool advances(const float*) { return true; }
  // [pos, rem, dcode, phase, doppler, pll_i1, dll_i1, enabled, pll_i2,
  //  dll_i2]; slot 7 is not read
  __device__ void load(St& s, const float* sc, const int*, int,
                       const Params&) const {
    s.pos = sc[0];
    s.rem = sc[1];
    s.dcode = sc[2];
    s.phase = sc[3];
    s.dop = sc[4];
    s.pll_i1 = sc[5];
    s.dll_i1 = sc[6];
    s.pll_i2 = sc[8];
    s.dll_i2 = sc[9];
  }
  __device__ void close(St& s, const Params& P, const float* taps,
                        float* row, const float*, const float*) const {
    close_simple<NT>(s, P, pll, dll, taps, row);
  }
};

template <int T>
cudaError_t dispatch(bool interp, const float2* w, const float* cd,
                     const float* sc, float* o, int c, int ranks, int width,
                     const Params& P, const Filter& pll, const Filter& dll,
                     cudaStream_t s) {
  const SimpleLoop<T> loop{pll, dll};
  return interp ? cluster_launch<SimpleLoop<T>, true>(
                      w, cd, sc, nullptr, o, c, ranks, width, P, loop, s)
                : cluster_launch<SimpleLoop<T>, false>(
                      w, cd, sc, nullptr, o, c, ranks, width, P, loop, s);
}

template <int T>
cudaError_t max_clusters(bool interp, int c, int ranks, int width,
                         const Params& P, int* n) {
  return interp ? cluster_max<SimpleLoop<T>, true>(c, ranks, width, P, n)
                : cluster_max<SimpleLoop<T>, false>(c, ranks, width, P, n);
}

}  // namespace

// window: float2 [window_len] (complex64); codes: f32 [C, code_len];
// scalars: f32 [C, 10]; out: f32 [C, n_periods, 128]; params: host f32[32]
// (ops/track_kernel.py::launch_simple): K1's layout in 0..7, tap offsets
// in 8..12, PLL filter constants in 16..21, DLL filter constants in 22..27;
// ranks CTAs per channel (a power of two <= 8) each covering `width`
// samples of a period (even, ranks * width >= n_max).
extern "C" int gnss_track_simple(const void* window, int window_len,
                                 const void* codes, int code_len,
                                 const void* scalars, void* out, int c,
                                 int n_periods, int n_max, const void* params,
                                 int num_taps, int pll_order, int dll_order,
                                 int interp_code, int ranks, int width,
                                 void* stream) {
  if ((num_taps != 3 && num_taps != 5)
      || !valid_cluster_shape(c, ranks, width, n_max))
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
  const bool interp = interp_code != 0;
  cudaError_t e = num_taps == 3
      ? dispatch<3>(interp, w, cd, sc, o, c, ranks, width, P, pll, dll, s)
      : dispatch<5>(interp, w, cd, sc, o, c, ranks, width, P, pll, dll, s);
  return (int)e;
}

// How many K4 clusters of `ranks` CTAs (slices of `width` samples, a
// `code_len`-chip table, num_taps taps) the card holds at once, into *n.
extern "C" int gnss_track_simple_max_clusters(int c, int code_len, int n_max,
                                              int interp_code, int num_taps,
                                              int ranks, int width, int* n) {
  if ((num_taps != 3 && num_taps != 5)
      || !valid_cluster_shape(c, ranks, width, n_max))
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.code_len = code_len;
  P.n_max = n_max;
  const bool interp = interp_code != 0;
  const cudaError_t e = num_taps == 3
      ? max_clusters<3>(interp, c, ranks, width, P, n)
      : max_clusters<5>(interp, c, ranks, width, P, n);
  return (int)e;
}
