// The per-period loop of the fused GPS trackers, shared by the two CUDA
// mappings of it: csrc/track_blocked.cu (K1, one CTA per channel) and
// csrc/track_full.cu (K2, one warp per channel). The simple tracker K4
// (csrc/track_simple.cu) takes the period geometry and the per-sample step
// from here and has its own loop closure.
//
// Scalar input slots and output lanes are those of ops/slots.py. The
// loop-closure section is float32 exactly as the plain version
// (ops/track_kernel_blocked.py::track_blocked_plain) writes it; the files
// that include this header build with -fmad=false so that the period-length
// rule (round, then correct a negative remnant) rounds as written and the
// period lengths and positions agree exactly with the plain version.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr float TWO_PI = 6.2831855f;  // float32(2 pi)

// scalar slots (ops/slots.py)
constexpr int S_REM = 1, S_DCODE = 2, S_PHASE = 3, S_DOP = 4;
constexpr int S_PLL_I1 = 5, S_DLL_I1 = 6, S_EN = 7, S_PLL_I2 = 8, S_DLL_I2 = 9;
constexpr int S_INTEG_LEN = 10, S_INTEG_CNT = 11, S_ACC_N = 12, S_SEC_IDX = 13;
constexpr int S_ATAN2 = 15, S_FLL = 16, S_PLL_BW = 17, S_DLL_BW = 18;
constexpr int S_PREV_RE = 19, S_PREV_IM = 20;
constexpr int S_ACCD_RE = 21, S_ACCD_IM = 22, S_ACCD_CNT = 23, S_ACC0 = 24;

// output lanes (ops/slots.py)
constexpr int LANE_N = 10, LANE_DOPPLER = 11, LANE_DCODE = 12, LANE_REM = 13;
constexpr int LANE_PHASE = 14, LANE_PLL_I1 = 15, LANE_DLL_I1 = 16;
constexpr int LANE_POS = 17, LANE_PLL_I2 = 18, LANE_DLL_I2 = 19;
constexpr int LANE_BOUND = 20, LANE_ACC_N = 21, LANE_ACC0 = 22;
constexpr int LANE_DATA_RE = 32, LANE_DATA_IM = 33, LANE_DATA_BOUND = 34;
constexpr int LANE_DATA_CNT = 35, LANE_SEC_IDX = 36, LANE_ICOUNT = 37;
constexpr int LANE_PREV_RE = 38, LANE_PREV_IM = 39;

constexpr int MAX_TAPS = 5;

// per-launch constants, float32 values computed on the host exactly as the
// plain version computes them
struct Params {
  float inv_fs;        // 1 / fs
  float nominal_step;  // code_rate / fs, chips per sample
  float aid_ratio;     // code_rate / carrier_freq
  float w0f;           // FLL natural frequency
  float pll_div;       // bandwidth -> natural frequency divisor
  float dll_div;
  float c0;            // spc * nominal_step - code_len
  float spcf;          // nominal samples per code period
  float offs[MAX_TAPS];
  int window_len;
  int code_len;
  int ns;              // scalar slots per channel
  int n_periods;
  int n_max;
  int pll_order;
  int dll_order;
};

// params (host, float32[8 + num_taps]): inv_fs, nominal_step, aid_ratio,
// w0f, pll_div, dll_div, c0, spcf, tap offsets
inline Params make_params(const float* hp, int num_taps, int window_len,
                          int code_len, int ns, int n_periods, int n_max,
                          int pll_order, int dll_order) {
  Params P;
  P.inv_fs = hp[0];
  P.nominal_step = hp[1];
  P.aid_ratio = hp[2];
  P.w0f = hp[3];
  P.pll_div = hp[4];
  P.dll_div = hp[5];
  P.c0 = hp[6];
  P.spcf = hp[7];
  for (int t = 0; t < MAX_TAPS; ++t) P.offs[t] = t < num_taps ? hp[8 + t] : 0.0f;
  P.window_len = window_len;
  P.code_len = code_len;
  P.ns = ns;
  P.n_periods = n_periods;
  P.n_max = n_max;
  P.pll_order = pll_order;
  P.dll_order = dll_order;
  return P;
}

// loop state of one channel
template <int T>
struct State {
  int pos;
  float rem, dcode, phase, dop;
  float pll_i1, pll_i2, dll_i1, dll_i2;
  float icount, acc_n, sec_idx;
  float prev_re, prev_im, accd_re, accd_im, accd_cnt;
  float acc[2 * T];
  // per-launch channel constants
  float en, integ_len, atan2_flag, fll, pll_bw, dll_bw, w0p, w0d;
  // this period's geometry
  float delta, code_step, n;
};

// period length from the code NCO: round, then correct a negative remnant
// (any loop state with rem, dcode and the geometry fields: K1/K2's State,
// K4's SimpleState in csrc/track_simple.cu)
template <class S>
__device__ void period_geometry(S& s, const Params& P) {
  s.delta = s.dcode * P.inv_fs;
  s.code_step = P.nominal_step + s.delta;
  const float small = s.rem + P.c0 + P.spcf * s.delta;
  const float n_f = P.spcf - small / s.code_step;
  const float n0 = floorf(n_f + 0.5f);
  const float rem0 = s.rem + ((n0 - P.spcf) * s.code_step + P.c0
                              + P.spcf * s.delta);
  const float addf = rem0 < 0.0f ? 1.0f : 0.0f;
  s.n = fminf(fmaxf(n0 + addf, 1.0f), (float)P.n_max);
}

__device__ __forceinline__ float nz(float x) {
  return fabsf(x) < 1e-20f ? 1e-20f : x;
}

// accumulation, discriminators, loop filters and NCO advance for one
// period (the per-channel section); fills the output row
template <int T>
__device__ void close_loop(State<T>& s, const Params& P, const float* taps,
                           float* row) {
  constexpr int p = T / 2;
  const bool eng = s.en > 0.5f;
  for (int j = 0; j < 2 * T; ++j) s.acc[j] = s.acc[j] + taps[j];
  const float acc_n_new = s.acc_n + s.n;
  const float icount_new = eng ? s.icount + 1.0f : 0.0f;
  const bool boundary = (icount_new >= s.integ_len) && eng;
  const float bf = boundary ? 1.0f : 0.0f;
  const float accd_re_new = s.accd_re + taps[2 * p];
  const float accd_im_new = s.accd_im + taps[2 * p + 1];
  const float accd_cnt_new = s.accd_cnt + 1.0f;
  const bool data_boundary = eng;
  const float dbf = data_boundary ? 1.0f : 0.0f;
  const float sec_n = s.sec_idx + 1.0f;
  // one secondary chip per period: the counter wraps every period
  const float sec_next = eng ? sec_n - floorf(sec_n) : s.sec_idx;

  // discriminators on the accumulated taps
  const float t_int = acc_n_new * P.inv_fs;
  const float p_re = s.acc[2 * p], p_im = s.acc[2 * p + 1];
  const float costas = atanf(p_im / nz(p_re));
  const float carr_err =
      (s.atan2_flag > 0.5f ? atan2f(p_im, p_re) : costas) / TWO_PI;
  const float cross = s.prev_re * p_im - s.prev_im * p_re;
  const float dot = s.prev_re * p_re + s.prev_im * p_im;
  const float freq_err =
      atanf(cross / nz(dot)) / (TWO_PI * fmaxf(t_int, 1e-20f));
  const float e_re = s.acc[2 * (p - 1)], e_im = s.acc[2 * (p - 1) + 1];
  const float l_re = s.acc[2 * (p + 1)], l_im = s.acc[2 * (p + 1) + 1];
  const float e_mag = sqrtf(e_re * e_re + e_im * e_im);
  const float l_mag = sqrtf(l_re * l_re + l_im * l_im);
  const float code_err =
      0.5f * (e_mag - l_mag) / fmaxf(e_mag + l_mag, 1e-20f);

  // loop filters (boundary-gated)
  const float fll_add =
      (boundary && s.fll > 0.5f) ? P.w0f * P.w0f * freq_err * t_int : 0.0f;
  const float pll_i1_a = s.pll_i1 + fll_add;
  const float w0p = s.w0p, w0d = s.w0d;
  float pll_i1_u, pll_i2_u, pll_out;
  if (P.pll_order == 1) {
    pll_i1_u = pll_i1_a;
    pll_i2_u = s.pll_i2;
    pll_out = 4.0f * s.pll_bw * carr_err;
  } else if (P.pll_order == 2) {
    pll_i1_u = pll_i1_a + w0p * w0p * carr_err * t_int;
    pll_i2_u = s.pll_i2;
    pll_out = pll_i1_u + 1.414f * w0p * carr_err;
  } else {
    pll_i2_u = s.pll_i2 + (w0p * w0p * w0p) * carr_err * t_int;
    pll_i1_u = pll_i1_a + t_int * (pll_i2_u + 1.1f * w0p * w0p * carr_err);
    pll_out = pll_i1_u + 2.4f * w0p * carr_err;
  }
  float dll_i1_u, dll_i2_u, dll_out;
  if (P.dll_order == 1) {
    dll_i1_u = s.dll_i1;
    dll_i2_u = s.dll_i2;
    dll_out = 4.0f * s.dll_bw * code_err;
  } else if (P.dll_order == 2) {
    dll_i1_u = s.dll_i1 + w0d * w0d * code_err * t_int;
    dll_i2_u = s.dll_i2;
    dll_out = dll_i1_u + 1.414f * w0d * code_err;
  } else {
    dll_i2_u = s.dll_i2 + (w0d * w0d * w0d) * code_err * t_int;
    dll_i1_u = s.dll_i1 + t_int * (dll_i2_u + 1.1f * w0d * w0d * code_err);
    dll_out = dll_i1_u + 2.4f * w0d * code_err;
  }
  const float pll_i1_n = boundary ? pll_i1_u : s.pll_i1;
  const float pll_i2_n = boundary ? pll_i2_u : s.pll_i2;
  const float dll_i1_n = boundary ? dll_i1_u : s.dll_i1;
  const float dll_i2_n = boundary ? dll_i2_u : s.dll_i2;
  const float doppler_new = boundary ? pll_out : s.dop;
  const float dcode_new =
      boundary ? doppler_new * P.aid_ratio - dll_out : s.dcode;

  // NCO advance over the consumed period, at the Doppler in force during it
  const float dphi = (TWO_PI * P.inv_fs) * s.dop * s.n;
  float phase_adv = s.phase + dphi;
  phase_adv = phase_adv - TWO_PI * floorf(phase_adv / TWO_PI);
  const float rem_adv = fmaxf(
      s.rem + ((s.n - P.spcf) * s.code_step + P.c0 + P.spcf * s.delta), 0.0f);
  const int pos_new = eng ? s.pos + (int)s.n : s.pos;
  const float rem_new = eng ? rem_adv : s.rem;
  const float phase_new = eng ? phase_adv : s.phase;
  const float dop_out = eng ? doppler_new : s.dop;
  const float dcode_out = eng ? dcode_new : s.dcode;
  const float prev_re_n = boundary ? p_re : s.prev_re;
  const float prev_im_n = boundary ? p_im : s.prev_im;
  const float icount_out = boundary ? 0.0f : icount_new;

  for (int j = 0; j < 2 * T; ++j) {
    row[j] = taps[j];
    row[LANE_ACC0 + j] = s.acc[j];
  }
  row[LANE_N] = s.n;
  row[LANE_DOPPLER] = dop_out;
  row[LANE_DCODE] = dcode_out;
  row[LANE_REM] = rem_new;
  row[LANE_PHASE] = phase_new;
  row[LANE_PLL_I1] = pll_i1_n;
  row[LANE_DLL_I1] = dll_i1_n;
  row[LANE_POS] = (float)pos_new;
  row[LANE_PLL_I2] = pll_i2_n;
  row[LANE_DLL_I2] = dll_i2_n;
  row[LANE_BOUND] = bf;
  row[LANE_ACC_N] = acc_n_new;
  row[LANE_DATA_RE] = accd_re_new;
  row[LANE_DATA_IM] = accd_im_new;
  row[LANE_DATA_BOUND] = dbf;
  row[LANE_DATA_CNT] = accd_cnt_new;
  row[LANE_SEC_IDX] = sec_next;
  row[LANE_ICOUNT] = icount_out;
  row[LANE_PREV_RE] = prev_re_n;
  row[LANE_PREV_IM] = prev_im_n;

  // carry into the next period
  for (int j = 0; j < 2 * T; ++j) s.acc[j] = boundary ? 0.0f : s.acc[j];
  s.pos = pos_new;
  s.rem = rem_new;
  s.dcode = dcode_out;
  s.phase = phase_new;
  s.dop = dop_out;
  s.pll_i1 = pll_i1_n;
  s.pll_i2 = pll_i2_n;
  s.dll_i1 = dll_i1_n;
  s.dll_i2 = dll_i2_n;
  s.icount = icount_out;
  s.acc_n = boundary ? 0.0f : acc_n_new;
  s.sec_idx = sec_next;
  s.prev_re = prev_re_n;
  s.prev_im = prev_im_n;
  s.accd_re = data_boundary ? 0.0f : accd_re_new;
  s.accd_im = data_boundary ? 0.0f : accd_im_new;
  s.accd_cnt = data_boundary ? 0.0f : accd_cnt_new;
}

template <int T>
__device__ void load_state(State<T>& s, const float* sc, int pos,
                           const Params& P) {
  s.pos = pos;
  s.rem = sc[S_REM];
  s.dcode = sc[S_DCODE];
  s.phase = sc[S_PHASE];
  s.dop = sc[S_DOP];
  s.pll_i1 = sc[S_PLL_I1];
  s.pll_i2 = sc[S_PLL_I2];
  s.dll_i1 = sc[S_DLL_I1];
  s.dll_i2 = sc[S_DLL_I2];
  s.icount = sc[S_INTEG_CNT];
  s.acc_n = sc[S_ACC_N];
  s.sec_idx = sc[S_SEC_IDX];
  s.prev_re = sc[S_PREV_RE];
  s.prev_im = sc[S_PREV_IM];
  s.accd_re = sc[S_ACCD_RE];
  s.accd_im = sc[S_ACCD_IM];
  s.accd_cnt = sc[S_ACCD_CNT];
  for (int j = 0; j < 2 * T; ++j) s.acc[j] = sc[S_ACC0 + j];
  s.en = sc[S_EN];
  s.integ_len = sc[S_INTEG_LEN];
  s.atan2_flag = sc[S_ATAN2];
  s.fll = sc[S_FLL];
  s.pll_bw = sc[S_PLL_BW];
  s.dll_bw = sc[S_DLL_BW];
  s.w0p = s.pll_bw / P.pll_div;
  s.w0d = s.dll_bw / P.dll_div;
}

// soft replica: each chip transition ramps linearly over one sample
template <bool INTERP>
__device__ __forceinline__ float replica(const float* code, int code_len,
                                         float tap_ph, float step) {
  if (INTERP) {
    const float fl = floorf(tap_ph + 0.5f);
    int m = (int)fl % code_len;
    if (m < 0) m += code_len;
    const int mp = m == 0 ? code_len - 1 : m - 1;
    const float cur = code[m];
    const float prev = code[mp];
    const float d = tap_ph - fl;
    const float w = fminf(fmaxf(d / step + 0.5f, 0.0f), 1.0f);
    return prev + (cur - prev) * w;
  }
  int m = (int)floorf(tap_ph) % code_len;
  if (m < 0) m += code_len;
  return code[m];
}

// one sample's contribution to the 2T tap sums: carrier wipeoff at the
// phase ramp ph0 + dstep * k, replica at the code phase rem + step * k
// (both ramps single-rounded multiply-adds, as the plain version rounds
// them)
template <int T, bool INTERP>
__device__ __forceinline__ void accumulate_sample(
    const float2* __restrict__ window, const float* code, const Params& P,
    const float* offs, int pos, int k, float rem, float step, float ph0,
    float dstep, float* acc_re, float* acc_im) {
  const int idx = pos + k;
  const float2 x = (idx >= 0 && idx < P.window_len)
                       ? window[idx] : make_float2(0.0f, 0.0f);
  const float kf = (float)k;
  float sw, cw;
  sincosf(fmaf(dstep, kf, ph0), &sw, &cw);
  const float wr = x.x * cw + x.y * sw;
  const float wi = x.y * cw - x.x * sw;
  const float cph = fmaf(step, kf, rem);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float v = replica<INTERP>(code, P.code_len, cph + offs[t], step);
    acc_re[t] += wr * v;
    acc_im[t] += wi * v;
  }
}

}  // namespace
