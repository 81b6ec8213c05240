// The per-period loop of the fused trackers, shared by their CUDA
// mappings: csrc/track_blocked.cu (K1) and csrc/track_simple.cu (K4) run the
// cluster kernel below (cluster_track_kernel, a thread-block cluster of R
// CTAs per channel) with their own loop policies, csrc/track_full.cu (K2,
// one CTA per channel) its own kernel on the same ring and closure; the
// correlator csrc/correlator.cu (K3) takes the staged per-sample helpers.
//
// Scalar input slots and output lanes are those of ops/slots.py. The
// period geometry and the loop closures are float32 exactly as the plain
// versions (ops/track_kernel_blocked.py::track_blocked_plain,
// ops/track_kernel.py::track_simple_plain) write them: every sum that could
// contract with a product into an FMA is written with
// __fadd_rn/__fsub_rn/__fmul_rn, which nvcc never contracts, so the
// period-length rule (round, then correct a negative remnant) rounds as
// written under any -fmad setting and the period lengths and positions
// agree exactly with the plain versions. Every kernel here therefore builds
// with FMA contraction on.
//
// The trackers take their samples from a two-slot ring in shared memory
// (ring_produce_period / ring_consume_period below): one producer warp
// stages each period's samples with cp.async.bulk (TMA's 1-D bulk copy)
// completing on an mbarrier, one period ahead of the consumer warps, which
// run the per-sample step accumulate_staged on what has arrived.
//
// Modes. T = 3 (early, prompt, late; the NELP DLL) or T = 5 (very early ..
// very late; the VEML DLL). PILOT adds the pilot/secondary mode of the TPU
// kernel (gnss_sdr_tpu/ops/track_kernel_blocked.py:483-529): the taps
// correlate the pilot code, one more tap at offset 0 correlates the data
// code (the data prompt), and once the host engages the secondary
// (S_SEC_ACT) each period's taps are wiped by the pilot secondary chip and
// the data prompt by the data secondary chip, both at the period's
// secondary index, which runs modulo sec_lcm; the data accumulator closes
// a symbol every sec_len_data periods. FDMA adds the TPU kernel's
// per-channel carrier offset (:308, :386-399, :597-600; GLONASS): w_off,
// rad/sample in scalar slot S_ACC0 + 2T, joins the carrier step, the
// per-sample phase is reduced mod 2 pi before the sine and cosine, and the
// NCO advances by the offset step; each of the three sums is one fused
// multiply-add (__fmaf_rn), as XLA contracts them in the TPU kernel and as
// the plain version (ops/track_kernel_blocked.py) rounds them. All three
// are template parameters: the GPS instantiation (T = 3, no PILOT, no FDMA)
// runs the float operations it ran before the modes were added, in the
// same order.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_util.cuh"

namespace {

constexpr int LANES = 128;
constexpr float TWO_PI = 6.2831855f;  // float32(2 pi)
constexpr float INV_TWO_PI = 0.15915494f;  // float32(1 / (2 pi))

// scalar slots (ops/slots.py)
constexpr int S_REM = 1, S_DCODE = 2, S_PHASE = 3, S_DOP = 4;
constexpr int S_PLL_I1 = 5, S_DLL_I1 = 6, S_EN = 7, S_PLL_I2 = 8, S_DLL_I2 = 9;
constexpr int S_INTEG_LEN = 10, S_INTEG_CNT = 11, S_ACC_N = 12, S_SEC_IDX = 13;
constexpr int S_SEC_ACT = 14, S_ATAN2 = 15, S_FLL = 16;
constexpr int S_PLL_BW = 17, S_DLL_BW = 18;
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
constexpr int SEC_MAX = 128;           // secondary chips a table row holds

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

// The pilot mode's tables on the device: the data code [C, code_len] and
// the secondary rows [C, sec_wp] and [C, sec_wd] (sequences of sp and sd
// chips), and the secondary counter's modulus. A kernel without the pilot
// mode carries NoPilot in its place, so that its arguments stay those of
// the GPS kernels.
struct Pilot {
  const float* dcodes;
  const float* sec_p;
  const float* sec_d;
  int sec_wp, sec_wd;
  int sp, sd, lcm;
};
struct NoPilot {};
template <bool PILOT>
using PilotOf = typename std::conditional<PILOT, Pilot, NoPilot>::type;

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

// the pilot-mode arguments of the C entry points: dcodes (f32 [C,
// code_len]), sec_p (f32 [C, sec_wp]), sec_d (f32 [C, sec_wd]) and
// sec[5] = {sec_wp, sec_wd, sp, sd, lcm}; false unless 1 <= sp <= sec_wp <=
// SEC_MAX, 1 <= sd <= sec_wd <= SEC_MAX, lcm >= 1 and the pointers are set
inline bool make_pilot(Pilot& pl, const void* dcodes, const void* sec_p,
                       const void* sec_d, const int* sec) {
  pl.dcodes = static_cast<const float*>(dcodes);
  pl.sec_p = static_cast<const float*>(sec_p);
  pl.sec_d = static_cast<const float*>(sec_d);
  pl.sec_wp = sec[0];
  pl.sec_wd = sec[1];
  pl.sp = sec[2];
  pl.sd = sec[3];
  pl.lcm = sec[4];
  return pl.dcodes && pl.sec_p && pl.sec_d && pl.sp >= 1
         && pl.sp <= pl.sec_wp && pl.sec_wp <= SEC_MAX && pl.sd >= 1
         && pl.sd <= pl.sec_wd && pl.sec_wd <= SEC_MAX && pl.lcm >= 1;
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
  float en, integ_len, atan2_flag, fll, pll_bw, dll_bw, w0p, w0d, sec_act;
  float w_off;         // FDMA: the carrier offset, rad/sample
  // this period's geometry
  float delta, code_step, n;
};

// period length from the code NCO: round, then correct a negative remnant
// (any loop state with rem, dcode and the geometry fields: K1/K2's State,
// K4's SimpleState in csrc/track_simple.cu)
template <class S>
__device__ void period_geometry(S& s, const Params& P) {
  s.delta = __fmul_rn(s.dcode, P.inv_fs);
  s.code_step = __fadd_rn(P.nominal_step, s.delta);
  const float spcd = __fmul_rn(P.spcf, s.delta);
  const float small = __fadd_rn(__fadd_rn(s.rem, P.c0), spcd);
  const float n_f = __fsub_rn(P.spcf, __fdiv_rn(small, s.code_step));
  const float n0 = floorf(__fadd_rn(n_f, 0.5f));
  const float rem0 = __fadd_rn(
      s.rem, __fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(n0, P.spcf),
                                           s.code_step), P.c0), spcd));
  const float addf = rem0 < 0.0f ? 1.0f : 0.0f;
  s.n = fminf(fmaxf(n0 + addf, 1.0f), (float)P.n_max);
}

__device__ __forceinline__ float nz(float x) {
  return fabsf(x) < 1e-20f ? 1e-20f : x;
}

__device__ __forceinline__ float mag(float re, float im) {
  return sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

// i mod m for the small non-negative integers the secondary counter holds,
// in float32 as the TPU kernel computes it
__device__ __forceinline__ float fmod_period(float i, float m) {
  return __fsub_rn(i, __fmul_rn(m, floorf(i / m)));
}

// the FDMA carrier step (2 pi / fs) * dop + w_off, rounded once
template <class S>
__device__ __forceinline__ float fdma_step(const S& s, const Params& P) {
  return __fmaf_rn(TWO_PI * P.inv_fs, s.dop, s.w_off);
}

// ph - 2 pi floor(ph / 2 pi) for the FDMA ramp: the quotient as a product
// with float32(1 / 2 pi), the difference one fused multiply-add
__device__ __forceinline__ float fdma_reduce(float ph) {
  return __fmaf_rn(-TWO_PI, floorf(__fmul_rn(ph, INV_TWO_PI)), ph);
}

// accumulation, discriminators, loop filters and NCO advance for one
// period (the per-channel section); fills the output row unless row is
// null (every thread of a CTA may run it; one writes the row). taps holds
// the 2T tap sums, then with PILOT the data prompt's two; sec_p and sec_d
// are the channel's secondary rows (PILOT only)
template <int T, bool PILOT, bool FDMA = false>
__device__ void close_loop(State<T>& s, const Params& P,
                           const PilotOf<PILOT>& pl, const float* taps,
                           float* row, const float* sec_p,
                           const float* sec_d) {
  constexpr int p = T / 2;
  const bool eng = s.en > 0.5f;
  // the secondary chips of this period, once the host engaged them
  float wipe_p = 1.0f, wipe_d = 1.0f;
  if constexpr (PILOT) {
    const bool act = s.sec_act > 0.5f;
    if (act && pl.sp > 1)
      wipe_p = sec_p[(int)fmod_period(s.sec_idx, (float)pl.sp)];
    if (act && pl.sd > 1)
      wipe_d = sec_d[(int)fmod_period(s.sec_idx, (float)pl.sd)];
    for (int j = 0; j < 2 * T; ++j)
      s.acc[j] = __fadd_rn(s.acc[j], __fmul_rn(taps[j], wipe_p));
  } else {
    for (int j = 0; j < 2 * T; ++j) s.acc[j] = s.acc[j] + taps[j];
  }
  const float acc_n_new = s.acc_n + s.n;
  const float icount_new = eng ? s.icount + 1.0f : 0.0f;
  const bool boundary = (icount_new >= s.integ_len) && eng;
  const float bf = boundary ? 1.0f : 0.0f;
  float accd_re_new, accd_im_new, sec_next;
  bool data_boundary;
  if constexpr (PILOT) {
    // the data prompt, its own secondary wiped; a symbol closes on the
    // last chip of the data secondary
    accd_re_new = __fadd_rn(s.accd_re, __fmul_rn(taps[2 * T], wipe_d));
    accd_im_new = __fadd_rn(s.accd_im, __fmul_rn(taps[2 * T + 1], wipe_d));
  } else {
    accd_re_new = s.accd_re + taps[2 * p];
    accd_im_new = s.accd_im + taps[2 * p + 1];
  }
  const float accd_cnt_new = s.accd_cnt + 1.0f;
  if constexpr (PILOT) {
    data_boundary = pl.sd > 1
        ? (fmod_period(s.sec_idx, (float)pl.sd) == (float)(pl.sd - 1)) && eng
        : eng;
  } else {
    data_boundary = eng;
  }
  const float dbf = data_boundary ? 1.0f : 0.0f;
  const float sec_n = s.sec_idx + 1.0f;
  if constexpr (PILOT) {
    sec_next = eng ? fmod_period(sec_n, (float)pl.lcm) : s.sec_idx;
  } else {
    // one secondary chip per period: the counter wraps every period
    sec_next = eng ? sec_n - floorf(sec_n) : s.sec_idx;
  }

  // discriminators on the accumulated taps
  const float t_int = acc_n_new * P.inv_fs;
  const float p_re = s.acc[2 * p], p_im = s.acc[2 * p + 1];
  const float costas = atanf(p_im / nz(p_re));
  const float carr_err =
      (s.atan2_flag > 0.5f ? atan2f(p_im, p_re) : costas) / TWO_PI;
  const float cross = __fsub_rn(__fmul_rn(s.prev_re, p_im),
                                __fmul_rn(s.prev_im, p_re));
  const float dot = __fadd_rn(__fmul_rn(s.prev_re, p_re),
                              __fmul_rn(s.prev_im, p_im));
  const float freq_err =
      atanf(cross / nz(dot)) / (TWO_PI * fmaxf(t_int, 1e-20f));
  const float e_re = s.acc[2 * (p - 1)], e_im = s.acc[2 * (p - 1) + 1];
  const float l_re = s.acc[2 * (p + 1)], l_im = s.acc[2 * (p + 1) + 1];
  const float e_mag = mag(e_re, e_im);
  const float l_mag = mag(l_re, l_im);
  float code_err;
  if constexpr (T == 5) {
    // VEML: the very early and very late taps join the early and late ones
    const float ve = mag(s.acc[0], s.acc[1]), vl = mag(s.acc[8], s.acc[9]);
    const float em = e_mag + ve, lm = l_mag + vl;
    code_err = 0.5f * (em - lm) / fmaxf(em + lm, 1e-20f);
  } else {
    code_err = 0.5f * (e_mag - l_mag) / fmaxf(e_mag + l_mag, 1e-20f);
  }

  // loop filters (boundary-gated)
  const float fll_add =
      (boundary && s.fll > 0.5f) ? P.w0f * P.w0f * freq_err * t_int : 0.0f;
  const float pll_i1_a = __fadd_rn(s.pll_i1, fll_add);
  const float w0p = s.w0p, w0d = s.w0d;
  float pll_i1_u, pll_i2_u, pll_out;
  if (P.pll_order == 1) {
    pll_i1_u = pll_i1_a;
    pll_i2_u = s.pll_i2;
    pll_out = 4.0f * s.pll_bw * carr_err;
  } else if (P.pll_order == 2) {
    pll_i1_u = __fadd_rn(pll_i1_a, w0p * w0p * carr_err * t_int);
    pll_i2_u = s.pll_i2;
    pll_out = __fadd_rn(pll_i1_u, 1.414f * w0p * carr_err);
  } else {
    pll_i2_u = __fadd_rn(s.pll_i2, (w0p * w0p * w0p) * carr_err * t_int);
    pll_i1_u = __fadd_rn(
        pll_i1_a,
        t_int * __fadd_rn(pll_i2_u, 1.1f * w0p * w0p * carr_err));
    pll_out = __fadd_rn(pll_i1_u, 2.4f * w0p * carr_err);
  }
  float dll_i1_u, dll_i2_u, dll_out;
  if (P.dll_order == 1) {
    dll_i1_u = s.dll_i1;
    dll_i2_u = s.dll_i2;
    dll_out = 4.0f * s.dll_bw * code_err;
  } else if (P.dll_order == 2) {
    dll_i1_u = __fadd_rn(s.dll_i1, w0d * w0d * code_err * t_int);
    dll_i2_u = s.dll_i2;
    dll_out = __fadd_rn(dll_i1_u, 1.414f * w0d * code_err);
  } else {
    dll_i2_u = __fadd_rn(s.dll_i2, (w0d * w0d * w0d) * code_err * t_int);
    dll_i1_u = __fadd_rn(
        s.dll_i1,
        t_int * __fadd_rn(dll_i2_u, 1.1f * w0d * w0d * code_err));
    dll_out = __fadd_rn(dll_i1_u, 2.4f * w0d * code_err);
  }
  const float pll_i1_n = boundary ? pll_i1_u : s.pll_i1;
  const float pll_i2_n = boundary ? pll_i2_u : s.pll_i2;
  const float dll_i1_n = boundary ? dll_i1_u : s.dll_i1;
  const float dll_i2_n = boundary ? dll_i2_u : s.dll_i2;
  const float doppler_new = boundary ? pll_out : s.dop;
  const float dcode_new =
      boundary ? __fsub_rn(__fmul_rn(doppler_new, P.aid_ratio), dll_out)
               : s.dcode;

  // NCO advance over the consumed period, at the Doppler in force during it
  float phase_adv;
  if constexpr (FDMA) {
    phase_adv = __fmaf_rn(fdma_step(s, P), s.n, s.phase);
    phase_adv = __fmaf_rn(-TWO_PI, floorf(__fdiv_rn(phase_adv, TWO_PI)),
                          phase_adv);
  } else {
    const float dphi = (TWO_PI * P.inv_fs) * s.dop * s.n;
    phase_adv = __fadd_rn(s.phase, dphi);
    phase_adv = __fsub_rn(phase_adv,
                          __fmul_rn(TWO_PI, floorf(phase_adv / TWO_PI)));
  }
  const float rem_adv = fmaxf(
      __fadd_rn(s.rem,
                __fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(s.n, P.spcf),
                                              s.code_step), P.c0),
                          __fmul_rn(P.spcf, s.delta))), 0.0f);
  const int pos_new = eng ? s.pos + (int)s.n : s.pos;
  const float rem_new = eng ? rem_adv : s.rem;
  const float phase_new = eng ? phase_adv : s.phase;
  const float dop_out = eng ? doppler_new : s.dop;
  const float dcode_out = eng ? dcode_new : s.dcode;
  const float prev_re_n = boundary ? p_re : s.prev_re;
  const float prev_im_n = boundary ? p_im : s.prev_im;
  const float icount_out = boundary ? 0.0f : icount_new;

  if (row != nullptr) {
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
  }

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

template <int T, bool FDMA = false>
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
  s.sec_act = sc[S_SEC_ACT];
  if constexpr (FDMA) s.w_off = sc[S_ACC0 + 2 * T];
  s.w0p = s.pll_bw / P.pll_div;
  s.w0d = s.dll_bw / P.dll_div;
}

// ---- the staged per-sample step ------------------------------------------

// The code index of a tap phase: the tap phases of one period lie within a
// few chips of [0, code_len), so one conditional add or subtract gives what
// % gives; % is kept for an index outside [-code_len, 2 code_len)
// (ops/track_kernel_blocked.py::wrap_code_index is the same rule).
__device__ __forceinline__ int wrap_index(int m, int code_len) {
  int r = m < 0 ? m + code_len : (m >= code_len ? m - code_len : m);
  if ((unsigned)r >= (unsigned)code_len) {
    r = m % code_len;
    if (r < 0) r += code_len;
  }
  return r;
}

// soft replica with the reciprocal code step (inv_step = 1 / step, once a
// period) and the comparison wrap
template <bool INTERP>
__device__ __forceinline__ float replica_staged(const float* code,
                                                int code_len, float tap_ph,
                                                float inv_step) {
  if (INTERP) {
    const float fl = floorf(tap_ph + 0.5f);
    const int m = wrap_index((int)fl, code_len);
    const int mp = m == 0 ? code_len - 1 : m - 1;
    const float cur = code[m];
    const float prev = code[mp];
    const float w = fminf(fmaxf((tap_ph - fl) * inv_step + 0.5f, 0.0f), 1.0f);
    return prev + (cur - prev) * w;
  }
  return code[wrap_index((int)floorf(tap_ph), code_len)];
}

// the geometry of one period, as every thread of a CTA uses it
struct Geo {
  int pos, n;
  float rem, step, inv_step, ph0, dstep;
};

template <bool FDMA = false, class S>
__device__ __forceinline__ Geo geo_of(const S& s, const Params& P) {
  Geo g;
  g.pos = (int)s.pos;
  g.n = (int)s.n;
  g.rem = s.rem;
  g.step = s.code_step;
  g.inv_step = __frcp_rn(s.code_step);
  g.ph0 = s.phase;
  if constexpr (FDMA)
    g.dstep = fdma_step(s, P);
  else
    g.dstep = (TWO_PI * P.inv_fs) * s.dop;
  return g;
}

// sample k of the period (already in registers): carrier wipeoff at the
// phase ramp ph0 + dstep * k (sincos_reduced), the soft replica at the code
// phase rem + step * k (replica_staged), with contraction allowed in the
// wipeoff and the tap products; the two phase ramps stay single-rounded
// fmaf as the plain version rounds them. With PILOT, accumulator T takes
// the data code's replica at offset 0 (the data prompt). With FDMA the
// carrier phase is reduced mod 2 pi first (fdma_reduce), then
// sincos_reduced reduces it again to [-pi, pi], as the TPU kernel's
// floor and its sincos do.
template <int T, bool INTERP, bool PILOT, bool FDMA = false>
__device__ __forceinline__ void accumulate_staged(
    float2 x, const float* code, const float* dcode, int code_len,
    const float* offs, float kf, const Geo& g, float* acc_re,
    float* acc_im) {
  float sw, cw;
  if constexpr (FDMA)
    sincos_reduced(fdma_reduce(fmaf(g.dstep, kf, g.ph0)), &sw, &cw);
  else
    sincos_reduced(fmaf(g.dstep, kf, g.ph0), &sw, &cw);
  const float wr = x.x * cw + x.y * sw;
  const float wi = x.y * cw - x.x * sw;
  const float cph = fmaf(g.step, kf, g.rem);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float v = replica_staged<INTERP>(code, code_len, cph + offs[t],
                                           g.inv_step);
    acc_re[t] += wr * v;
    acc_im[t] += wi * v;
  }
  if constexpr (PILOT) {
    const float v = replica_staged<INTERP>(dcode, code_len, cph, g.inv_step);
    acc_re[T] += wr * v;
    acc_im[T] += wi * v;
  }
}

// ---- the shared-memory sample ring (K1, K2, K4) -------------------------

// How a CTA walks its slice of every period: the slice [lo, lo + width) of
// the period's samples (K2: lo = 0 and width = n_max rounded up to the copy
// alignment; K1 and K4: CTA r of R takes lo = r * width), cut into nch
// chunks of `chunk` samples, each staged into one of two ring slots of
// slotw = chunk + 2 samples (one more on each side for the 16-byte
// alignment).
// Chunk g of the stream (period g / nch) goes to slot g % 2.
struct RingShape {
  int width, chunk, nch, slotw;
};

constexpr int RING_CHUNK_MAX = 8192;   // samples a slot holds (64 KB)
constexpr int COPY_ALIGN = 2;          // samples: 16 bytes of float2

__host__ __device__ inline RingShape ring_shape(int width) {
  RingShape r;
  r.width = width;
  r.nch = (width + RING_CHUNK_MAX - 1) / RING_CHUNK_MAX;
  if (r.nch < 1) r.nch = 1;
  r.chunk = (width + r.nch - 1) / r.nch;
  r.chunk = (r.chunk + COPY_ALIGN - 1) / COPY_ALIGN * COPY_ALIGN;
  r.slotw = r.chunk + COPY_ALIGN;
  return r;
}

// Dynamic shared memory of a tracker CTA (K1, K2, K4): the ring's two
// slots, the channel's code table, and with PILOT its data code table and
// its two secondary rows (SEC_MAX chips each).
__host__ __device__ inline size_t track_smem_bytes(const RingShape& R,
                                                   int code_len, bool pilot) {
  return (size_t)2 * R.slotw * sizeof(float2)
         + (size_t)code_len * sizeof(float) * (pilot ? 2 : 1)
         + (pilot ? (size_t)2 * SEC_MAX * sizeof(float) : 0);
}

// Stage channel c's pilot tables into shared memory after its code table
// (s_dcode = s_code + code_len): the data code, then the secondary rows
// (a row's chips past its width read 1).
__device__ __forceinline__ void stage_pilot(const Pilot& pl, int c,
                                            int code_len, float* s_dcode,
                                            int tid, int nthreads) {
  float* s_sec = s_dcode + code_len;
  for (int i = tid; i < code_len; i += nthreads)
    s_dcode[i] = pl.dcodes[(size_t)c * code_len + i];
  for (int i = tid; i < SEC_MAX; i += nthreads) {
    s_sec[i] = i < pl.sec_wp ? pl.sec_p[(size_t)c * pl.sec_wp + i] : 1.0f;
    s_sec[SEC_MAX + i] =
        i < pl.sec_wd ? pl.sec_d[(size_t)c * pl.sec_wd + i] : 1.0f;
  }
}

// 1 when window[idx] is 16-byte aligned for odd idx (the stream starts 8
// bytes past a 16-byte boundary), else 0
__device__ __forceinline__ int odd_alignment(const float2* window) {
  return (int)((reinterpret_cast<uintptr_t>(window) >> 3) & 1);
}

// Producer warp: stage chunk g, whose first sample is window[start], into
// its slot. The slot holds window[g0 .. g0 + slotw) with g0 = start rounded
// down to 16 bytes. The 16-byte-aligned part inside the window comes by one
// bulk copy; the lanes store the rest (the aligned edges, and zeros outside
// the window). The slot's full barrier expects 32 arrivals (one a lane) and
// the copy's bytes. Before reusing a slot the warp waits until the consumer
// warps have released it.
__device__ __forceinline__ void ring_produce(
    const float2* __restrict__ window, int window_len, float2* ring,
    uint64_t* full, uint64_t* empty, const RingShape& R, int g, int start,
    int lane) {
  const int s = g & 1;
  if (g >= 2) mbar_wait(&empty[s], ((g >> 1) - 1) & 1);
  const int a0 = odd_alignment(window);
  const int g0 = start - ((start + a0) & 1);
  int lo = max(g0, 0);
  lo += (lo + a0) & 1;
  int hi = min(g0 + R.slotw, window_len);
  hi -= (hi + a0) & 1;
  if (hi < lo) hi = lo;
  float2* dst = ring + s * R.slotw;
  const int front = min(lo - g0, R.slotw);
  const int back = max(min(hi - g0, R.slotw), front);
  for (int e = lane; e < front; e += 32) {
    const int idx = g0 + e;
    dst[e] = (idx >= 0 && idx < window_len) ? window[idx]
                                            : make_float2(0.0f, 0.0f);
  }
  for (int e = back + lane; e < R.slotw; e += 32) {
    const int idx = g0 + e;
    dst[e] = (idx >= 0 && idx < window_len) ? window[idx]
                                            : make_float2(0.0f, 0.0f);
  }
  if (lane == 0) {
    const uint32_t bytes = (uint32_t)(hi - lo) * (uint32_t)sizeof(float2);
    mbar_arrive_tx(&full[s], bytes);
    if (bytes) bulk_load(dst + (lo - g0), window + lo, bytes, &full[s]);
  } else {
    mbar_arrive(&full[s]);
  }
}

// Producer warp, once a period `it` whose geometry it holds: stage every
// chunk it may without waiting on a slot that only the next period frees,
// so that it reaches the period's barrier: the rest of period it, then the
// first chunks (up to two) of period it + 1, which starts at pos_next
// (pos + n, or pos for a disabled channel). Returns the next chunk index.
__device__ __forceinline__ int ring_produce_period(
    const float2* __restrict__ window, int window_len, float2* ring,
    uint64_t* full, uint64_t* empty, const RingShape& R, int g_next, int it,
    int n_periods, int lo, int pos, int pos_next, int lane) {
  const int limit = min((it + 1) * R.nch + min(R.nch, 2), n_periods * R.nch);
  for (; g_next < limit; ++g_next) {
    const int p = g_next / R.nch;
    const int c = g_next - p * R.nch;
    ring_produce(window, window_len, ring, full, empty, R, g_next,
                 (p == it ? pos : pos_next) + lo + c * R.chunk, lane);
  }
  return g_next;
}

// Consumer warps, once a period: each thread (ctid of nct) adds its samples
// of this CTA's slice [lo, lo + len) of period `it` (geometry g) to its 2T
// tap partials (2T + 2 with PILOT, the data prompt last), chunk by chunk as
// the slots fill; each warp releases a slot when it is done with it.
template <int T, bool INTERP, bool PILOT, bool FDMA = false>
__device__ __forceinline__ void ring_consume_period(
    const float2* __restrict__ window, const float2* ring, uint64_t* full,
    uint64_t* empty, const RingShape& R, const float* code,
    const float* dcode, int code_len, const float* offs, const Geo& g,
    int it, int lo, int len, int ctid, int nct, int lane, float* acc_re,
    float* acc_im) {
  const int a0 = odd_alignment(window);
  for (int c = 0; c < R.nch; ++c) {
    const int gi = it * R.nch + c;
    const int s = gi & 1;
    const int start = g.pos + lo + c * R.chunk;
    const float2* src = ring + s * R.slotw + ((start + a0) & 1);
    const int j0 = c * R.chunk;
    const int j1 = min(len, j0 + R.chunk);
    mbar_wait(&full[s], (gi >> 1) & 1);
    for (int j = j0 + ctid; j < j1; j += nct)
      accumulate_staged<T, INTERP, PILOT, FDMA>(src[j - j0], code, dcode,
                                          code_len, offs, (float)(lo + j), g,
                                          acc_re, acc_im);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// ---- the cluster mapping (K1 and K4) ------------------------------------

constexpr int NCW = 8;                         // consumer warps
constexpr int RING_THREADS = (NCW + 1) * 32;   // + the producer warp

// One channel is a thread-block cluster of `ranks` CTAs (grid ranks * C).
// CTA r takes samples [r * S, min((r + 1) * S, n)) of each period, S =
// R.width, and stages its slice of the next period into its ring while its
// 8 consumer warps run accumulate_staged on the current one. Each consumer
// warp writes its tap partials into its CTA's shared memory, in a slot
// chosen by the period's parity; then one cluster barrier; then warp 0 of
// every CTA reads the ranks x 8 partials over distributed shared memory in
// rank order (so every CTA gets the same bits), runs the loop closure
// redundantly, and hands the next period's geometry to its CTA through one
// __syncthreads; rank 0 stores the row. One cluster barrier and one CTA
// barrier a period.
//
// The loop policy `Loop` (BlockedLoop in csrc/track_blocked.cu, SimpleLoop
// in csrc/track_simple.cu) carries what differs between the trackers:
//   Loop::T                        taps
//   Loop::PILOT                    the pilot mode: the data prompt's tap,
//                                  and loop.pilot (a Pilot) to stage the
//                                  data code and secondary tables from
//   Loop::FDMA                     the FDMA mode: the carrier step and
//                                  the ramp's reduction (St then carries
//                                  w_off)
//   Loop::St                       the loop state (warp 0 of each CTA holds
//                                  it), with pos, rem, dcode, phase, dop and
//                                  the geometry fields delta, code_step, n
//   Loop::advances(sc)             whether the channel's position moves on
//                                  (the producer's next start)
//   loop.load(st, sc, pos_in, c, P)   the channel's state from its scalars
//   loop.close(st, P, taps, row, sec_p, sec_d)
//                                  the closure of one period (taps: 2T
//                                  sums, then the data prompt's 2 with
//                                  PILOT; sec_p, sec_d: the channel's
//                                  secondary rows in shared memory); it
//                                  writes the row's lanes unless row is
//                                  null (the other lanes stay zero)
template <class Loop, bool INTERP>
__global__ void __launch_bounds__(RING_THREADS)
cluster_track_kernel(const float2* __restrict__ window,
                     const float* __restrict__ codes,
                     const float* __restrict__ scalars,
                     const int* __restrict__ pos_in,
                     float* __restrict__ out, const Params P,
                     const RingShape R, int ranks, const Loop loop) {
  constexpr int T = Loop::T;
  constexpr bool PILOT = Loop::PILOT;
  constexpr bool FDMA = Loop::FDMA;
  constexpr int NT = 2 * (T + (PILOT ? 1 : 0));   // sums a period
  namespace cg = cooperative_groups;
  // [2][slotw] ring slots, then the tables (track_smem_bytes)
  extern __shared__ float4 smem4[];
  float2* ring = reinterpret_cast<float2*>(smem4);
  float* s_code = reinterpret_cast<float*>(ring + 2 * R.slotw);
  const float* s_dcode = s_code + P.code_len;
  const float* s_sec = s_dcode + P.code_len;
  __shared__ uint64_t full[2], empty[2];
  __shared__ float s_part[2][NCW][NT];
  __shared__ __align__(16) float s_row[LANES];
  __shared__ Geo s_geo;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / ranks;
  const int lo = rank * R.width;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* sc = scalars + (size_t)c * P.ns;

  for (int i = tid; i < P.code_len; i += RING_THREADS)
    s_code[i] = codes[(size_t)c * P.code_len + i];
  if constexpr (PILOT)
    stage_pilot(loop.pilot, c, P.code_len, s_code + P.code_len, tid,
                RING_THREADS);
  for (int i = tid; i < LANES; i += RING_THREADS) s_row[i] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], NCW);
    }
    mbar_init_fence();
  }
  const bool en = Loop::advances(sc);

  // warp 0 carries the loop state
  typename Loop::St st;
  if (warp == 0) {
    loop.load(st, sc, pos_in, c, P);
    period_geometry(st, P);
    if (lane == 0) s_geo = geo_of<FDMA>(st, P);
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
      float acc_re[NT / 2], acc_im[NT / 2];
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) acc_re[t] = acc_im[t] = 0.0f;
      ring_consume_period<T, INTERP, PILOT, FDMA>(
          window, ring, full, empty, R, s_code, s_dcode, P.code_len, offs, g,
          it, lo, len, tid, NCW * 32, lane, acc_re, acc_im);
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
    cluster.sync();

    if (warp == 0) {
      // lane j < NT adds sum j over the ranks, then the warps, in order
      float v = 0.0f;
      if (lane < NT) {
        for (int q = 0; q < ranks; ++q) {
          const float* part = cluster.map_shared_rank(&s_part[it & 1][0][0], q);
          for (int w = 0; w < NCW; ++w) v += part[w * NT + lane];
        }
      }
      float taps[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        taps[j] = __shfl_sync(0xffffffffu, v, j);
      loop.close(st, P, taps, (rank == 0 && lane == 0) ? s_row : nullptr,
                 s_sec, s_sec + SEC_MAX);
      period_geometry(st, P);
      if (lane == 0) s_geo = geo_of<FDMA>(st, P);
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

// cudaSuccess when a CTA of `kernel` with `smem` bytes of dynamic shared
// memory fits the card's opt-in limit per block (227 KB on an H100), and
// then allows it past 48 KB; cudaErrorInvalidValue when it does not fit.
// *need (if set) gets the CTA's whole shared memory, *limit the limit.
template <class K>
cudaError_t allow_smem(K* kernel, size_t smem, int* need = nullptr,
                       int* limit = nullptr) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  int dev = 0, optin = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const size_t total = smem + fa.sharedSizeBytes;
  if (need != nullptr) *need = (int)total;
  if (limit != nullptr) *limit = optin;
  if (total > (size_t)optin) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

// The launch configuration of cluster_track_kernel<Loop, INTERP>: grid
// c * ranks, clusters of `ranks`, the ring and the tables in dynamic shared
// memory (allowed past 48 KB here); *err is cudaErrorInvalidValue when
// they do not fit.
template <class Loop, bool INTERP>
cudaLaunchConfig_t cluster_config(int c, int ranks, const RingShape& R,
                                  const Params& P, cudaStream_t stream,
                                  cudaLaunchAttribute* attr,
                                  cudaError_t* err) {
  const size_t smem = track_smem_bytes(R, P.code_len, Loop::PILOT);
  *err = allow_smem(cluster_track_kernel<Loop, INTERP>, smem);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * ranks);
  cfg.blockDim = dim3(RING_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class Loop, bool INTERP>
cudaError_t cluster_launch(const float2* window, const float* codes,
                           const float* scalars, const int* pos, float* out,
                           int c, int ranks, int width, const Params& P,
                           const Loop& loop, cudaStream_t stream) {
  const RingShape R = ring_shape(width);
  cudaLaunchAttribute attr;
  cudaError_t e;
  const cudaLaunchConfig_t cfg =
      cluster_config<Loop, INTERP>(c, ranks, R, P, stream, &attr, &e);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, cluster_track_kernel<Loop, INTERP>, window,
                         codes, scalars, pos, out, P, R, ranks, loop);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many clusters of `ranks` CTAs (slices of `width` samples, a
// P.code_len-chip table) the card holds at once, into *n: 0 when one CTA's
// shared memory passes the card's limit.
template <class Loop, bool INTERP>
cudaError_t cluster_max(int c, int ranks, int width, const Params& P,
                        int* n) {
  cudaLaunchAttribute attr;
  cudaError_t e;
  const cudaLaunchConfig_t cfg = cluster_config<Loop, INTERP>(
      c, ranks, ring_shape(width), P, 0, &attr, &e);
  if (e == cudaErrorInvalidValue) {
    *n = 0;
    return cudaSuccess;
  }
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(n, cluster_track_kernel<Loop, INTERP>,
                                        &cfg);
}

// ranks a power of two <= 8, width even and ranks * width >= n_max
inline bool valid_cluster_shape(int c, int ranks, int width, int n_max) {
  return c > 0 && ranks >= 1 && ranks <= 8 && (ranks & (ranks - 1)) == 0
         && width > 0 && width % COPY_ALIGN == 0
         && (long long)ranks * width >= n_max;
}

}  // namespace
