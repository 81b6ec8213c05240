// Fused K-period tracker (K1): closed-loop DLL/PLL/FLL tracking of C
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
// channel is only ~2600 samples (GPS L1 C/A at 2.6 Msps; 16000 for Galileo
// E1 at 4 Msps): about 2600 x 8 B of window reads, which would take well
// under a microsecond at 3.35 TB/s. At the receiver's C = 8 one CTA per
// channel would leave 124 of 132 SMs idle, and each period pays for its
// samples' arithmetic, the tap reduction and a serial discriminator/loop-
// filter section.
//
// What the design does about it: grid R * C, launched with a cluster of R
// CTAs per channel (cudaLaunchKernelEx), R the largest power of two <= 8
// with R * C <= the card's SM count, 132 on an H100 SXM
// (ops/track_kernel_blocked.py::cluster_shape, which halves R while the
// occupancy query says the C clusters do not fit at once). The kernel is
// csrc/track_loop.cuh's cluster_track_kernel, which K4 (csrc/track_simple.cu)
// runs too: CTA r takes samples [r * S, min((r + 1) * S, n)) of each period
// and stages its slice of the next period into a two-slot shared-memory ring
// exactly as K2 does (one producer warp, cp.async.bulk on an mbarrier),
// while its 8 consumer warps run the staged per-sample step on the current
// one; one cluster barrier, then warp 0 of every CTA reads the R x 8
// partials over distributed shared memory in rank order and runs the
// closure below; one CTA barrier hands on the geometry. This file supplies
// K1's loop policy: the State<T> of the slots, load_state and close_loop
// (extended integration, FLL, the atan2 flag, enabled gating, NELP at
// T = 3 and VEML at T = 5, the pilot/secondary mode, and FDMA, the
// per-channel carrier offset of GLONASS: three more float operations a
// sample, the ramp's reduction mod 2 pi). Each CTA holds
// its channel's code table in shared memory, and in pilot mode the data
// code and the two secondary rows too (2 x 32 KB + 1 KB at E1's 8184-unit
// sinBOC tables).

#include "track_loop.cuh"

namespace {

// the pilot mode's tables, held by the policy that needs them (an empty
// base without the pilot mode, so that the GPS kernels' arguments stay
// what they were)
template <bool PL>
struct PilotHolder {};
template <>
struct PilotHolder<true> {
  Pilot pilot;
};

// K1's loop policy for cluster_track_kernel (FD: the FDMA mode)
template <int NT, bool PL, bool FD = false>
struct BlockedLoop : PilotHolder<PL> {
  static constexpr int T = NT;
  static constexpr bool PILOT = PL;
  static constexpr bool FDMA = FD;
  using St = State<NT>;
  // a disabled channel stays where it is
  __device__ static bool advances(const float* sc) { return sc[S_EN] > 0.5f; }
  __device__ void load(St& s, const float* sc, const int* pos_in, int c,
                       const Params& P) const {
    load_state<NT, FD>(s, sc, pos_in[c], P);
  }
  __device__ void close(St& s, const Params& P, const float* taps,
                        float* row, const float* sec_p,
                        const float* sec_d) const {
    if constexpr (PL)
      close_loop<NT, true, FD>(s, P, this->pilot, taps, row, sec_p, sec_d);
    else
      close_loop<NT, false, FD>(s, P, NoPilot{}, taps, row, sec_p, sec_d);
  }
};

template <int NT, bool PL, bool FD>
cudaError_t dispatch(bool interp, const float2* w, const float* cd,
                     const float* sc, const int* ps, float* o, int c,
                     int ranks, int width, const Params& P,
                     const Pilot& pilot, cudaStream_t s) {
  using L = BlockedLoop<NT, PL, FD>;
  L loop{};
  if constexpr (PL) loop.pilot = pilot;
  return interp ? cluster_launch<L, true>(w, cd, sc, ps, o, c, ranks, width,
                                          P, loop, s)
                : cluster_launch<L, false>(w, cd, sc, ps, o, c, ranks, width,
                                           P, loop, s);
}

template <int NT, bool PL, bool FD>
cudaError_t max_clusters(bool interp, int c, int ranks, int width,
                         const Params& P, int* n) {
  using L = BlockedLoop<NT, PL, FD>;
  return interp ? cluster_max<L, true>(c, ranks, width, P, n)
                : cluster_max<L, false>(c, ranks, width, P, n);
}

template <int NT, bool PL, bool FD>
cudaError_t smem(bool interp, int width, const Params& P, int* need,
                 int* limit) {
  using L = BlockedLoop<NT, PL, FD>;
  const size_t b = track_smem_bytes(ring_shape(width), P.code_len, PL);
  return interp ? allow_smem(cluster_track_kernel<L, true>, b, need, limit)
                : allow_smem(cluster_track_kernel<L, false>, b, need, limit);
}

// the instantiation for (num_taps, pilot, fdma): T = 3 or 5, with or
// without the pilot mode, with or without FDMA
#define GNSS_BLOCKED_PILOT(FN, T, FD, ...)                                 \
  (pilot ? FN<T, true, FD>(__VA_ARGS__) : FN<T, false, FD>(__VA_ARGS__))
#define GNSS_BLOCKED_TAPS(FN, FD, ...)                                     \
  (num_taps == 3 ? GNSS_BLOCKED_PILOT(FN, 3, FD, __VA_ARGS__)              \
                 : GNSS_BLOCKED_PILOT(FN, 5, FD, __VA_ARGS__))
#define GNSS_BLOCKED_SWITCH(FN, ...)                                       \
  (fdma ? GNSS_BLOCKED_TAPS(FN, true, __VA_ARGS__)                         \
        : GNSS_BLOCKED_TAPS(FN, false, __VA_ARGS__))

}  // namespace

// window (complex64 [L] as float2), codes (f32 [C, code_len]), scalars
// (f32 [C, ns]), pos (int32 [C]), out (f32 [C, K, 128]); num_taps 3 or 5;
// with fdma the carrier offset in scalar slot S_ACC0 + 2 num_taps; with
// track_pilot the data code (f32 [C, code_len]), the secondary rows
// sec_p (f32 [C, sec[0]]) and sec_d (f32 [C, sec[1]]) and sec = {sec_wp,
// sec_wd, sec_len_pilot, sec_len_data, sec_lcm} (csrc/track_loop.cuh
// make_pilot); ranks CTAs per channel (a power of two <= 8) each covering
// `width` samples of a period (even, ranks * width >= n_max).
extern "C" int gnss_track_blocked(const void* window, int window_len,
                                  const void* codes, int code_len,
                                  const void* scalars, int ns, const void* pos,
                                  void* out, int c, int n_periods, int n_max,
                                  const void* params, int num_taps,
                                  int pll_order, int dll_order,
                                  int interp_code, int track_pilot,
                                  int fdma_flag, const void* dcodes,
                                  const void* sec_p, const void* sec_d,
                                  const int* sec, int ranks, int width,
                                  void* stream) {
  if ((num_taps != 3 && num_taps != 5)
      || !valid_cluster_shape(c, ranks, width, n_max))
    return (int)cudaErrorInvalidValue;
  const Params P = make_params(static_cast<const float*>(params), num_taps,
                               window_len, code_len, ns, n_periods, n_max,
                               pll_order, dll_order);
  const bool pilot = track_pilot != 0;
  const bool fdma = fdma_flag != 0;
  Pilot pl = {};
  if (pilot && !make_pilot(pl, dcodes, sec_p, sec_d, sec))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = GNSS_BLOCKED_SWITCH(
      dispatch, interp_code != 0, static_cast<const float2*>(window),
      static_cast<const float*>(codes), static_cast<const float*>(scalars),
      static_cast<const int*>(pos), static_cast<float*>(out), c, ranks,
      width, P, pl, static_cast<cudaStream_t>(stream));
  return (int)e;
}

// How many clusters of `ranks` CTAs (slices of `width` samples, a
// `code_len`-chip table, num_taps taps, the pilot mode or not, FDMA or
// not) the card holds at once, into *n (0 when a CTA's shared memory does
// not fit).
extern "C" int gnss_track_blocked_max_clusters(int c, int code_len,
                                               int n_max, int interp_code,
                                               int num_taps, int track_pilot,
                                               int fdma_flag, int ranks,
                                               int width, int* n) {
  if ((num_taps != 3 && num_taps != 5)
      || !valid_cluster_shape(c, ranks, width, n_max))
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.code_len = code_len;
  P.n_max = n_max;
  const bool pilot = track_pilot != 0;
  const bool fdma = fdma_flag != 0;
  const cudaError_t e = GNSS_BLOCKED_SWITCH(max_clusters, interp_code != 0,
                                            c, ranks, width, P, n);
  return (int)e;
}

// The shared memory one K1 CTA needs for slices of `width` samples (*need,
// bytes, static included) and the card's opt-in limit per block (*limit);
// returns cudaErrorInvalidValue when need > limit.
extern "C" int gnss_track_blocked_smem(int code_len, int interp_code,
                                       int num_taps, int track_pilot,
                                       int fdma_flag, int width, int* need,
                                       int* limit) {
  if ((num_taps != 3 && num_taps != 5) || width <= 0)
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.code_len = code_len;
  const bool pilot = track_pilot != 0;
  const bool fdma = fdma_flag != 0;
  return (int)GNSS_BLOCKED_SWITCH(smem, interp_code != 0, width, P, need,
                                  limit);
}
