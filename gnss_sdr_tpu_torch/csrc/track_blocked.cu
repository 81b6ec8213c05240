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
// K1's loop policy: the State<3> of the slots, load_state and close_loop
// (extended integration, FLL, the atan2 flag, enabled gating).

#include "track_loop.cuh"

namespace {

// K1's loop policy for cluster_track_kernel
template <int NT>
struct BlockedLoop {
  static constexpr int T = NT;
  using St = State<NT>;
  // a disabled channel stays where it is
  __device__ static bool advances(const float* sc) { return sc[S_EN] > 0.5f; }
  __device__ void load(St& s, const float* sc, const int* pos_in, int c,
                       const Params& P) const {
    load_state<NT>(s, sc, pos_in[c], P);
  }
  __device__ void close(St& s, const Params& P, const float* taps,
                        float* row) const {
    close_loop<NT>(s, P, taps, row);
  }
};

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
  if (num_taps != 3 || !valid_cluster_shape(c, ranks, width, n_max))
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
  const BlockedLoop<3> loop{};
  cudaError_t e = interp_code
      ? cluster_launch<BlockedLoop<3>, true>(w, cd, sc, ps, o, c, ranks,
                                             width, P, loop, s)
      : cluster_launch<BlockedLoop<3>, false>(w, cd, sc, ps, o, c, ranks,
                                              width, P, loop, s);
  return (int)e;
}

// How many clusters of `ranks` CTAs (slices of `width` samples, a
// `code_len`-chip table) the card holds at once, into *n.
extern "C" int gnss_track_blocked_max_clusters(int c, int code_len,
                                               int n_max, int interp_code,
                                               int ranks, int width,
                                               int* n) {
  if (!valid_cluster_shape(c, ranks, width, n_max))
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.code_len = code_len;
  P.n_max = n_max;
  const cudaError_t e = interp_code
      ? cluster_max<BlockedLoop<3>, true>(c, ranks, width, P, n)
      : cluster_max<BlockedLoop<3>, false>(c, ranks, width, P, n);
  return (int)e;
}
