"""Hand-written CUDA kernels and their plain PyTorch versions.

- ``track_kernel_blocked.track_blocked``: K code periods of closed-loop
  tracking for all channels in one launch, a thread-block cluster of R
  CTAs per channel (csrc/track_blocked.cu);
- ``track_kernel.track_full``: the same loop and rows, one CTA per
  channel (csrc/track_full.cu);
- ``correlator.correlator``: one period's multi-tap correlation, a
  thread-block cluster of R CTAs per channel (csrc/correlator.cu);
- ``track_kernel.track_simple``: K periods of the simple one-period CDMA
  loop (T = 3 or 5, no enabled gating) on K1's cluster kernel
  (csrc/track_simple.cu), driven by ``tools/kbench.py``.

The primitive-cost probe P1 (csrc/probe.cu) is launched from
``gnss_sdr_tpu_torch.tools.mosaic_probe``.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors. ``_build`` compiles the sources with nvcc at
first use.
"""
