"""Benchmark tools of the port, counterparts of the repository's ``tools/``.

- ``kbench``: the fused trackers K2 (``track_full``) and K4
  (``track_simple``) at C = 32, K = 200 on a noise window;
  ``python -m gnss_sdr_tpu_torch.tools.kbench [variant ...]``.
- ``mosaic_probe``: the primitive-cost probe P1 (``csrc/probe.cu``), each
  kernel body's cost per period inside a K = 2000 loop;
  ``python -m gnss_sdr_tpu_torch.tools.mosaic_probe``.

Both run on the card by default and raise without one; from Python,
``device="cpu"`` runs their plain versions at a size of the caller's
choosing.
"""
