"""Tools of the port, counterparts of the repository's ``tools/``.

- ``kbench``: the fused trackers K2 (``track_full``) and K4
  (``track_simple``) at C = 32, K = 200 on a noise window;
  ``python -m gnss_sdr_tpu_torch.tools.kbench [variant ...]``.
- ``mosaic_probe``: the primitive-cost probe P1 (``csrc/probe.cu``), each
  kernel body's cost per period inside a K = 2000 loop;
  ``python -m gnss_sdr_tpu_torch.tools.mosaic_probe``.
- ``front_end_cal``: the front-end LO error from PCPS Dopplers against
  assistance ephemerides;
  ``python -m gnss_sdr_tpu_torch.tools.front_end_cal --capture ...``.
- ``ttff``: cold and warm time to first fix of the ``Receiver``;
  ``python -m gnss_sdr_tpu_torch.tools.ttff [--trials N]``.
- ``bench_micro``: the reference's seven micro-benchmarks (sample decode,
  discriminators and the detector on the device, preamble, crypto, TESLA
  chain, Reed-Solomon); ``python -m gnss_sdr_tpu_torch.tools.bench_micro``.
- ``scaling``: ms per sharded tracking block at 1, 2, 4 and 8 channel
  shards and the ratio to one shard;
  ``python -m gnss_sdr_tpu_torch.tools.scaling [--device cuda|cpu]``.
- ``dist_worker``: one rank of the two-process ``torch.distributed`` dry
  run; ``python -m gnss_sdr_tpu_torch.tools.dist_worker <rank> <world>
  <port> <local_shards> [--device cuda|cpu] [--backend gloo|nccl]``.
- ``nav_listener``: a live channel table from the UDP monitor stream
  (``monitor/sinks.py``); ``python -m gnss_sdr_tpu_torch.tools.nav_listener
  [--port 1234] [--mode binary|json]``.
- ``skyplot``: satellites' azimuth and elevation from an assistance XML,
  as ASCII and SVG; ``python -m gnss_sdr_tpu_torch.tools.skyplot
  --assistance ... --lat ... --lon ... --tow ...``.

All but nav_listener and skyplot (host-only) run on the card by default
and raise without one; from Python, ``device="cpu"`` runs their plain
versions (kbench, mosaic_probe) or the CPU path at a size of the caller's
choosing.
"""
