"""``Receiver(num_devices=2, device="cpu")`` against the port's unsharded
Receiver, which tests/test_torch_receiver.py holds to JAX's, on 0.3 s of
a GpsScenario capture: the same acquisitions, FSM phases, period counts
and final tracking states, bit for bit (two CPU shards run the same
per-channel arithmetic). The JAX Receiver with two devices alone takes
longer than a test file's budget on the CPU, so
tests/test_torch_parallel.py holds the port to JAX at the Tracker and
PCPS level instead.
"""

import dataclasses

import numpy as np
import torch

from conftest import cached_capture
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig

torch.set_num_threads(2)

FS = 2.6e6


def _scenario():
    return GpsScenario(ScenarioConfig(
        fs=FS, tow_start_s=7314.0, duration_s=0.3, cn0_dbhz=46.0,
        max_sats=4, seed=1))


def _run_receiver(num_devices, x, prns):
    rx = Receiver(ReceiverConfig(fs=FS, num_channels=4, device="cpu",
                                 num_devices=num_devices, search_prns=prns))
    cut = int(0.1 * FS)
    rx.feed(x[:cut])
    rx.acquire()
    rx.run()
    rx.feed(x[cut:])
    rx.run()
    return rx


def test_sharded_receiver_matches_unsharded():
    scen = _scenario()
    x = cached_capture("torch_parallel_0.3s",
                       lambda: scen.generate(0, scen.total_samples))
    prns = tuple(sorted(scen.prns)) + (2, 3)
    rx1, rx2 = _run_receiver(0, x, prns), _run_receiver(2, x, prns)
    assert rx1.mesh is None and rx2.mesh.size == 2
    assert rx2.groups[0].acq.mesh is rx2.mesh
    assert len(rx1.status.acquired) >= 3
    assert rx1.status.acquired == rx2.status.acquired
    for c1, c2 in zip(rx1.tracker.ctl, rx2.tracker.ctl, strict=True):
        assert (c1.phase, c1.prn, c1.total_periods) == (
            c2.phase, c2.prn, c2.total_periods)
    assert rx1.tracker.ctl[0].total_periods > 150
    for f in dataclasses.fields(rx1.tracker.state):
        np.testing.assert_array_equal(
            getattr(rx1.tracker.state, f.name).numpy(),
            getattr(rx2.tracker.state, f.name).numpy(), err_msg=f.name)
