"""The realtime factor is taken over the whole window: a stall anywhere
in it lowers the factor."""

import time

import numpy as np

from rxbench import drive, harness


class _Tracker:
    conf = type("C", (), {"num_taps": 3, "track_pilot": False})()
    codes = np.zeros(1)
    data_codes = sec_pilot = sec_data = None
    ctl = []

    def process_device(self, *a):
        return None


class _Group:
    def __init__(self):
        self.tracker = _Tracker()
        self.plan = type("P", (), {"system": "G", "name": "1C"})()
        self.channel_prn = [0]

    def idle_channel(self):
        return None


class _Receiver:
    """Takes feeds and runs in a fixed time; ``stall`` adds to one run."""

    stall_at: int | None = None

    def __init__(self):
        self.groups = [_Group()]
        self.ephemerides, self.status = {}, type("S", (), {"fixes": []})()
        self.runs = 0

    def feed(self, x, band=None):
        pass

    def acquire(self):
        return {}

    def run(self, max_blocks=None):
        time.sleep(0.002)
        if self.runs == self.stall_at:
            time.sleep(0.05)
        self.runs += 1


def _factor(monkeypatch, stall_at):
    _Receiver.stall_at = stall_at
    monkeypatch.setattr(drive, "build_receiver", lambda cfg, device: _Receiver())
    cfg = {"bands": [{"band": "L1", "fs": 1000.0, "steps_per_block": 20}]}
    traffic = {"feed_s": 1.0, "acquire_feeds": 0}
    files = [[np.zeros(10_000, np.complex64)]]
    _, signal_s, wall_s = drive.replay(cfg, traffic, files, 10.0,
                                       device="cpu", max_files=2)
    assert signal_s == 20.0
    return harness.rate(signal_s, wall_s)


def test_stall_lowers_the_factor(monkeypatch):
    steady = _factor(monkeypatch, None)
    stalled = _factor(monkeypatch, 3)
    assert stalled < steady * 0.8
