"""``correct`` comes out false for each fault the replay cells can have,
planted in the port's timed path underneath an otherwise whole run of
the harness; and true for the run with no fault. Also the control: the
reference computed in float32 and put in the port's place fails the
limits.

The run skips the harness's look for a card (``device="cpu"``, the port's
plain kernels) and is cut to one 28 s gps8 file, long enough for the
ephemerides and the first fixes (about 24 s in), with one warm-up
second. Each run takes one to two minutes of one core; ``-n 4`` runs
them side by side.
"""

import math
import time

import numpy as np
import pytest

from rxbench import harness, reference

FILE_S = 28


def _cell():
    cell = harness.Cell("gps8.replay")
    cell.config = dict(cell.config, file_s=FILE_S)
    cell.traffic = dict(cell.traffic, pool_files=1, warm_s=1)
    return cell


def _run(keep=None):
    return harness.run("gps8.replay", 2**31 + 77, math.inf, False,
                       time.perf_counter(), device="cpu", keep=keep,
                       cell=_cell(), max_files=1)


def _state_unchanged(mp):
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    orig = Tracker._process

    def step(self, *a):
        old = self.state
        res = orig(self, *a)
        self.state = old            # the loop's state back as it was
        return res

    mp.setattr(Tracker, "_process", step)


def _half_channels(mp):
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    orig = Tracker._process

    def half(self, *a):
        en = self.state.enabled
        c = en.shape[0]
        kept = en.clone()
        kept[c // 2:] = False           # the upper half left out
        self.state = self.state.replace(enabled=kept)
        res = orig(self, *a)
        back = self.state.enabled.clone()
        back[c // 2:] = en[c // 2:]
        self.state = self.state.replace(enabled=back)
        return res

    mp.setattr(Tracker, "_process", half)


def _acquisition_altered(mp):
    from gnss_sdr_tpu_torch.acquisition.pcps import PcpsAcquisition

    orig = PcpsAcquisition.acquire

    def shifted(self, *a, **kw):
        res = orig(self, *a, **kw)
        res.delay_samples = res.delay_samples + 3.0
        return res

    mp.setattr(PcpsAcquisition, "acquire", shifted)


def _tracking_altered(mp):
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    orig = Tracker._process

    def shifted(self, *a):
        res = orig(self, *a)
        res.outputs["rem_code_phase"] = res.outputs["rem_code_phase"] + 0.3
        return res

    mp.setattr(Tracker, "_process", shifted)


def _ephemeris_altered(mp):
    from gnss_sdr_tpu_torch.telemetry.lnav import LnavDecoder

    orig = LnavDecoder.push_bits

    def altered(self, *a, **kw):
        events = orig(self, *a, **kw)
        if any(e.get("ephemeris_complete") for e in events):
            self.eph.af0 += 1e-6        # 300 m of clock
        return events

    mp.setattr(LnavDecoder, "push_bits", altered)


def _fix_altered(mp):
    from gnss_sdr_tpu_torch.receiver import receiver

    orig = receiver.solve_pvt

    def moved(*a, **kw):
        sol = orig(*a, **kw)
        sol.pos_ecef = np.asarray(sol.pos_ecef) + np.array([200.0, 0, 0])
        return sol

    mp.setattr(receiver, "solve_pvt", moved)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_channels": _half_channels,
          "acquisition_altered": _acquisition_altered,
          "tracking_altered": _tracking_altered,
          "ephemeris_altered": _ephemeris_altered,
          "fix_altered": _fix_altered}


@pytest.fixture(scope="module")
def sound():
    keep: dict = {}
    res = _run(keep)
    return res, keep


def test_sound_run_is_correct(sound):
    res, keep = sound
    assert res["correct"], res["checks"]
    assert keep["answers"][0].fixes, "the cut-down file gives no fix"


def test_control_is_not_correct(sound):
    _, keep = sound
    cell = keep["cell"]
    ctl = reference.control(cell.config, keep["geos"], keep["answers"],
                            cell.file_s, np.float32)
    over = [k for k in reference.NUMBERS if not ctl[k] <= cell.limits[k]]
    assert over, ctl


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run()
    assert not res["correct"], (fault, res["checks"])
