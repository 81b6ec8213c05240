"""The port's tracer (``gnss_sdr_tpu_torch.utils.trace``): off it records
nothing, on it keeps each span's parent, ``collect()`` clears and drops
spans left open, and the tracking block and the feed open their spans
without changing what they compute."""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
from gnss_sdr_tpu_torch.tracking.tracker import Tracker
from gnss_sdr_tpu_torch.utils import trace

from torch_cases import C, DOPS, conf_kw, make_signal

TRACK_CHILDREN = ("track.pack", "track.launch", "track.unpack",
                  "track.to_host", "track.fsm")


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.collect()
    yield
    trace.disable()
    trace.collect()


def test_off_records_nothing():
    a, b = trace.span("x"), trace.span("y")
    assert a is b
    with a:
        trace.count("n", 3)
    trace.follow_profiler()
    with trace.span("z"):
        pass
    assert trace.collect() == ([], {})


def test_nesting_parents_and_clear():
    trace.enable()
    with trace.span("a"):
        with trace.span("b"):
            trace.count("n")
        with trace.span("c"):
            with trace.span("d"):
                trace.count("n", 2)
    with trace.span("e"):
        pass
    spans, counts = trace.collect()
    assert [(s[2], s[3]) for s in spans] == [
        ("a", -1), ("b", 0), ("c", 0), ("d", 2), ("e", -1)]
    assert all(t0 <= t1 for t0, t1, _, _ in spans)
    assert spans[0][0] <= spans[1][0] <= spans[1][1] <= spans[2][0]
    assert spans[2][1] <= spans[0][1] <= spans[4][0]
    assert counts == {"n": 3}
    assert trace.collect() == ([], {})


def test_unclosed_span_dropped():
    trace.enable()
    with trace.span("top"):
        held = trace.span("open")
        held.__enter__()
        with trace.span("inner"):
            pass
        spans, _ = trace.collect()
        held.__exit__(None, None, None)      # closed after collect: lost
    assert [(s[2], s[3]) for s in spans] == [("inner", -1)]
    assert trace.collect() == ([], {})


def _records(name):
    with trace.span(name):
        pass


def test_follows_the_profiler_unless_held(monkeypatch):
    # torch.profiler sets this flag while it records (the benchmark's
    # replay test runs a real profiler session, at more cost)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    trace.follow_profiler()
    _records("profiled")
    monkeypatch.undo()
    trace.follow_profiler()
    _records("after")
    trace.enable()
    trace.follow_profiler()
    _records("held")
    assert [s[2] for s in trace.collect()[0]] == ["profiled", "held"]


def _tracker_block():
    tbl = gps_l1_ca_code_table()[:C].astype(np.float32)
    trk = Tracker(DllPllConf(**conf_kw(fused_tracker=True)), tbl,
                  device="cpu")
    assert trk._block.fused
    for ch in range(C):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=0.0,
                          acq_doppler_hz=DOPS[ch] + 30.0,
                          acq_samplestamp=0, current_abs_sample=0)
    return trk.process(make_signal(tbl, 100_000), 0)


def test_tracker_block_spans_and_bit_equal_outputs():
    torch.set_num_threads(2)
    off = _tracker_block()
    trace.enable()
    on = _tracker_block()
    spans, counts = trace.collect()
    names = [s[2] for s in spans]
    assert names.count("track") == 1
    top = names.index("track")
    for child in TRACK_CHILDREN:
        # pack twice: the positions and tables in Tracker._process, the
        # scalars in _pack_scalars
        assert names.count(child) == (2 if child == "track.pack" else 1)
        for s in spans:
            if s[2] == child:
                assert s[3] == top
                assert spans[top][0] <= s[0] <= s[1] <= spans[top][1]
    assert counts["track.blocks"] == 1
    # four bandwidth constants, the positions and the code table
    assert counts["h2d.track.copies"] == 6
    assert counts["h2d.track.bytes"] == 4 * 4 + 4 * C + C * 1023 * 4
    assert set(on.outputs) == set(off.outputs)
    for k in off.outputs:
        np.testing.assert_array_equal(on.outputs[k], off.outputs[k])
    np.testing.assert_array_equal(on.abs_sample_end, off.abs_sample_end)
    assert on.events == off.events


def test_feed_spans_int8():
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    rx = Receiver(ReceiverConfig(fs=2.6e6, num_channels=1, device="cpu",
                                 int8_stream=True))
    chunk = (np.random.default_rng(3).normal(size=(2600, 2))
             .astype(np.float32).view(np.complex64).ravel())
    trace.enable()
    rx.feed(chunk)
    spans, counts = trace.collect()
    names = [s[2] for s in spans]
    assert names == ["feed", "feed.concat", "feed.upload", "feed.quantize"]
    assert [s[3] for s in spans] == [-1, 0, 0, 2]
    assert counts == {"h2d.feed.copies": 1, "h2d.feed.bytes": 2600 * 2}
