"""Idle share, K1 time and idle-gap labels from a synthetic trace, and
the stream-union byte count."""

import numpy as np
import pytest

from rxbench import devtrace


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


K1 = ("void (anonymous namespace)::cluster_track_kernel<(anonymous "
      "namespace)::BlockedLoop<3, false, false>, true>(float2 const*)")


SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


def test_idle_share_and_labels():
    # the trace's clock runs 5000 us ahead of the host's; the spans are
    # the host's (start, end, name) in seconds
    host0 = 100.0
    events = [
        _ev(SPIN, "kernel", 5000, 6),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5100, 50),
        _ev(K1, "kernel", 5420, 60),
        _ev(K1, "kernel", 5450, 60),          # overlaps the first
        _ev(SPIN, "kernel", 6000, 6),
        _ev("other", "kernel", 7000, 10),    # outside the window
    ]
    spans = [(host0, host0 + 400e-6, "feed"),
             (host0 + 400e-6, host0 + 1000e-6, "run"),
             (host0 + 400e-6, host0 + 500e-6, "track"),
             (host0 + 500e-6, host0 + 1000e-6, "blocks")]
    tr = devtrace.analyse(events, spans, [host0, host0 + 1000e-6])
    assert tr["window_s"] == pytest.approx(1e-3)
    assert tr["clock_scale"] == pytest.approx(1.0)
    assert tr["busy_s"] == pytest.approx(140e-6)
    assert tr["k1_s"] == pytest.approx(120e-6) and tr["k1_launches"] == 2
    assert tr["idle_by_span"]["blocks"] == pytest.approx(490e-6)
    assert tr["idle_by_span"]["feed"] == pytest.approx(370e-6)
    assert tr["idle_gaps"][0] == ["blocks", pytest.approx(490e-6)]
    ctx = {"trace": tr}
    from rxbench.harness import Cell

    idle = Cell("gps8.replay").reader("device_idle_pct")(ctx)
    assert idle == pytest.approx(86.0)


def test_missing_marks_or_clock_refused():
    spans = [(1.0, 1.0005, "feed")]
    with pytest.raises(RuntimeError):
        devtrace.analyse([_ev(SPIN, "kernel", 0, 6)], spans, [1.0, 1.001])
    events = [_ev(SPIN, "kernel", 0, 6), _ev(SPIN, "kernel", 1000, 6)]
    with pytest.raises(RuntimeError):       # 1 ms traced over 2 ms host
        devtrace.analyse(events, spans, [1.0, 1.002])


def test_k1_counts_take_the_block_start_channels():
    from rxbench.drive import TrackedBlock

    end = np.array([[100, 100], [200, 200]])
    block = TrackedBlock(
        "G", {"n_samples": np.array([[100, 100], [100, 100]])}, end,
        ("NARROW", "IDLE"), ("IDLE", "IDLE"), (3, 0),
        {"num_taps": 3, "pilot": False, "tables_bytes": 1000})
    got = devtrace.k1_counts(block)
    assert got["ops"] == 200 * devtrace.FUSED_OPS_PER_SAMPLE
    assert got["bytes"] == (200 * 8 + 1000 + 2 * (devtrace.MAX_SLOTS + 1) * 4
                            + 2 * 2 * devtrace.LANES * 4)


def test_idle_share_absent_without_trace():
    from rxbench.harness import Cell

    assert Cell("gps8.replay").reader("device_idle_pct")({"trace": None}) \
        is None


def test_union_counts_shared_samples_once():
    start = np.array([0, 5, 20])
    stop = np.array([10, 12, 25])
    assert devtrace.union_samples(start, stop) == 17


def test_bound_names_its_limit():
    t, by = devtrace.bound_s(3.35e12, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = devtrace.bound_s(1.0, 67e12)
    assert by == "operations" and t == pytest.approx(1.0)
