"""The port's own spans and counters in a traced run (rxbench/program.py
and the readers that read them): each reader on a hand-made
``run["program"]`` and None without one; a short replay on the CPU under
a profiler, as the traced window runs, through the readers, the idle-gap
labelling with the harness's spans and the port's, and ``json.dumps``."""

import json
import math
import time

import pytest
import torch

from rxbench import devtrace, harness
from rxbench.drive import Spans, replay

SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
CELL = harness.Cell("gps8.replay")
SPAN_METRICS = {m["name"]: m["name"][len("host_ms_per_s."):]
                for m in CELL.per_layer
                if m["name"].startswith("host_ms_per_s.")
                and m["name"].count(".") == 2}
NEW = sorted(SPAN_METRICS) + ["feed.h2d_mb_per_s",
                              "track.h2d_copies_per_block"]


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_new_metrics_listed_for_both_cells():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert len(NEW) == 11
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == ["dual16.replay", "gps8.replay"]
        assert m["moves"] == "realtime_factor"
        assert m["source"] == ("program_span" if name in SPAN_METRICS
                               else "program_counter")


def test_readers_on_a_hand_made_program():
    spans = {n: 0.001 * (i + 1) for i, n in enumerate(SPAN_METRICS.values())}
    ctx = {"signal_s": 2.0, "program": {
        "spans": spans, "intervals": [],
        "counts": {"h2d.track.copies": 30, "track.blocks": 6,
                   "h2d.feed.bytes": 41_600_000}}}
    for metric, span in SPAN_METRICS.items():
        assert CELL.reader(metric)(ctx) == pytest.approx(
            1e3 * spans[span] / 2.0)
    assert CELL.reader("track.h2d_copies_per_block")(ctx) == 5.0
    assert CELL.reader("feed.h2d_mb_per_s")(ctx) == pytest.approx(20.8)
    for empty in ({"signal_s": 2.0, "program": None},
                  {"signal_s": 2.0, "program": {"spans": {}, "counts": {},
                                                "intervals": []}}):
        for name in NEW:
            assert CELL.reader(name)(empty) is None


def test_nothing_recorded_reads_none():
    from gnss_sdr_tpu_torch.utils import trace

    trace.disable()
    trace.collect()
    ctx = {"signal_s": 1.0}
    for name in NEW:
        assert CELL.reader(name)(ctx) is None
    assert ctx["program"] is None


def _short_replay(mp):
    """A 2 s gps8 file replayed on the CPU inside a profiler session, as
    the harness runs its traced window, with the harness's spans; the
    trackers on K1's plain version, the card's engine."""
    from gnss_sdr_tpu_torch.parallel import sharding
    from gnss_sdr_tpu_torch.tracking.fused import build_fused_engine
    from gnss_sdr_tpu_torch.utils import trace

    init = sharding.ShardedTrackBlock.__init__

    def fused(self, conf, mesh):
        init(self, conf, mesh)
        self.fused = True
        self.spec = build_fused_engine(conf)

    mp.setattr(sharding.ShardedTrackBlock, "__init__", fused)
    cfg = dict(CELL.config, file_s=2)
    traffic = dict(CELL.traffic, pool_files=1)
    geos = harness.make_geometries(cfg, 2)
    files = harness.make_pool(cfg, geos, 1, 2, 2**31 + 5,
                              torch.device("cpu"))
    spans = Spans(keep=True)
    trace.disable()
    trace.collect()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        marks = [time.perf_counter()]
        answers, signal_s, wall_s = replay(cfg, traffic, files, math.inf,
                                           spans, "cpu", None, 1)
        marks.append(time.perf_counter())
    trace.follow_profiler()
    return spans, marks, answers, signal_s, wall_s


def test_traced_path_with_program_spans(monkeypatch):
    spans, marks, answers, signal_s, wall_s = _short_replay(monkeypatch)
    # one copy in the middle of the window, the marks at its ends
    w = 1e6 * (marks[1] - marks[0])
    events = [_ev(SPIN, "kernel", 0.0, 6), _ev(SPIN, "kernel", w, 6),
              _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy",
                  w / 2, 10)]
    tr = devtrace.analyse(events, spans.intervals, marks)
    ctx = {"spans": dict(spans.total), "signal_s": signal_s,
           "wall_s": wall_s, "trace": tr,
           "k1_blocks": [devtrace.k1_counts(b) for a in answers
                         for b in a.blocks]}
    result = {"metrics": {}}
    for m in CELL.per_layer:
        v = CELL.reader(m["name"])(ctx)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    got = result["metrics"]
    # 2 s hold no ephemeris, so no PVT epoch; nothing else is missing
    assert set(NEW) - set(got) == {"host_ms_per_s.epochs.pvt"}
    assert got["feed.h2d_mb_per_s"]["value"] == pytest.approx(
        2.6e6 * 8 / 1e6)
    assert 5 <= got["track.h2d_copies_per_block"]["value"] < 6
    p = ctx["program"]
    kids = sum(p["spans"][k] for k in (
        "track.pack", "track.launch", "track.unpack", "track.to_host",
        "track.fsm"))
    assert 0.9 * p["spans"]["track"] <= kids <= p["spans"]["track"]
    assert p["spans"]["track"] <= spans.total["track"]
    # the port's spans label the idle gaps inside the harness's; the
    # harness's own labelling is unchanged by them
    both = devtrace.analyse(events, spans.intervals + p["intervals"],
                            marks)
    assert both["idle_by_span"] != tr["idle_by_span"]
    assert devtrace.analyse(events, spans.intervals, marks) == tr
    assert set(both["idle_by_span"]) & {
        "feed.upload", "feed.concat", "track.launch", "track.to_host"}
    assert sum(both["idle_by_span"].values()) == pytest.approx(
        sum(tr["idle_by_span"].values()))
    result.update(breakdown={"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]},
                  idle_by_span_s=tr["idle_by_span"],
                  idle_gaps_program=both["idle_gaps"])
    json.loads(json.dumps(result))
