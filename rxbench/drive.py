"""The replay drive: one ``Receiver`` per capture file, fed 1 s at a time
in a closed loop: ``acquire`` after each of a file's first
``acquire_feeds`` feeds while a channel is idle (a cold start's search),
``run`` after every feed, as bench.py and the tests drive it.

What the timed path produced is kept for the check after the window: each
file's first acquisition, every tracked block's host outputs (by
reference, so the window pays for no copy), the decoded ephemerides and
the fixes; ``sample_periods`` draws the seeded sample of locked periods
from the blocks once the window has closed. In a traced run the layer
boundaries are wrapped in host spans (``Spans``): the bound methods of
each Receiver and of each group's Tracker, so the port itself is not
edited, and each span times the port's own call and nothing of the
harness.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

# per-period samples kept from each tracked block of a locked channel
PERIODS_KEPT = 4


class Spans:
    """Host time per span name on the ``perf_counter`` clock, nested spans
    counted in both; with ``keep`` every span's (start, end, name) is kept
    too, so that the device trace's idle gaps can be labelled."""

    def __init__(self, keep: bool = False) -> None:
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}
        self.intervals: list | None = [] if keep else None

    @contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.total[name] = self.total.get(name, 0.0) + (t1 - t)
            self.count[name] = self.count.get(name, 0) + 1
            if self.intervals is not None:
                self.intervals.append((t, t1, name))

    def wrap(self, obj, attr: str, name: str) -> None:
        """Replace ``obj.attr`` (a bound method) on the instance by one
        timed under ``name``."""
        fn = getattr(obj, attr)

        def timed(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)

        setattr(obj, attr, timed)


@dataclass
class TrackedBlock:
    """One tracked block as the window left it: the Tracker's host outputs
    (held, not copied), the channels' phases before and after it and,
    per group, what K1's byte count needs of the Tracker."""

    system: str                    # the group's system letter
    outputs: dict                  # name -> [K, C] host array
    abs_sample_end: np.ndarray     # [K, C]
    before: tuple                  # phase name per channel
    after: tuple
    prns: tuple                    # PRN per channel after the block
    k1: dict                       # the Tracker's sizes (shared per group)


@dataclass
class FileAnswers:
    """What the Receiver produced on one file."""

    index: int                     # file of the pool
    seconds_fed: int = 0
    complete: bool = False         # every feed of the file ran
    first_acq: dict = field(default_factory=dict)   # (sys, prn) -> (dop, delay)
    starts: list = field(default_factory=list)      # (feed, sys, prn, dop_hz)
    periods: list = field(default_factory=list)     # (sys, prn, s_end, rem)
    ephemerides: dict = field(default_factory=dict)
    fixes: list = field(default_factory=list)       # PvtSolution
    blocks: list = field(default_factory=list)      # TrackedBlock, in order


def build_receiver(cfg: dict, device: str = "cuda"):
    """The configuration's Receiver: one plan per band, built by the
    port's ``<plan>_plan`` factory with the band's rate, channels, block
    length and the source's acquisition and tracking settings
    (``plan_options``, under the factory's own argument names), and the
    configuration's receiver options; the CLI builds the same from the
    source's ``.conf``."""
    from gnss_sdr_tpu_torch.receiver import plans as plan_mod
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    bands = cfg["bands"]
    plans = [getattr(plan_mod, b["plan"] + "_plan")(
        fs=b["fs"], num_channels=b["num_channels"],
        steps_per_block=b["steps_per_block"], **b["plan_options"])
        for b in bands]
    rc = ReceiverConfig(fs=bands[0]["fs"],
                        num_channels=sum(b["num_channels"] for b in bands),
                        device=device, **cfg.get("receiver", {}))
    return Receiver(rc, plans=plans)


def _tracker_sizes(tracker) -> dict:
    """What K1's counts need of a Tracker and that no block changes."""
    conf = tracker.conf
    return {"num_taps": conf.num_taps, "pilot": bool(conf.track_pilot),
            "tables_bytes": tracker.codes.nbytes + sum(
                t.nbytes for t in (tracker.data_codes, tracker.sec_pilot,
                                   tracker.sec_data) if t is not None)}


def _record(g, ans: FileAnswers) -> None:
    """Wrap ``g``'s ``Tracker.process_device`` (over its span, if any):
    keep each block's host outputs and the channels' phases around it.
    Nothing is sampled or counted here; ``sample_periods`` and
    ``devtrace.k1_counts`` read the blocks after the window."""
    tracker = g.tracker
    process = tracker.process_device
    sizes = _tracker_sizes(tracker)

    def recorded(*args):
        before = tuple(c.phase.name for c in tracker.ctl)
        res = process(*args)
        ans.blocks.append(TrackedBlock(
            g.plan.system, res.outputs, res.abs_sample_end, before,
            tuple(c.phase.name for c in tracker.ctl),
            tuple(g.channel_prn), sizes))
        return res

    tracker.process_device = recorded


def sample_periods(answers: list, seed: int) -> None:
    """Each file's seeded sample of PERIODS_KEPT periods from every block
    of every channel locked (NARROW) before and after it, drawn in the
    blocks' order once the window has closed."""
    rng = np.random.default_rng([seed, 0x5EED])
    for ans in answers:
        for b in ans.blocks:
            k = b.abs_sample_end.shape[0]
            rem = b.outputs["rem_code_phase"]
            for ch, (p0, p1) in enumerate(zip(b.before, b.after)):
                if p0 != "NARROW" or p1 != "NARROW":
                    continue
                for i in rng.choice(k, size=min(PERIODS_KEPT, k),
                                    replace=False):
                    ans.periods.append((
                        b.system, b.prns[ch],
                        int(b.abs_sample_end[i, ch]), float(rem[i, ch])))


def replay(cfg: dict, traffic: dict, files: list, seconds: float,
           spans: Spans | None = None, device: str = "cuda", sync=None,
           max_files: int | None = None) -> tuple[list, float, float]:
    """Replay the pool ``files`` (each a list of per-band complex64 host
    arrays) file after file, a new Receiver each, for ``seconds`` of wall
    time (or for ``max_files`` files); a file cut by the end counts the
    seconds it processed. Returns the answers of every file begun, the
    signal seconds whose ``run`` returned, and the window's wall seconds
    (from the start to the return of its last ``run``, after ``sync``)."""
    feed_s = traffic["feed_s"]
    search = traffic["acquire_feeds"]
    bands = cfg["bands"]
    answers: list[FileAnswers] = []
    # ten times the blocks a feed holds at 1 ms periods: never reached by
    # a receiver that advances, it keeps one whose state does not from
    # looping without end
    guard = 10 * math.ceil(1000.0 * feed_s
                           / min(b["steps_per_block"] for b in bands))
    signal_s = 0.0
    t0 = time.perf_counter()
    k = 0
    done = False
    while not done and (max_files is None or k < max_files):
        idx = k % len(files)
        k += 1
        ans = FileAnswers(index=idx)
        answers.append(ans)
        if spans is not None:
            with spans.span("construct"):
                rx = build_receiver(cfg, device)
        else:
            rx = build_receiver(cfg, device)
        for g in rx.groups:
            if spans is not None:
                spans.wrap(g.tracker, "process_device", "track")
            _record(g, ans)
        if spans is not None:
            spans.wrap(rx, "feed", "feed")
            spans.wrap(rx, "acquire", "acquire")
            spans.wrap(rx, "_handle_block", "blocks")
            spans.wrap(rx, "_run_epochs", "epochs")
            spans.wrap(rx, "run", "run")
        n_feeds = int(round(files[idx][0].shape[0] / (bands[0]["fs"]
                                                      * feed_s)))
        for j in range(n_feeds):
            for b, x in zip(bands, files[idx]):
                c = int(round(b["fs"] * feed_s))
                rx.feed(x[j * c:(j + 1) * c], band=b["band"])
            if j < search and any(g.idle_channel() is not None
                                  for g in rx.groups):
                started = rx.acquire()
                ans.starts += [(j, s, p, float(dop))
                               for (s, p), (dop, _delay) in started.items()]
                if j == 0:
                    ans.first_acq = dict(started)
            rx.run(max_blocks=guard)
            signal_s += feed_s
            ans.seconds_fed = j + 1
            if time.perf_counter() - t0 >= seconds:
                done = True
                break
        ans.complete = ans.seconds_fed == n_feeds
        ans.ephemerides = dict(rx.ephemerides)
        ans.fixes = list(rx.status.fixes)
        # drop the wrappers (each holds the instance) so that the
        # Receiver and its device buffers go now, not at a later GC pass
        for g in rx.groups:
            g.tracker.__dict__.pop("process_device", None)
        for attr in ("feed", "acquire", "_handle_block", "_run_epochs",
                     "run"):
            rx.__dict__.pop(attr, None)
        del rx
    if sync is not None:
        sync()
    return answers, signal_s, time.perf_counter() - t0
