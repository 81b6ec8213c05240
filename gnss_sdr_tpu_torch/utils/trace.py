"""The port's tracer: named host spans and counters on the receive path.

    from gnss_sdr_tpu_torch.utils import trace

    trace.enable()
    ...                                  # feed, acquire, run
    spans, counts = trace.collect()      # and clears them
    trace.disable()

``span(name)`` is a context manager that times the code inside it;
``count(name, n)`` adds ``n`` to a counter. ``collect()`` returns every
span closed since the last collect as ``(start, end, name,
parent_index)``, ``parent_index`` the index in the same list of the span
it was opened in (-1 at the top), and the counters' totals. A span still
open at ``collect()`` is dropped, and its children take its parent.

Times are ``time.perf_counter`` seconds, the clock on which a caller's own
spans and a device trace's window marks are read, so the spans map onto
the trace without conversion. Spans are kept in memory until
``collect()``; nothing is written while they are recorded. The tracer
reads only the host clock: it never synchronises the device, reads a
tensor or launches a kernel.

Off by default. Off, ``span`` returns one shared no-op object after one
flag test and ``count`` returns at once. ``enable()`` turns it on until
``disable()``. Without either, ``follow_profiler()`` (called by
``Receiver.feed``) turns it on while a ``torch.profiler`` session records
and off when none does, so a profiled window of a receiver carries the
program's spans. Spans are opened from the thread that drives the
receiver.
"""

from __future__ import annotations

import sys
import time

_clock = time.perf_counter
_on = False            # spans and counts are recorded
_forced = False        # enable() holds the tracer on
_gen = 0               # bumped by collect(): spans open across it are lost
_names: list = []
_starts: list = []
_ends: list = []       # None until the span closes
_parents: list = []
_stack: list = []      # indices of the open spans, innermost last
_counts: dict = {}


class _Off:
    """The span handed out while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "index", "gen")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.index = i = len(_names)
        self.gen = _gen
        _names.append(self.name)
        _parents.append(_stack[-1] if _stack else -1)
        _ends.append(None)
        _stack.append(i)
        _starts.append(_clock())
        return self

    def __exit__(self, *exc):
        t = _clock()
        if self.gen == _gen:
            _ends[self.index] = t
            if _stack and _stack[-1] == self.index:
                _stack.pop()
        return False


def span(name: str):
    """A context manager timing its body under ``name``."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _on:
        return
    _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    """Record spans and counts until ``disable()``."""
    global _on, _forced
    _on = _forced = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``collect()``."""
    global _on, _forced
    _on = _forced = False


def follow_profiler() -> None:
    """Unless ``enable()`` holds the tracer on, record while a
    ``torch.profiler`` session records and not otherwise."""
    global _on
    if not _forced:
        prof = sys.modules.get("torch.autograd.profiler")
        _on = bool(getattr(prof, "_is_profiler_enabled", False))


def collect() -> tuple[list, dict]:
    """The closed spans as ``(start, end, name, parent_index)`` in the
    order they were opened, and the counters' totals; both are cleared."""
    global _gen
    kept: dict[int, int] = {}
    spans = []
    for i, (name, t0, t1, parent) in enumerate(
            zip(_names, _starts, _ends, _parents)):
        if t1 is None:
            # dropped: its children take its nearest kept ancestor
            kept[i] = kept.get(parent, -1)
            continue
        kept[i] = len(spans)
        spans.append((t0, t1, name, kept.get(parent, -1)))
    counts = dict(_counts)
    for lst in (_names, _starts, _ends, _parents, _stack):
        lst.clear()
    _counts.clear()
    _gen += 1
    return spans, counts
