"""The port's own spans and counters over a traced window, for the
per-layer readers in ``metrics/``.

The port's tracer (``gnss_sdr_tpu_torch.utils.trace``) records while a
``torch.profiler`` session records, and the harness runs one around the
traced window alone, so in a traced run the tracer holds the window's
spans and counters and nothing of the warm-up. The first reader that asks
collects them once into the run's context as ``run["program"]``:

    {"spans": {name: seconds}, "counts": {name: total},
     "intervals": [(start, end, name), ...]}

``intervals`` are on ``time.perf_counter``, the clock of the harness's own
spans and of ``devtrace.mark``, in the triples ``devtrace.analyse`` takes.
It is None where the port has no tracer or recorded nothing, and then
every reader returns None.
"""

from __future__ import annotations


def collect() -> dict | None:
    """The tracer's spans and counters, cleared from the tracer; None
    where the port has no tracer or it recorded nothing."""
    try:
        from gnss_sdr_tpu_torch.utils import trace
    except ImportError:
        return None
    spans, counts = trace.collect()
    if not spans and not counts:
        return None
    totals: dict[str, float] = {}
    for start, end, name, _parent in spans:
        totals[name] = totals.get(name, 0.0) + (end - start)
    return {"spans": totals, "counts": dict(counts),
            "intervals": [(s, e, name) for s, e, name, _p in spans]}


def program(run: dict) -> dict | None:
    """``run["program"]``, collected on the first call."""
    if "program" not in run:
        run["program"] = collect()
    return run["program"]


def span_ms_per_s(run: dict, name: str) -> float | None:
    """Host milliseconds per signal second inside the port's span
    ``name``, or None where it was never recorded."""
    p = program(run)
    if p is None or name not in p["spans"] or not run.get("signal_s"):
        return None
    return 1e3 * p["spans"][name] / run["signal_s"]


def counter(run: dict, name: str) -> int | None:
    """The port's counter ``name`` over the window, or None."""
    p = program(run)
    return None if p is None else p["counts"].get(name)
