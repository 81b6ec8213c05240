"""Host milliseconds per signal second inside the port's own ``track.fsm``
span (rxbench/program.py)."""

from rxbench.program import span_ms_per_s


def read(run):
    return span_ms_per_s(run, "track.fsm")
