"""Megabytes the port uploads from the host stream per signal second: its
``h2d.feed.bytes`` counter (rxbench/program.py)."""

from rxbench.program import counter


def read(run):
    n = counter(run, "h2d.feed.bytes")
    if n is None or not run.get("signal_s"):
        return None
    return n / run["signal_s"] / 1e6
