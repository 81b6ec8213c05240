"""Host-to-device copies the port issues per tracked block: its
``h2d.track.copies`` counter over its ``track.blocks`` counter
(rxbench/program.py)."""

from rxbench.program import counter


def read(run):
    copies, blocks = (counter(run, "h2d.track.copies"),
                      counter(run, "track.blocks"))
    if copies is None or not blocks:
        return None
    return copies / blocks
