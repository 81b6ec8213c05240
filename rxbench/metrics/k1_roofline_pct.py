"""K1's share of its roofline: the least time its launches need, each the
larger of its bytes over the memory rate and its operations over the
float32 rate (the benchmark's own counts, rxbench/devtrace.py), over
their device time in the profiler's trace."""

from rxbench.devtrace import bound_s


def read(run):
    tr, blocks = run["trace"], run["k1_blocks"]
    if not blocks or tr is None or tr["k1_s"] <= 0:
        return None
    if tr["k1_launches"] != len(blocks):
        raise RuntimeError(f"{tr['k1_launches']} K1 launches traced for "
                           f"{len(blocks)} blocks counted")
    least = sum(bound_s(b["bytes"], b["ops"])[0] for b in blocks)
    return 100.0 * least / tr["k1_s"]
