"""Host milliseconds per signal second inside the ``blocks`` span."""


def read(run):
    s = run["spans"].get("blocks")
    return None if s is None else 1e3 * s / run["signal_s"]
