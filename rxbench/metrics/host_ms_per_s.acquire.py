"""Host milliseconds per signal second inside the ``acquire`` span."""


def read(run):
    s = run["spans"].get("acquire")
    return None if s is None else 1e3 * s / run["signal_s"]
