"""Host milliseconds per signal second inside the ``feed`` span."""


def read(run):
    s = run["spans"].get("feed")
    return None if s is None else 1e3 * s / run["signal_s"]
