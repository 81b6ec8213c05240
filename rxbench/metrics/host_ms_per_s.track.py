"""Host milliseconds per signal second inside the ``track`` span."""


def read(run):
    s = run["spans"].get("track")
    return None if s is None else 1e3 * s / run["signal_s"]
