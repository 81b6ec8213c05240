"""Host milliseconds per signal second inside the ``epochs`` span."""


def read(run):
    s = run["spans"].get("epochs")
    return None if s is None else 1e3 * s / run["signal_s"]
