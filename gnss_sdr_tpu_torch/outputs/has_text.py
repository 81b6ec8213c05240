# Copied from gnss_sdr_tpu/outputs/has_text.py; only the package imports are rewritten.
"""Galileo E6 HAS message text dump.

Reference analog: src/algorithms/PVT/libs/has_simple_printer.{h,cc} —
writes every assembled HAS message's header fields and payload to a
human-readable text file for offline analysis (the "simple" HAS logger,
as opposed to applying the corrections).
"""

from __future__ import annotations

import time

import numpy as np


class HasSimplePrinter:
    """Appends one readable record per assembled HAS message."""

    def __init__(self, path: str) -> None:
        self._f = open(path, "w")
        self._f.write("# Galileo E6 HAS message log "
                      "(has_simple_printer analog)\n")
        self.messages = 0

    def print_message(self, msg) -> None:
        """msg: telemetry.hascnav.HasMessage-like with .header dict and
        .payload bits (np array)."""
        self.messages += 1
        self._f.write(f"\n=== HAS message {self.messages} "
                      f"(logged {time.strftime('%Y-%m-%d %H:%M:%S')}) ===\n")
        mid = getattr(msg, "mid", None)
        if mid is not None:
            self._f.write(f"     mid: {mid}\n")
        for key, val in (getattr(msg, "header", {}) or {}).items():
            self._f.write(f"{key:>8}: {val}\n")
        payload = np.asarray(
            getattr(msg, "data", getattr(msg, "payload", np.zeros(0))),
            dtype=np.int64).ravel()
        if payload.size:
            # pack bits to hex, 32 hex chars per line
            nbytes = (payload.size + 7) // 8
            bits = np.zeros(nbytes * 8, dtype=np.int64)
            bits[: payload.size] = payload
            by = np.packbits(bits.astype(np.uint8))
            hexstr = by.tobytes().hex()
            self._f.write(f" payload: {payload.size} bits\n")
            for i in range(0, len(hexstr), 64):
                self._f.write(f"   {hexstr[i:i + 64]}\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
