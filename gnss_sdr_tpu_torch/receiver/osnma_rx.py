# Copied from gnss_sdr_tpu/receiver/osnma_rx.py; only the package imports are rewritten.
"""Receiver-side OSNMA plumbing (reference osnma_msg_receiver.cc).

Routes the 40-bit OSNMA fields the I/NAV decoder extracts from every
E1-B page into the TESLA engine (telemetry/osnma.py), maintains
per-satellite authentication state, and feeds the PVT strict mode
(reference rtklib_pvt_gs.cc:1990-2075 "osnma_strict" satellite gating).

Field assembly: each I/NAV page carries 8 HKROOT + 32 MACK bits; an
OSNMA subframe is the 15 pages of one GST 30 s frame. Page slots are
recovered from the decoded TOW (pages start on even GST seconds;
slot = (tow_page % 30) / 2), so assembly survives starting mid-subframe
and losing pages.

Authenticated navigation data (tag message): the bit-exact WT1-4 word
contents re-packed from the (bit-quantized) ephemeris via the I/NAV
encoder's own word builder — identical whether packed by the simulator
from its transmit ephemeris or by the receiver from the decoded one
(an ADKD-0-style definition; the reference authenticates the same
ephemeris+clock word set).
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.telemetry.osnma import OsnmaReceiver, inav_auth_message
from gnss_sdr_tpu_torch.utils.log import get_logger

log = get_logger("osnma")

__all__ = ["OsnmaManager", "inav_auth_message"]


class OsnmaManager:
    """Per-receiver OSNMA state: field assembly + auth bookkeeping."""

    def __init__(self, public_key=None) -> None:
        self.rx = OsnmaReceiver(public_key=public_key)
        # (prn, sf_id) -> {slot: field40}
        self._buf: dict[tuple[int, int], dict[int, np.ndarray]] = {}
        # per-channel-key linear tow(stamp) anchors: (tow_s, stamp, fs)
        self._anchor: dict[int, tuple[float, int, float]] = {}
        self._reported = 0
        self.auth_ok: set[int] = set()       # PRNs with >=1 verified tag
        self.auth_fail: set[int] = set()

    def load_chain(self, params) -> None:
        """Warm-start with a previously verified KROOT chain (reference
        stores the DSM-KROOT between sessions; cold KROOT assembly takes
        ~8 subframes = 4 minutes of broadcast)."""
        self.rx.params = params
        self.rx.kroot_verified = True

    def anchor(self, gch: int, tow_s: float, stamp: int, fs: float) -> None:
        """Record a decoded (TOW, sample stamp) pair for a channel."""
        self._anchor[gch] = (float(tow_s), int(stamp), float(fs))

    def push_fields(self, gch: int, prn: int, week: int | None,
                    eph, fields: list[tuple[int, np.ndarray]]) -> None:
        """Consume (odd-part-end stamp, field40) entries from a decoder.

        ``week``/``eph`` may be None until the ephemeris completes — the
        subframe buffer tolerates that; tags only verify once both the
        GST week and the authenticated words are known."""
        a = self._anchor.get(gch)
        if a is None or week is None or eph is None:
            return
        tow0, stamp0, fs = a
        p = self.rx.params
        for stamp, field in fields:
            # odd part ends 2 s after the page's even-part start
            tow_page = tow0 + (stamp - stamp0) / fs - 2.0
            tow_i = int(round(tow_page))
            if abs(tow_page - tow_i) > 0.2 or tow_i % 2:
                continue                      # mis-anchored page
            sf_id, rem = divmod(tow_i % 604800, 30)
            slot = rem // 2
            buf = self._buf.setdefault((prn, sf_id), {})
            buf[slot] = np.asarray(field, np.uint8)
            if len(buf) < 15:
                continue
            hk = np.concatenate([buf[s][:8] for s in range(15)])
            mack = np.concatenate([buf[s][8:] for s in range(15)])
            del self._buf[(prn, sf_id)]
            self.rx.feed_hkroot(sf_id, hk)
            if not self.rx.kroot_verified:
                continue
            p = self.rx.params
            gst = (int(week) << 20) | (sf_id * 30)
            ci = ((int(week) - p.wn0) * 604800 + sf_id * 30
                  - p.tow0_hours * 3600) // 30
            if ci < 0:
                continue
            self.rx.feed_mack(gst, int(ci), mack,
                              inav_auth_message(eph), prn)
        # fold new tag reports into per-satellite status
        for rep in self.rx.reports[self._reported:]:
            if rep.ok:
                self.auth_ok.add(rep.prn)
                self.auth_fail.discard(rep.prn)
                log.info("OSNMA: E%02d authenticated (GST %d)",
                         rep.prn, rep.subframe_gst & 0xFFFFF)
            else:
                self.auth_fail.add(rep.prn)
                log.warning("OSNMA: E%02d tag FAILED (GST %d)",
                            rep.prn, rep.subframe_gst & 0xFFFFF)
        self._reported = len(self.rx.reports)

    def authenticated(self, prn: int) -> bool:
        return prn in self.auth_ok
