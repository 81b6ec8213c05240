# Copied from gnss_sdr_tpu/monitor/status.py; only the package imports are rewritten.
"""Channel-status console display.

Reference analog: channel_status_msg_receiver + the PVT block's periodic
"Current receiver channel status" table (src/core/libs/
channel_status_msg_receiver.cc, rtklib_pvt_gs.cc d_show... /
`-print_channel_status` flow): a fixed-width table of every channel's
signal, PRN, FSM state, C/N0 and Doppler, printed at a configured cadence
so an operator can watch lock health without parsing dump files.

Here the table is rendered straight from the batched engines' host state:
the Tracker's per-channel ``ChannelControl`` (phase/C/N0/lock) plus one
small device->host pull of the carrier-Doppler row.
"""

from __future__ import annotations

import numpy as np

_PHASE_NAMES = {0: "IDLE", 1: "WIDE", 2: "NARROW", 3: "LOST"}


def render_channel_status(receiver) -> str:
    """Format the current per-channel status table for a Receiver."""
    rows = []
    header = (f"{'CH':>3} {'Signal':<10} {'PRN':>4} {'State':<7} "
              f"{'CN0[dB-Hz]':>10} {'Doppler[Hz]':>12}")
    rows.append(header)
    rows.append("-" * len(header))
    for g in receiver.groups:
        dop = np.asarray(g.tracker.state.carrier_doppler)
        for ch in range(g.plan.num_channels):
            ctl = g.tracker.ctl[ch]
            prn = g.channel_prn[ch]
            state = _PHASE_NAMES.get(int(ctl.phase), "?")
            cn0 = f"{ctl.cn0_dbhz:10.1f}" if prn else f"{'--':>10}"
            dhz = f"{float(dop[ch]):12.1f}" if prn else f"{'--':>12}"
            rows.append(
                f"{g.offset + ch:>3} {g.plan.name:<10} "
                f"{prn if prn else '--':>4} {state:<7} {cn0} {dhz}")
    return "\n".join(rows)


class ChannelStatusDisplay:
    """Prints the channel table every ``rate_s`` of stream time."""

    def __init__(self, rate_s: float = 2.0, out=None) -> None:
        self.rate_s = rate_s
        self._next_t = rate_s
        self._out = out

    def tick(self, receiver, stream_t: float) -> None:
        if stream_t < self._next_t:
            return
        self._next_t = stream_t + self.rate_s
        text = (f"-- channel status @ t={stream_t:7.2f} s --\n"
                + render_channel_status(receiver))
        if self._out is not None:
            print(text, file=self._out)
        else:
            print(text)
