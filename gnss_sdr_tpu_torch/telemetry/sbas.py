# Copied from gnss_sdr_tpu/telemetry/sbas.py; only the package imports are rewritten.
"""SBAS L1 telemetry codec (250 bps, rate-1/2 K=7 FEC, 500 sps).

Reference analog: src/algorithms/telemetry_decoder/gnuradio_blocks/
sbas_l1_telemetry_decoder_gs.cc (+ viterbi_decoder_sbas.cc): the SBAS
signal rides a C/A-family code (PRN 120-158) at 1 kHz code rate with two
code periods per symbol; the 250-bit messages (DO-229) are convolutionally
encoded and framed by a 24-bit preamble distributed over three successive
messages (0x53, 0x9A, 0xC6) with a CRC-24Q over the first 226 bits.

Decoder mirrors telemetry/cnav.py's continuous-stream strategy: buffer
soft symbols, free-boundary Viterbi, scan decoded bits for
preamble + CRC."""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.telemetry.fec import conv_encode, crc24q, viterbi_decode

MSG_BITS = 250
PREAMBLES = (0b01010011, 0b10011010, 0b11000110)
SYMBOL_RATE = 500.0
CODES_PER_SYMBOL = 2          # 1 ms C/A periods per symbol


def encode_message(msg_type: int, data212: np.ndarray,
                   preamble_idx: int) -> np.ndarray:
    """One 250-bit SBAS message: preamble(8) + type(6) + data(212) +
    CRC-24Q(24)."""
    data212 = np.asarray(data212, dtype=np.uint8)
    if len(data212) != 212:
        raise ValueError("SBAS data field is 212 bits")
    bits = np.zeros(MSG_BITS, dtype=np.uint8)
    pre = PREAMBLES[preamble_idx % 3]
    bits[0:8] = [(pre >> (7 - i)) & 1 for i in range(8)]
    bits[8:14] = [(msg_type >> (5 - i)) & 1 for i in range(6)]
    bits[14:226] = data212
    crc = crc24q(bits[:226])
    bits[226:250] = [(crc >> (23 - i)) & 1 for i in range(24)]
    return bits


def parse_message(bits: np.ndarray) -> dict | None:
    """Validate CRC and split fields; None when the CRC fails."""
    bits = np.asarray(bits, dtype=np.uint8)
    crc = 0
    for b in bits[226:250]:
        crc = (crc << 1) | int(b)
    if crc24q(bits[:226]) != crc:
        return None
    pre = 0
    for b in bits[0:8]:
        pre = (pre << 1) | int(b)
    if pre not in PREAMBLES:
        return None
    mt = 0
    for b in bits[8:14]:
        mt = (mt << 1) | int(b)
    return {"preamble": pre, "msg_type": mt, "data": bits[14:226].copy()}


class SbasEncoder:
    """Continuous symbol stream for the simulator: messages at 1 Hz with
    cycling preambles, convolutionally encoded across message boundaries."""

    def __init__(self, prn: int, msg_types: list[int] | None = None,
                 seed: int = 0) -> None:
        self.prn = prn
        self.rng = np.random.default_rng(seed + prn)
        self.msg_types = msg_types or [2, 3, 4, 9, 0]

    def symbols(self, num_msgs: int) -> np.ndarray:
        """[num_msgs * 500] symbol levels (+-1)."""
        bits = []
        for i in range(num_msgs):
            mt = self.msg_types[i % len(self.msg_types)]
            data = self.rng.integers(0, 2, 212).astype(np.uint8)
            bits.append(encode_message(mt, data, i))
        stream = np.concatenate(bits)
        sym = conv_encode(stream, invert_g2=False)
        return (1.0 - 2.0 * sym.astype(np.float64))


class SbasDecoder:
    """Streaming SBAS decoder; push_symbols(signs, stamps) -> events with
    1 s message cadence (each event marks a decoded message's last
    symbol). SBAS carries no ephemeris for the PVT chain here, so events
    report message type + data (integrity/corrections consumers)."""

    EDGE = 64

    def __init__(self, prn: int) -> None:
        self.prn = prn
        self._hist: list[float] = []
        self._stamps: list[int] = []
        self.msgs_ok = 0
        self.crc_fail = 0
        self.messages: list[dict] = []
        # interface parity with nav decoders (no ephemeris content)
        self.eph = None

    def push_symbols(self, signs: np.ndarray, stamps: np.ndarray) -> list[dict]:
        self._hist.extend(float(s) for s in signs)
        self._stamps.extend(int(s) for s in stamps)
        events: list[dict] = []
        need = 2 * MSG_BITS + 4 * self.EDGE
        while len(self._hist) >= need + 2 * MSG_BITS:
            sym = np.asarray(self._hist[: need + 2 * MSG_BITS])
            found = None
            for pol in (1.0, -1.0):
                for align in (0, 1):
                    n_pairs = (len(sym) - align) // 2
                    dec = viterbi_decode(
                        pol * sym[align: align + 2 * n_pairs],
                        invert_g2=False, soft=True,
                        start_state=None, end_state=None,
                    )
                    for start in range(self.EDGE,
                                       len(dec) - MSG_BITS - self.EDGE):
                        msg = parse_message(dec[start: start + MSG_BITS])
                        if msg is not None:
                            found = (pol, align, start, msg)
                            break
                    if found:
                        break
                if found:
                    break
            if not found:
                # drop one message worth and retry later
                drop = 2 * MSG_BITS
                self._hist = self._hist[drop:]
                self._stamps = self._stamps[drop:]
                self.crc_fail += 1
                continue
            pol, align, start, msg = found
            last_sym = align + 2 * (start + MSG_BITS) - 1
            stamp = self._stamps[min(last_sym, len(self._stamps) - 1)]
            self.msgs_ok += 1
            self.messages.append(msg)
            events.append({
                "msg_type": msg["msg_type"],
                "preamble": msg["preamble"],
                "sample_stamp": int(stamp),
                "tow_s": None,            # SBAS MT12/MT9 carry time; N/A
                "ephemeris_complete": False,
            })
            # keep EDGE bits of tail so the next message (which starts
            # immediately) stays clear of the Viterbi window edge
            consumed = max(align + 2 * (start + MSG_BITS - self.EDGE), 1)
            self._hist = self._hist[consumed:]
            self._stamps = self._stamps[consumed:]
        return events
