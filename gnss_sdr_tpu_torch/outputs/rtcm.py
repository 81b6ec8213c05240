# Copied from gnss_sdr_tpu/outputs/rtcm.py; only the package imports are rewritten.
"""RTCM 3.x codec + TCP broadcast server.

Reference analog: src/algorithms/PVT/libs/rtcm.cc (6684 LoC; frame layer,
legacy + MSM observation messages, ephemeris messages, TCP server used by
rtcm_printer.cc). This implementation covers the messages the reference's
PVT actually emits for a rover:

- frame layer: 0xD3 preamble, 10-bit length, CRC-24Q;
- 1005: stationary antenna reference point;
- 1019: GPS broadcast ephemeris;
- 1020: GLONASS broadcast ephemeris (state vector);
- MSM7 (1077 GPS / 1087 GLONASS / 1097 Galileo / 1127 BeiDou): full
  pseudorange + carrier-phase + Doppler + C/N0 observation sets.

Both encode and decode are provided so the codec round-trips (the
reference uses decode in its tests and in rinex2assist)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gnss_sdr_tpu_torch.pvt.ephemeris import C_LIGHT

PREAMBLE = 0xD3
_CRC24Q_POLY = 0x1864CFB

MSM_SYS = {"G": 1077, "R": 1087, "E": 1097, "C": 1127}
SYS_OF_MSM = {v: k for k, v in MSM_SYS.items()}

RANGE_MS = 1.0 / 1000.0 * C_LIGHT          # meters per millisecond


def crc24q_bytes(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24Q_POLY
    return crc & 0xFFFFFF


# ------------------------------------------------------------- bit plumbing
class BitWriter:
    def __init__(self) -> None:
        self.bits: list[int] = []

    def u(self, value: int, n: int) -> "BitWriter":
        v = int(value)
        if v < 0 or v >= (1 << n):
            raise ValueError(f"u{n} out of range: {value}")
        self.bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))
        return self

    def s(self, value: int, n: int) -> "BitWriter":
        """Two's-complement signed (RTCM int fields)."""
        v = int(value)
        lo, hi = -(1 << (n - 1)), (1 << (n - 1)) - 1
        if not lo <= v <= hi:
            raise ValueError(f"s{n} out of range: {value}")
        return self.u(v & ((1 << n) - 1), n)

    def to_bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def s(self, n: int) -> int:
        v = self.u(n)
        if v & (1 << (n - 1)):
            v -= 1 << n
        return v


# -------------------------------------------------------------- frame layer
def frame(payload: bytes) -> bytes:
    """Wrap a message payload in the RTCM transport frame."""
    if len(payload) > 1023:
        raise ValueError("RTCM payload > 1023 bytes")
    head = bytes([PREAMBLE, (len(payload) >> 8) & 0x03, len(payload) & 0xFF])
    crc = crc24q_bytes(head + payload)
    return head + payload + bytes([(crc >> 16) & 0xFF, (crc >> 8) & 0xFF,
                                   crc & 0xFF])


def deframe(stream: bytes):
    """Yield (msg_number, payload) for every valid frame in the byte
    stream; resynchronizes on garbage (reference rtcm.cc frame hunt)."""
    i = 0
    n = len(stream)
    while i + 6 <= n:
        if stream[i] != PREAMBLE:
            i += 1
            continue
        length = ((stream[i + 1] & 0x03) << 8) | stream[i + 2]
        end = i + 3 + length + 3
        if end > n:
            # bogus length from a spurious preamble byte (or a truncated
            # trailing frame — callers stream whole frames, so skip)
            i += 1
            continue
        payload = stream[i + 3 : i + 3 + length]
        crc = int.from_bytes(stream[i + 3 + length : end], "big")
        if crc24q_bytes(stream[i : i + 3 + length]) != crc:
            i += 1
            continue
        msg = (payload[0] << 4) | (payload[1] >> 4) if length >= 2 else 0
        yield msg, payload
        i = end


# ------------------------------------------------------------------- MSG1005
def encode_1005(station_id: int, ecef: np.ndarray,
                gps: bool = True, glo: bool = True, gal: bool = True) -> bytes:
    w = BitWriter()
    w.u(1005, 12).u(station_id, 12).u(0, 6)       # ITRF year
    w.u(int(gps), 1).u(int(glo), 1).u(int(gal), 1).u(0, 1)
    w.s(round(ecef[0] / 1e-4), 38).u(0, 1).u(0, 1)
    w.s(round(ecef[1] / 1e-4), 38).u(0, 2)
    w.s(round(ecef[2] / 1e-4), 38)
    return w.to_bytes()


def decode_1005(payload: bytes) -> dict:
    r = BitReader(payload)
    msg = r.u(12)
    assert msg == 1005
    sid = r.u(12)
    r.u(6)
    gps, glo, gal = r.u(1), r.u(1), r.u(1)
    r.u(1)
    x = r.s(38) * 1e-4
    r.u(2)
    y = r.s(38) * 1e-4
    r.u(2)
    z = r.s(38) * 1e-4
    return {"msg": 1005, "station_id": sid, "ecef": np.array([x, y, z]),
            "gps": bool(gps), "glo": bool(glo), "gal": bool(gal)}


# ------------------------------------------------------------------- MSG1019
# (field order/scalings per RTCM 10403 Table 3.5-21; same content the
# reference encodes in Rtcm::print_MT1019)
def encode_1019(eph, station_week: int | None = None) -> bytes:
    w = BitWriter()
    w.u(1019, 12)
    w.u(eph.prn, 6)
    w.u(int(eph.week) % 1024, 10)
    w.u(0, 4)                                     # URA
    w.u(0, 2)                                     # L2 code
    w.s(round(eph.idot / 2.0 ** -43 / np.pi), 14)
    w.u(int(eph.iode_sf2) & 0xFF, 8)
    w.u(round(eph.toc / 16.0), 16)
    w.s(round(eph.af2 / 2.0 ** -55), 8)
    w.s(round(eph.af1 / 2.0 ** -43), 16)
    w.s(round(eph.af0 / 2.0 ** -31), 22)
    w.u(int(eph.iodc) & 0x3FF, 10)
    w.s(round(eph.crs / 2.0 ** -5), 16)
    w.s(round(eph.delta_n / 2.0 ** -43 / np.pi), 16)
    w.s(round(eph.m0 / 2.0 ** -31 / np.pi), 32)
    w.s(round(eph.cuc / 2.0 ** -29), 16)
    w.u(round(eph.ecc / 2.0 ** -33), 32)
    w.s(round(eph.cus / 2.0 ** -29), 16)
    w.u(round(eph.sqrt_a / 2.0 ** -19), 32)
    w.u(round(eph.toe / 16.0), 16)
    w.s(round(eph.cic / 2.0 ** -29), 16)
    w.s(round(eph.omega0 / 2.0 ** -31 / np.pi), 32)
    w.s(round(eph.cis / 2.0 ** -29), 16)
    w.s(round(eph.i0 / 2.0 ** -31 / np.pi), 32)
    w.s(round(eph.crc / 2.0 ** -5), 16)
    w.s(round(eph.omega / 2.0 ** -31 / np.pi), 32)
    w.s(round(eph.omega_dot / 2.0 ** -43 / np.pi), 24)
    w.s(round(eph.tgd / 2.0 ** -31), 8)
    w.u(0, 6).u(0, 1).u(0, 1)                     # health, L2P, fit
    return w.to_bytes()


def decode_1019(payload: bytes):
    from gnss_sdr_tpu_torch.telemetry.lnav import GpsEphemeris

    r = BitReader(payload)
    assert r.u(12) == 1019
    e = GpsEphemeris(prn=r.u(6))
    e.week = r.u(10)
    r.u(4)
    r.u(2)
    e.idot = r.s(14) * 2.0 ** -43 * np.pi
    e.iode_sf2 = e.iode_sf3 = r.u(8)
    e.toc = r.u(16) * 16.0
    e.af2 = r.s(8) * 2.0 ** -55
    e.af1 = r.s(16) * 2.0 ** -43
    e.af0 = r.s(22) * 2.0 ** -31
    e.iodc = r.u(10)
    e.crs = r.s(16) * 2.0 ** -5
    e.delta_n = r.s(16) * 2.0 ** -43 * np.pi
    e.m0 = r.s(32) * 2.0 ** -31 * np.pi
    e.cuc = r.s(16) * 2.0 ** -29
    e.ecc = r.u(32) * 2.0 ** -33
    e.cus = r.s(16) * 2.0 ** -29
    e.sqrt_a = r.u(32) * 2.0 ** -19
    e.toe = r.u(16) * 16.0
    e.cic = r.s(16) * 2.0 ** -29
    e.omega0 = r.s(32) * 2.0 ** -31 * np.pi
    e.cis = r.s(16) * 2.0 ** -29
    e.i0 = r.s(32) * 2.0 ** -31 * np.pi
    e.crc = r.s(16) * 2.0 ** -5
    e.omega = r.s(32) * 2.0 ** -31 * np.pi
    e.omega_dot = r.s(24) * 2.0 ** -43 * np.pi
    e.tgd = r.s(8) * 2.0 ** -31
    return e


# ------------------------------------------------------------------- MSG1020
def encode_1020(geph) -> bytes:
    """GLONASS ephemeris (state vector; RTCM Table 3.5-21b essentials)."""
    w = BitWriter()
    w.u(1020, 12)
    w.u(geph.slot, 6)
    w.u(geph.freq_k + 7, 5)
    w.u(0, 4)                                     # health/P flags
    # tb in 15-min units of the GLONASS day is re-derived by the decoder
    # from tb_gps_tow; transmit tb index + day-free state vector
    from gnss_sdr_tpu_torch.telemetry.gnav import gpst_to_glot

    tod, nt, n4 = gpst_to_glot(2290, geph.tb_gps_tow)
    w.u(int(round(tod / 900.0)), 7)
    w.u(nt, 11)
    w.u(n4, 5)
    for axis in range(3):
        w.s(round(geph.vel[axis] / 1e3 / 2.0 ** -20), 24)
        w.s(round(geph.pos[axis] / 1e3 / 2.0 ** -11), 27)
        w.s(round(geph.acc[axis] / 1e3 / 2.0 ** -30), 5)
    w.s(round(geph.gamma_n / 2.0 ** -40), 11)
    w.s(round(geph.tau_n / 2.0 ** -30), 22)
    w.s(round(geph.dtau_n / 2.0 ** -30), 5)
    return w.to_bytes()


def decode_1020(payload: bytes):
    from gnss_sdr_tpu_torch.pvt.glonass import GlonassEphemeris
    from gnss_sdr_tpu_torch.telemetry.gnav import glot_to_gpst

    r = BitReader(payload)
    assert r.u(12) == 1020
    e = GlonassEphemeris()
    e.slot = r.u(6)
    e.freq_k = r.u(5) - 7
    r.u(4)
    tb = r.u(7) * 900.0
    nt = r.u(11)
    n4 = r.u(5)
    e.nt, e.n4 = nt, n4
    _, e.tb_gps_tow = glot_to_gpst(tb, nt, n4)
    for axis in range(3):
        e.vel[axis] = r.s(24) * 2.0 ** -20 * 1e3
        e.pos[axis] = r.s(27) * 2.0 ** -11 * 1e3
        e.acc[axis] = r.s(5) * 2.0 ** -30 * 1e3
    e.gamma_n = r.s(11) * 2.0 ** -40
    e.tau_n = r.s(22) * 2.0 ** -30
    e.dtau_n = r.s(5) * 2.0 ** -30
    return e


# --------------------------------------------------------------------- MSM7
@dataclass
class MsmObservation:
    prn: int
    pseudorange_m: float
    carrier_phase_cycles: float       # accumulated phase (sign: ~ -range)
    doppler_hz: float
    cn0_dbhz: float
    wavelength_m: float
    lock_s: float = 100.0


def encode_msm7(system: str, station_id: int, tow_s: float,
                obs: list[MsmObservation]) -> bytes:
    """Encode one epoch's observations as MSM7 (one signal per satellite).

    The MSM phase field carries phase-range in range units; the codec maps
    our accumulated-phase convention in and out symmetrically."""
    msg = MSM_SYS[system]
    obs = sorted(obs, key=lambda o: o.prn)[:64]
    w = BitWriter()
    w.u(msg, 12).u(station_id, 12)
    # GPS epoch time ms (GLONASS MSM uses day time; single field here)
    w.u(int(round((tow_s % 604800.0) * 1e3)) % (1 << 30), 30)
    w.u(0, 1).u(0, 3).u(0, 7).u(0, 2).u(0, 2).u(0, 1).u(0, 3)
    sat_mask = 0
    for o in obs:
        sat_mask |= 1 << (64 - o.prn)
    w.u(sat_mask, 64)
    w.u(1 << 31, 32)                              # one signal (slot 1)
    w.u((1 << len(obs)) - 1, len(obs) or 1)       # dense cell mask
    # satellite data: rough range (ms int 8 + mod 10 bits) + rough rate 14
    for o in obs:
        rng_ms = o.pseudorange_m / RANGE_MS
        w.u(int(rng_ms) & 0xFF, 8)
        w.u(0, 4)                                 # extended info
        w.u(int(round((rng_ms % 1.0) * 1024)) & 0x3FF, 10)
        w.s(int(round(-o.doppler_hz * o.wavelength_m)), 14)  # rough, 1 m/s
    # signal data per cell
    for o in obs:
        rng_ms = o.pseudorange_m / RANGE_MS
        rough = (int(rng_ms) + round((rng_ms % 1.0) * 1024) / 1024.0)
        fine = rng_ms - rough
        w.s(np.clip(round(fine / 2.0 ** -29), -(1 << 19), (1 << 19) - 1), 20)
    for o in obs:
        # phase-range (meters) = -lambda * phase; transmitted relative to
        # the rough range, in ms units at 2^-31
        pr_ms = (-o.carrier_phase_cycles * o.wavelength_m) / RANGE_MS
        rng_ms = o.pseudorange_m / RANGE_MS
        rough = (int(rng_ms) + round((rng_ms % 1.0) * 1024) / 1024.0)
        fine = pr_ms - rough
        # 24-bit field covers +-2^-8 ms (~117 km): fold in whole wavelengths
        w.s(int(np.clip(round(fine / 2.0 ** -31), -(1 << 23), (1 << 23) - 1)),
            24)
    for o in obs:
        w.u(min(int(o.lock_s * 1000), (1 << 10) - 1), 10)
    for o in obs:
        w.u(0, 1)                                 # half-cycle ambiguity
    for o in obs:
        w.u(int(round(o.cn0_dbhz / 2.0 ** -4)) & 0x3FF, 10)
    for o in obs:
        # fine phase-range rate: residual vs the rough 1 m/s field
        rate = -o.doppler_hz * o.wavelength_m
        fine_rate = rate - int(round(rate))
        w.s(np.clip(round(fine_rate / 1e-4), -(1 << 14), (1 << 14) - 1), 15)
    return w.to_bytes()


def decode_msm7(payload: bytes) -> dict:
    r = BitReader(payload)
    msg = r.u(12)
    system = SYS_OF_MSM[msg]
    sid = r.u(12)
    tow_ms = r.u(30)
    r.u(1 + 3 + 7 + 2 + 2 + 1 + 3)
    sat_mask = r.u(64)
    sig_mask = r.u(32)
    prns = [64 - i for i in range(64) if sat_mask & (1 << i)]
    prns.sort()
    ncell = len(prns) * bin(sig_mask).count("1")
    cell_mask = r.u(ncell or 1)
    rough_int = []
    rough_mod = []
    rough_rate = []
    for _ in prns:
        rough_int.append(r.u(8))
        r.u(4)
        rough_mod.append(r.u(10))
        rough_rate.append(r.s(14))
    fine_rng = [r.s(20) * 2.0 ** -29 for _ in prns]
    fine_phr = [r.s(24) * 2.0 ** -31 for _ in prns]
    locks = [r.u(10) for _ in prns]
    halves = [r.u(1) for _ in prns]
    cn0s = [r.u(10) * 2.0 ** -4 for _ in prns]
    rates = [rough_rate[i] + r.s(15) * 1e-4 for i in range(len(prns))]
    out = []
    for i, prn in enumerate(prns):
        rough = rough_int[i] + rough_mod[i] / 1024.0
        pr = (rough + fine_rng[i]) * RANGE_MS
        phr = (rough + fine_phr[i]) * RANGE_MS      # phase-range, meters
        out.append({
            "prn": prn,
            "pseudorange_m": pr,
            "phase_range_m": phr,
            "doppler_mps": -rates[i],
            "cn0_dbhz": cn0s[i],
            "lock_ms": locks[i],
        })
    return {"msg": msg, "system": system, "station_id": sid,
            "tow_ms": tow_ms, "obs": out}


# --------------------------------------------------------------- TCP server
class RtcmTcpServer:
    """Non-blocking broadcast server (reference rtcm_printer TCP server:
    rovers connect and receive the frame stream)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 2101) -> None:
        import socket

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self._srv.setblocking(False)
        self.port = self._srv.getsockname()[1]
        self._clients: list = []

    def poll_accept(self) -> None:
        import socket

        try:
            while True:
                c, _ = self._srv.accept()
                c.setblocking(False)
                self._clients.append(c)
        except (BlockingIOError, socket.error):
            pass

    def broadcast(self, frame_bytes: bytes) -> None:
        self.poll_accept()
        dead = []
        for c in self._clients:
            try:
                c.sendall(frame_bytes)
            except OSError:
                dead.append(c)
        for c in dead:
            self._clients.remove(c)
            c.close()

    def close(self) -> None:
        for c in self._clients:
            c.close()
        self._srv.close()
