# Copied from gnss_sdr_tpu/receiver/supl.py; only the package imports are rewritten.
"""SUPL 1.0 / RRLP A-GNSS client: real OMA-ULP + 3GPP-RRLP interop.

The reference's A-GNSS path (core/libs/supl/supl.c + ~72 kLoC of
asn1c-generated codecs) speaks SUPL over TLS with RRLP assistance
payloads. This module re-expresses that capability as a compact,
self-contained ASN.1 UPER (unaligned PER, X.691) interpreter driven by
declarative schema tables transcribed from the protocol definitions the
reference ships (src/core/libs/supl/asn/supl-*.asn, rrlp-*.asn — OMA
AD/ULP and 3GPP TS 44.031 subsets). The message flow mirrors
supl.c supl_get_assist: SUPL-START -> SUPL-RESPONSE -> SUPL-POS-INIT ->
SUPL-POS (RRLP assistanceData, acked until moreAssDataToBeSent clears)
-> SUPL-END.

tests/test_supl.py cross-validates the wire bytes against an oracle
compiled at test time from the reference's own asn1c-generated C codecs
(same pattern as tests/test_reference_oracle.py).

Values: SEQUENCE <-> dict, CHOICE <-> (name, value), SEQUENCE OF <->
list, ENUMERATED <-> name string, BIT STRING <-> (int, n_bits),
OCTET STRING <-> bytes.
"""

from __future__ import annotations

import math
import socket
import ssl as _ssl
from dataclasses import dataclass, field


# ============================================================ bit I/O
class BitWriter:
    def __init__(self) -> None:
        self._bits: list[int] = []

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def put_bytes(self, data: bytes) -> None:
        for b in data:
            self.put(b, 8)

    def __len__(self) -> int:
        return len(self._bits)

    def to_bytes(self) -> bytes:
        bits = self._bits + [0] * (-len(self._bits) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            v = 0
            for b in bits[i:i + 8]:
                v = (v << 1) | b
            out.append(v)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def get_bytes(self, n: int) -> bytes:
        return bytes(self.get(8) for _ in range(n))


# ==================================================== length determinants
def _put_general_length(w: BitWriter, n: int) -> None:
    """X.691 general length determinant (unaligned, unfragmented)."""
    if n <= 127:
        w.put(n, 8)                   # '0' + 7 bits
    elif n <= 16383:
        w.put(0x8000 | n, 16)         # '10' + 14 bits
    else:
        raise ValueError("fragmented lengths unsupported")


def _get_general_length(r: BitReader) -> int:
    if r.get(1) == 0:
        return r.get(7)
    if r.get(1) == 0:
        return r.get(14)
    raise ValueError("fragmented lengths unsupported")


def _put_small_number(w: BitWriter, n: int) -> None:
    """Normally small non-negative whole number (X.691 10.6)."""
    if n <= 63:
        w.put(0, 1)
        w.put(n, 6)
    else:
        w.put(1, 1)
        _put_general_length(w, n)     # semi-constrained fallback


def _get_small_number(r: BitReader) -> int:
    if r.get(1) == 0:
        return r.get(6)
    n_oct = _get_general_length(r)
    return int.from_bytes(r.get_bytes(n_oct), "big")


def _nbits(rng: int) -> int:
    return max(0, (rng - 1).bit_length())


# ============================================================ type system
class Type:
    def enc(self, w: BitWriter, v) -> None:
        raise NotImplementedError

    def dec(self, r: BitReader):
        raise NotImplementedError


@dataclass
class Int(Type):
    lo: int | None = None
    hi: int | None = None

    def enc(self, w, v):
        v = int(v)
        if self.lo is not None and self.hi is not None:
            if not self.lo <= v <= self.hi:
                raise ValueError(f"int {v} outside [{self.lo},{self.hi}]")
            w.put(v - self.lo, _nbits(self.hi - self.lo + 1))
        else:
            # unconstrained: length (octets) + 2's complement
            n = max(1, (v.bit_length() + 8) // 8)
            _put_general_length(w, n)
            w.put_bytes(v.to_bytes(n, "big", signed=True))

    def dec(self, r):
        if self.lo is not None and self.hi is not None:
            return self.lo + r.get(_nbits(self.hi - self.lo + 1))
        n = _get_general_length(r)
        return int.from_bytes(r.get_bytes(n), "big", signed=True)


@dataclass
class Bool(Type):
    def enc(self, w, v):
        w.put(1 if v else 0, 1)

    def dec(self, r):
        return bool(r.get(1))


@dataclass
class Null(Type):
    def enc(self, w, v):
        pass

    def dec(self, r):
        return None


@dataclass
class Enum(Type):
    names: tuple
    ext: bool = False

    def enc(self, w, v):
        if self.ext:
            w.put(0, 1)
        w.put(self.names.index(v), _nbits(len(self.names)))

    def dec(self, r):
        if self.ext and r.get(1):
            return f"_ext_{_get_small_number(r)}"
        return self.names[r.get(_nbits(len(self.names)))]


@dataclass
class OctStr(Type):
    lo: int | None = None
    hi: int | None = None

    def enc(self, w, v: bytes):
        if self.lo is not None and self.lo == self.hi:
            if len(v) != self.lo:
                raise ValueError("octet string size mismatch")
            w.put_bytes(v)
            return
        if self.lo is not None:
            w.put(len(v) - self.lo, _nbits(self.hi - self.lo + 1))
        else:
            _put_general_length(w, len(v))
        w.put_bytes(v)

    def dec(self, r):
        if self.lo is not None and self.lo == self.hi:
            return r.get_bytes(self.lo)
        if self.lo is not None:
            n = self.lo + r.get(_nbits(self.hi - self.lo + 1))
        else:
            n = _get_general_length(r)
        return r.get_bytes(n)


@dataclass
class BitStr(Type):
    size: int

    def enc(self, w, v):
        val, n = v if isinstance(v, tuple) else (v, self.size)
        if n != self.size:
            raise ValueError("bit string size mismatch")
        w.put(val, n)

    def dec(self, r):
        return (r.get(self.size), self.size)


@dataclass
class IA5Str(Type):
    lo: int = 1
    hi: int = 1000

    def enc(self, w, v: str):
        w.put(len(v) - self.lo, _nbits(self.hi - self.lo + 1))
        for ch in v:
            w.put(ord(ch), 7)

    def dec(self, r):
        n = self.lo + r.get(_nbits(self.hi - self.lo + 1))
        return "".join(chr(r.get(7)) for _ in range(n))


@dataclass
class VisStr(Type):
    """VisibleString, unconstrained length (UTCTime rides on this)."""

    def enc(self, w, v: str):
        _put_general_length(w, len(v))
        for ch in v:
            w.put(ord(ch), 7)

    def dec(self, r):
        n = _get_general_length(r)
        return "".join(chr(r.get(7)) for _ in range(n))


@dataclass
class SeqOf(Type):
    elem: Type
    lo: int = 1
    hi: int = 16

    def enc(self, w, v: list):
        w.put(len(v) - self.lo, _nbits(self.hi - self.lo + 1))
        for item in v:
            self.elem.enc(w, item)

    def dec(self, r):
        n = self.lo + r.get(_nbits(self.hi - self.lo + 1))
        return [self.elem.dec(r) for _ in range(n)]


OPT = "optional"


@dataclass
class Unsupported(Type):
    """Schema-subset guard: decoding fails loudly instead of silently
    misaligning the bit stream if a peer sends an element outside the
    A-GPS subset (E-OTD/measurement structures)."""

    what: str = ""

    def enc(self, w, v):
        raise NotImplementedError(f"{self.what} not in the A-GPS subset")

    def dec(self, r):
        raise NotImplementedError(f"{self.what} not in the A-GPS subset")


@dataclass
class Seq(Type):
    """fields: [(name, type) | (name, type, OPT)]; ``ext`` adds the
    extension marker. Extension additions are never encoded and are
    length-skipped on decode."""

    fields: list
    ext: bool = False

    def enc(self, w, v: dict):
        if self.ext:
            w.put(0, 1)
        opts = [f for f in self.fields if len(f) > 2]
        for name, *_ in opts:
            w.put(0 if v.get(name) is None else 1, 1)
        for f in self.fields:
            name, typ = f[0], f[1]
            val = v.get(name)
            if len(f) > 2 and val is None:
                continue
            if val is None:
                raise ValueError(f"missing mandatory field {name}")
            typ.enc(w, val)

    def dec(self, r):
        has_ext = bool(self.ext and r.get(1))
        opts = [f[0] for f in self.fields if len(f) > 2]
        present = {name: bool(r.get(1)) for name in opts}
        out = {}
        for f in self.fields:
            name, typ = f[0], f[1]
            if len(f) > 2 and not present[name]:
                out[name] = None
                continue
            out[name] = typ.dec(r)
        if has_ext:
            # skip extension additions: small count + presence bitmap +
            # open-type (length + octets) per present addition
            m = _get_small_number(r) + 1
            bitmap = [r.get(1) for _ in range(m)]
            for bit in bitmap:
                if bit:
                    n = _get_general_length(r)
                    r.get_bytes(n)
        return out


@dataclass
class Choice(Type):
    alts: list          # [(name, Type)]
    ext: bool = False

    def enc(self, w, v):
        name, val = v
        idx = [a[0] for a in self.alts].index(name)
        if self.ext:
            w.put(0, 1)
        if len(self.alts) > 1:
            w.put(idx, _nbits(len(self.alts)))
        self.alts[idx][1].enc(w, val)

    def dec(self, r):
        if self.ext and r.get(1):
            idx = _get_small_number(r)
            n = _get_general_length(r)
            return (f"_ext_{idx}", r.get_bytes(n))
        idx = r.get(_nbits(len(self.alts))) if len(self.alts) > 1 else 0
        name, typ = self.alts[idx]
        return (name, typ.dec(r))


# ====================================================== ULP schema tables
# (transcribed from the OMA-TS-ULP-V1.0 module set the reference ships;
# field order and optionality are normative for the UPER bit layout)

U8 = Int(0, 255)
VERSION = Seq([("maj", U8), ("min", U8), ("servind", U8)])

IP_ADDRESS = Choice([("ipv4Address", OctStr(4, 4)),
                     ("ipv6Address", OctStr(16, 16))])
FQDN_ALPHABET = None      # 65-char alphabet still uses 7-bit ASCII (X.691)
SLP_ADDRESS = Choice([("iPAddress", IP_ADDRESS),
                      ("fQDN", IA5Str(1, 255))], ext=True)
SET_ID = Choice([
    ("msisdn", OctStr(8, 8)), ("mdn", OctStr(8, 8)),
    ("min", BitStr(34)), ("imsi", OctStr(8, 8)),
    ("nai", IA5Str(1, 1000)), ("iPAddress", IP_ADDRESS)], ext=True)
SET_SESSION_ID = Seq([("sessionId", Int(0, 65535)), ("setId", SET_ID)])
SLP_SESSION_ID = Seq([("sessionID", OctStr(4, 4)),
                      ("slpId", SLP_ADDRESS)])
SESSION_ID = Seq([("setSessionID", SET_SESSION_ID, OPT),
                  ("slpSessionID", SLP_SESSION_ID, OPT)])

NMR_ELEMENT = Seq([("aRFCN", Int(0, 1023)), ("bSIC", Int(0, 63)),
                   ("rxLev", Int(0, 63))], ext=True)
GSM_CELL = Seq([
    ("refMCC", Int(0, 999)), ("refMNC", Int(0, 999)),
    ("refLAC", Int(0, 65535)), ("refCI", Int(0, 65535)),
    ("nMR", SeqOf(NMR_ELEMENT, 1, 15), OPT),
    ("tA", Int(0, 255), OPT)], ext=True)
FREQ_FDD = Seq([("uarfcn-UL", Int(0, 16383), OPT),
                ("uarfcn-DL", Int(0, 16383))], ext=True)
FREQ_TDD = Seq([("uarfcn-Nt", Int(0, 16383))], ext=True)
FREQ_INFO = Seq([("fmodeSpecificInfo",
                  Choice([("fdd", FREQ_FDD), ("tdd", FREQ_TDD)],
                         ext=True))], ext=True)
PRIMARY_CPICH = Seq([("primaryScramblingCode", Int(0, 511))])
CELL_MEASURED = Seq([
    ("cellIdentity", Int(0, 268435455), OPT),
    ("modeSpecificInfo", Choice([
        ("fdd", Seq([("primaryCPICH-Info", PRIMARY_CPICH),
                     ("cpich-Ec-N0", Int(0, 63), OPT),
                     ("cpich-RSCP", Int(0, 127), OPT),
                     ("pathloss", Int(46, 173), OPT)])),
        ("tdd", Seq([("cellParametersID", Int(0, 127)),
                     ("proposedTGSN", Int(0, 14), OPT),
                     ("primaryCCPCH-RSCP", Int(0, 127), OPT),
                     ("pathloss", Int(46, 173), OPT),
                     ("timeslotISCP-List",
                      SeqOf(Int(0, 127), 1, 14), OPT)]))]))])
MEASURED_RESULTS = Seq([
    ("frequencyInfo", FREQ_INFO, OPT),
    ("utra-CarrierRSSI", Int(0, 127), OPT),
    ("cellMeasuredResultsList", SeqOf(CELL_MEASURED, 1, 32), OPT)])
WCDMA_CELL = Seq([
    ("refMCC", Int(0, 999)), ("refMNC", Int(0, 999)),
    ("refUC", Int(0, 268435455)),
    ("frequencyInfo", FREQ_INFO, OPT),
    ("primaryScramblingCode", Int(0, 511), OPT),
    ("measuredResultsList", SeqOf(MEASURED_RESULTS, 1, 8), OPT)],
    ext=True)
CDMA_CELL = Seq([
    ("refNID", Int(0, 65535)), ("refSID", Int(0, 32767)),
    ("refBASEID", Int(0, 65535)), ("refBASELAT", Int(0, 4194303)),
    ("reBASELONG", Int(0, 8388607)), ("refREFPN", Int(0, 511)),
    ("refWeekNumber", Int(0, 65535)), ("refSeconds", Int(0, 4194303))],
    ext=True)
CELL_INFO = Choice([("gsmCell", GSM_CELL), ("wcdmaCell", WCDMA_CELL),
                    ("cdmaCell", CDMA_CELL)], ext=True)
STATUS = Enum(("stale", "current", "unknown"), ext=True)
LOCATION_ID = Seq([("cellInfo", CELL_INFO), ("status", STATUS)],
                  ext=True)

ALTITUDE_INFO = Seq([
    ("altitudeDirection", Enum(("height", "depth"))),
    ("altitude", Int(0, 32767)), ("altUncertainty", Int(0, 127))],
    ext=True)
POSITION_ESTIMATE = Seq([
    ("latitudeSign", Enum(("north", "south"))),
    ("latitude", Int(0, 8388607)),
    ("longitude", Int(-8388608, 8388607)),
    ("uncertainty", Seq([("uncertaintySemiMajor", Int(0, 127)),
                         ("uncertaintySemiMinor", Int(0, 127)),
                         ("orientationMajorAxis", Int(0, 180))]), OPT),
    ("confidence", Int(0, 100), OPT),
    ("altitudeInfo", ALTITUDE_INFO, OPT)], ext=True)
HORVEL = Seq([("bearing", BitStr(9)), ("horspeed", BitStr(16))],
             ext=True)
HORANDVERVEL = Seq([("verdirect", BitStr(1)), ("bearing", BitStr(9)),
                    ("horspeed", BitStr(16)), ("verspeed", BitStr(8))],
                   ext=True)
HORVELUNCERT = Seq([("bearing", BitStr(9)), ("horspeed", BitStr(16)),
                    ("uncertspeed", BitStr(8))], ext=True)
HORANDVERUNCERT = Seq([
    ("verdirect", BitStr(1)), ("bearing", BitStr(9)),
    ("horspeed", BitStr(16)), ("verspeed", BitStr(8)),
    ("horuncertspeed", BitStr(8)), ("veruncertspeed", BitStr(8))],
    ext=True)
VELOCITY = Choice([("horvel", HORVEL), ("horandvervel", HORANDVERVEL),
                   ("horveluncert", HORVELUNCERT),
                   ("horandveruncert", HORANDVERUNCERT)], ext=True)
POSITION = Seq([("timestamp", VisStr()),
                ("positionEstimate", POSITION_ESTIMATE),
                ("velocity", VELOCITY, OPT)], ext=True)
QOP = Seq([("horacc", Int(0, 127)), ("veracc", Int(0, 127), OPT),
           ("maxLocAge", Int(0, 65535), OPT), ("delay", Int(0, 7), OPT)],
          ext=True)
STATUS_CODE = Enum((
    "unspecified", "systemFailure", "unexpectedMessage", "protocolError",
    "dataMissing", "unexpectedDataValue", "posMethodFailure",
    "posMethodMismatch", "posProtocolMismatch", "targetSETnotReachable",
    "versionNotSupported", "resourceShortage", "invalidSessionId",
    "nonProxyModeNotSupported", "proxyModeNotSupported",
    "positioningNotPermitted", "authNetFailure", "authSuplinitFailure",
    "consentDeniedByUser", "consentGrantedByUser"), ext=True)
POS_METHOD = Enum((
    "agpsSETassisted", "agpsSETbased", "agpsSETassistedpref",
    "agpsSETbasedpref", "autonomousGPS", "aFLT", "eCID", "eOTD",
    "oTDOA", "noPosition"), ext=True)
VER = BitStr(64)

POS_TECHNOLOGY = Seq([(n, Bool()) for n in (
    "agpsSETassisted", "agpsSETBased", "autonomousGPS", "aFLT", "eCID",
    "eOTD", "oTDOA")], ext=True)
PREF_METHOD = Enum(("agpsSETassistedPreferred", "agpsSETBasedPreferred",
                    "noPreference"))
POS_PROTOCOL = Seq([("tia801", Bool()), ("rrlp", Bool()),
                    ("rrc", Bool())], ext=True)
SET_CAPABILITIES = Seq([("posTechnology", POS_TECHNOLOGY),
                        ("prefMethod", PREF_METHOD),
                        ("posProtocol", POS_PROTOCOL)], ext=True)

SUPL_START = Seq([("sETCapabilities", SET_CAPABILITIES),
                  ("locationId", LOCATION_ID),
                  ("qoP", QOP, OPT)], ext=True)
SET_AUTH_KEY = Choice([("shortKey", BitStr(128)),
                       ("longKey", BitStr(256))], ext=True)
SUPL_RESPONSE = Seq([("posMethod", POS_METHOD),
                     ("sLPAddress", SLP_ADDRESS, OPT),
                     ("sETAuthKey", SET_AUTH_KEY, OPT),
                     ("keyIdentity4", BitStr(128), OPT)], ext=True)
SATELLITE_INFO_ELEMENT = Seq([("satId", Int(0, 63)),
                              ("iODE", Int(0, 255))], ext=True)
XNAVIGATION_MODEL = Seq([
    ("gpsWeek", Int(0, 1023)), ("gpsToe", Int(0, 167)),
    ("nSAT", Int(0, 31)), ("toeLimit", Int(0, 10)),
    ("satInfo", SeqOf(SATELLITE_INFO_ELEMENT, 1, 31), OPT)], ext=True)
REQUESTED_ASSIST_DATA = Seq([
    ("almanacRequested", Bool()), ("utcModelRequested", Bool()),
    ("ionosphericModelRequested", Bool()),
    ("dgpsCorrectionsRequested", Bool()),
    ("referenceLocationRequested", Bool()),
    ("referenceTimeRequested", Bool()),
    ("acquisitionAssistanceRequested", Bool()),
    ("realTimeIntegrityRequested", Bool()),
    ("navigationModelRequested", Bool()),
    ("navigationModelData", XNAVIGATION_MODEL, OPT)], ext=True)
POS_PAYLOAD = Choice([("tia801payload", OctStr(1, 8192)),
                      ("rrcPayload", OctStr(1, 8192)),
                      ("rrlpPayload", OctStr(1, 8192))], ext=True)
SUPL_POS = Seq([("posPayLoad", POS_PAYLOAD),
                ("velocity", VELOCITY, OPT)], ext=True)
SUPL_POS_INIT = Seq([
    ("sETCapabilities", SET_CAPABILITIES),
    ("requestedAssistData", REQUESTED_ASSIST_DATA, OPT),
    ("locationId", LOCATION_ID),
    ("position", POSITION, OPT),
    ("sUPLPOS", SUPL_POS, OPT),
    ("ver", VER, OPT)], ext=True)
SUPL_END = Seq([("position", POSITION, OPT),
                ("statusCode", STATUS_CODE, OPT),
                ("ver", VER, OPT)], ext=True)

# SUPLINIT subset (decode-only; SET-initiated sessions never receive it,
# but the CHOICE index space must match)
NOTIFICATION = Seq([
    ("notificationType", Enum((
        "noNotificationNoVerification", "notificationOnly",
        "notificationAndVerficationAllowedNA",
        "notificationAndVerficationDeniedNA",
        "privacyOverride"), ext=True)),
    ("encodingType", Enum(("ucs2", "gsmDefault", "utf8"), ext=True), OPT),
    ("requestorId", OctStr(1, 50), OPT),
    ("requestorIdType", Enum((
        "logicalName", "e-mailAddress", "msisdn", "url", "sipUrl", "min",
        "mdn"), ext=True), OPT),
    ("clientName", OctStr(1, 50), OPT),
    ("clientNameType", Enum((
        "logicalName", "e-mailAddress", "msisdn", "url", "sipUrl", "min",
        "mdn"), ext=True), OPT)], ext=True)
SLP_MODE = Enum(("proxy", "nonProxy"))
SUPL_INIT = Seq([
    ("posMethod", POS_METHOD),
    ("notification", NOTIFICATION, OPT),
    ("sLPAddress", SLP_ADDRESS, OPT),
    ("qoP", QOP, OPT),
    ("sLPMode", SLP_MODE),
    ("mAC", BitStr(64), OPT),
    ("keyIdentity", BitStr(128), OPT)], ext=True)

ULP_MESSAGE = Choice([
    ("msSUPLINIT", SUPL_INIT),
    ("msSUPLSTART", SUPL_START),
    ("msSUPLRESPONSE", SUPL_RESPONSE),
    ("msSUPLPOSINIT", SUPL_POS_INIT),
    ("msSUPLPOS", SUPL_POS),
    ("msSUPLEND", SUPL_END),
    ("msDUMMY2", Int()),
    ("msDUMMY3", Int()),
], ext=True)
ULP_PDU = Seq([
    ("length", Int(0, 65535)),
    ("version", VERSION),
    ("sessionID", SESSION_ID),
    ("message", ULP_MESSAGE)])


def encode_ulp(pdu: dict) -> bytes:
    """Encode with the two-pass length fix-up (supl.c supl_ulp_encode:
    the length field counts the final octets, so encode, patch, and
    re-encode)."""
    w = BitWriter()
    ULP_PDU.enc(w, dict(pdu, length=0))
    n = len(w.to_bytes())
    w = BitWriter()
    ULP_PDU.enc(w, dict(pdu, length=n))
    out = w.to_bytes()
    if len(out) != n:
        raise ValueError("ULP length fix-up did not converge")
    return out


def decode_ulp(data: bytes) -> dict:
    return ULP_PDU.dec(BitReader(data))


# ====================================================== RRLP schema tables
SATELLITE_ID = Int(0, 63)
GPS_TIME = Seq([("gpsTOW23b", Int(0, 7559999)),
                ("gpsWeek", Int(0, 1023))])
GSM_TIME = Seq([("bcchCarrier", Int(0, 1023)), ("bsic", Int(0, 63)),
                ("frameNumber", Int(0, 2097151)),
                ("timeSlot", Int(0, 7)), ("bitNumber", Int(0, 156))])
GPS_TOW_ASSIST_ELEMENT = Seq([
    ("satelliteID", SATELLITE_ID), ("tlmWord", Int(0, 16383)),
    ("antiSpoof", Int(0, 1)), ("alert", Int(0, 1)),
    ("tlmRsvdBits", Int(0, 3))])
REFERENCE_TIME = Seq([
    ("gpsTime", GPS_TIME),
    ("gsmTime", GSM_TIME, OPT),
    ("gpsTowAssist", SeqOf(GPS_TOW_ASSIST_ELEMENT, 1, 12), OPT)])
REF_LOCATION = Seq([("threeDLocation", OctStr(1, 20))])
SAT_ELEMENT = Seq([
    ("satelliteID", SATELLITE_ID), ("iode", Int(0, 239)),
    ("udre", Int(0, 3)), ("pseudoRangeCor", Int(-2047, 2047)),
    ("rangeRateCor", Int(-127, 127)),
    ("deltaPseudoRangeCor2", Int(-127, 127)),
    ("deltaRangeRateCor2", Int(-7, 7)),
    ("deltaPseudoRangeCor3", Int(-127, 127)),
    ("deltaRangeRateCor3", Int(-7, 7))])
DGPS_CORRECTIONS = Seq([
    ("gpsTOW", Int(0, 604799)), ("status", Int(0, 7)),
    ("satList", SeqOf(SAT_ELEMENT, 1, 16))])
EPHEMERIS_SF1_RESERVED = Seq([
    ("reserved1", Int(0, 8388607)), ("reserved2", Int(0, 16777215)),
    ("reserved3", Int(0, 16777215)), ("reserved4", Int(0, 65535))])
UNCOMPRESSED_EPHEMERIS = Seq([
    ("ephemCodeOnL2", Int(0, 3)), ("ephemURA", Int(0, 15)),
    ("ephemSVhealth", Int(0, 63)), ("ephemIODC", Int(0, 1023)),
    ("ephemL2Pflag", Int(0, 1)),
    ("ephemSF1Rsvd", EPHEMERIS_SF1_RESERVED),
    ("ephemTgd", Int(-128, 127)), ("ephemToc", Int(0, 37799)),
    ("ephemAF2", Int(-128, 127)), ("ephemAF1", Int(-32768, 32767)),
    ("ephemAF0", Int(-2097152, 2097151)),
    ("ephemCrs", Int(-32768, 32767)),
    ("ephemDeltaN", Int(-32768, 32767)),
    ("ephemM0", Int(-2147483648, 2147483647)),
    ("ephemCuc", Int(-32768, 32767)),
    ("ephemE", Int(0, 4294967295)),
    ("ephemCus", Int(-32768, 32767)),
    ("ephemAPowerHalf", Int(0, 4294967295)),
    ("ephemToe", Int(0, 37799)), ("ephemFitFlag", Int(0, 1)),
    ("ephemAODA", Int(0, 31)), ("ephemCic", Int(-32768, 32767)),
    ("ephemOmegaA0", Int(-2147483648, 2147483647)),
    ("ephemCis", Int(-32768, 32767)),
    ("ephemI0", Int(-2147483648, 2147483647)),
    ("ephemCrc", Int(-32768, 32767)),
    ("ephemW", Int(-2147483648, 2147483647)),
    ("ephemOmegaADot", Int(-8388608, 8388607)),
    ("ephemIDot", Int(-8192, 8191))])
SAT_STATUS = Choice([
    ("newSatelliteAndModelUC", UNCOMPRESSED_EPHEMERIS),
    ("oldSatelliteAndModel", Null()),
    ("newNaviModelUC", UNCOMPRESSED_EPHEMERIS)], ext=True)
NAV_MODEL_ELEMENT = Seq([("satelliteID", SATELLITE_ID),
                         ("satStatus", SAT_STATUS)])
NAVIGATION_MODEL = Seq([
    ("navModelList", SeqOf(NAV_MODEL_ELEMENT, 1, 16))])
IONOSPHERIC_MODEL = Seq([(n, Int(-128, 127)) for n in (
    "alfa0", "alfa1", "alfa2", "alfa3",
    "beta0", "beta1", "beta2", "beta3")])
UTC_MODEL = Seq([
    ("utcA1", Int(-8388608, 8388607)),
    ("utcA0", Int(-2147483648, 2147483647)),
    ("utcTot", Int(0, 255)), ("utcWNt", Int(0, 255)),
    ("utcDeltaTls", Int(-128, 127)), ("utcWNlsf", Int(0, 255)),
    ("utcDN", Int(-128, 127)), ("utcDeltaTlsf", Int(-128, 127))])
ALMANAC_ELEMENT = Seq([
    ("satelliteID", SATELLITE_ID), ("almanacE", Int(0, 65535)),
    ("alamanacToa", Int(0, 255)), ("almanacKsii", Int(-32768, 32767)),
    ("almanacOmegaDot", Int(-32768, 32767)),
    ("almanacSVhealth", Int(0, 255)),
    ("almanacAPowerHalf", Int(0, 16777215)),
    ("almanacOmega0", Int(-8388608, 8388607)),
    ("almanacW", Int(-8388608, 8388607)),
    ("almanacM0", Int(-8388608, 8388607)),
    ("almanacAF0", Int(-1024, 1023)),
    ("almanacAF1", Int(-1024, 1023))])
ALMANAC = Seq([("alamanacWNa", Int(0, 255)),
               ("almanacList", SeqOf(ALMANAC_ELEMENT, 1, 64))])
ADDIONAL_DOPPLER = Seq([("doppler1", Int(0, 63)),
                        ("dopplerUncertainty", Int(0, 7))])
ADDIONAL_ANGLE = Seq([("azimuth", Int(0, 31)), ("elevation", Int(0, 7))])
ACQUIS_ELEMENT = Seq([
    ("svid", SATELLITE_ID), ("doppler0", Int(-2048, 2047)),
    ("addionalDoppler", ADDIONAL_DOPPLER, OPT),
    ("codePhase", Int(0, 1022)), ("intCodePhase", Int(0, 19)),
    ("gpsBitNumber", Int(0, 3)), ("codePhaseSearchWindow", Int(0, 15)),
    ("addionalAngle", ADDIONAL_ANGLE, OPT)])
TIME_RELATION = Seq([("gpsTOW", Int(0, 7559999)),
                     ("gsmTime", GSM_TIME, OPT)])
ACQUIS_ASSIST = Seq([("timeRelation", TIME_RELATION),
                     ("acquisList", SeqOf(ACQUIS_ELEMENT, 1, 16))])
CONTROL_HEADER = Seq([
    ("referenceTime", REFERENCE_TIME, OPT),
    ("refLocation", REF_LOCATION, OPT),
    ("dgpsCorrections", DGPS_CORRECTIONS, OPT),
    ("navigationModel", NAVIGATION_MODEL, OPT),
    ("ionosphericModel", IONOSPHERIC_MODEL, OPT),
    ("utcModel", UTC_MODEL, OPT),
    ("almanac", ALMANAC, OPT),
    ("acquisAssist", ACQUIS_ASSIST, OPT),
    ("realTimeIntegrity", SeqOf(SATELLITE_ID, 1, 16), OPT)])
GPS_ASSIST_DATA = Seq([("controlHeader", CONTROL_HEADER)])
MORE_ASS_DATA = Enum(("noMoreMessages", "moreMessagesOnTheWay"))
ASSISTANCE_DATA = Seq([
    ("referenceAssistData", Unsupported("referenceAssistData"), OPT),
    ("msrAssistData", Unsupported("msrAssistData"), OPT),
    ("systemInfoAssistData", Unsupported("systemInfoAssistData"), OPT),
    ("gps-AssistData", GPS_ASSIST_DATA, OPT),
    ("moreAssDataToBeSent", MORE_ASS_DATA, OPT),
    ("extensionContainer", Int(), OPT)], ext=True)
ERROR_CODES = Enum((
    "unDefined", "missingComponet", "incorrectData",
    "missingIEorComponentElement", "messageTooShort",
    "unknowReferenceNumber"), ext=True)
PROTOCOL_ERROR = Seq([("errorCause", ERROR_CODES),
                      ("extensionContainer", Int(), OPT)], ext=True)
RRLP_COMPONENT = Choice([
    ("msrPositionReq", Unsupported("MsrPosition-Req")),
    ("msrPositionRsp", Unsupported("MsrPosition-Rsp")),
    ("assistanceData", ASSISTANCE_DATA),
    ("assistanceDataAck", Null()),
    ("protocolError", PROTOCOL_ERROR)], ext=True)
RRLP_PDU = Seq([("referenceNumber", Int(0, 7)),
                ("component", RRLP_COMPONENT)])


def encode_rrlp(pdu: dict) -> bytes:
    w = BitWriter()
    RRLP_PDU.enc(w, pdu)
    return w.to_bytes()


def decode_rrlp(data: bytes) -> dict:
    return RRLP_PDU.dec(BitReader(data))


# ============================================== assistance data extraction
# LNAV scalings (IS-GPS-200 Table 20-I..IV) — the RRLP ephemeris fields
# are the raw broadcast integers (gnss_sdr_supl_client.cc read_supl_data)
_SEMI = math.pi


def ephemeris_from_rrlp(sat_id: int, e: dict):
    """UncompressedEphemeris dict -> telemetry.lnav.GpsEphemeris."""
    from gnss_sdr_tpu_torch.telemetry.lnav import GpsEphemeris

    return GpsEphemeris(
        prn=sat_id + 1,
        iodc=e["ephemIODC"],
        iode_sf2=e["ephemIODC"] & 0xFF,
        iode_sf3=e["ephemIODC"] & 0xFF,
        week=0,
        sv_health=e["ephemSVhealth"], ura_index=e["ephemURA"],
        has_sf1=True, has_sf2=True, has_sf3=True,
        tgd=e["ephemTgd"] * 2.0 ** -31,
        toc=e["ephemToc"] * 16.0,
        af2=e["ephemAF2"] * 2.0 ** -55,
        af1=e["ephemAF1"] * 2.0 ** -43,
        af0=e["ephemAF0"] * 2.0 ** -31,
        crs=e["ephemCrs"] * 2.0 ** -5,
        delta_n=e["ephemDeltaN"] * 2.0 ** -43 * _SEMI,
        m0=e["ephemM0"] * 2.0 ** -31 * _SEMI,
        cuc=e["ephemCuc"] * 2.0 ** -29,
        ecc=e["ephemE"] * 2.0 ** -33,
        cus=e["ephemCus"] * 2.0 ** -29,
        sqrt_a=e["ephemAPowerHalf"] * 2.0 ** -19,
        toe=e["ephemToe"] * 16.0,
        cic=e["ephemCic"] * 2.0 ** -29,
        omega0=e["ephemOmegaA0"] * 2.0 ** -31 * _SEMI,
        cis=e["ephemCis"] * 2.0 ** -29,
        i0=e["ephemI0"] * 2.0 ** -31 * _SEMI,
        crc=e["ephemCrc"] * 2.0 ** -5,
        omega=e["ephemW"] * 2.0 ** -31 * _SEMI,
        omega_dot=e["ephemOmegaADot"] * 2.0 ** -43 * _SEMI,
        idot=e["ephemIDot"] * 2.0 ** -43 * _SEMI,
    )


def extract_assistance(rrlp: dict) -> dict:
    """Decoded RRLP PDU -> assistance dict: ephemerides {('G',prn): eph},
    iono KlobucharParams, utc dict, ref_time (tow_s, week), ref_location
    ECEF-free geodetic tuple, acquisition list."""
    out: dict = {"ephemerides": {}, "iono": None, "utc": None,
                 "ref_time": None, "ref_location": None, "acq": [],
                 "more": False}
    kind, comp = rrlp["component"]
    if kind != "assistanceData":
        return out
    out["more"] = comp.get("moreAssDataToBeSent") == "moreMessagesOnTheWay"
    gad = comp.get("gps-AssistData")
    if gad is None:
        return out
    ch = gad["controlHeader"]
    rt = ch.get("referenceTime")
    if rt is not None:
        out["ref_time"] = (rt["gpsTime"]["gpsTOW23b"] * 0.08,
                           rt["gpsTime"]["gpsWeek"])
    rl = ch.get("refLocation")
    if rl is not None:
        out["ref_location"] = decode_geographical_info(
            rl["threeDLocation"])
    nm = ch.get("navigationModel")
    if nm is not None:
        for el in nm["navModelList"]:
            status, val = el["satStatus"]
            if status in ("newSatelliteAndModelUC", "newNaviModelUC"):
                eph = ephemeris_from_rrlp(el["satelliteID"], val)
                out["ephemerides"][("G", eph.prn)] = eph
    im = ch.get("ionosphericModel")
    if im is not None:
        from gnss_sdr_tpu_torch.pvt.atmosphere import KlobucharParams

        out["iono"] = KlobucharParams(
            alpha=(im["alfa0"] * 2.0 ** -30, im["alfa1"] * 2.0 ** -27,
                   im["alfa2"] * 2.0 ** -24, im["alfa3"] * 2.0 ** -24),
            beta=(im["beta0"] * 2.0 ** 11, im["beta1"] * 2.0 ** 14,
                  im["beta2"] * 2.0 ** 16, im["beta3"] * 2.0 ** 16))
    um = ch.get("utcModel")
    if um is not None:
        out["utc"] = {
            "a0": um["utcA0"] * 2.0 ** -30,
            "a1": um["utcA1"] * 2.0 ** -50,
            "tot": um["utcTot"] * 4096.0, "wnt": um["utcWNt"],
            "delta_tls": um["utcDeltaTls"], "wnlsf": um["utcWNlsf"],
            "dn": um["utcDN"], "delta_tlsf": um["utcDeltaTlsf"]}
    aa = ch.get("acquisAssist")
    if aa is not None:
        for el in aa["acquisList"]:
            out["acq"].append({
                "prn": el["svid"] + 1,
                "doppler_hz": el["doppler0"] * 2.5,
                "code_phase_chips": el["codePhase"],
                "int_code_phase_ms": el["intCodePhase"],
                "search_window": el["codePhaseSearchWindow"]})
    return out


def decode_geographical_info(data: bytes):
    """3GPP TS 23.032 Ext-GeographicalInformation: ellipsoid point
    (+altitude) -> (lat_deg, lon_deg, alt_m|None)."""
    if not data:
        return None
    shape = data[0] >> 4
    lat_raw = int.from_bytes(data[1:4], "big")
    sign = -1.0 if (lat_raw & 0x800000) else 1.0
    lat = sign * (lat_raw & 0x7FFFFF) * 90.0 / 2 ** 23
    lon_raw = int.from_bytes(data[4:7], "big")
    if lon_raw >= 1 << 23:
        lon_raw -= 1 << 24
    lon = lon_raw * 360.0 / 2 ** 24
    alt = None
    if shape in (8, 9) and len(data) >= 9:       # point with altitude
        alt_raw = int.from_bytes(data[7:9], "big")
        alt = float(alt_raw & 0x7FFF)
        if alt_raw & 0x8000:
            alt = -alt
    return (lat, lon, alt)


# ================================================================ session
@dataclass
class SuplConfig:
    server: str = "supl.google.com"
    port: int = 7275
    use_tls: bool = True
    imsi_bcd: bytes = b"\x09\x91\x42\x35\x71\x99\x22\xf0"
    # current cell (LocationId is mandatory in SUPL)
    mcc: int = 244
    mnc: int = 5
    lac: int = 0x59E2
    ci: int = 0x31D2
    request: int = 1               # 0 alm/time/pos, 1 nav model, 2 acq


class SuplClient:
    """SET-initiated SUPL session (supl.c supl_get_assist analog).

    ``transport``: optional injected object with send(bytes)/recv()->bytes
    for tests; otherwise a TCP(+TLS) socket to cfg.server."""

    def __init__(self, cfg: SuplConfig | None = None,
                 transport=None) -> None:
        self.cfg = cfg or SuplConfig()
        self.transport = transport
        self._sock = None
        self.slp_session_id = None

    # ---------------------------------------------------------- transport
    def _connect(self) -> None:
        raw = socket.create_connection(
            (self.cfg.server, self.cfg.port), timeout=15.0)
        if self.cfg.use_tls:
            ctx = _ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = _ssl.CERT_NONE     # like the reference
            self._sock = ctx.wrap_socket(raw)
        else:
            self._sock = raw

    def _send(self, data: bytes) -> None:
        if self.transport is not None:
            self.transport.send(data)
        else:
            self._sock.sendall(data)

    def _recv_pdu(self) -> dict:
        if self.transport is not None:
            return decode_ulp(self.transport.recv())
        # the ULP length field is the first 16 bits of the message
        head = b""
        while len(head) < 2:
            chunk = self._sock.recv(2 - len(head))
            if not chunk:
                raise ConnectionError("SLP closed the connection")
            head += chunk
        total = int.from_bytes(head, "big")
        buf = head
        while len(buf) < total:
            chunk = self._sock.recv(total - len(buf))
            if not chunk:
                raise ConnectionError("short ULP read")
            buf += chunk
        return decode_ulp(buf)

    # ------------------------------------------------------------ messages
    def _session_id(self) -> dict:
        return {
            "setSessionID": {
                "sessionId": 1,
                "setId": ("imsi", self.cfg.imsi_bcd)},
            "slpSessionID": self.slp_session_id,
        }

    def _location_id(self) -> dict:
        return {"cellInfo": ("gsmCell", {
            "refMCC": self.cfg.mcc, "refMNC": self.cfg.mnc,
            "refLAC": self.cfg.lac, "refCI": self.cfg.ci,
            "nMR": None, "tA": None}),
            "status": "current"}

    def _capabilities(self) -> dict:
        return {
            "posTechnology": {
                "agpsSETassisted": False, "agpsSETBased": True,
                "autonomousGPS": False, "aFLT": False, "eCID": False,
                "eOTD": False, "oTDOA": False},
            "prefMethod": "agpsSETBasedPreferred",
            "posProtocol": {"tia801": False, "rrlp": True,
                            "rrc": False}}

    def make_start(self) -> bytes:
        return encode_ulp({
            "version": {"maj": 1, "min": 0, "servind": 0},
            "sessionID": {"setSessionID": self._session_id()[
                "setSessionID"], "slpSessionID": None},
            "message": ("msSUPLSTART", {
                "sETCapabilities": self._capabilities(),
                "locationId": self._location_id(),
                "qoP": None})})

    def make_pos_init(self) -> bytes:
        req = {
            "almanacRequested": self.cfg.request != 1,
            "utcModelRequested": self.cfg.request != 1,
            "ionosphericModelRequested": self.cfg.request != 1,
            "dgpsCorrectionsRequested": False,
            "referenceLocationRequested": self.cfg.request != 1,
            "referenceTimeRequested": True,
            "acquisitionAssistanceRequested": self.cfg.request == 2,
            "realTimeIntegrityRequested": self.cfg.request != 1,
            "navigationModelRequested": self.cfg.request == 1,
            "navigationModelData": None,
        }
        return encode_ulp({
            "version": {"maj": 1, "min": 0, "servind": 0},
            "sessionID": self._session_id(),
            "message": ("msSUPLPOSINIT", {
                "sETCapabilities": self._capabilities(),
                "requestedAssistData": req,
                "locationId": self._location_id(),
                "position": None, "sUPLPOS": None, "ver": None})})

    def make_rrlp_ack(self, ref_number: int) -> bytes:
        rrlp = encode_rrlp({"referenceNumber": ref_number,
                            "component": ("assistanceDataAck", None)})
        return encode_ulp({
            "version": {"maj": 1, "min": 0, "servind": 0},
            "sessionID": self._session_id(),
            "message": ("msSUPLPOS", {
                "posPayLoad": ("rrlpPayload", rrlp),
                "velocity": None})})

    def make_end(self) -> bytes:
        return encode_ulp({
            "version": {"maj": 1, "min": 0, "servind": 0},
            "sessionID": self._session_id(),
            "message": ("msSUPLEND", {
                "position": None, "statusCode": "unspecified",
                "ver": None})})

    # ------------------------------------------------------------- session
    def get_assistance(self) -> dict:
        """Full SET-initiated flow; returns merged extract_assistance()
        output (supl.c supl_get_assist analog)."""
        if self.transport is None:
            self._connect()
        try:
            self._send(self.make_start())
            resp = self._recv_pdu()
            kind, msg = resp["message"]
            if kind == "msSUPLEND":
                raise RuntimeError(
                    f"SLP ended session: {msg.get('statusCode')}")
            if kind != "msSUPLRESPONSE":
                raise RuntimeError(f"unexpected {kind} after SUPL-START")
            # harvest slpSessionID for subsequent messages
            self.slp_session_id = resp["sessionID"].get("slpSessionID")
            self._send(self.make_pos_init())

            merged: dict = {"ephemerides": {}, "iono": None, "utc": None,
                            "ref_time": None, "ref_location": None,
                            "acq": [], "more": False}
            while True:
                pdu = self._recv_pdu()
                kind, msg = pdu["message"]
                if kind == "msSUPLEND":
                    break
                if kind != "msSUPLPOS":
                    raise RuntimeError(f"unexpected {kind} in POS phase")
                pk, payload = msg["posPayLoad"]
                if pk != "rrlpPayload":
                    raise RuntimeError(f"unsupported payload {pk}")
                rrlp = decode_rrlp(payload)
                got = extract_assistance(rrlp)
                merged["ephemerides"].update(got["ephemerides"])
                for k in ("iono", "utc", "ref_time", "ref_location"):
                    if got[k] is not None:
                        merged[k] = got[k]
                merged["acq"].extend(got["acq"])
                if got["more"]:
                    self._send(self.make_rrlp_ack(
                        rrlp["referenceNumber"]))
                else:
                    self._send(self.make_end())
            return merged
        finally:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
