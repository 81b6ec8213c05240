# Copied from gnss_sdr_tpu/telemetry/osnma.py; only the package imports are rewritten.
"""Galileo OSNMA: navigation-message authentication (TESLA + ECDSA).

Reference analog: src/core/libs/osnma_msg_receiver.{h,cc} (protocol state
machine) and src/core/libs/gnss_crypto.{h,cc} (ECDSA P-256/P-521,
HMAC-SHA-256, CMAC-AES primitives). This implementation covers the OSNMA
SIS ICD v1.1 core:

- HKROOT assembly: 8 bits per INAV page -> 120-bit subframe messages ->
  DSM-KROOT blocks -> chain parameters + root key + digital signature;
- ECDSA P-256 verification of the DSM-KROOT against the Merkle-tree
  public key (cryptography library; the reference links OpenSSL/GnuTLS);
- TESLA key-chain verification: a released key K_m hashes back to the
  verified KROOT through m rounds of trunc(H(K || GST || alpha));
- MACK tag verification: truncated HMAC-SHA-256 (or CMAC-AES) of the
  authenticated navigation data with the next-released (delayed) key.

The engine is transport-agnostic: callers feed per-subframe
(hkroot_bits[120], mack_bits[480]) extracted from the INAV OSNMA field,
plus the navigation data to authenticate. A matching OsnmaSigner builds
valid streams for tests/simulation (the role gnss-sim's OSNMA mode plays
for the reference)."""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
from dataclasses import dataclass, field

import numpy as np

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.cmac import CMAC
    from cryptography.hazmat.primitives.ciphers.algorithms import AES

    _HAVE_CRYPTO = True
except Exception:  # pragma: no cover - environment without cryptography
    _HAVE_CRYPTO = False


def _bits_to_bytes(bits: np.ndarray) -> bytes:
    bits = np.asarray(bits, dtype=np.uint8)
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits).tobytes()


def _bytes_to_bits(data: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8))[:n]


def _take(bits: np.ndarray, pos: int, n: int) -> int:
    v = 0
    for b in bits[pos: pos + n]:
        v = (v << 1) | int(b)
    return v


@dataclass
class ChainParams:
    """DSM-KROOT payload (OSNMA ICD §3.2.3)."""

    hash_func: int = 0            # 0: SHA-256, 2: SHA3-256
    mac_func: int = 0             # 0: HMAC-SHA-256, 1: CMAC-AES
    key_size_bits: int = 128
    tag_size_bits: int = 40
    alpha: int = 0                # 48-bit chain randomizer
    wn0: int = 0                  # chain start week
    tow0_hours: int = 0           # chain start time (hours)
    kroot: bytes = b""


class OsnmaCrypto:
    """The primitive set of the reference's gnss_crypto.cc."""

    @staticmethod
    def hash_fn(params: ChainParams, data: bytes) -> bytes:
        if params.hash_func == 2:
            return hashlib.sha3_256(data).digest()
        return hashlib.sha256(data).digest()

    @staticmethod
    def mac_fn(params: ChainParams, key: bytes, data: bytes) -> bytes:
        if params.mac_func == 1:
            if not _HAVE_CRYPTO:
                raise RuntimeError("CMAC-AES requires cryptography")
            c = CMAC(AES(key[:16].ljust(16, b"\0")))
            c.update(data)
            return c.finalize()
        return hmac_mod.new(key, data, hashlib.sha256).digest()

    @staticmethod
    def ecdsa_verify(public_key, message: bytes, signature: bytes) -> bool:
        if not _HAVE_CRYPTO:
            return False
        try:
            public_key.verify(signature, message, ec.ECDSA(hashes.SHA256()))
            return True
        except InvalidSignature:
            return False


def tesla_previous_key(params: ChainParams, key: bytes,
                       gst_bits: int) -> bytes:
    """K_{m-1} = trunc(H(K_m || GST_sf || alpha)) (ICD §6.4)."""
    msg = key + gst_bits.to_bytes(4, "big") + params.alpha.to_bytes(6, "big")
    return OsnmaCrypto.hash_fn(params, msg)[: params.key_size_bits // 8]


def verify_tesla_key(params: ChainParams, key: bytes, m: int,
                     gst_of: callable) -> bool:
    """Hash K_m back m rounds to KROOT; gst_of(i) gives the GST word for
    round i (the subframe time the key belongs to)."""
    k = key
    for i in range(m, 0, -1):
        k = tesla_previous_key(params, k, gst_of(i - 1))
    return k == params.kroot


# ------------------------------------------------------------- DSM-KROOT
def build_dsm_kroot(params: ChainParams, signature: bytes) -> np.ndarray:
    """Serialize chain params + DS into DSM-KROOT bits (simplified field
    layout preserving the ICD's content; 13-byte header + KROOT + DS)."""
    head = np.zeros(13 * 8, dtype=np.uint8)
    def put(pos, n, v):
        for i in range(n):
            head[pos + i] = (v >> (n - 1 - i)) & 1
    put(0, 4, params.hash_func)
    put(4, 4, params.mac_func)
    put(8, 8, params.key_size_bits // 8)
    put(16, 8, params.tag_size_bits)
    put(24, 16, params.wn0)
    put(40, 8, params.tow0_hours)
    put(48, 48, params.alpha)
    put(96, 8, len(signature))
    kroot_bits = _bytes_to_bits(params.kroot, params.key_size_bits)
    sig_bits = _bytes_to_bits(signature, len(signature) * 8)
    return np.concatenate([head, kroot_bits, sig_bits])


def parse_dsm_kroot(bits: np.ndarray) -> tuple[ChainParams, bytes]:
    p = ChainParams(
        hash_func=_take(bits, 0, 4),
        mac_func=_take(bits, 4, 4),
        key_size_bits=_take(bits, 8, 8) * 8,
        tag_size_bits=_take(bits, 16, 8),
        wn0=_take(bits, 24, 16),
        tow0_hours=_take(bits, 40, 8),
        alpha=_take(bits, 48, 48),
    )
    sig_len = _take(bits, 96, 8)
    kb = p.key_size_bits
    p.kroot = _bits_to_bytes(bits[104: 104 + kb])
    sig = _bits_to_bytes(bits[104 + kb: 104 + kb + sig_len * 8])
    return p, sig


# ------------------------------------------------------------------ engine
@dataclass
class TagReport:
    prn: int
    subframe_gst: int
    ok: bool


class OsnmaReceiver:
    """Per-receiver OSNMA state machine (osnma_msg_receiver.cc analog).

    feed(subframe_gst, hkroot120, mack_bits, nav_bits) per 30 s subframe;
    tags verify one subframe later when the TESLA key is disclosed."""

    def __init__(self, public_key=None) -> None:
        self.public_key = public_key
        self.params: ChainParams | None = None
        self.kroot_verified = False
        self._dsm_blocks: dict[int, np.ndarray] = {}
        self._dsm_total: int | None = None
        self._pending: list = []        # (gst, tag_bytes, nav_bits, prn)
        self._key_cache: dict[int, bytes] = {}
        self.reports: list[TagReport] = []
        self.authenticated_subframes = 0
        self.failed_subframes = 0

    # -- HKROOT path
    def feed_hkroot(self, sf_index: int, hkroot120: np.ndarray) -> None:
        """120 HKROOT bits of one subframe: NMA header(8) + DSM ID(4) +
        block ID(4) + 104-bit block."""
        block_id = _take(hkroot120, 12, 4)
        nb = _take(hkroot120, 16, 8)    # first block: total block count
        if block_id == 0:
            self._dsm_total = nb if nb > 0 else None
        self._dsm_blocks[block_id] = hkroot120[16:]
        if (self._dsm_total and not self.kroot_verified
                and len(self._dsm_blocks) >= self._dsm_total
                and all(i in self._dsm_blocks
                        for i in range(self._dsm_total))):
            payload = np.concatenate([
                self._dsm_blocks[i] for i in range(self._dsm_total)
            ])
            # block 0 starts with the block-count byte; strip it
            params, sig = parse_dsm_kroot(payload[8:])
            # signed content: KROOT + the fixed header fields (the DS
            # length byte varies with DER encoding and is excluded)
            msg = _bits_to_bytes(payload[8: 8 + 96])
            signed = params.kroot + msg
            if self.public_key is None or OsnmaCrypto.ecdsa_verify(
                self.public_key, signed, sig
            ):
                self.params = params
                self.kroot_verified = True

    # -- MACK path
    def feed_mack(self, subframe_gst: int, chain_index: int,
                  mack_bits: np.ndarray, nav_bits: np.ndarray,
                  prn: int) -> None:
        """One subframe's MACK: tag0 (tag_size) + ... + TESLA key at the
        end. chain_index = subframes since chain start (key index)."""
        if self.params is None:
            return
        p = self.params
        ts = p.tag_size_bits
        tag0 = _bits_to_bytes(mack_bits[:ts])
        key = _bits_to_bytes(mack_bits[-p.key_size_bits:])
        # verify the disclosed key against the chain
        def gst_of(i):
            return (p.wn0 << 20) | (p.tow0_hours * 3600 + 30 * i)
        if not verify_tesla_key(p, key, chain_index, gst_of):
            self.failed_subframes += 1
            self.reports.append(TagReport(prn, subframe_gst, False))
            return
        self._key_cache[chain_index] = key
        # tags of subframe i verify with the key of subframe i+1
        self._pending.append((subframe_gst, chain_index, tag0,
                              np.array(nav_bits, np.uint8), prn))
        self._drain()

    def _drain(self) -> None:
        p = self.params
        still = []
        for gst, idx, tag, nav, prn in self._pending:
            key = self._key_cache.get(idx + 1)
            if key is None:
                still.append((gst, idx, tag, nav, prn))
                continue
            msg = prn.to_bytes(1, "big") + gst.to_bytes(4, "big") + \
                _bits_to_bytes(nav)
            full = OsnmaCrypto.mac_fn(p, key, msg)
            ok = full[: p.tag_size_bits // 8] == tag[: p.tag_size_bits // 8]
            self.reports.append(TagReport(prn, gst, ok))
            if ok:
                self.authenticated_subframes += 1
            else:
                self.failed_subframes += 1
        self._pending = still


def inav_auth_message(eph) -> np.ndarray:
    """Canonical ADKD-0 navigation bits for one satellite: the WT1-4
    I/NAV word contents re-packed from the (bit-quantized) ephemeris via
    the encoder's own word builder. Quantized fields round-trip exactly
    through the ICD packing, so simulator-side (transmit ephemeris) and
    receiver-side (decoded ephemeris) calls produce identical bits —
    the tag message both OsnmaSigner and OsnmaReceiver MAC over."""
    from gnss_sdr_tpu_torch.telemetry.inav import InavEncoder

    enc = InavEncoder(eph)
    return np.concatenate([enc._word_bits(wt, 0.0) for wt in (1, 2, 3, 4)])


# ------------------------------------------------------------------ signer
class OsnmaSigner:
    """Test/simulator-side chain builder: generates a TESLA chain, signs
    the KROOT (ECDSA P-256) and emits per-subframe HKROOT/MACK streams."""

    def __init__(self, num_keys: int = 64, seed: int = 0,
                 mac_func: int = 0, wn0: int = 1200,
                 tow0_hours: int = 2) -> None:
        rng = np.random.default_rng(seed)
        self.params = ChainParams(
            hash_func=0, mac_func=mac_func, key_size_bits=128,
            tag_size_bits=40, alpha=int(rng.integers(0, 1 << 48)),
            wn0=wn0, tow0_hours=tow0_hours,
        )
        self._private = (ec.generate_private_key(ec.SECP256R1())
                         if _HAVE_CRYPTO else None)
        self.public_key = (self._private.public_key()
                           if self._private else None)
        # chain: K_N random; K_{m-1} = H(K_m...); KROOT = K_0
        p = self.params
        keys = [None] * (num_keys + 1)
        keys[num_keys] = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
        for m in range(num_keys, 0, -1):
            keys[m - 1] = tesla_previous_key(p, keys[m], self._gst(m - 1))
        self.keys = keys
        p.kroot = keys[0]

    def _gst(self, i: int) -> int:
        p = self.params
        return (p.wn0 << 20) | (p.tow0_hours * 3600 + 30 * i)

    def dsm_kroot_subframes(self) -> list[np.ndarray]:
        """HKROOT 120-bit messages carrying the signed DSM-KROOT."""
        body = build_dsm_kroot(self.params, self._sign())
        nblk = int(np.ceil((len(body) + 8) / 104.0))
        out = []
        padded = np.concatenate([
            np.array([(nblk >> (7 - i)) & 1 for i in range(8)], np.uint8),
            body,
            np.zeros(nblk * 104 - len(body) - 8, np.uint8),
        ])
        for b in range(nblk):
            msg = np.zeros(120, dtype=np.uint8)
            msg[0:8] = [0, 1, 0, 0, 0, 0, 0, 0]      # NMA header: operational
            for i in range(4):
                msg[8 + i] = 0                        # DSM ID 0
                msg[12 + i] = (b >> (3 - i)) & 1      # block id
            msg[16:] = padded[b * 104: (b + 1) * 104]
            out.append(msg)
        return out

    def _sign(self) -> bytes:
        p = self.params
        head = build_dsm_kroot(p, b"")[:96]
        msg = p.kroot + _bits_to_bytes(head)
        if self._private is None:
            return b"\x00" * 64
        return self._private.sign(msg, ec.ECDSA(hashes.SHA256()))

    def mack_subframe(self, chain_index: int, nav_bits: np.ndarray,
                      prn: int) -> np.ndarray:
        """MACK bits for one subframe: tag0 + ... + disclosed key."""
        p = self.params
        key_next = self.keys[chain_index + 1]
        gst = self._gst(chain_index)
        msg = prn.to_bytes(1, "big") + gst.to_bytes(4, "big") + \
            _bits_to_bytes(np.asarray(nav_bits, np.uint8))
        tag = OsnmaCrypto.mac_fn(p, key_next, msg)[: p.tag_size_bits // 8]
        tag_bits = _bytes_to_bits(tag, p.tag_size_bits)
        key_bits = _bytes_to_bits(self.keys[chain_index], p.key_size_bits)
        filler = np.zeros(480 - len(tag_bits) - len(key_bits), np.uint8)
        return np.concatenate([tag_bits, filler, key_bits])
