# Copied from gnss_sdr_tpu/io/formats.py; only the package imports are rewritten.
"""Sample-format decoding: raw capture bytes -> complex64 baseband.

Host-side ingest layer covering the reference's data-type adapters and
bit-unpacker blocks (SURVEY.md §2.2 signal sources):

- item formats of File_Signal_Source (file_source_base.cc item-size mapping):
  ``byte``, ``ibyte``/``cbyte``, ``short``, ``ishort``/``cshort``, ``float``,
  ``gr_complex``;
- packed formats: 2-bit and 4-bit two's-complement samples, LSB-first within
  each byte, real or interleaved-complex
  (reference: signal_source/gnuradio_blocks/unpack_byte_2bit_samples.cc,
  unpack_byte_2bit_cpx_samples.cc, unpack_byte_4bit_samples.cc — each byte
  holds 4x2-bit or 2x4-bit sign-extended fields, extracted low bits first).

Decoding runs vectorized in NumPy on the host: ingest is IO-bound, the
arrays then move to device once per block. The corresponding *device-side*
dtype casts live in conditioner/adapters.py for pipelines that ship the raw
integer stream to the TPU and widen there (cheaper host->device transfer:
int8 is 1/8 the bytes of complex64).
"""

from __future__ import annotations

import numpy as np

# item format -> (numpy dtype of one file item, items per complex sample)
_FORMATS = {
    "byte": (np.int8, 1),        # real int8
    "short": (np.int16, 1),      # real int16
    "float": (np.float32, 1),    # real float32
    "ibyte": (np.int8, 2),       # interleaved int8 I,Q
    "cbyte": (np.int8, 2),
    "ishort": (np.int16, 2),     # interleaved int16 I,Q
    "cshort": (np.int16, 2),
    "gr_complex": (np.complex64, 1),
}

PACKED_FORMATS = ("2bit_real", "2bit_cpx", "4bit_real", "4bit_cpx",
                  "spir_1bit", "gss6450_2bit", "gss6450_4bit", "ntlab_2bit")


def item_format_names() -> tuple[str, ...]:
    return tuple(_FORMATS) + PACKED_FORMATS


def bytes_per_sample(fmt: str) -> float:
    """File bytes per complex output sample (fractional for packed formats)."""
    if fmt in _FORMATS:
        dt, k = _FORMATS[fmt]
        return np.dtype(dt).itemsize * k
    if fmt == "2bit_real":
        return 0.25
    if fmt == "2bit_cpx":
        return 0.5
    if fmt == "4bit_real":
        return 0.5
    if fmt == "4bit_cpx":
        return 1.0
    if fmt == "spir_1bit":       # one complex sample per int32 word
        return 4.0
    if fmt == "gss6450_2bit":    # 8 complex samples per uint32 word
        return 0.5
    if fmt == "gss6450_4bit":    # 4 complex samples per uint32 word
        return 1.0
    if fmt == "ntlab_2bit":      # 4 real sign/magnitude samples per byte
        return 0.25
    raise ValueError(f"unknown sample format: {fmt!r}")


def _sign_extend_2bit(b: np.ndarray) -> np.ndarray:
    """Unpack 4x 2-bit two's-complement fields per byte, LSB-first.

    Matches the reference's ``signed two_bit_sample : 2`` bitfield extraction
    (unpack_byte_2bit_samples.cc work()).
    """
    from gnss_sdr_tpu_torch import native

    nat = native.unpack_2bit(b)
    if nat is not None:
        return nat
    b = b.astype(np.uint8)
    out = np.empty((b.size, 4), dtype=np.int8)
    for k in range(4):
        v = (b >> (2 * k)) & 0x3
        out[:, k] = np.where(v >= 2, v.astype(np.int16) - 4, v).astype(np.int8)
    return out.reshape(-1)


def _sign_extend_4bit(b: np.ndarray) -> np.ndarray:
    """Unpack 2x 4-bit two's-complement fields per byte, LSB-first
    (unpack_byte_4bit_samples.cc)."""
    from gnss_sdr_tpu_torch import native

    nat = native.unpack_4bit(b)
    if nat is not None:
        return nat
    b = b.astype(np.uint8)
    out = np.empty((b.size, 2), dtype=np.int8)
    for k in range(2):
        v = (b >> (4 * k)) & 0xF
        out[:, k] = np.where(v >= 8, v.astype(np.int16) - 16, v).astype(np.int8)
    return out.reshape(-1)


def decode_samples(raw: bytes | np.ndarray, fmt: str) -> np.ndarray:
    """Decode raw capture bytes into complex64 samples.

    Real formats produce complex with zero Q (the reference feeds real IF
    streams through Byte_To_Short/Ibyte_To_Complex-style adapters before the
    freq-xlating filter; the complexification happens there too).
    """
    buf = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
    if fmt in _FORMATS:
        dt, k = _FORMATS[fmt]
        items = buf.view(dt) if buf.dtype == np.uint8 else buf.astype(dt)
        if fmt == "gr_complex":
            return items.astype(np.complex64)
        if k == 1:
            return items.astype(np.float32).astype(np.complex64)
        iq = items.reshape(-1, 2).astype(np.float32)
        return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    if fmt == "spir_1bit":
        # SPIR 1-bit: one int32 word per complex sample, channel-1 layout
        # I = bit 0, Q = bit 1, bit value 1 -> +1 / 0 -> -1
        # (reference unpack_intspir_1bit_samples.cc work(); the reference
        # scales to +-32767 for historical reasons — normalized here)
        w = buf[: 4 * (buf.size // 4)].view(np.uint32)
        i = ((w & 1).astype(np.float32) * 2.0 - 1.0)
        q = (((w >> 1) & 1).astype(np.float32) * 2.0 - 1.0)
        return (i + 1j * q).astype(np.complex64)
    if fmt in ("gss6450_2bit", "gss6450_4bit"):
        # SPIR GSS6450: uint32 words, I/Q packed two's complement; the
        # first sample in time sits in the HIGH bits (the reference writes
        # out[7-i]/out[3-i] while extracting from the LSB,
        # unpack_spir_gss6450_samples.cc decode_4bits_word)
        bits = 2 if fmt.endswith("2bit") else 4
        per = 32 // (2 * bits)
        mask = (1 << bits) - 1
        half = 1 << (bits - 1)
        w = buf[: 4 * (buf.size // 4)].view(np.uint32)
        out = np.empty((w.size, per), dtype=np.complex64)
        for k in range(per):                    # k = 0 is first in time
            shift = 2 * bits * (per - 1 - k)
            iv = ((w >> shift) & mask).astype(np.int32)
            qv = ((w >> (shift + bits)) & mask).astype(np.int32)
            iv = np.where(iv >= half, iv - (2 * half), iv)
            qv = np.where(qv >= half, qv - (2 * half), qv)
            out[:, k] = iv.astype(np.float32) + 1j * qv.astype(np.float32)
        return out.reshape(-1)
    if fmt == "ntlab_2bit":
        # NTLab: 4 sign/magnitude samples per byte, MSB-first; magnitude
        # bit above the sign bit; levels +-1 / +-3
        # (unpack_ntlab_2bit_samples.cc work())
        out = np.empty((buf.size, 4), dtype=np.float32)
        for n in range(4):
            shift = 2 * (3 - n)
            mbit = (buf >> (shift + 1)) & 1
            sbit = (buf >> shift) & 1
            mag = np.where(mbit == 1, 3.0, 1.0).astype(np.float32)
            out[:, n] = np.where(sbit == 1, mag, -mag)
        return out.reshape(-1).astype(np.complex64)
    if fmt.startswith("2bit"):
        fields = _sign_extend_2bit(buf)
    elif fmt.startswith("4bit"):
        fields = _sign_extend_4bit(buf)
    else:
        raise ValueError(f"unknown sample format: {fmt!r}")
    if fmt.endswith("_real"):
        return fields.astype(np.float32).astype(np.complex64)
    iq = fields.reshape(-1, 2).astype(np.float32)
    return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)


def encode_samples(x: np.ndarray, fmt: str) -> bytes:
    """Inverse of decode_samples, for writing test captures.

    Values are rounded and clipped to the format's range; packed formats pack
    LSB-first two's complement.
    """
    x = np.asarray(x)
    if fmt in _FORMATS:
        dt, k = _FORMATS[fmt]
        if fmt == "gr_complex":
            return np.ascontiguousarray(x.astype(np.complex64)).tobytes()
        if k == 1:
            info = np.iinfo(dt) if np.issubdtype(dt, np.integer) else None
            v = x.real if np.iscomplexobj(x) else x
            if info:
                v = np.clip(np.round(v), info.min, info.max)
            return np.ascontiguousarray(v.astype(dt)).tobytes()
        info = np.iinfo(dt)
        iq = np.empty(2 * x.size, dtype=dt)
        iq[0::2] = np.clip(np.round(x.real), info.min, info.max).astype(dt)
        iq[1::2] = np.clip(np.round(x.imag), info.min, info.max).astype(dt)
        return iq.tobytes()

    if fmt == "spir_1bit":
        w = ((np.real(x) > 0).astype(np.uint32)
             | ((np.imag(x) > 0).astype(np.uint32) << 1))
        return w.tobytes()
    if fmt in ("gss6450_2bit", "gss6450_4bit"):
        bits = 2 if fmt.endswith("2bit") else 4
        per = 32 // (2 * bits)
        half = 1 << (bits - 1)
        mask = (1 << bits) - 1
        pad = (-x.size) % per
        xv = np.concatenate([x.reshape(-1), np.zeros(pad, x.dtype)])
        iv = np.clip(np.round(xv.real), -half, half - 1).astype(np.int64) & mask
        qv = np.clip(np.round(xv.imag), -half, half - 1).astype(np.int64) & mask
        w = np.zeros(xv.size // per, dtype=np.int64)
        for k in range(per):
            shift = 2 * bits * (per - 1 - k)
            w |= iv[k::per] << shift
            w |= qv[k::per] << (shift + bits)
        return w.astype(np.uint32).tobytes()
    if fmt == "ntlab_2bit":
        v = np.real(x)
        pad = (-v.size) % 4
        v = np.concatenate([v.reshape(-1), np.ones(pad)])
        sbit = (v > 0).astype(np.int64)
        mbit = (np.abs(v) >= 2).astype(np.int64)
        b = np.zeros(v.size // 4, dtype=np.int64)
        for n in range(4):
            shift = 2 * (3 - n)
            b |= sbit[n::4] << shift
            b |= mbit[n::4] << (shift + 1)
        return b.astype(np.uint8).tobytes()
    if fmt.startswith("2bit"):
        bits, lo, hi = 2, -2, 1
    elif fmt.startswith("4bit"):
        bits, lo, hi = 4, -8, 7
    else:
        raise ValueError(f"unknown sample format: {fmt!r}")
    if fmt.endswith("_real"):
        fields = np.clip(np.round(x.real if np.iscomplexobj(x) else x), lo, hi)
    else:
        fields = np.empty(2 * x.size)
        fields[0::2] = np.clip(np.round(x.real), lo, hi)
        fields[1::2] = np.clip(np.round(x.imag), lo, hi)
    fields = fields.astype(np.int64) & ((1 << bits) - 1)
    per_byte = 8 // bits
    pad = (-len(fields)) % per_byte
    fields = np.concatenate([fields, np.zeros(pad, dtype=np.int64)])
    grp = fields.reshape(-1, per_byte)
    byte = np.zeros(grp.shape[0], dtype=np.int64)
    for k in range(per_byte):
        byte |= grp[:, k] << (bits * k)
    return byte.astype(np.uint8).tobytes()
