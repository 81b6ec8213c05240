# Copied from gnss_sdr_tpu/io/ion_gsms.py; only the package imports are rewritten.
"""ION GNSS Metadata Standard (GSMS) file source — pragmatic subset.

Reference analog: src/algorithms/signal_source/gnuradio_blocks/ion_gsms.cc
(ION_GSMS_Signal_Source adapter), which uses the external GnssMetadata C++
library to interpret an XML description of an arbitrary packed capture.

This module implements the common single-lane / single-stream subset of the
standard: a ``<metadata>`` document with ``<file>`` (data-file URL +
owning lane), ``<lane>`` -> ``<block>`` -> ``<chunk>`` -> ``<lump>`` ->
``<stream>`` describing one sample stream with

- ``<ratefactor>``/``<rate>``: sampling rate,
- ``<quantization>``: bits per component (2/4/8/16),
- ``<encoding>``: "INT8"/"INT16" container two's complement ("TC") or
  sign-magnitude ("SM"; the low formats), and
- ``<format>``: "IQ", "QI", or "IF" (real).

which covers the captures the reference's conf examples drive through this
source. Unsupported layouts raise with a clear message rather than
mis-decoding.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from gnss_sdr_tpu_torch.io.sources import SignalSource


def _find(el, tag):
    """Namespace-insensitive find."""
    for child in el.iter():
        if child.tag.split("}")[-1].lower() == tag.lower():
            return child
    return None


def _text(el, tag, default=None):
    node = _find(el, tag)
    return node.text.strip() if node is not None and node.text else default


class IonGsmsMetadata:
    """Parsed single-stream GSMS metadata."""

    def __init__(self, xml_path: str | Path) -> None:
        self.xml_path = Path(xml_path)
        root = ET.parse(self.xml_path).getroot()
        file_el = _find(root, "file")
        if file_el is None:
            raise ValueError("GSMS metadata: no <file> element")
        url = _text(file_el, "url")
        if not url:
            raise ValueError("GSMS metadata: <file> has no <url>")
        self.data_path = (self.xml_path.parent / url).resolve()
        # the <file> element also holds a <lane> *reference*; pick the lane
        # definition (the one that contains a <stream>)
        stream = None
        for el in root.iter():
            if el.tag.split("}")[-1].lower() == "lane":
                stream = _find(el, "stream")
                if stream is not None:
                    break
        if stream is None:
            raise ValueError("GSMS metadata: no <lane> with a <stream>")
        self.fs = float(_text(root, "rate", 0) or _text(root, "ratefactor", 0)
                        or 0)
        self.quantization = int(_text(stream, "quantization", 8))
        self.encoding = (_text(stream, "encoding", "INT8") or "INT8").upper()
        self.fmt = (_text(stream, "format", "IQ") or "IQ").upper()
        if self.fmt not in ("IQ", "QI", "IF"):
            raise ValueError(f"GSMS: unsupported stream format {self.fmt!r}")
        if self.quantization not in (2, 4, 8, 16):
            raise ValueError(
                f"GSMS: unsupported quantization {self.quantization}")


class IonGsmsSignalSource(SignalSource):
    """Single-stream GSMS capture reader (ION_GSMS_Signal_Source analog)."""

    def __init__(self, metadata_file: str | Path,
                 fs_override: float | None = None) -> None:
        self.meta = IonGsmsMetadata(metadata_file)
        self.fs = fs_override or self.meta.fs
        q = self.meta.quantization
        cplx = self.meta.fmt in ("IQ", "QI")
        if q == 8:
            self._file_fmt = "ibyte" if cplx else "byte"
        elif q == 16:
            self._file_fmt = "ishort" if cplx else "short"
        elif q == 4:
            self._file_fmt = "4bit_cpx" if cplx else "4bit_real"
        else:
            self._file_fmt = "2bit_cpx" if cplx else "2bit_real"
        from gnss_sdr_tpu_torch.io.formats import bytes_per_sample

        self._bps = bytes_per_sample(self._file_fmt)
        self._f = open(self.meta.data_path, "rb")
        size = os.path.getsize(self.meta.data_path)
        self.total_samples = int(size / self._bps)
        self._eof = False

    def read(self, num_samples: int) -> np.ndarray:
        from gnss_sdr_tpu_torch.io.formats import decode_samples

        if self.exhausted():
            return np.zeros(0, dtype=np.complex64)
        nbytes = int(np.ceil(num_samples * self._bps))
        raw = self._f.read(nbytes)
        if len(raw) < nbytes:
            self._eof = True
        x = decode_samples(raw, self._file_fmt)[:num_samples]
        if self.meta.fmt == "QI":
            # decoded pairs are (Q, I): swap components
            x = (x.imag + 1j * x.real).astype(np.complex64)
        self.samples_read += len(x)
        return x

    def exhausted(self) -> bool:
        return self._eof or self.samples_read >= self.total_samples

    def close(self) -> None:
        self._f.close()
