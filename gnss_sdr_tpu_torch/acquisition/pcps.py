"""Batched PCPS (parallel code-phase search) acquisition.

Counterpart of ``gnss_sdr_tpu/acquisition/pcps.py``. The reference engine
(pcps_acquisition.cc) loops serially over Doppler bins per channel:
wipeoff -> FFT -> x conj(code FFT) -> IFFT -> |.|^2, then CFAR or
peak-ratio detection. Here the (channel, Doppler) hypothesis grid is one
batched tensor program, chunked over the Doppler axis:

    grid[c, d, :] = |IFFT( FFT(x[c] * wipeoff[d]) * conj(CODE_FFT[prn[c]]) )|^2

PRN selection indexes a precomputed code-FFT table. The FFTs are
``torch.fft`` on complex64. Supported: coherent integration over several
code periods, non-coherent dwells, the bit-transition double-length FFT,
both detection statistics, Pfa-derived thresholds, the two-step
Doppler refinement and a per-row frequency-offset table (row p searches
offset[p] + the Doppler grid; the reported Doppler excludes the offset).
The offsets are a device tensor that ``set_offsets`` rewrites in place
between calls, as the assisted engine (``acquisition/engines.py``) does.

With a ``mesh`` (``parallel.sharding.ChannelMesh``) the hypothesis batch
splits over the shards: it is padded by repeating its last row to a
multiple of the mesh size, each shard runs its contiguous rows through
``torch.fft`` on its own device, and the results are concatenated on the
engine's device (the surplus rows dropped) before they go to the host.
The code FFTs, the Doppler grid and the offsets are held once per
distinct shard device.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass

import numpy as np
import torch

from gnss_sdr_tpu_torch import canonical_device, resolve_device
from gnss_sdr_tpu_torch.codes.resample import resample_code


@dataclass(frozen=True)
class AcqConfig:
    """Acquisition parameters (reference: acquisition/libs/acq_conf.h)."""

    fs: float
    code_length_chips: int
    code_rate_cps: float
    doppler_max_hz: float = 5000.0
    doppler_step_hz: float = 250.0
    doppler_min_hz: float | None = None  # default: -doppler_max
    coherent_integration_periods: int = 1
    max_dwells: int = 1
    bit_transition_flag: bool = False
    threshold: float = 0.0               # 0 -> derive from pfa
    pfa: float = 1e-3
    statistic: str = "max_to_input_power"  # or "peak1_peak2"
    make_two_steps: bool = False
    doppler_step2_hz: float = 125.0
    num_doppler_bins_step2: int = 4
    doppler_chunk: int = 8               # Doppler bins per grid pass

    @property
    def samples_per_code(self) -> int:
        return int(round(self.fs * self.code_length_chips / self.code_rate_cps))

    @property
    def coherent_samples(self) -> int:
        return self.samples_per_code * self.coherent_integration_periods

    @property
    def fft_size(self) -> int:
        """Correlation FFT length, a power of two covering the coherent
        window plus one code period (twice the window with
        bit_transition), so every searched lag is a full linear
        correlation against the zero-padded local code."""
        n = self.coherent_samples
        base = 2 * n if self.bit_transition_flag else n + self.samples_per_code
        return 1 << (base - 1).bit_length()

    @property
    def dwell_stride(self) -> int:
        """Sample stride between non-coherent dwell windows: the largest
        whole number of code periods <= fft_size, so the peak's lag stays
        put from dwell to dwell."""
        return self.samples_per_code * (self.fft_size // self.samples_per_code)

    @property
    def input_samples(self) -> int:
        """Samples consumed per acquisition attempt (all dwells)."""
        return self.fft_size * self.max_dwells

    def doppler_grid_hz(self) -> np.ndarray:
        dmin = -self.doppler_max_hz if self.doppler_min_hz is None else self.doppler_min_hz
        return np.arange(dmin, self.doppler_max_hz + self.doppler_step_hz / 2,
                         self.doppler_step_hz, dtype=np.float64)


@dataclass
class AcqResults:
    """Per-channel acquisition outcome (-> Gnss_Synchro Acq_* fields)."""

    detected: np.ndarray        # [C] bool
    test_statistic: np.ndarray  # [C] float
    delay_samples: np.ndarray   # [C] float, code delay in samples [0, spc)
    doppler_hz: np.ndarray      # [C] float
    input_power: np.ndarray     # [C] float
    threshold: float


def threshold_from_pfa(conf: AcqConfig, num_bins: int) -> float:
    """Detection threshold for the normalised max statistic at the given
    Pfa: each normalised cell under H0 is a sum of ``max_dwells`` unit
    exponentials, and the max over N cells crosses ``th`` with probability
    pfa when P(cell > th) = 1 - (1 - pfa)^(1/N)."""
    num_cells = num_bins * conf.samples_per_code
    p_cell = 1.0 - (1.0 - conf.pfa) ** (1.0 / num_cells)
    k = conf.max_dwells
    # invert the regularised upper incomplete gamma Q(k, th) = p_cell
    lo, hi = 0.0, 2000.0

    def q_upper(x: float) -> float:
        # Q(k, x) for integer k: e^-x * sum_{i<k} x^i/i!
        s = 0.0
        term = 1.0
        for i in range(k):
            if i > 0:
                term *= x / i
            s += term
        return math.exp(-x) * s

    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if q_upper(mid) > p_cell:
            lo = mid
        else:
            hi = mid
    # the statistic is a per-dwell average, and so is the threshold
    return 0.5 * (lo + hi) / k


class PcpsAcquisition:
    """Batched PCPS engine over a fixed PRN table.

    Build once per (signal, sampling rate, config); call with a [C, input]
    sample block and per-channel row indices into the table.
    """

    def __init__(
        self,
        conf: AcqConfig,
        code_table: np.ndarray,   # [P, code_length] chips (+-1), float
        prns: list[int],          # PRN id per table row (for reporting)
        *,
        freq_offset_table: np.ndarray | None = None,
        mesh=None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.mesh = mesh
        # per-row carrier offsets (Hz, float32 as the JAX grid holds them)
        self._offsets = (
            None if freq_offset_table is None
            else torch.as_tensor(
                np.asarray(freq_offset_table, dtype=np.float32),
                device=self.device))
        self.conf = conf
        self.prns = list(prns)
        spc = conf.samples_per_code
        ncoh = conf.coherent_samples
        fft_size = conf.fft_size
        sampled = np.stack([
            np.tile(
                resample_code(code_table[p], conf.fs, conf.code_rate_cps, spc),
                conf.coherent_integration_periods,
            )
            for p in range(code_table.shape[0])
        ]).astype(np.float32)
        if fft_size != ncoh:              # zero-pad the local code
            pad = np.zeros((sampled.shape[0], fft_size - ncoh), np.float32)
            sampled = np.concatenate([sampled, pad], axis=1)
        self._codes_fft_conj = torch.as_tensor(
            np.conj(np.fft.fft(sampled, axis=1)).astype(np.complex64),
            device=self.device)
        dop = conf.doppler_grid_hz()
        self._doppler_hz = dop
        self._dop = torch.as_tensor(dop.astype(np.float32),
                                    device=self.device)
        self._n = torch.arange(fft_size, dtype=torch.float32,
                               device=self.device)
        # -2 pi / fs in float32, as the JAX grid computes it
        self._w = float(np.float32(-2.0 * np.pi) / np.float32(conf.fs))

        nb = len(dop)
        if conf.threshold > 0:
            self.threshold = conf.threshold
        elif conf.statistic == "peak1_peak2":
            # H0: M1 = max over all (bin, lag) cells, M2 = max over the
            # winning bin's lags, both Gumbel; P(M1 > r M2) ~ Gamma(1 + r)
            # Nall Nbin^-r, solved for r by fixed point
            nbin = conf.samples_per_code
            nall = nb * nbin
            r = 2.0
            for _ in range(16):
                r = (
                    math.log(nall)
                    + math.log(math.gamma(1.0 + r) / conf.pfa)
                ) / math.log(nbin)
            self.threshold = r
        else:
            self.threshold = threshold_from_pfa(conf, nb)
        # one engine per shard, sharing the tables of each distinct device
        self._shards = None
        if mesh is not None:
            on = {}
            for dev in mesh.distinct():
                on[dev] = (self if dev == canonical_device(self.device)
                           else self._on_device(dev))
            self._shards = [on[d] for d in mesh.devices]

    def _on_device(self, dev: torch.device) -> PcpsAcquisition:
        """This engine with its device tables copied to ``dev``."""
        eng = copy.copy(self)
        eng.device, eng.mesh, eng._shards = dev, None, None
        for name in ("_codes_fft_conj", "_dop", "_n", "_offsets"):
            t = getattr(self, name)
            setattr(eng, name, None if t is None else t.to(dev))
        return eng

    def set_offsets(self, offsets_hz) -> None:
        """Rewrite the per-row offset table in place (same shape), so the
        next call searches around the new offsets with nothing rebuilt."""
        src = torch.as_tensor(np.asarray(offsets_hz, dtype=np.float32))
        for eng in {self, *(self._shards or ())}:
            eng._offsets.copy_(src)

    def map_shards(self, fn, x, prn_idx) -> tuple:
        """``fn(engine, x, rows)`` on the hypothesis batch (host samples
        [C, N] and table rows [C]) as device tensors; returns its tuple of
        [C] tensors on this engine's device. With a mesh, each shard's
        engine takes its rows of the padded batch on its own device."""
        x = np.asarray(x, dtype=np.complex64)
        prn_idx = np.asarray(prn_idx, dtype=np.int64)
        n_real = x.shape[0]
        if self._shards is None or n_real == 0:
            return fn(self,
                      torch.as_tensor(np.ascontiguousarray(x),
                                      device=self.device),
                      torch.as_tensor(prn_idx, device=self.device))
        pad = (-n_real) % self.mesh.size
        if pad:
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
            prn_idx = np.concatenate([prn_idx, np.repeat(prn_idx[-1:], pad)])
        parts = [fn(eng,
                    torch.as_tensor(np.ascontiguousarray(x[a:b]),
                                    device=eng.device),
                    torch.as_tensor(prn_idx[a:b], device=eng.device))
                 for (a, b), eng in zip(self.mesh.ranges(len(x)),
                                        self._shards)]
        return tuple(torch.cat([p[i].to(self.device) for p in parts])[:n_real]
                     for i in range(len(parts[0])))

    def _row_offsets(self, prn_idx: torch.Tensor) -> torch.Tensor | None:
        return None if self._offsets is None else self._offsets[prn_idx]

    # ------------------------------------------------------------------ core
    def _dwell_windows(self, x: torch.Tensor) -> torch.Tensor:
        """[C, input] -> [C, K, F] dwell windows at whole-code-period stride
        (see AcqConfig.dwell_stride)."""
        conf = self.conf
        s, f = conf.dwell_stride, conf.fft_size
        return torch.stack([x[:, k * s:k * s + f]
                            for k in range(conf.max_dwells)], dim=1)

    def _grid(self, xk: torch.Tensor, cfc: torch.Tensor,
              dops: torch.Tensor) -> torch.Tensor:
        """Correlation grid.

        xk:   [C, K, F] complex64 dwell windows
        cfc:  [C, F] conjugate code FFTs
        dops: [B] Doppler bins shared by all channels, or [C, B] per channel
        returns [C, B, spc] non-coherently accumulated |corr|^2 (float32).
        """
        d = dops[None, :, None] if dops.dim() == 1 else dops[:, :, None]
        phase = (d * self._w) * self._n                       # [., B, F]
        wipe = torch.complex(torch.cos(phase), torch.sin(phase))
        xw = xk[:, :, None, :] * wipe[:, None, :, :]          # [C, K, B, F]
        corr = torch.fft.ifft(torch.fft.fft(xw) * cfc[:, None, None, :])
        mag2 = (corr.real * corr.real + corr.imag * corr.imag).sum(dim=1)
        # valid code delays: the first samples_per_code lags
        return mag2[:, :, :self.conf.samples_per_code]

    def _acquire(self, x: torch.Tensor, prn_idx: torch.Tensor):
        """Coarse search over the whole grid, chunked over Doppler."""
        conf = self.conf
        spc = conf.samples_per_code
        xk = self._dwell_windows(x)
        cfc = self._codes_fft_conj[prn_idx]
        off = self._row_offsets(prn_idx)
        c = x.shape[0]
        best_val = torch.full((c,), -math.inf, device=x.device)
        best_dop = torch.zeros(c, device=x.device)
        best_lag = torch.zeros(c, dtype=torch.int64, device=x.device)
        for dop in torch.split(self._dop, conf.doppler_chunk):
            # row p searches offset[p] + the grid; the best bin is reported
            # without the offset
            dops = dop if off is None else dop[None, :] + off[:, None]
            flat = self._grid(xk, cfc, dops).reshape(c, -1)
            val, idx = flat.max(dim=1)
            better = val > best_val
            best_val = torch.where(better, val, best_val)
            best_dop = torch.where(better, dop[idx // spc], best_dop)
            best_lag = torch.where(better, idx % spc, best_lag)
        input_power = (x.real * x.real + x.imag * x.imag).mean(dim=1)
        return best_val, best_dop, best_lag, input_power

    def _second_peak(self, x, prn_idx, best_dop, best_lag) -> torch.Tensor:
        """Second-largest delay-domain peak in each channel's best Doppler
        bin, excluding +-1 chip around the main peak (reference
        first_vs_second_peak_statistic)."""
        conf = self.conf
        spc = conf.samples_per_code
        off = self._row_offsets(prn_idx)
        dop = best_dop if off is None else best_dop + off
        g = self._grid(self._dwell_windows(x), self._codes_fft_conj[prn_idx],
                       dop[:, None])[:, 0]                    # [C, spc]
        excl = int(np.ceil(conf.fs / conf.code_rate_cps))    # 1 chip
        lags = torch.arange(spc, device=x.device)[None, :]
        lag = best_lag[:, None]
        dist = torch.minimum((lags - lag) % spc, (lag - lags) % spc)
        return torch.where(dist <= excl, -math.inf, g).max(dim=1).values

    def _refine(self, x, prn_idx, center_dop, step2_hz=None):
        """Second-step narrow Doppler zoom around each channel's coarse
        peak (reference make_2_steps / num_doppler_bins_step2).
        ``step2_hz`` overrides the configured fine step for this call (the
        iterative fine-Doppler engine, ``acquisition/engines.py``)."""
        conf = self.conf
        spc = conf.samples_per_code
        nb2 = 2 * conf.num_doppler_bins_step2 + 1
        step = conf.doppler_step2_hz if step2_hz is None else step2_hz
        offs = (torch.arange(nb2, dtype=torch.float32, device=x.device)
                - conf.num_doppler_bins_step2) * np.float32(step)
        off = self._row_offsets(prn_idx)
        center = center_dop if off is None else center_dop + off
        dops = center[:, None] + offs[None, :]                # [C, B2]
        g = self._grid(self._dwell_windows(x), self._codes_fft_conj[prn_idx],
                       dops)
        val, idx = g.reshape(x.shape[0], -1).max(dim=1)
        dop = torch.gather(dops, 1, (idx // spc)[:, None])[:, 0]
        # the reported Doppler excludes the offset
        return val, (dop if off is None else dop - off), idx % spc

    # ------------------------------------------------------------------- API
    def _detect(self, xt: torch.Tensor, pt: torch.Tensor) -> tuple:
        """(statistic, Doppler, code delay, input power) per row."""
        conf = self.conf
        val, dop, lag, power = self._acquire(xt, pt)
        if conf.make_two_steps:
            val, dop, lag = self._refine(xt, pt, dop)
        if conf.statistic == "peak1_peak2":
            p2 = self._second_peak(xt, pt, dop, lag)
            stat = val.double() / p2.double().clamp_min(1e-30)
        else:
            # normalised CFAR statistic: peak / (sigma^2 * N_coh * K)
            norm = power.double() * conf.coherent_samples * conf.max_dwells
            stat = val.double() / norm.clamp_min(1e-30)
        return stat, dop, lag, power

    def acquire(self, x, prn_idx) -> AcqResults:
        """Run acquisition. x: [C, input_samples] c64; prn_idx: [C] into
        the table."""
        stat, dop, lag, power = self.map_shards(PcpsAcquisition._detect, x,
                                                prn_idx)
        stat = stat.cpu().numpy()
        return AcqResults(
            detected=stat > self.threshold,
            test_statistic=stat,
            delay_samples=lag.cpu().numpy().astype(np.float64),
            doppler_hz=dop.cpu().numpy().astype(np.float64),
            input_power=power.cpu().numpy().astype(np.float64),
            threshold=self.threshold,
        )
