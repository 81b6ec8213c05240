"""Acquisition engine variants beyond plain PCPS.

Counterpart of ``gnss_sdr_tpu/acquisition/engines.py``. Reference analogs
(src/algorithms/acquisition/gnuradio_blocks/):

- ``pcps_acquisition_fine_doppler_cc.cc``: coarse PCPS, then an iterative
  Doppler zoom that halves the bin width each pass;
- ``pcps_tong_acquisition_cc.cc``: the Tong sequential detector, an
  up/down counter per channel that declares on ``tong_max`` and dismisses
  on 0;
- ``pcps_quicksync_acquisition_cc.cc``: QuickSync folding; the coherent
  window is folded by summing segments, which shortens the correlation FFT
  by the folding factor, and the delay ambiguity is resolved by direct
  correlation at the candidate lags;
- ``pcps_cccwsr_acquisition_cc.cc``: CCCWSR for Galileo E1 CBOC, against
  code x cos-subcarrier and code x sin-subcarrier replicas combined as
  max(|C_cos + j C_sin|, |C_cos - j C_sin|);
- ``galileo_e5a_noncoherent_iq_acquisition_caf_cc.cc``: both primary codes
  of a QPSK pilot+data signal, the two |corr|^2 grids summed per cell;
- ``gps_l1_ca_pcps_assisted_acquisition.cc``: a narrow Doppler search
  around per-satellite predicted Doppler.

Fine-Doppler, Tong and assisted schedule the batched PCPS engine
(``pcps.py``). QuickSync, CCCWSR and noncoherent I/Q run their own grids:
complex64 ``torch.fft`` on the engine's device, chunked over Doppler as
PCPS is (``AcqConfig.doppler_chunk``), with one copy of the per-channel
results to the host per ``acquire``. Every engine takes a ``device``
("cuda" by default; without a card that raises unless "cpu" is asked for).
The three PCPS schedulers also take a ``mesh`` (a
``parallel.sharding.ChannelMesh``) and shard the hypothesis batch over it
as PCPS does; the three grid engines take none, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device
from gnss_sdr_tpu_torch.acquisition.pcps import (
    AcqConfig,
    AcqResults,
    PcpsAcquisition,
    threshold_from_pfa,
)
from gnss_sdr_tpu_torch.codes.resample import resample_code


def _inputs(x, prn_idx, win: int | None, device, pad: bool = False):
    """Host samples [C, >= win] and table rows [C] as device tensors (the
    first ``win`` samples, zero-padded to ``win`` when ``pad``)."""
    x = np.asarray(x, dtype=np.complex64)
    if win is not None:
        x = x[:, :win]
        if pad and x.shape[1] < win:
            x = np.pad(x, ((0, 0), (0, win - x.shape[1])))
    return (torch.as_tensor(np.ascontiguousarray(x), device=device),
            torch.as_tensor(np.asarray(prn_idx, dtype=np.int64),
                            device=device))


def _results(val, dop, lag, power, norm_len: float,
             threshold: float) -> AcqResults:
    """Per-channel device results -> AcqResults, in one copy to the host:
    the statistic is val / (input power * norm_len)."""
    host = torch.stack([val.double(), dop.double(), lag.double(),
                        power.double()]).cpu().numpy()
    val_np, dop_np, lag_np, power_np = host
    stat = val_np / np.maximum(power_np * norm_len, 1e-30)
    return AcqResults(detected=stat > threshold, test_statistic=stat,
                      delay_samples=lag_np, doppler_hz=dop_np,
                      input_power=power_np, threshold=threshold)


def _conj_fft_table(sampled: np.ndarray, fft_size: int) -> np.ndarray:
    """[P, L] sampled replicas -> [P, fft_size] conjugate FFTs of the
    zero-padded rows (complex64, computed on the host in float64)."""
    pad = np.zeros((sampled.shape[0], fft_size - sampled.shape[1]),
                   np.float32)
    return np.conj(np.fft.fft(np.concatenate([sampled, pad], 1),
                              axis=1)).astype(np.complex64)


def _sampled_codes(table: np.ndarray, conf: AcqConfig) -> np.ndarray:
    spc = conf.samples_per_code
    return np.stack([
        resample_code(table[p], conf.fs, conf.code_rate_cps, spc)
        for p in range(table.shape[0])
    ]).astype(np.float32)


class _GridEngine:
    """Shared Doppler wipeoff and chunked argmax of the FFT-grid engines
    (QuickSync, CCCWSR, noncoherent I/Q)."""

    def _setup_grid(self, conf: AcqConfig, n_wipe: int, device) -> None:
        self.device = resolve_device(device)
        dop = conf.doppler_grid_hz()
        self._doppler_hz = dop
        self._dop = torch.as_tensor(dop.astype(np.float32),
                                    device=self.device)
        self._n = torch.arange(n_wipe, dtype=torch.float32,
                               device=self.device)
        # -2 pi / fs in float32, as the JAX grids compute it
        self._w = float(np.float32(-2.0 * np.pi) / np.float32(conf.fs))

    def _wipe(self, dop: torch.Tensor) -> torch.Tensor:
        """[B] or [C] Doppler -> [., N] complex64 carrier wipeoff."""
        phase = (dop[:, None] * self._w) * self._n[None, :]
        return torch.complex(torch.cos(phase), torch.sin(phase))

    def _search(self, grid_fn, c: int, cells: int):
        """Max over every (Doppler, lag) cell, chunked over Doppler:
        ``grid_fn(dop_chunk)`` -> [C, B, cells]. Returns (value, Doppler,
        lag), the first maximum winning ties as one argmax over the whole
        grid would."""
        dev = self.device
        best_val = torch.full((c,), -math.inf, device=dev)
        best_dop = torch.zeros(c, device=dev)
        best_lag = torch.zeros(c, dtype=torch.int64, device=dev)
        for dop in torch.split(self._dop, self.conf.doppler_chunk):
            val, idx = grid_fn(dop).reshape(c, -1).max(dim=1)
            better = val > best_val
            best_val = torch.where(better, val, best_val)
            best_dop = torch.where(better, dop[idx // cells], best_dop)
            best_lag = torch.where(better, idx % cells, best_lag)
        return best_val, best_dop, best_lag


def _power(x: torch.Tensor) -> torch.Tensor:
    return (x.real * x.real + x.imag * x.imag).mean(dim=1)


def _mag2(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


class FineDopplerAcquisition:
    """Iterative Doppler zoom (pcps_acquisition_fine_doppler_cc analog).

    Coarse PCPS at ``conf.doppler_step_hz``, then ``iterations`` refine
    passes, each sweeping ``2*num_doppler_bins_step2+1`` bins around the
    current peak with the step halved every pass. Final Doppler resolution
    is ``doppler_step / 2**iterations``.
    """

    def __init__(self, conf: AcqConfig, code_table: np.ndarray,
                 prns: list[int], iterations: int = 4,
                 freq_offset_table: np.ndarray | None = None, *,
                 mesh=None, device: str | torch.device = "cuda") -> None:
        self.iterations = iterations
        self.inner = PcpsAcquisition(
            replace(conf, make_two_steps=False), code_table, prns,
            freq_offset_table=freq_offset_table, mesh=mesh, device=device)
        self.conf = self.inner.conf
        self.prns = self.inner.prns
        self.threshold = self.inner.threshold

    def _zoom(self, eng: PcpsAcquisition, xt: torch.Tensor,
              pt: torch.Tensor) -> tuple:
        val, dop, lag, power = eng._acquire(xt, pt)
        step = eng.conf.doppler_step_hz
        for _ in range(self.iterations):
            step *= 0.5
            val, dop, lag = eng._refine(xt, pt, dop, step2_hz=step)
        return val, dop, lag, power

    def acquire(self, x, prn_idx) -> AcqResults:
        conf = self.inner.conf
        val, dop, lag, power = self.inner.map_shards(self._zoom, x, prn_idx)
        return _results(val, dop, lag, power,
                        conf.coherent_samples * conf.max_dwells,
                        self.threshold)


class TongAcquisition:
    """Tong sequential detector (pcps_tong_acquisition_cc analog).

    Per attempt (one coherent window), the per-channel counter K increments
    when the normalized peak crosses the per-dwell threshold and decrements
    otherwise. K == ``tong_max`` declares; K == 0 dismisses. The per-dwell
    threshold uses a relaxed Pfa (the sequential test, not the single
    crossing, sets the overall false-alarm rate).
    """

    def __init__(self, conf: AcqConfig, code_table: np.ndarray,
                 prns: list[int], tong_init: int = 1, tong_max: int = 8,
                 max_attempts: int | None = None,
                 freq_offset_table: np.ndarray | None = None, *,
                 mesh=None, device: str | torch.device = "cuda") -> None:
        self.tong_init = tong_init
        self.tong_max = tong_max
        self.max_attempts = max_attempts or (4 * tong_max)
        inner_conf = replace(conf, max_dwells=1)
        self.inner = PcpsAcquisition(inner_conf, code_table, prns,
                                     freq_offset_table=freq_offset_table,
                                     mesh=mesh, device=device)
        self.prns = self.inner.prns
        # per-dwell threshold at a relaxed pfa: each H0 dwell must be likely
        # to decrement (pfa_dwell ~ 0.1 keeps E[K] drifting to 0 fast while
        # an H1 dwell at the design C/N0 crosses nearly always)
        self.dwell_threshold = threshold_from_pfa(
            replace(inner_conf, pfa=0.1), len(inner_conf.doppler_grid_hz()))
        self.threshold = self.dwell_threshold
        self.conf = replace(
            inner_conf,
            max_dwells=self.max_attempts)  # .input_samples covers all attempts

    def acquire(self, x, prn_idx) -> AcqResults:
        """x: [C, >= max_attempts * window] samples; early-exits when all
        channels have declared or dismissed."""
        inner = self.inner
        win = inner.conf.input_samples
        x = np.asarray(x, dtype=np.complex64)
        prn_idx = np.asarray(prn_idx, dtype=np.int32)
        C = x.shape[0]
        K = np.full(C, self.tong_init, dtype=np.int64)
        decided = np.zeros(C, dtype=bool)
        detected = np.zeros(C, dtype=bool)
        best = None
        spc = inner.conf.samples_per_code
        n_attempts = min(self.max_attempts, x.shape[1] // win)
        for a in range(n_attempts):
            res = inner.acquire(x[:, a * win:(a + 1) * win], prn_idx)
            # refer the code delay back to the first sample of x (each
            # attempt window starts a non-integer number of code periods in)
            res.delay_samples = np.mod(res.delay_samples + a * win, spc)
            hit = res.test_statistic > self.dwell_threshold
            K = np.where(~decided & hit, K + 1, K)
            K = np.where(~decided & ~hit, K - 1, K)
            if best is None:
                best = res
            else:  # keep the strongest attempt's delay/Doppler per channel
                better = (res.test_statistic > best.test_statistic) & ~decided
                best.test_statistic = np.where(
                    better, res.test_statistic, best.test_statistic)
                best.delay_samples = np.where(
                    better, res.delay_samples, best.delay_samples)
                best.doppler_hz = np.where(
                    better, res.doppler_hz, best.doppler_hz)
                best.input_power = np.where(
                    better, res.input_power, best.input_power)
            newly_declared = ~decided & (K >= self.tong_max)
            newly_dismissed = ~decided & (K <= 0)
            detected |= newly_declared
            decided |= newly_declared | newly_dismissed
            if decided.all():
                break
        return AcqResults(
            detected=detected,
            test_statistic=best.test_statistic,
            delay_samples=best.delay_samples,
            doppler_hz=best.doppler_hz,
            input_power=best.input_power,
            threshold=self.dwell_threshold,
        )


class QuickSyncAcquisition(_GridEngine):
    """Folding acquisition (pcps_quicksync_acquisition_cc analog).

    The coherent window (``folding_factor`` code periods, sampled) is folded
    by summing ``folding_factor`` equal segments, so the correlation FFT is
    ``folding_factor``x shorter; the folded peak gives the code delay modulo
    the segment length, and the true delay is recovered by direct
    correlation of the unfolded window at the candidate lags.
    """

    def __init__(self, conf: AcqConfig, code_table: np.ndarray,
                 prns: list[int], folding_factor: int = 2, *,
                 device: str | torch.device = "cuda") -> None:
        self.conf = conf
        self.prns = list(prns)
        f = int(folding_factor)
        self.fold = f
        spc = conf.samples_per_code
        self.seg = spc // f                 # folded segment length
        self.win = self.seg * f             # samples used (remainder dropped)
        self.fft_size = 1 << (2 * self.seg - 1).bit_length()
        self._setup_grid(conf, self.win, device)
        sampled = _sampled_codes(code_table, conf)
        self._codes = torch.as_tensor(sampled, device=self.device)  # [P, spc]
        # folded local code: sum of the f segments of the sampled period
        folded_code = sampled[:, : self.win].reshape(
            sampled.shape[0], f, self.seg).sum(axis=1)
        self._codes_fft_conj = torch.as_tensor(
            _conj_fft_table(folded_code, self.fft_size), device=self.device)
        # H0 cells = doppler bins x folded lags; folding raises the noise
        # floor (code self-noise), so derive the threshold on the
        # DISAMBIGUATED full-length statistic (standard cell count)
        self.threshold = threshold_from_pfa(
            replace(conf, max_dwells=1), len(self._doppler_hz))

    def _acquire(self, x: torch.Tensor, prn_idx: torch.Tensor):
        c = x.shape[0]
        f, seg, spc = self.fold, self.seg, self.conf.samples_per_code
        cfc = self._codes_fft_conj[prn_idx][:, None, :]           # [C, 1, F]

        def grid(dop):
            # wipe off each Doppler hypothesis BEFORE folding (the fold
            # sums across segments, so residual carrier must go first)
            xw = x[:, None, :] * self._wipe(dop)[None, :, :]     # [C, B, win]
            folded = xw.reshape(c, dop.shape[0], f, seg).sum(dim=2)
            corr = torch.fft.ifft(
                torch.fft.fft(folded, n=self.fft_size) * cfc)
            return _mag2(corr[..., :seg])

        _, best_dop, lag_mod = self._search(grid, c, seg)
        # ---- disambiguate: direct correlation at the f candidate lags ----
        xw1 = x * self._wipe(best_dop)                           # [C, win]
        code_c = self._codes[prn_idx]                            # [C, spc]
        m = torch.arange(f, device=x.device)
        cand = lag_mod[:, None] + m[None, :] * seg               # [C, f]
        k_idx = torch.arange(self.win, device=x.device)
        gather_idx = torch.remainder(
            k_idx[None, None, :] - cand[:, :, None], spc)        # [C, f, win]
        creps = torch.gather(code_c[:, None, :].expand(c, f, spc), 2,
                             gather_idx)
        cm = _mag2((xw1[:, None, :] * creps).sum(dim=-1))        # [C, f]
        val, mi = cm.max(dim=1)
        lag = torch.gather(cand, 1, mi[:, None])[:, 0]
        return val, best_dop, lag, _power(x)

    def acquire(self, x, prn_idx) -> AcqResults:
        xt, pt = _inputs(x, prn_idx, self.win, self.device)
        val, dop, lag, power = self._acquire(xt, pt)
        # disambiguation statistic: full-length direct correlation
        return _results(val, dop, lag, power, self.win, self.threshold)


class CccwsrAcquisition(_GridEngine):
    """CCCWSR for Galileo E1 CBOC (pcps_cccwsr_acquisition_cc analog).

    Correlates against code x cos-subcarrier (the sinBOC(1,1) replica) and
    code x sin-subcarrier (the quadrature subcarrier replica) and combines
    max(|C_cos + j C_sin|, |C_cos - j C_sin|) per cell — reconstructing the
    BOC subcarrier sign without squaring loss.
    """

    def __init__(self, conf: AcqConfig, chips_table: np.ndarray,
                 prns: list[int], *,
                 device: str | torch.device = "cuda") -> None:
        """chips_table: [P, 4092] raw E1-B code chips (+-1), WITHOUT
        subcarrier; the two replicas are built here."""
        self.conf = conf
        self.prns = list(prns)
        spc = conf.samples_per_code
        self.fft_size = 1 << (2 * spc - 1).bit_length()
        self.win = self.fft_size
        self._setup_grid(conf, self.fft_size, device)
        fs = conf.fs
        t = np.arange(spc) / fs
        chip_phase = t * conf.code_rate_cps               # chips (fractional)
        idx = np.floor(chip_phase).astype(np.int64) % chips_table.shape[1]
        # sinBOC(1,1): sign(sin(2*pi*f_sub*t)), f_sub = code rate;
        # quadrature: sign(cos(...)) — the "W" replica of CCCWSR
        sub_sin = np.sign(np.sin(2 * np.pi * conf.code_rate_cps * t) + 1e-12)
        sub_cos = np.sign(np.cos(2 * np.pi * conf.code_rate_cps * t) + 1e-12)
        cos_tab = (chips_table[:, idx] * sub_sin[None, :]).astype(np.float32)
        sin_tab = (chips_table[:, idx] * sub_cos[None, :]).astype(np.float32)
        self._fft_cos = torch.as_tensor(
            _conj_fft_table(cos_tab, self.fft_size), device=self.device)
        self._fft_sin = torch.as_tensor(
            _conj_fft_table(sin_tab, self.fft_size), device=self.device)
        self.threshold = (conf.threshold if conf.threshold > 0 else
                          threshold_from_pfa(replace(conf, max_dwells=1),
                                             len(self._doppler_hz)))

    def _acquire(self, x: torch.Tensor, prn_idx: torch.Tensor):
        spc = self.conf.samples_per_code
        cc = self._fft_cos[prn_idx][:, None, :]
        cs = self._fft_sin[prn_idx][:, None, :]

        def grid(dop):
            xf = torch.fft.fft(x[:, None, :] * self._wipe(dop)[None, :, :])
            corr_c = torch.fft.ifft(xf * cc)[..., :spc]
            corr_s = torch.fft.ifft(xf * cs)[..., :spc]
            plus = torch.abs(corr_c + 1j * corr_s)
            minus = torch.abs(corr_c - 1j * corr_s)
            return torch.maximum(plus, minus) ** 2               # [C, B, spc]

        val, dop, lag = self._search(grid, x.shape[0], spc)
        return val, dop, lag, _power(x)

    def acquire(self, x, prn_idx) -> AcqResults:
        xt, pt = _inputs(x, prn_idx, self.win, self.device, pad=True)
        val, dop, lag, power = self._acquire(xt, pt)
        # the +/- combining doubles the H0 max population; fold that into
        # the normalization (2 correlators' noise adds in the combined cell)
        return _results(val, dop, lag, power,
                        self.conf.samples_per_code * 2.0, self.threshold)


class AssistedAcquisition:
    """Assisted acquisition (gps_l1_ca_pcps_assisted_acquisition analog).

    Searches a narrow window (+-``window_hz``) around per-satellite
    predicted Doppler, through the batched engine's per-row frequency
    offsets; the reported Doppler includes the prediction.
    """

    def __init__(self, conf: AcqConfig, code_table: np.ndarray,
                 prns: list[int], predicted_doppler_hz: dict[int, float],
                 window_hz: float = 500.0, *, mesh=None,
                 device: str | torch.device = "cuda") -> None:
        offsets = np.array(
            [predicted_doppler_hz.get(p, 0.0) for p in prns], np.float64)
        narrow = replace(conf, doppler_max_hz=window_hz, doppler_min_hz=None)
        self.inner = PcpsAcquisition(narrow, code_table, prns,
                                     freq_offset_table=offsets, mesh=mesh,
                                     device=device)
        self.conf = self.inner.conf
        self.prns = self.inner.prns
        self.threshold = self.inner.threshold
        self._offsets_np = offsets

    def set_predicted_doppler(self, offsets_hz: np.ndarray) -> None:
        """Update the per-row predicted Doppler between calls. The inner
        engine's offset table is rewritten in place: nothing is rebuilt."""
        offsets_hz = np.asarray(offsets_hz, np.float64)
        if offsets_hz.shape != self._offsets_np.shape:
            raise ValueError(
                f"expected {self._offsets_np.shape} offsets, "
                f"got {offsets_hz.shape}")
        self._offsets_np = offsets_hz
        self.inner.set_offsets(offsets_hz)

    def acquire(self, x, prn_idx) -> AcqResults:
        res = self.inner.acquire(x, prn_idx)
        # the engine reports Doppler excluding the offset; assistance
        # offsets are Doppler, so they are added back
        res.doppler_hz = res.doppler_hz + self._offsets_np[
            np.asarray(prn_idx, np.int64)]
        return res


class NoncoherentIQAcquisition(_GridEngine):
    """Noncoherent I/Q-combining acquisition for QPSK pilot+data signals
    (galileo_e5a_noncoherent_iq_acquisition_caf_cc analog): correlates the
    input against BOTH the data (I) and pilot (Q) primary codes and sums
    the two magnitude-squared grids per (Doppler, lag) cell — capturing
    the full signal power regardless of the unknown secondary-code/symbol
    phases of either component.
    """

    def __init__(self, conf: AcqConfig, data_table: np.ndarray,
                 pilot_table: np.ndarray, prns: list[int], *,
                 device: str | torch.device = "cuda") -> None:
        self.conf = conf
        self.prns = list(prns)
        spc = conf.samples_per_code
        self.fft_size = 1 << (2 * spc - 1).bit_length()
        self.win = self.fft_size
        self._setup_grid(conf, self.fft_size, device)
        self._fft_i = torch.as_tensor(_conj_fft_table(
            _sampled_codes(data_table, conf), self.fft_size),
            device=self.device)
        self._fft_q = torch.as_tensor(_conj_fft_table(
            _sampled_codes(pilot_table, conf), self.fft_size),
            device=self.device)
        # H0: sum of two independent Exp(1) cells -> chi^2(4)/2 ==
        # the max_dwells=2 statistic of the standard engine
        self.threshold = (conf.threshold if conf.threshold > 0 else
                          threshold_from_pfa(replace(conf, max_dwells=2),
                                             len(self._doppler_hz)))

    def _acquire(self, x: torch.Tensor, prn_idx: torch.Tensor):
        spc = self.conf.samples_per_code
        ci = self._fft_i[prn_idx][:, None, :]
        cq = self._fft_q[prn_idx][:, None, :]

        def grid(dop):
            xf = torch.fft.fft(x[:, None, :] * self._wipe(dop)[None, :, :])
            gi = _mag2(torch.fft.ifft(xf * ci)[..., :spc])
            gq = _mag2(torch.fft.ifft(xf * cq)[..., :spc])
            return gi + gq

        val, dop, lag = self._search(grid, x.shape[0], spc)
        return val, dop, lag, _power(x)

    def acquire(self, x, prn_idx) -> AcqResults:
        xt, pt = _inputs(x, prn_idx, self.win, self.device, pad=True)
        val, dop, lag, power = self._acquire(xt, pt)
        # per-code-correlation normalization; /2 folds the two-cell sum
        # into the per-dwell-average convention of threshold_from_pfa
        return _results(val, dop, lag, power,
                        self.conf.samples_per_code * 2.0, self.threshold)
