"""The port's signal conditioner against the JAX package's, on the cases
of ``tests/test_conditioner.py``: the FIR with and without decimation and
the frequency-translating FIR, the notch, pulse blanking, both resamplers,
the beamformer, and the streaming conditioner (an ibyte real-IF capture
translated and decimated in two blocks, the fractional resampler in 2048-
sample blocks, and decimation on irregular block lengths). Every output
is float32/complex64 and must lie within 1e-5 of the JAX output relative
to its largest sample; the JAX test's own gates hold for the port's
outputs too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu import conditioner as jc
from gnss_sdr_tpu_torch import conditioner as tc

torch.set_num_threads(2)

RNG = np.random.default_rng(3)


def tone(fs, f, n, amp=1.0):
    t = np.arange(n) / fs
    return (amp * np.exp(2j * np.pi * f * t)).astype(np.complex64)


def noise(n):
    return (RNG.normal(size=n) + 1j * RNG.normal(size=n)).astype(np.complex64)


def close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def test_design_fir_is_the_same():
    for band in ((0.0, 2e5), (1e5, 3e5), 2e5):
        np.testing.assert_array_equal(tc.design_fir(31, 1e6, band),
                                      jc.design_fir(31, 1e6, band))


@pytest.mark.parametrize("decim", [1, 2, 3])
def test_fir_matches_jax(decim):
    taps = tc.design_fir(31, 1e6, (0.0, 2e5)).astype(np.float32)
    x = noise(4099)
    y = tc.fir_apply(torch.as_tensor(x), torch.as_tensor(taps), decim)
    close(y.numpy(), jc.fir_apply(jnp.asarray(x), jnp.asarray(taps), decim))
    if decim == 1:
        ref = np.convolve(x, taps, mode="full")[len(taps) - 1: len(x)]
        np.testing.assert_allclose(y.numpy(), ref, atol=1e-4)


def test_freq_xlating_fir_matches_jax():
    fs, f_if = 8e6, 2e6
    taps = tc.design_fir(65, fs, (0.0, 8e5)).astype(np.float32)
    x = tone(fs, f_if + 5e4, 8192) + 0.1 * noise(8192)
    yt, pt = tc.freq_xlating_fir_apply(torch.as_tensor(x),
                                       torch.as_tensor(taps), 0.3, fs, f_if,
                                       4)
    yj, pj = jc.freq_xlating_fir_apply(jnp.asarray(x), jnp.asarray(taps),
                                       jnp.asarray(0.3), fs, f_if, 4)
    close(yt.numpy(), yj)
    assert pt == float(pj)


def test_notch_matches_jax():
    fs, n = 4e6, 1 << 14
    x = noise(n) + tone(fs, 1.1e6, n, amp=30.0)
    y = tc.notch_filter_block(torch.as_tensor(x)).numpy()
    close(y, jc.notch_filter_block(jnp.asarray(x)))
    spec = np.abs(np.fft.fft(y)) ** 2
    assert spec[int(round(1.1e6 / fs * n))] < 20 * np.median(spec)
    clean = noise(1 << 12)
    close(tc.notch_filter_block(torch.as_tensor(clean), 40.0).numpy(),
          jc.notch_filter_block(jnp.asarray(clean), 40.0))


def test_pulse_blanking_matches_jax():
    x = noise(4096)
    x[[100, 200, 300]] = 100.0
    y = tc.pulse_blanking_block(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(y, jc.pulse_blanking_block(jnp.asarray(x)))
    assert np.all(y[[100, 200, 300]] == 0)


def test_resamplers_match_jax():
    x = tone(4e6, 2e5, 8192) + 0.1 * noise(8192)
    ratio = 4e6 / 2.6e6
    n_out = int((8192 - 10) / ratio)
    for frac0 in (0.0, 4.0, 7.3):
        close(tc.polyphase_resample(torch.as_tensor(x), ratio, n_out,
                                    frac0).numpy(),
              jc.polyphase_resample(jnp.asarray(x), ratio, n_out, frac0))
        np.testing.assert_array_equal(
            tc.direct_resample(torch.as_tensor(x), ratio, n_out,
                               frac0).numpy(),
            jc.direct_resample(jnp.asarray(x), ratio, n_out, frac0))


def test_beamformer_matches_jax():
    w = tc.steering_weights(4, 0.5, 20.0)
    np.testing.assert_array_equal(w, jc.steering_weights(4, 0.5, 20.0))
    x = np.stack([noise(5000) for _ in range(4)])
    inner = dict(input_format="passthrough", fs_in=4e6, fir_taps=17,
                 decimation=2)
    ta = tc.ArrayConditioner(tc.Beamformer(w, device="cpu"),
                             tc.SignalConditioner(
                                 tc.ConditionerConfig(**inner), "cpu"))
    ja = jc.ArrayConditioner(jc.Beamformer(w), jc.SignalConditioner(
        jc.ConditionerConfig(**inner)))
    close(ta.beamformer.process(x), ja.beamformer.process(x))
    close(ta.process(x), ja.process(x))
    with pytest.raises(ValueError):
        ta.process(x[0])


def _stream(cfg_kw, blocks, x):
    """The port's and the JAX conditioner over the same blocks."""
    t = tc.SignalConditioner(tc.ConditionerConfig(**cfg_kw), device="cpu")
    j = jc.SignalConditioner(jc.ConditionerConfig(**cfg_kw))
    out_t, out_j, i = [], [], 0
    for n in blocks:
        out_t.append(t.process(x[i:i + n]))
        out_j.append(j.process(x[i:i + n]))
        i += n
    return np.concatenate(out_t), np.concatenate(out_j)


def test_conditioner_ibyte_xlating_decimation_matches_jax():
    """A real-IF int8 capture to baseband at fs/4 in two blocks, equal to
    the port's one-shot run, the tone at +50 kHz."""
    fs, f_if, n = 8e6, 2e6, 1 << 15
    t = np.arange(n) / fs
    raw = np.round(np.cos(2 * np.pi * (f_if + 5e4) * t) * 100).astype(
        np.int8)
    kw = dict(input_format="byte", fs_in=fs, if_freq_hz=f_if, fir_taps=65,
              fir_band_hz=(0.0, 8e5), decimation=4)
    yt, yj = _stream(kw, (n // 2, n // 2), raw)
    close(yt, yj)
    once = tc.SignalConditioner(tc.ConditionerConfig(**kw), "cpu").process(
        raw)
    np.testing.assert_allclose(yt, once, atol=1e-2)
    spec = np.abs(np.fft.fft(yt[200:]))
    assert abs(np.argmax(spec) / (len(yt) - 200) * fs / 4 - 5e4) < (
        2 * fs / 4 / (len(yt) - 200))


def test_conditioner_fractional_resample_matches_jax():
    x = tone(4e6, 1e5, 1 << 14)
    yt, yj = _stream(dict(input_format="passthrough", fs_in=4e6,
                          fs_out=2.6e6), [2048] * 8, x)
    close(yt, yj)


def test_conditioner_decimation_irregular_block_lengths_matches_jax():
    """test_conditioner_decimation_irregular_block_lengths's blocks, with
    the notch and pulse blanking on as well."""
    x = tone(4e6, 0.1e6, 4096) + 0.05 * noise(4096)
    blocks = (1000, 37, 511, 1025, 999, 524)
    kw = dict(input_format="passthrough", fs_in=4e6, fir_taps=17,
              fir_band_hz=(0.0, 0.4e6), decimation=4)
    yt, yj = _stream(kw, blocks, x)
    close(yt, yj)
    one = tc.SignalConditioner(tc.ConditionerConfig(**kw), "cpu").process(x)
    np.testing.assert_allclose(yt, one[:len(yt)], rtol=0, atol=1e-4)
    assert len(yt) >= len(one) - 1
    kw.update(enable_notch=True, enable_pulse_blanking=True)
    close(*_stream(kw, blocks, x))
