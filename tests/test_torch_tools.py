"""The port's tools against the repository's JAX tools, on the CPU.

- P1: each plain variant of ``gnss_sdr_tpu_torch.tools.mosaic_probe``
  against the JAX variant function of ``tools/mosaic_probe.py`` (plain
  ``jnp`` functions, callable outside the Pallas kernel) on the same
  (704, 128) tile; ``staging``, ``narrow`` and ``out store`` (whole Pallas
  kernels in the TPU probe) against a numpy rendering of
  ``tools/mosaic_probe.py:149-189``. The port keeps one accumulator per
  channel where the TPU harness keeps one for all 704 rows (one channel is
  one CTA on the card); the accumulator equals the period count either way,
  which the harness checks show.
- kbench: ``run`` at C = 2, K = 4 for ``full`` (K2's plain version) and
  ``simple`` (K4's), its checksum against the same chain computed with the
  JAX kernels of ``tools/kbench.py`` in interpret mode.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools import kbench as jkbench  # noqa: E402
from tools import mosaic_probe as jprobe  # noqa: E402

from gnss_sdr_tpu.codes.gps_l1_ca import gps_l1_ca_code_table  # noqa: E402
from gnss_sdr_tpu.ops.correlator import pack_code_table  # noqa: E402
from gnss_sdr_tpu_torch.ops.track_kernel_blocked import (  # noqa: E402
    cluster_shape,
)
from gnss_sdr_tpu_torch.tools import kbench  # noqa: E402
from gnss_sdr_tpu_torch.tools import mosaic_probe as probe  # noqa: E402

torch.set_num_threads(2)

# per-variant tolerance (rtol, atol) against the JAX function:
# exact where both compute the same float32 additions and gathers;
# a few ulp where sin/cos differ between XLA and PyTorch, or where XLA
# may contract v * a + b into one rounding (vec20); sums of 22 (matreduce)
# or 128 (lanereduce8) terms in another order at float32's 1e-6
TOLS = {
    "baseline": (0.0, 0.0),
    "gather1": (0.0, 0.0),
    "gather3": (0.0, 0.0),
    "qloop8": (0.0, 0.0),
    "sincos": (1e-6, 1e-6),
    "vec20": (1e-6, 0.0),
    "matreduce": (1e-6, 1e-5),
    "lanereduce8": (1e-6, 1e-4),
}


def tile():
    return probe.probe_input("cpu")


@pytest.mark.parametrize("variant", list(probe.FUNCTIONS))
@pytest.mark.parametrize("i,acc", [(0, 0.0), (7, 7.0), (45, 1999.0)])
def test_probe_variant_matches_jax(variant, i, acc):
    x = tile()
    src = x[:probe.BR]
    want = np.asarray(getattr(jprobe, variant)(
        i, jnp.float32(acc), jnp.asarray(src.numpy()), None, None))
    got = probe.FUNCTIONS[variant](
        i, torch.full((probe.C,), acc, dtype=torch.float32),
        src.reshape(probe.C, probe.ROWS_P, probe.LANES))
    got = got.reshape(want.shape).numpy()
    rtol, atol = TOLS[variant]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_lane_idx_varies_per_lane():
    for i in (0, 30, 31):
        idx = probe.lane_idx(i, "cpu").to(torch.int64)
        assert idx.min() >= 0 and idx.max() < 128
        assert len(torch.unique(idx)) > 100


@pytest.mark.parametrize("variant", list(probe.FUNCTIONS))
def test_probe_harness_accumulates_per_channel(variant):
    """The coupled harness: acc ends at K whatever the variant computes,
    as in the TPU probe, and the first-period sums are the sums of v at
    acc = 0, channel by channel."""
    x = tile()
    k = 3
    out, sums, big = probe.probe(variant, x, k)
    assert big is None
    np.testing.assert_array_equal(out.numpy(), np.full((8, 128), k,
                                                       np.float32))
    src = x[:probe.BR]
    v0 = np.asarray(getattr(jprobe, variant)(
        0, jnp.float32(0.0), jnp.asarray(src.numpy()), None, None),
        np.float64)
    per_ch = v0.reshape(probe.C, -1).sum(axis=1)
    np.testing.assert_allclose(sums[:, 0].numpy(), per_ch, rtol=1e-5,
                               atol=1e-3)


def _np_staging(x, k):
    """tools/mosaic_probe.py:149-166 in numpy; the per-channel sum of the
    staged copy at the first and the last period."""
    acc = np.float32(0.0)
    sums = np.zeros((probe.C, 2), np.float32)
    for i in range(k):
        pos = np.full((probe.C, 1), 100.0, np.float32) + acc * np.float32(1e-20)
        scr = np.zeros((probe.BR, 128), np.float32)
        scr2 = np.zeros((probe.BR, 128), np.float32)
        for c in range(probe.C):
            r0 = int(pos[c, 0])
            scr[c * 22:(c + 1) * 22] = x[r0:r0 + 22]
            scr2[c * 22:(c + 1) * 22] = x[r0 + 1:r0 + 23]
        per_ch = scr.reshape(probe.C, -1).sum(axis=1, dtype=np.float64)
        if i == 0:
            sums[:, 0] = per_ch
        if i == k - 1:
            sums[:, 1] = per_ch
        acc = np.float32(acc + np.float32(scr.sum()) * np.float32(1e-20)
                         + np.float32(1.0))
    return np.full((8, 128), acc, np.float32) + scr2[0:8], sums


def _np_narrow(x, k):
    """tools/mosaic_probe.py:169-178 in numpy; v after the first and the
    last period."""
    v = x[0:32, 0:1].copy()
    sums = np.zeros((32, 2), np.float32)
    a, b = np.float32(1.000001), np.float32(1e-8)
    for i in range(k):
        for _ in range(150):
            v = v * a + b
        if i == 0:
            sums[:, 0] = v[:, 0]
        if i == k - 1:
            sums[:, 1] = v[:, 0]
    return np.broadcast_to(v[0:8], (8, 1)) * np.ones((8, 128), np.float32), sums


def _np_outstore(x, k):
    """tools/mosaic_probe.py:181-189 in numpy; the row sums at the first
    and the last period, and the (32, 200, 128) buffer."""
    big = np.zeros((32, 200, 128), np.float32)
    acc = np.float32(0.0)
    sums = np.zeros((32, 2), np.float32)
    for i in range(k):
        row = x[0:32, :] + acc
        big[:, i % 200, :] = row
        if i == 0:
            sums[:, 0] = row.sum(axis=1, dtype=np.float64)
        if i == k - 1:
            sums[:, 1] = row.sum(axis=1, dtype=np.float64)
        acc = np.float32(acc + np.float32(1.0))
    return np.full((8, 128), acc, np.float32) + big[0, 0:8, :], sums, big


@pytest.mark.parametrize("k", [1, 4])
def test_probe_staging_narrow_outstore_match_numpy(k):
    x = tile()
    xn = x.numpy()
    out, sums, _ = probe.probe("staging", x, k)
    w_out, w_sums = _np_staging(xn, k)
    np.testing.assert_array_equal(out.numpy(), w_out)
    np.testing.assert_allclose(sums.numpy(), w_sums, rtol=1e-5, atol=1e-3)

    out, sums, _ = probe.probe("narrow", x, k)
    w_out, w_sums = _np_narrow(xn, k)
    np.testing.assert_array_equal(out.numpy(), w_out)
    np.testing.assert_array_equal(sums.numpy(), w_sums)

    out, sums, big = probe.probe("out store", x, k)
    w_out, w_sums, w_big = _np_outstore(xn, k)
    np.testing.assert_array_equal(out.numpy(), w_out)
    np.testing.assert_array_equal(big.numpy(), w_big)
    np.testing.assert_allclose(sums.numpy(), w_sums, rtol=1e-5, atol=1e-3)


def test_probe_rejects():
    with pytest.raises(ValueError):
        probe.probe("matmul", tile(), 2)
    with pytest.raises(ValueError):
        probe.probe("baseline", torch.zeros((704, 128)), 2)


def test_probe_cluster_size():
    """P1 launches on the trackers' mapping: by default R = cluster_shape's
    R for C = 32 channels of 22 x 128 elements, 4 on 132 SMs; an explicit R
    must be a power of two <= 8, on any device. On the CPU every valid
    choice runs the plain version."""
    assert probe.ranks_for(132) == cluster_shape(32, 2816, 132)[0] == 4
    x = tile()
    for bad in (3, 6, 16, 0):
        with pytest.raises(ValueError):
            probe.probe("baseline", x, 2, ranks=bad)
    want = probe.probe_plain("staging", x, 2)
    for r in (1, 2, 4, 8):
        got = probe.probe("staging", x, 2, ranks=r)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_probe_timed_on_cpu():
    ns = probe.timed("baseline", "baseline", reps=1, k=2, iters=1,
                     device="cpu")
    assert np.isfinite(ns) and ns > 0


def _jax_chain(kind, C, K, iters, monkeypatch):
    """tools/kbench.py:65-115's chain from scal0 with its own kernels
    (interpret mode): the float32 checksum after ``iters`` launches."""
    monkeypatch.setattr(jkbench, "CHANNELS", C)
    monkeypatch.setattr(jkbench, "STEPS", K)
    conf, fused, ns, _ = jkbench.build(kind, "qloop")
    n_win = conf.window_samples
    npadw = ((n_win + 127) // 128 + 32) * 128
    rng = np.random.default_rng(0)
    wr = jnp.asarray(rng.normal(size=(npadw // 128, 128)).astype(np.float32))
    wi = jnp.asarray(rng.normal(size=(npadw // 128, 128)).astype(np.float32))
    codes = gps_l1_ca_code_table()[np.arange(C) % 32].astype(np.float32)
    codes_q = jnp.asarray(pack_code_table(codes))
    scal = np.zeros((C, ns), np.float32)
    scal[:, 1] = 0.3
    scal[:, 4] = np.linspace(-4000, 4000, C)
    scal[:, 7] = 1
    if kind == "full":
        scal[:, 10] = 1
        scal[:, 17] = 35.0
        scal[:, 18] = 2.0
    scal = jnp.asarray(scal)
    chk = jnp.zeros((), jnp.float32)
    with jax.enable_x64(False):
        for _ in range(iters):
            out = fused(wr, wi, codes_q, scal)
            last = out[:, -1, :]
            cols = [jnp.zeros((C,), jnp.float32), last[:, 13], last[:, 12],
                    last[:, 14], last[:, 11], last[:, 15], last[:, 16],
                    jnp.ones((C,), jnp.float32), last[:, 18], last[:, 19]]
            cols += [scal[:, j] for j in range(10, ns)]
            chk = (chk + jnp.sum(out[:, :, 2])
                   + jnp.sum(out[:, :, 10])).astype(jnp.float32)
            scal = jnp.stack(cols, axis=1).astype(jnp.float32)
    return float(chk)


@pytest.mark.parametrize("kind", ["full", "simple"])
@pytest.mark.parametrize("iters", [1, 2])
def test_kbench_checksum_matches_jax_chain(kind, iters, monkeypatch):
    """The checksum sums lane 10 (period lengths, exact) and lane 2 (the
    prompt's real part, within 2e-3 relative per period over K = 4 of
    noise): 1e-5 relative of a checksum of ~2 x 4 x 2600 x iters."""
    got = kbench.run(kind, C=2, K=4, iters=iters, device="cpu")
    want = _jax_chain(kind, 2, 4, iters, monkeypatch)
    assert got["kind"] == kind
    assert np.isfinite(got["msps"]) and got["us_per_ch_period"] > 0
    assert abs(got["checksum"] - want) <= 1e-5 * abs(want), (got, want)


def test_kbench_variants(capsys):
    assert kbench.parse_variant("simple-window2") == "simple"
    assert kbench.parse_variant("full-qloop") == "full"
    for bad in ("blocked", "full-pingpong"):
        with pytest.raises(ValueError):
            kbench.parse_variant(bad)
    r = kbench.run("simple-qloop", C=1, K=2, iters=1, device="cpu")
    out = capsys.readouterr().out
    assert "simple-qloop" in out and "one CUDA kernel" in out
    assert out.strip().splitlines()[-1].startswith("simple: ")
    assert r["kind"] == "simple"
