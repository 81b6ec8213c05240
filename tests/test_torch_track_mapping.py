"""How K1, K3 and K4 are spread over the card, the kernels' code-index
wrap, and the readers of what nvcc made of them.

CPU only, no JAX: ``cluster_shape`` picks the cluster size R and slice
width S from the channel count (K1 and K4 with their occupancy queries, K3
from the rule alone), ``wrap_code_index`` is the comparison wrap that
replaced ``%`` in the per-sample step of the kernels
(``csrc/track_loop.cuh::wrap_index``), and ``tools/sass_report.py`` with
``_build.kernel_resources`` read the ptxas log and the SASS.
"""

import math

import numpy as np
import pytest
import torch

from gnss_sdr_tpu_torch.ops import _build
from gnss_sdr_tpu_torch.ops import track_kernel as k4
from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
from gnss_sdr_tpu_torch.tools import sass_report
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf

FS = 2.6e6
CHANNELS = [1, 5, 8, 16, 17, 32, 33, 66, 67, 132, 200]
H100_SMS = 132         # multiprocessors of an H100 SXM


def _n_max(code_len: int) -> int:
    # at the GPS chip rate: 2602 and 26002 samples a period
    return DllPllConf(fs=FS, code_length_chips=code_len,
                      code_rate_cps=1.023e6,
                      carrier_freq_hz=1575.42e6).max_step_samples


@pytest.mark.parametrize("code_len", [1023, 10230])
@pytest.mark.parametrize("c", CHANNELS)
def test_cluster_shape_covers_the_period(c, code_len):
    n_max = _n_max(code_len)
    r, s = k1.cluster_shape(c, n_max, H100_SMS)
    assert r in (1, 2, 4, 8)
    if r > 1:
        assert r * c <= H100_SMS
    if r < k1.MAX_CLUSTER:
        assert 2 * r * c > H100_SMS        # the largest such power of two
    assert s % k1.COPY_ALIGN == 0
    covered = np.zeros(r * s, np.int64)
    for rank in range(r):
        covered[rank * s:(rank + 1) * s] += 1
    assert np.all(covered[:n_max] == 1)    # each sample once
    assert (r - 1) * s < n_max             # no CTA starts past the period


@pytest.mark.parametrize("sms,sizes", [
    (H100_SMS, {1: 8, 5: 8, 8: 8, 16: 8, 17: 4, 32: 4, 33: 4, 66: 2, 67: 1,
                132: 1, 200: 1}),
    (114, {1: 8, 5: 8, 8: 8, 16: 4, 17: 4, 32: 2, 33: 2, 66: 1, 67: 1,
           132: 1, 200: 1}),
], ids=["132_sms", "114_sms"])
def test_cluster_shape_sizes(sms, sizes):
    """R follows the multiprocessor count the card reports (114 on an H100
    PCIe)."""
    n_max = _n_max(1023)
    assert {c: k1.cluster_shape(c, n_max, sms)[0] for c in CHANNELS} == sizes


def test_cluster_shape_halves_until_the_clusters_fit():
    """An occupancy answer below C halves R; R = 1 is taken without
    asking."""
    asked = []

    def fits(limit):
        def max_clusters(r, s):
            asked.append((r, s))
            return limit[r]
        return max_clusters

    n_max = _n_max(1023)
    r, s = k1.cluster_shape(8, n_max, H100_SMS, fits({8: 7, 4: 8}))
    assert (r, s) == (4, 652) and asked == [(8, 326), (4, 652)]
    asked.clear()
    assert k1.cluster_shape(8, n_max, H100_SMS,
                            fits({8: 0, 4: 0, 2: 0})) == (1, 2602)
    assert [a[0] for a in asked] == [8, 4, 2]


# K3's period lengths N: the JAX test's 2544, the eager engine's 2688 at
# 2.6 Msps (2602 valid), an odd row length and a 10230-chip period
@pytest.mark.parametrize("n", [2544, 2601, 2688, 26112])
@pytest.mark.parametrize("c", [1, 8, 33, 67, 140])
def test_correlator_slices_cover_the_period(c, n):
    """CTA r of K3's cluster reads [r S, min((r + 1) S, N)) of the
    period (``csrc/correlator.cu``): every sample once, every slice
    starting on a 16-byte copy boundary."""
    r, s = k1.cluster_shape(c, n, H100_SMS)
    covered = np.zeros(n, np.int64)
    for rank in range(r):
        lo = rank * s
        assert lo % k1.COPY_ALIGN == 0
        covered[lo:lo + min(max(n - lo, 0), s)] += 1
    assert np.all(covered == 1)
    assert r == (8 if c <= 16 else 4 if c <= 33 else 1)


@pytest.mark.parametrize("c,code_len,taps,fits,want", [
    (8, 1023, 3, {}, 8),
    (8, 10230, 5, {8: 7}, 4),
    (33, 10230, 3, {4: 0, 2: 0}, 1),
    (140, 1023, 5, {}, 1),
], ids=["c8", "c8_long_code_halved", "c33_long_code_to_one", "c140"])
def test_track_simple_cluster_follows_the_rule(monkeypatch, c, code_len,
                                               taps, fits, want):
    """K4 takes K1's rule, with the occupancy query asked of its own entry
    point for its code length (the chip table in shared memory beside the
    ring), replica form and tap count, at each R and slice width the rule
    tries; an answer below C halves R."""
    asked = []

    def occupancy(entry, device, *args):
        asked.append((entry, device, *args))
        return fits.get(args[-2], c)

    monkeypatch.setattr(k1, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(k1, "_max_clusters", occupancy)
    n_max = _n_max(code_len)
    spec = k4.make_simple_spec(
        20, n_max, code_len, [0.0] * taps, fs=FS, code_rate_cps=1.023e6,
        carrier_freq_hz=1575.42e6, pll_bw_hz=25.0, dll_bw_hz=2.0,
        interp_code=False)
    dev = torch.device("cpu")
    r, s = k4.simple_launch_shape(dev, c, spec)
    assert r == want
    assert (r, s) == k1.cluster_shape(c, n_max, H100_SMS,
                                      lambda r_, s_: fits.get(r_, c))
    # every R the rule tried from its first choice down to R, R = 1 unasked
    first = k1.cluster_shape(c, n_max, H100_SMS)[0]
    tried = [q for q in (8, 4, 2) if max(r, 2) <= q <= first]
    width = {q: 2 * math.ceil(math.ceil(n_max / q) / 2) for q in tried}
    assert asked == [("gnss_track_simple_max_clusters", dev, c, code_len,
                      n_max, 0, taps, q, width[q]) for q in tried]


@pytest.mark.parametrize("code_len", [1023, 10230])
def test_wrap_code_index_equals_modulo(code_len):
    """Every index a period's tap phases reach (within a few chips of
    [0, code_len)) and well beyond, where ``%`` is kept."""
    m = torch.arange(-code_len, 2 * code_len, dtype=torch.int64)
    far = torch.tensor([-5 * code_len - 3, -2 * code_len, 2 * code_len,
                        7 * code_len + 11, 2 ** 30], dtype=torch.int64)
    for x in (m, far):
        assert torch.equal(k1.wrap_code_index(x, code_len), x % code_len)


def test_kernel_resources_reads_the_ptxas_log():
    log = """--- track_full.cu
ptxas info    : Compiling entry function '_Zkern' for 'sm_90a'
ptxas info    : Function properties for _Zkern
    32 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 4608 bytes smem
"""
    assert _build.kernel_resources(log) == {"_Zkern": dict(
        stack_bytes=32, spill_store_bytes=12, spill_load_bytes=8,
        registers=72)}


def test_sass_report_finds_the_loops():
    sass = """\t\tFunction : _Zother
        /*0000*/                   EXIT ;
\t\tFunction : _Ztrack_full_kernel
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   MUFU.SIN R2, R3 ;
.L_x_2:
        /*0020*/                   FFMA R2, R3, R4, R5 ;
        /*0030*/              @P0  BRA `(.L_x_2) ;
        /*0040*/              @!P1 BRA 0x10 ;
        /*0050*/                   EXIT ;
"""
    funcs = sass_report.split_functions(sass)
    assert sorted(funcs) == ["_Zother", "_Ztrack_full_kernel"]
    a = sass_report.analyse(funcs["_Ztrack_full_kernel"])
    assert a["instructions"] == 6 and a["opcodes"]["BRA"] == 2
    assert a["loops"] == [
        dict(start="0x10", end="0x40", depth=0, instructions=4,
             opcodes={"BRA": 2, "MUFU.SIN": 1, "FFMA": 1}),
        dict(start="0x20", end="0x30", depth=1, instructions=2,
             opcodes={"FFMA": 1, "BRA": 1})]


def test_sass_report_period_loop():
    """The period loop is the outermost loop with a CTA or cluster barrier."""
    loops = [dict(depth=0, instructions=9, opcodes={"LDG.E.128": 2}),
             dict(depth=0, instructions=40, opcodes={"UCGABAR_ARV": 1}),
             dict(depth=1, instructions=12, opcodes={"BAR.SYNC": 1})]
    assert sass_report.period_loop(loops) == 40
    assert sass_report.period_loop(loops[2:]) is None
    assert sass_report.period_loop(
        [dict(depth=0, instructions=7, opcodes={"BAR.SYNC.DEFER_BLOCKING": 1})]
    ) == 7
