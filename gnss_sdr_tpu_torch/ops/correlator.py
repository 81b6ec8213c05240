"""One-period multi-tap correlator (kernel K3) and its plain version.

Counterpart of ``gnss_sdr_tpu/ops/correlator.py``: carrier wipeoff, the
soft-interpolated code replica and T tap dot products for C channels over
one code period, with no loop closure. The eager tracking engine
(``tracking/dll_pll.py``) calls ``correlator`` once per period.

``correlator`` launches the CUDA kernel ``csrc/correlator.cu`` for CUDA
tensors and runs ``correlator_plain`` for CPU tensors; it never falls back
from one to the other. On the card each channel is a thread-block cluster
of R CTAs, each taking a slice of S samples of the period, with (R, S) from
K1's rule ``cluster_shape`` on the card's SM count.

Inputs: ``x`` complex64 [C, N] (the period's samples from each channel's
start position), ``codes_q``/``dcodes_q`` float32 [C, Q, 128] zero-padded
code tables (``pack_code_table``), ``scalars`` float32 [C, 8] =
[rem_code_phase chips, code_step chips/sample, phase0 rad, ph_step
rad/sample, n_valid, 0, 0, 0]. Output: float32 [C, 1, 128] with lanes
[2t, 2t+1] = tap t re/im and, with ``track_pilot``, lanes [2T, 2T+1] = the
data-code prompt.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops import _build
from gnss_sdr_tpu_torch.ops.track_kernel_blocked import cluster_shape, sm_count

LANES = 128
MAX_TAPS = 5


def _pad128(n: int) -> int:
    return ((n + LANES - 1) // LANES) * LANES


def pack_code_table(codes: np.ndarray) -> np.ndarray:
    """[C, L] chips -> [C, Q, 128] row-major padded table (pad chips 0)."""
    c, l = codes.shape
    lp = _pad128(l)
    out = np.zeros((c, lp), dtype=np.float32)
    out[:, :l] = codes
    return out.reshape(c, lp // LANES, LANES)


def _check(x, codes_q, dcodes_q, scalars, tap_offsets, code_len,
           track_pilot):
    dev = x.device
    if x.dtype != torch.complex64 or x.dim() != 2:
        raise ValueError(f"x must be complex64 [C, N], got {x.dtype} "
                         f"{tuple(x.shape)}")
    c = x.shape[0]
    if len(tap_offsets) not in (3, 5):
        raise ValueError(f"num_taps must be 3 or 5, got {len(tap_offsets)}")
    tables = [codes_q] + ([dcodes_q] if track_pilot else [])
    for name, t in zip(("codes_q", "dcodes_q"), tables):
        if (t is None or t.dtype != torch.float32 or t.dim() != 3
                or t.shape[0] != c or t.shape[2] != LANES
                or t.shape[1] * LANES < code_len):
            raise ValueError(f"{name} must be float32 [C, Q, 128] covering "
                             f"{code_len} chips")
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (c, 8):
        raise ValueError("scalars must be float32 [C, 8]")
    for t in (x, scalars, *tables):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def correlator_plain(x, codes_q, dcodes_q, scalars, tap_offsets, *,
                     code_len: int, interp_code: bool = True,
                     track_pilot: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same float32 formulas."""
    c, n = x.shape
    dev = x.device
    f32 = torch.float32
    k = torch.arange(n, dtype=f32, device=dev)
    rem, step = scalars[:, 0:1], scalars[:, 1:2]
    phase0, ph_step, n_valid = scalars[:, 2:3], scalars[:, 3:4], scalars[:, 4:5]
    mask = (k[None, :] < n_valid).to(f32)
    # phase ramps rounded once, as a fused multiply-add rounds them (the
    # product of two float32 values is exact in float64)
    ph = (ph_step.double() * k[None, :].double() + phase0.double()).float()
    cw, sw = torch.cos(ph), torch.sin(ph)
    xr, xi = x.real, x.imag
    # x * e^{-j ph}
    wr = (xr * cw + xi * sw) * mask
    wi = (xi * cw - xr * sw) * mask
    cph = (step.double() * k[None, :].double()
           + rem.double()).float()                             # [C, N] chips

    def taps(table, offs):
        tbl = table.reshape(c, -1)[:, :code_len]
        tap_ph = cph[:, None, :] + torch.tensor(
            np.asarray(offs, np.float32), device=dev)[None, :, None]
        fl = torch.floor(tap_ph)
        idx = fl.to(torch.int64) % code_len                    # [C, T', N]
        flat = idx.reshape(c, -1)

        def chips(i):
            return torch.gather(tbl, 1, i).reshape(idx.shape)

        c0 = chips(flat)
        if not interp_code:
            ctap = c0
        else:
            cm = chips((flat - 1) % code_len)
            cp = chips((flat + 1) % code_len)
            # the ramps' widths as one reciprocal of the step, as the
            # kernel applies them
            frac = tap_ph - fl
            inv = (1.0 / step)[:, :, None]
            ramp_in = torch.clamp(frac * inv + 0.5, 0.0, 1.0)
            ramp_out = torch.clamp((frac - 1.0) * inv + 0.5, 0.0, 1.0)
            ctap = cm + (c0 - cm) * ramp_in + (cp - c0) * ramp_out
        re = (wr[:, None, :] * ctap).sum(-1)
        im = (wi[:, None, :] * ctap).sum(-1)
        return torch.stack([re, im], dim=-1).reshape(c, -1)   # [C, 2T']

    t = len(tap_offsets)
    out = torch.zeros((c, 1, LANES), dtype=f32, device=dev)
    out[:, 0, :2 * t] = taps(codes_q, tap_offsets)
    if track_pilot:
        out[:, 0, 2 * t:2 * t + 2] = taps(dcodes_q, [tap_offsets[t // 2]])
    return out


def correlator(x, codes_q, dcodes_q, scalars, tap_offsets, *,
               code_len: int, interp_code: bool = True,
               track_pilot: bool = False) -> torch.Tensor:
    """K3 on a CUDA tensor, the plain version on a CPU tensor."""
    tap_offsets = [float(o) for o in np.asarray(tap_offsets, np.float32)]
    _check(x, codes_q, dcodes_q, scalars, tap_offsets, code_len, track_pilot)
    kw = dict(code_len=code_len, interp_code=interp_code,
              track_pilot=track_pilot)
    if x.device.type == "cpu":
        return correlator_plain(x, codes_q, dcodes_q, scalars, tap_offsets,
                                **kw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty((x.shape[0], 1, LANES), dtype=torch.float32,
                      device=x.device)
    launch(x, codes_q, dcodes_q, scalars, tap_offsets, out, **kw)
    return out


def launch(x, codes_q, dcodes_q, scalars, tap_offsets, out, *,
           code_len: int, interp_code: bool = True,
           track_pilot: bool = False) -> None:
    """Launch K3 on checked CUDA inputs into ``out`` [C, 1, 128], on the
    current stream, without synchronising; ``correlator.cluster`` keeps the
    cluster size R of the last launch."""
    c, n = x.shape
    dq = dcodes_q if track_pilot else codes_q
    if codes_q.data_ptr() % 16 or dq.data_ptr() % 16:
        raise ValueError("codes_q and dcodes_q must be 16-byte aligned")
    r, width = cluster_shape(c, n, sm_count(x.device))
    lib = _build.library()
    offs = (ctypes.c_float * MAX_TAPS)(*tap_offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gnss_correlator(
            x.data_ptr(), n, codes_q.data_ptr(), dq.data_ptr(),
            codes_q.shape[1] * LANES, code_len, scalars.data_ptr(),
            out.data_ptr(), c, offs, len(tap_offsets), int(interp_code),
            int(track_pilot), r, width, stream)
    _build.check(rc, "correlator")
    correlator.cluster = r
    correlator.launches += 1


correlator.launches = 0
correlator.cluster = None
