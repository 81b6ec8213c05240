"""Gaussian (nonlinear Bayesian) carrier tracking: batched cubature /
unscented Kalman filtering on prompt correlator outputs.

Counterpart of ``gnss_sdr_tpu/tracking/gaussian.py``. Reference analogs:

- src/algorithms/tracking/libs/nonlinear_tracking.{h,cc}: the reusable
  CubatureFilter / UnscentedFilter classes (cubature point sets, sigma
  points, predict/update on arbitrary f/h);
- src/algorithms/tracking/gnuradio_blocks/gps_l1_ca_gaussian_tracking_cc
  + libs/bayesian_estimation.cc (GPS_L1_CA_Gaussian_Tracking): a carrier
  loop whose phase/Doppler estimate comes from a Bayesian nonlinear filter
  on the prompt I/Q (measurement model z = A[cos phi, sin phi]) with an
  adaptively estimated measurement covariance, instead of a discriminator
  and loop filter.

Both transforms are batched over channels (leading axis C) in float64 (the
JAX package runs them with x64 on). ``GaussianCarrierTracker`` runs the
prompt sequence as a loop over its periods on the tracker's device, where
the JAX package scans. ``GaussianLoopCloser`` writes its commands into the
port's state tensors in place between blocks.

State per channel: x = [phi (rad), omega (rad/period), omega_dot].
Measurement per period: prompt [I, Q]; data-bit sign invariance is handled
by flipping the observation into the predicted measurement's half-plane
(Costas-equivalent).
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device

F64 = torch.float64


# ------------------------------------------------------------- point sets
def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """The Cholesky factor, unchecked as ``jnp.linalg.cholesky`` is: a
    checked factorisation reads its status back to the host, which on the
    card stalls the filter's loop twice a period."""
    return torch.linalg.cholesky_ex(a, check_errors=False).L


def cubature_points(mean: torch.Tensor, cov: torch.Tensor):
    """Third-degree spherical-radial cubature points (batched).

    mean: [C, n], cov: [C, n, n] -> points [C, 2n, n], weights [2n]
    (nonlinear_tracking.cc CubatureFilter point generation).
    """
    n = mean.shape[-1]
    s = _cholesky(cov)                               # [C, n, n]
    eye = torch.eye(n, dtype=mean.dtype, device=mean.device)
    unit = torch.cat([eye, -eye]) * np.sqrt(n)       # [2n, n]
    pts = mean[:, None, :] + torch.einsum("cij,kj->cki", s, unit)
    w = torch.full((2 * n,), 1.0 / (2 * n), dtype=mean.dtype,
                   device=mean.device)
    return pts, w


def unscented_points(mean: torch.Tensor, cov: torch.Tensor,
                     alpha: float = 1e-2, beta: float = 2.0,
                     kappa: float = 0.0):
    """Scaled unscented sigma points (batched).

    mean: [C, n], cov: [C, n, n] -> points [C, 2n+1, n],
    (mean weights [2n+1], cov weights [2n+1])
    (nonlinear_tracking.cc UnscentedFilter).
    """
    n = mean.shape[-1]
    lam = alpha * alpha * (n + kappa) - n
    s = _cholesky((n + lam) * cov)
    st = s.transpose(-1, -2)
    pts = torch.cat([mean[:, None, :], mean[:, None, :] + st,
                     mean[:, None, :] - st], dim=1)
    wm = torch.full((2 * n + 1,), 1.0 / (2 * (n + lam)), dtype=mean.dtype,
                    device=mean.device)
    wm[:1].fill_(lam / (n + lam))
    wc = wm.clone()
    wc[:1] += 1.0 - alpha * alpha + beta
    return pts, (wm, wc)


def gauss_update(pts, wm, wc, z, h_fn, R):
    """Generic Gaussian measurement update from propagated points.

    pts: [C, K, n] sigma/cubature points; z: [C, m] measurements;
    h_fn: [C, K, n] -> [C, K, m]; R: [m, m] or [C, m, m]. Returns the
    posterior (mean, cov).
    """
    zs = h_fn(pts)                                   # [C, K, m]
    z_pred = torch.einsum("k,ckm->cm", wm, zs)
    dz = zs - z_pred[:, None, :]
    x_mean = torch.einsum("k,ckn->cn", wm, pts)
    dx = pts - x_mean[:, None, :]
    S = torch.einsum("k,ckm,ckl->cml", wc, dz, dz) + R
    Pxz = torch.einsum("k,ckn,ckm->cnm", wc, dx, dz)
    K = torch.linalg.solve_ex(S.transpose(-1, -2), Pxz.transpose(-1, -2),
                              check_errors=False).result
    K = K.transpose(-1, -2)                          # [C, n, m]
    mean = x_mean + torch.einsum("cnm,cm->cn", K, z - z_pred)
    cov = (torch.einsum("k,ckn,ckl->cnl", wc, dx, dx)
           - torch.einsum("cnm,cml,ckl->cnk", K, S, K))
    return mean, cov


def _smoothed_amplitude(prompts: np.ndarray) -> np.ndarray:
    """[T, C] prompts -> [T, C] moving average of |p| over min(20, T)
    periods (bayesian_estimation.cc adaptively estimates the measurement
    scale)."""
    amp = np.abs(prompts).astype(np.float64)
    k = min(20, prompts.shape[0])
    kern = np.ones(k) / k
    return np.apply_along_axis(
        lambda a: np.convolve(a, kern, mode="same"), 0, amp)


class GaussianCarrierTracker:
    """Batched CKF/UKF carrier phase/frequency tracker on prompt I/Q
    (gps_l1_ca_gaussian_tracking_cc analog), on ``device``."""

    def __init__(self, num_channels: int, t_int_s: float = 1e-3,
                 kind: str = "cubature",
                 meas_std: float = 0.1,
                 q_phase: float = 1e-6, q_omega: float = 1e-4,
                 q_alpha: float = 1e-6, *,
                 device: str | torch.device = "cuda") -> None:
        if kind not in ("cubature", "unscented"):
            raise ValueError(kind)
        self.device = resolve_device(device)
        self.kind = kind
        self.C = num_channels
        self.T = t_int_s
        self.R = np.eye(2) * meas_std**2
        self.Q = np.diag([q_phase, q_omega, q_alpha])
        self._F = torch.tensor([[1.0, 1.0, 0.5],
                                [0.0, 1.0, 1.0],
                                [0.0, 0.0, 1.0]], dtype=F64,
                               device=self.device)   # per-period units
        self._Q = torch.tensor(self.Q, dtype=F64, device=self.device)
        self._graphs: dict = {}              # input shapes -> CUDA graph

    def _run(self, x, P, prompts, amps, R):
        """x: [C,3], P: [C,3,3], prompts: [T,C,2], amps: [T,C],
        R: [2,2] or [C,2,2] measurement covariance; float64 tensors on the
        device. Returns (x_final, P_final, xs [T,C,3])."""
        F, Q = self._F, self._Q
        xs = []
        for z, amp in zip(prompts, amps):
            def h(pts, amp=amp):                     # [C,K,3] -> [C,K,2]
                phi = pts[..., 0]
                return amp[:, None, None] * torch.stack(
                    [torch.cos(phi), torch.sin(phi)], dim=-1)

            # predict
            x = torch.einsum("ij,cj->ci", F, x)
            P = torch.einsum("ij,cjk,lk->cil", F, P, F) + Q
            # bit-sign invariance (Costas): flip z into the predicted
            # half-plane
            pred = torch.stack([torch.cos(x[:, 0]), torch.sin(x[:, 0])], -1)
            sgn = torch.sign(torch.sum(pred * z, dim=-1, keepdim=True))
            zz = z * torch.where(sgn == 0.0, 1.0, sgn)
            if self.kind == "cubature":
                pts, w = cubature_points(x, P)
                wm = wc = w
            else:
                pts, (wm, wc) = unscented_points(x, P)
            x, P = gauss_update(pts, wm, wc, zz, h, R)
            # keep covariance symmetric (numerical)
            P = 0.5 * (P + P.transpose(-1, -2))
            xs.append(x)
        return x, P, torch.stack(xs)

    def _call(self, prompts, x0, P0, R):
        prompts = np.asarray(prompts)
        z = np.stack([prompts.real, prompts.imag], -1)
        args = [np.ascontiguousarray(a, np.float64) for a in (
            x0, P0, z, _smoothed_amplitude(prompts),
            self.R if R is None else R)]
        if self.device.type == "cuda":
            xf, Pf, xs = self._replay(args)
        else:
            xf, Pf, xs = self._run(*(torch.as_tensor(a) for a in args))
        return xs.cpu().numpy(), xf.cpu().numpy(), Pf.cpu().numpy()

    def _replay(self, args):
        """``_run`` on the card as one CUDA graph per input shape: the
        loop's ~60 small launches a period would otherwise cost the host
        far more than the card's work (about 50 ms a 20-period block
        against 3 ms of kernels on an H100). The inputs are copied into
        the graph's own tensors, and its outputs are overwritten by the
        next replay."""
        key = tuple(a.shape for a in args)
        if key not in self._graphs:
            static = [torch.as_tensor(a, device=self.device) for a in args]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._run(*static)                   # warm-up, uncaptured
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self._run(*static)
            self._graphs[key] = (graph, static, out)
        graph, static, out = self._graphs[key]
        for dst, a in zip(static, args):
            dst.copy_(torch.from_numpy(a))
        graph.replay()
        return out

    def run(self, prompts: np.ndarray, x0: np.ndarray | None = None,
            P0: np.ndarray | None = None, R: np.ndarray | None = None):
        """prompts: [T, C] complex prompt stream (one per integration
        period). Returns per-step states [T, C, 3]
        ([phi rad, omega rad/period, alpha rad/period^2])."""
        C = np.asarray(prompts).shape[1]
        if x0 is None:
            x0 = np.zeros((C, 3))
        if P0 is None:
            P0 = np.tile(np.diag([1.0, 0.5, 1e-4]), (C, 1, 1))
        return self._call(prompts, x0, P0, R)[0]

    def run_carry(self, prompts: np.ndarray, x0: np.ndarray,
                  P0: np.ndarray, R: np.ndarray | None = None):
        """Like run(), but returns (xs, x_final, P_final) so the filter
        state carries across tracking blocks."""
        return self._call(prompts, x0, P0, R)


class GaussianLoopCloser:
    """Closes the carrier loop at tracking-block cadence with the CKF/UKF
    (the live-receiver integration of GPS_L1_CA_Gaussian_Tracking,
    reference gps_l1_ca_gaussian_tracking_cc.cc: after `s_transient`
    periods the Bayesian filter owns the carrier estimate).

    The batched tracker runs with a near-dead internal PLL; after every
    block the filter consumes the block's per-period prompts (post-wipeoff
    residuals), and its frequency estimate is written into the tracker's
    state tensors in place, on their device, before the next block. Once a
    frequency command lands, the residual frequency restarts near zero, so
    the filter's omega state is re-zeroed after each command.
    """

    def __init__(self, num_channels: int, code_period_s: float,
                 kind: str = "cubature", meas_std: float = 0.5,
                 s_transient: int = 0, gain: float = 0.3,
                 max_cmd_hz: float = 2.0, *,
                 device: str | torch.device = "cuda") -> None:
        self.trk = GaussianCarrierTracker(
            num_channels, t_int_s=code_period_s, kind=kind,
            meas_std=meas_std, device=device)
        self.C = num_channels
        self.Tp = code_period_s
        self.s_transient = int(s_transient)
        self.gain = float(gain)
        self.max_cmd_hz = float(max_cmd_hz)
        self._seen = np.zeros(num_channels, np.int64)
        self._om_hist = [[] for _ in range(num_channels)]
        self.x = np.zeros((num_channels, 3))
        self.P = np.tile(np.diag([1.0, 0.5, 1e-4]), (num_channels, 1, 1))

    def after_block(self, tracker, result) -> None:
        out = result.outputs
        prompts = np.asarray(out["prompt"])            # [S, C]
        S = prompts.shape[0]
        act = [ch for ch in tracker.active_channels()]
        if not act:
            return
        # fresh channels: seed phi/omega from this block's prompts (the
        # CKF's Costas half-plane flip cannot disambiguate the rotation
        # direction from a cold zero-omega prior). The squared-product
        # removes the BPSK sign: angle((p[k+1] conj(p[k]))^2)/2.
        fresh = [ch for ch in act if self._seen[ch] == 0]
        for ch in fresh:
            p = prompts[:, ch]
            if len(p) >= 3:
                d = (p[1:] * np.conj(p[:-1])) ** 2
                self.x[ch, 0] = float(np.angle(p[-1]))
                self.x[ch, 1] = 0.5 * float(np.angle(np.sum(d)))
                self.x[ch, 2] = 0.0
                self.P[ch] = np.diag([1.0, 1e-3, 1e-6])
            self._seen[ch] = S
        run_chs = [ch for ch in act if ch not in fresh]
        if not run_chs:
            return
        # adaptive measurement covariance (reference
        # bayesian_estimation.cc): per-channel noise variance from the
        # block's amplitude jitter (|p| fluctuation ~ per-quadrature noise
        # at tracking SNR)
        amp = np.abs(prompts)
        s2 = np.maximum(np.var(amp, axis=0), 1e-6)      # [C]
        R = (np.eye(2)[None, :, :]
             * s2[:, None, None]).astype(np.float64)    # [C,2,2]
        _, xf, Pf = self.trk.run_carry(prompts, self.x, self.P, R=R)
        # Costas bit-sign invariance aliases omega by multiples of pi
        # rad/period; fold the estimate into the unambiguous (-pi/2, pi/2]
        # band (the filter can silently converge to the pi-alias of a
        # small residual)
        xf[:, 1] = np.mod(xf[:, 1] + np.pi / 2, np.pi) - np.pi / 2
        state = tracker.state
        ctl = getattr(tracker, "ctl", None)
        for ch in run_chs:
            self._seen[ch] += S
            self.x[ch], self.P[ch] = xf[ch], Pf[ch]
            if self._seen[ch] <= self.s_transient:
                continue
            # The filter COMMANDS the NCO only where it owns the loop:
            # channels whose configured PLL is dead (<1 mHz — the
            # external-closure configuration). Against a live PLL the
            # block-cadence commands fight the per-period loop (two
            # controllers, one plant), so there the filter observes only —
            # its state remains available for monitoring.
            conf = tracker.conf
            narrow = ctl is not None and int(ctl[ch].phase) == 2
            eff_bw = (getattr(conf, "pll_bw_narrow_hz", 0.0) if narrow
                      else getattr(conf, "pll_bw_hz", 0.0))
            if eff_bw > 1e-3:
                continue
            # persistence-gated commanding: a genuine residual offset
            # (dead/weak loop, handoff error) produces consistent-sign
            # omega estimates block after block, while noise flips sign.
            # Command the running mean only once 3 consecutive blocks
            # agree in sign.
            h = self._om_hist[ch]
            h.append(float(xf[ch, 1]))
            if len(h) > 3:
                del h[0]
            if len(h) < 3 or not (all(v > 0 for v in h)
                                  or all(v < 0 for v in h)):
                continue
            xf[ch, 1] = float(np.mean(h))
            h.clear()
            # omega is rad/period of residual carrier after wipeoff. The
            # command must land in the PLL's first integrator:
            # pll_state[:, 0] carries the absolute Doppler and rewrites
            # carrier_doppler at every integration boundary.
            corr = np.float32(np.clip(
                self.gain * xf[ch, 1] / (2.0 * np.pi * self.Tp),
                -self.max_cmd_hz, self.max_cmd_hz))
            state.carrier_doppler[ch] += corr
            state.pll_state[ch, 0] += corr
            self.x[ch, 1] = 0.0

    def reset_channel(self, ch: int) -> None:
        self._seen[ch] = 0
        self._om_hist[ch].clear()
        self.x[ch] = 0.0
        self.P[ch] = np.diag([1.0, 0.5, 1e-4])
