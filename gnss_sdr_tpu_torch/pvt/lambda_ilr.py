# Copied from gnss_sdr_tpu/pvt/lambda_ilr.py; only the package imports are rewritten.
"""LAMBDA integer ambiguity resolution (least-squares ambiguity
decorrelation adjustment).

Reference analog: src/algorithms/libs/rtklib/rtklib_lambda.cc (itself the
standard published LAMBDA method: Teunissen 1995; De Jonge & Tiberius
1996). Components:

- LTDL factorization of the float ambiguity covariance Q = L^T D L;
- Z-transform decorrelation (integer Gauss transformations + permutations)
  so the search ellipsoid is near-spherical;
- depth-first integer search returning the best and second-best candidate
  (for the ratio test).

All double-precision numpy — ambiguity dimension is small (#DD sats), this
is control-plane math, not a device kernel.
"""

from __future__ import annotations

import numpy as np


def _ltdl(Q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Q = L^T diag(D) L with L unit lower-triangular (rtklib LD())."""
    n = Q.shape[0]
    A = Q.copy().astype(np.float64)
    L = np.zeros((n, n))
    D = np.zeros(n)
    for i in range(n - 1, -1, -1):
        D[i] = A[i, i]
        if D[i] <= 0.0:
            raise np.linalg.LinAlgError("LAMBDA: Q not positive definite")
        L[i, : i + 1] = A[i, : i + 1] / np.sqrt(D[i])
        for j in range(i):
            A[j, : j + 1] -= L[i, : j + 1] * L[i, j]
        L[i, : i + 1] /= L[i, i]
    return L, D


def _reduction(L: np.ndarray, D: np.ndarray):
    """Lambda decorrelation (rtklib reduction()): integer Gauss
    transformations + symmetric permutations. Returns (L, D, Z)."""
    n = L.shape[0]
    L = L.copy()
    D = D.copy()
    Z = np.eye(n)
    j = n - 2
    k = n - 2
    while j >= 0:
        if j <= k:
            for i in range(j + 1, n):
                # integer Gauss transformation on column j
                mu = round(L[i, j])
                if mu != 0:
                    L[i:, j] -= mu * L[i:, i]
                    Z[:, j] -= mu * Z[:, i]
        delta = D[j] + L[j + 1, j] ** 2 * D[j + 1]
        if delta + 1e-6 < D[j + 1]:
            eta = D[j] / delta
            lam = D[j + 1] * L[j + 1, j] / delta
            D[j] = eta * D[j + 1]
            D[j + 1] = delta
            for kk in range(j):
                a0 = L[j, kk]
                a1 = L[j + 1, kk]
                L[j, kk] = -L[j + 1, j] * a0 + a1
                L[j + 1, kk] = eta * a0 + lam * a1
            L[j + 1, j] = lam
            # swap rows below, columns of Z
            L[j + 2:, [j, j + 1]] = L[j + 2:, [j + 1, j]]
            Z[:, [j, j + 1]] = Z[:, [j + 1, j]]
            k = j
            j = n - 2
        else:
            j -= 1
    return L, D, Z


def _search(L: np.ndarray, D: np.ndarray, zs: np.ndarray, m: int = 2):
    """Depth-first integer search (rtklib search()): the m best integer
    vectors of ||z - zs||^2 in the metric L^T D^-1 L... returns
    (candidates [m, n], squared norms [m])."""
    n = L.shape[0]
    maxcand = m
    S = np.zeros((n, n))
    dist = np.zeros(n)
    zb = np.zeros(n)
    z = np.zeros(n)
    step = np.zeros(n)
    cands = []
    maxdist = 1e18
    k = n - 1
    zb[k] = zs[k]
    z[k] = round(zb[k])
    y = zb[k] - z[k]
    step[k] = np.sign(y) or 1.0
    iters = 0
    while iters < 10000:
        iters += 1
        newdist = dist[k] + y * y / D[k]
        if newdist < maxdist:
            if k != 0:
                k -= 1
                dist[k] = newdist
                S[k, : k + 1] = (
                    S[k + 1, : k + 1]
                    + (z[k + 1] - zb[k + 1]) * L[k + 1, : k + 1]
                )
                zb[k] = zs[k] + S[k, k]
                z[k] = round(zb[k])
                y = zb[k] - z[k]
                step[k] = np.sign(y) or 1.0
            else:
                if len(cands) < maxcand:
                    cands.append((newdist, z.copy()))
                    cands.sort(key=lambda c: c[0])
                else:
                    if newdist < cands[-1][0]:
                        cands[-1] = (newdist, z.copy())
                        cands.sort(key=lambda c: c[0])
                    maxdist = cands[-1][0]
                z[0] += step[0]
                y = zb[0] - z[0]
                step[0] = -step[0] - np.sign(step[0])
        else:
            if k == n - 1:
                break
            k += 1
            z[k] += step[k]
            y = zb[k] - z[k]
            step[k] = -step[k] - np.sign(step[k])
    if not cands:
        return None, None
    norms = np.array([c[0] for c in cands])
    vecs = np.stack([c[1] for c in cands])
    return vecs, norms


def lambda_fix(a_float: np.ndarray, Q: np.ndarray,
               ratio_threshold: float = 3.0):
    """Resolve float ambiguities to integers.

    Returns (a_fixed [n] int array or None, ratio). Fix is accepted when
    the second-best candidate's residual exceeds ratio_threshold x the
    best (rtklib's ratio test)."""
    n = len(a_float)
    if n == 0:
        return None, 0.0
    try:
        L, D = _ltdl(Q)
    except np.linalg.LinAlgError:
        return None, 0.0
    L, D, Z = _reduction(L, D)
    # transform float solution: z = Z^T a  (rtklib z=Z'*a)
    zs = Z.T @ a_float
    vecs, norms = _search(L, D, zs, m=2)
    if vecs is None or len(norms) < 2:
        return None, 0.0
    ratio = float(norms[1] / max(norms[0], 1e-12))
    if ratio < ratio_threshold:
        return None, ratio
    # back-transform: a = Z^-T z
    a_fix = np.linalg.solve(Z.T, vecs[0])
    return np.round(a_fix).astype(int), ratio
