# Copied from gnss_sdr_tpu/telemetry/reed_solomon.py; only the package imports are rewritten.
"""Reed-Solomon codec over GF(2^8) for Galileo CED (and HAS pages).

Reference analog: src/core/system_parameters/reed_solomon.cc — RS(255,
255-nroots) with configurable primitive polynomial, first consecutive
root, primitive element and shortening. Galileo E1B reduced-CED outer
code uses nroots=223 (k=32: any 32 clean symbols out of 255 recover the
CED); Galileo HAS uses RS(255, 223) (nroots=32).

Implementation: classic BCH-view polynomial codec — systematic encoding
by polynomial division; decoding by syndromes + Berlekamp-Massey + Chien
search + Forney. Corrects up to nroots/2 symbol errors (the reference's
decoder has the same bound; erasure-aided decoding is future work)."""

from __future__ import annotations

import numpy as np


class GF256:
    """GF(2^8) tables for a given primitive polynomial (low 8 bits)."""

    def __init__(self, min_poly: int = 29) -> None:
        poly = 0x100 | min_poly                   # + x^8
        self.exp = np.zeros(512, dtype=np.int64)
        self.log = np.zeros(256, dtype=np.int64)
        x = 1
        for i in range(255):
            self.exp[i] = x
            self.log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= poly
        self.exp[255:510] = self.exp[:255]

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.exp[self.log[a] + self.log[b]])

    def div(self, a: int, b: int) -> int:
        if a == 0:
            return 0
        return int(self.exp[(self.log[a] - self.log[b]) % 255])

    def pow_alpha(self, n: int) -> int:
        """alpha^n."""
        return int(self.exp[n % 255])

    def inv(self, a: int) -> int:
        return int(self.exp[(255 - self.log[a]) % 255])

    def poly_mul(self, p: list[int], q: list[int]) -> list[int]:
        """Little-endian polynomial product (index = power)."""
        out = [0] * (len(p) + len(q) - 1)
        for i, a in enumerate(p):
            if a:
                for j, b in enumerate(q):
                    out[i + j] ^= self.mul(a, b)
        return out

    def poly_eval(self, p: list[int], x: int) -> int:
        """Evaluate little-endian p at x (Horner from the top power)."""
        y = 0
        for c in reversed(p):
            y = self.mul(y, x) ^ c
        return y


class ReedSolomon:
    """RS(255 - shortening, 255 - nroots - shortening) codec.

    Defaults are the Galileo CED parameters
    (reed_solomon.cc:24-36: nroots=223, min_poly=29, prim=1, fcr=1)."""

    def __init__(self, nroots: int = 223, min_poly: int = 29,
                 prim: int = 1, fcr: int = 1, shortening: int = 0) -> None:
        if prim != 1:
            raise NotImplementedError("prim != 1 not needed by Galileo")
        self.gf = GF256(min_poly)
        self.nroots = nroots
        self.fcr = fcr
        self.shortening = shortening
        self.n = 255 - shortening
        self.k = 255 - nroots - shortening
        # generator g(x) = prod_{i=0}^{nroots-1} (x - a^{fcr+i}),
        # little-endian
        g = [1]
        for i in range(nroots):
            g = self.gf.poly_mul(g, [self.gf.pow_alpha(fcr + i), 1])
        self.genpoly = g

    # ---------------------------------------------------------------- encode
    def encode(self, info: np.ndarray) -> np.ndarray:
        """Systematic codeword [n]: info symbols (first = highest power)
        then parity."""
        info = np.asarray(info, dtype=np.int64)
        if len(info) != self.k:
            raise ValueError(f"need {self.k} info symbols")
        gf = self.gf
        # divide info(x) * x^nroots by g(x); remainder = parity
        rem = [0] * self.nroots                    # big-endian scratch
        g_be = self.genpoly[::-1]                  # [1, g_{nr-1}, ...]
        for s in info:
            feedback = int(s) ^ rem[0]
            rem = rem[1:] + [0]
            if feedback:
                for j in range(self.nroots):
                    rem[j] ^= gf.mul(feedback, g_be[j + 1])
        return np.concatenate([info, np.asarray(rem, dtype=np.int64)])

    def _syndromes(self, r_be: list[int]) -> list[int]:
        gf = self.gf
        # received poly big-endian; virtual pad symbols (shortening) are 0
        return [
            gf.poly_eval(r_be[::-1], gf.pow_alpha(self.fcr + i))
            for i in range(self.nroots)
        ]

    # ---------------------------------------------------------------- decode
    def decode(self, received: np.ndarray, erasure_pos=None):
        """Returns (info, n_corrected) or (None, -1) on failure.

        ``erasure_pos``: known-bad symbol indices into ``received``
        (big-endian, 0 = highest power). With e erasures and nu errors
        the decoder succeeds when 2*nu + e <= nroots (the reference's
        decode_rs_8 erasure interface, reed_solomon.cc:773). The Galileo
        INAV FEC2 CED path uses pure-erasure decoding: any 4 of the 8
        CED/parity pages (58 info + 60 parity octets) recover the block.
        """
        gf = self.gf
        r = list(np.asarray(received, dtype=np.int64))
        if len(r) != self.n:
            raise ValueError(f"need {self.n} symbols")
        erasures = sorted(set(int(p) for p in (erasure_pos or [])))
        if len(erasures) > self.nroots:
            return None, -1
        synd = self._syndromes(r)
        if not any(synd):
            return np.asarray(r[: self.k]), 0

        # Erasure locator Gamma(z) = prod (1 - X_i z), X_i = a^{power_i}
        gamma = [1]
        for j in erasures:
            power = self.n - 1 - j
            gamma = gf.poly_mul(gamma, [1, gf.pow_alpha(power)])
        e = len(erasures)

        # Modified syndromes Xi = S * Gamma mod z^nroots; standard BM on
        # Xi[e:] finds the ERROR locator Lambda (Forney-Massey method)
        xi_full = gf.poly_mul(synd, gamma)
        xi = (xi_full + [0] * self.nroots)[: self.nroots]
        seq = xi[e:]
        lam = [1]
        b = [1]
        L = 0
        for n_it in range(len(seq)):
            delta = seq[n_it]
            for i in range(1, L + 1):
                if i < len(lam):
                    delta ^= gf.mul(lam[i], seq[n_it - i])
            b = [0] + b
            if delta:
                if 2 * L <= n_it:
                    lam, old = (
                        _padd(lam, [gf.mul(c, delta) for c in b]), lam)
                    b = [gf.div(c, delta) for c in old]
                    L = n_it + 1 - L
                else:
                    lam = _padd(lam, [gf.mul(c, delta) for c in b])
        nerr = len(lam) - 1
        if 2 * nerr + e > self.nroots:
            return None, -1

        # total locator covers erasures + errors
        loc = gf.poly_mul(gamma, lam)
        n_roots_expected = len(loc) - 1
        if n_roots_expected == 0:
            return None, -1

        # Chien search over list positions
        err_idx = []
        for j in range(self.n):
            power = self.n - 1 - j                 # power of x for r[j]
            xl = gf.pow_alpha(power)
            if gf.poly_eval(loc, gf.inv(xl)) == 0:
                err_idx.append(j)
        if len(err_idx) != n_roots_expected:
            return None, -1

        # Forney: Omega(z) = S(z) Loc(z) mod z^nroots
        omega_full = gf.poly_mul(synd, loc)
        omega = omega_full[: self.nroots]
        loc_deriv = [loc[i] if i % 2 == 1 else 0
                     for i in range(1, len(loc))]
        for j in err_idx:
            power = self.n - 1 - j
            xl = gf.pow_alpha(power)
            xinv = gf.inv(xl)
            num = gf.poly_eval(omega, xinv)
            den = gf.poly_eval(loc_deriv, xinv)
            if den == 0:
                return None, -1
            # magnitude = X_l^{1-fcr} * Omega(X^-1)/Loc'(X^-1)
            mag = gf.mul(gf.pow_alpha(power * (1 - self.fcr)),
                         gf.div(num, den))
            r[j] ^= mag

        if any(self._syndromes(r)):
            return None, -1
        return np.asarray(r[: self.k]), len(err_idx)


def _padd(p: list[int], q: list[int]) -> list[int]:
    n = max(len(p), len(q))
    p = p + [0] * (n - len(p))
    q = q + [0] * (n - len(q))
    return [a ^ b for a, b in zip(p, q)]
