"""Lattice security estimation for the shipped CKKS chains.

Replaces the round-4 folklore rule (``128-bit needs logQP <~ N/36.2``)
with an explicit primal-uSVP estimate in the usual core-SVP cost model —
the same methodology the lattice-estimator's ``usvp`` entry implements
(Alkim-Ducas-Poppelmann-Schwabe '16 success condition under the geometric
series assumption; classical core-SVP cost 2^(0.292 beta), quantum
2^(0.265 beta)).  The reference defers to the HE standard table with a
stated sparse-secret caveat (reference: test_full_scheme.hpp:389,
2025-991.pdf section 6); here the estimate is computed for the actual
chain modulus and the actual secret distribution.

Model
-----
RLWE at ring dimension N, modulus Q (for key-recovery the relevant
modulus is Q*P: switching keys are published mod QP), error sigma = 3.2,
secret ternary with Hamming weight h (or uniform ternary, h ~ 2N/3).

Primal attack: embed m LWE samples into the Bai-Galbraith/Kannan lattice
of dimension d = m + N + 1 and run BKZ-beta.  With the secret rescaled by
nu = sigma / sqrt(h/N) (balancing secret and error norms) the lattice
volume is (Q^m * nu^N)^(1/d) and uSVP succeeds when

    sigma * sqrt(beta)  <=  delta^(2*beta - d - 1) * (Q^m nu^N)^(1/d),

    delta(beta) = ((pi*beta)^(1/beta) * beta / (2*pi*e))^(1/(2*(beta-1))).

We minimise beta over the number of samples m in [1, N] and report
0.292 * beta_min (classical sieving exponent).  This tracks the
lattice-estimator's usvp figure to within a few bits for the HE-standard
anchor points (see tests/test_security.py) — adequate for the honest
"which ballpark" question; it deliberately ignores hybrid/dual attacks,
which for these shapes (large h, huge Q) are within a few bits of primal.

Sparse caveat: very small h (< ~64 at these dimensions) would admit
combinatorial hybrid attacks this model does not cover; the shipped
chains use h in {64 (tests), 192 (production)} at N >= 2^15 where the
hybrid advantage over the rescaled-primal estimate is small.
"""

from __future__ import annotations

import math


def _delta(beta: float) -> float:
    """BKZ root-Hermite factor (GSA)."""
    return ((math.pi * beta) ** (1.0 / beta) * beta / (2 * math.pi * math.e)
            ) ** (1.0 / (2.0 * (beta - 1.0)))


def _primal_beta_for_m(n: int, log2_q: float, sigma: float, nu: float,
                       m: int) -> float | None:
    """Smallest BKZ blocksize succeeding with m samples (binary search)."""
    d = m + n + 1
    log_vol = (m * log2_q + n * math.log2(max(nu, 2.0 ** -40))) / d

    def ok(beta: float) -> bool:
        if beta >= d:
            return True
        lhs = math.log2(sigma) + 0.5 * math.log2(beta)
        rhs = (2 * beta - d - 1) * math.log2(_delta(beta)) + log_vol
        return lhs <= rhs

    lo, hi = 50.0, float(d)
    if not ok(hi):
        return None
    while hi - lo > 1.0:
        mid = 0.5 * (lo + hi)
        if ok(mid):
            hi = mid
        else:
            lo = mid
    return hi


def primal_usvp_beta(n: int, log2_q: float, sigma: float = 3.2,
                     hamming_weight: int | None = None) -> float:
    """Minimal successful blocksize over the sample count m (golden-section
    style coarse scan + local refine; the beta(m) curve is unimodal)."""
    if hamming_weight:
        nu = sigma / math.sqrt(hamming_weight / n)
    else:
        nu = sigma / math.sqrt(2.0 / 3.0)        # uniform ternary
    best = float("inf")
    # coarse scan (beta(m) is smooth; 64 points then refine around argmin)
    coarse = [max(1, (i * n) // 64) for i in range(1, 65)]
    vals = {}
    for m in coarse:
        b = _primal_beta_for_m(n, log2_q, sigma, nu, m)
        if b is not None:
            vals[m] = b
            best = min(best, b)
    if not vals:
        return float("inf")
    m0 = min(vals, key=vals.get)
    step = max(1, n // 64)
    for m in range(max(1, m0 - step), min(n, m0 + step) + 1,
                   max(1, step // 16)):
        b = _primal_beta_for_m(n, log2_q, sigma, nu, m)
        if b is not None:
            best = min(best, b)
    return best


def security_bits(n: int, log2_qp: float, sigma: float = 3.2,
                  hamming_weight: int | None = None,
                  quantum: bool = False) -> float:
    """Core-SVP security exponent of the primal uSVP attack."""
    beta = primal_usvp_beta(n, log2_qp, sigma, hamming_weight)
    if beta == float("inf"):
        return float("inf")
    return (0.265 if quantum else 0.292) * beta


def context_security_bits(ctx, quantum: bool = False) -> float:
    """Security of a built Context: N, full key modulus QP, the configured
    secret distribution."""
    log2_qp = sum(math.log2(p) for p in ctx.all_primes)
    h = ctx.cfg.hamming_weight or None
    return security_bits(ctx.cfg.N, log2_qp, ctx.cfg.noise_std, h,
                         quantum=quantum)
