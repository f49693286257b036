"""Chebyshev-basis ciphertext polynomial evaluation.

Port of the evaluators of ``moai_tpu/boot/evalmod.py``: ``cheb_eval``
(doubling ladder), ``cheb_eval_bsgs`` (baby-step/giant-step quotient and
remainder recursion) and their host helpers, the numpy cosine fit, and
``ModReducer``, the bootstrap's homomorphic t -> sin(2*pi*t).  The JAX
version serializes the BSGS subtrees with ``mod_arith.seq`` to bound XLA's
schedule; eager PyTorch runs them in program order, so the port has no
counterpart.
"""

from __future__ import annotations

import numpy as np

from ..ciphertext import Ciphertext
from ..evaluator import Evaluator


def fit_cos_multi_interval(K: int, eps: float, degree: int,
                           double_angles: int, n_grid_per: int = 64,
                           lawson_iters: int = 12):
    """Fit P(x), x in [-1,1], to cos(2*pi*scale*x) over the union of
    intervals mapped from t in [i - eps, i + eps], |i| <= K, where
    s = (t - 0.25)/2^double_angles and x = s / x_max, x_max =
    (K + 0.5)/2^double_angles.  Returns (cheb_coeffs, x_max)."""
    da = 1 << double_angles
    x_max = (K + 0.5) / da
    xs = []
    for i in range(-K, K + 1):
        t = np.linspace(i - eps, i + eps, n_grid_per)
        xs.append((t - 0.25) / da / x_max)
    xs = np.concatenate(xs)
    target = np.cos(2 * np.pi * (x_max * xs))
    w = np.ones_like(xs)
    V = np.polynomial.chebyshev.chebvander(xs, degree)
    coef = None
    for _ in range(lawson_iters):
        sw = np.sqrt(w)
        coef, *_ = np.linalg.lstsq(V * sw[:, None], target * sw, rcond=None)
        err = np.abs(V @ coef - target)
        w = w * (1e-12 + err)
        w /= w.sum()
    return coef, x_max


def _cheb_T(ev: Evaluator, T: dict, k: int) -> Ciphertext:
    """T_k from the memo T = {1: x, ...} by the doubling recurrence
    T_2j = 2 T_j^2 - 1, T_2j+1 = 2 T_j T_j+1 - T_1.  (Module functions with
    explicit state, not recursive closures: a closure that calls itself is
    a reference cycle, which would hold every T_k on the card until the
    garbage collector ran.)"""
    if k in T:
        return T[k]
    j = k // 2
    if k % 2 == 0:
        out = ev.add_const(ev.mul_int(ev.square_rescale(_cheb_T(ev, T, j)), 2),
                           -1.0)
    else:
        a, b = _cheb_T(ev, T, j), _cheb_T(ev, T, j + 1)
        ab = ev.mul_int(ev.mul_relin_rescale(a, b), 2)
        t1 = ev.match_scale(T[1], ab.scale)   # exact-scale T_1 copy
        out = ev.sub(*ev.align(ab, t1))
    T[k] = out
    return out


def _sum_terms(ev: Evaluator, terms: list[Ciphertext]) -> Ciphertext:
    """Level-aligned sum of ciphertexts at one scale."""
    n_min = min(t.n_q for t in terms)
    acc = None
    for t in terms:
        t = ev.mod_drop_to(t, n_min)
        acc = t if acc is None else ev.add(acc, t)
    return acc


def cheb_eval(ev: Evaluator, x: Ciphertext, coeffs: np.ndarray
              ) -> Ciphertext:
    """sum_k coeffs[k] T_k(x) for x in [-1, 1] (ciphertext): T_k by the
    doubling recurrence (depth ceil(log2 deg)+1), every term landed at
    x.scale exactly, then a level-aligned sum."""
    coeffs = np.asarray(coeffs, np.float64)
    T = {1: x}
    terms = [ev.rescale_pair(ev.mul_const_to(_cheb_T(ev, T, k), coeffs[k],
                                             x.scale))
             for k in range(1, len(coeffs)) if abs(coeffs[k]) >= 1e-15]
    return ev.add_const(_sum_terms(ev, terms), float(coeffs[0]))


def _cheb_divmod(c, s):
    """Chebyshev-basis division p = q*T_s + r with deg r < s, using
    T_k = 2*T_s*T_{k-s} - T_{|k-2s|} (k > s) and T_s*T_0 = T_s."""
    c = [float(v) for v in c]
    d = len(c) - 1
    if d < s:
        return [0.0], c
    q = [0.0] * (d - s + 1)
    for k in range(d, s - 1, -1):
        a = c[k]
        if a == 0.0:
            continue
        c[k] = 0.0
        if k == s:
            q[0] += a
        else:
            q[k - s] += 2.0 * a
            c[abs(k - 2 * s)] -= a
    return q, c[:s]


def _trim(c):
    d = len(c) - 1
    while d > 0 and c[d] == 0.0:
        d -= 1
    return c[:d + 1]


def _giant(g: int, d: int) -> int:
    """The largest giant step g*2^i <= d."""
    s = g
    while (s << 1) <= d:
        s <<= 1
    return s


def _bsgs_nq(T: dict, g: int, c) -> int:
    """The result level of _bsgs_rec(c), without emitting ops."""
    c = _trim(c)
    d = len(c) - 1
    if d == 0:
        return T[1].n_q - 2                # constant path: one rescale
    if d <= g:
        return min(T[k].n_q for k in range(1, d + 1) if c[k] != 0.0) - 2
    s = _giant(g, d)
    qc, rc = _cheb_divmod(c, s)
    prod = min(_bsgs_nq(T, g, qc), T[s].n_q) - 2
    rc = _trim(rc)
    return min(prod, _bsgs_nq(T, g, rc)) if rc != [0.0] else prod


def _bsgs_rec(ev: Evaluator, T: dict, g: int, c, target: float
              ) -> Ciphertext:
    """sum_k c[k] T_k at exactly ``target`` scale: leaves land their
    coefficient multiplies at ``target``; above g, quotient * T_s + rest,
    the quotient landed so that the product rescales to ``target``."""
    c = _trim(c)
    d = len(c) - 1
    if d == 0:
        # constant polynomial: const * (a real ct at x's level)
        z = ev.rescale_pair(ev.mul_const_to(T[1], 0.0, target))
        return ev.add_const(z, c[0])
    if d <= g:
        terms = [ev.rescale_pair(ev.mul_const_to(T[k], c[k], target))
                 for k in range(1, d + 1) if c[k] != 0.0]
        return ev.add_const(_sum_terms(ev, terms), c[0])
    s = _giant(g, d)
    qc, rc = _cheb_divmod(c, s)
    Ts = T[s]
    pair_p = ev.level_pair_scale(min(_bsgs_nq(T, g, qc), Ts.n_q))
    qv = _bsgs_rec(ev, T, g, qc, target * pair_p / Ts.scale)
    prod = ev.mul_relin_rescale(qv, Ts)      # scale == target exactly
    rc = _trim(rc)
    if rc == [0.0]:
        return prod
    return ev.add(*ev.align(prod, _bsgs_rec(ev, T, g, rc, target)))


def cheb_eval_bsgs(ev: Evaluator, x: Ciphertext, coeffs: np.ndarray
                   ) -> Ciphertext:
    """Baby-step/giant-step Chebyshev evaluation: ~2*sqrt(deg) ct-ct
    multiplies instead of ~deg, same multiplicative depth.

    Exact-scale discipline: every leaf coefficient multiply lands at a
    computed target so each quotient*T_s product rescales exactly to its
    parent's target scale."""
    coeffs = _trim(list(np.asarray(coeffs, np.float64)))
    deg = len(coeffs) - 1
    if deg < 4:
        return cheb_eval(ev, x, coeffs)
    g = 1 << max(1, (deg + 1).bit_length() // 2)
    # babies T_1..T_g and giants T_{2g}, ..., T_{g*2^(m-1)} (g*2^m > deg)
    T = {1: x}
    for k in range(2, g + 1):
        _cheb_T(ev, T, k)
    s = g
    while (s << 1) <= deg:
        s <<= 1
        _cheb_T(ev, T, s)
    return _bsgs_rec(ev, T, g, coeffs, x.scale)


class ModReducer:
    """Homomorphic t -> sin(2*pi*t) for t = m*Delta/q0 + I, |I| <= K.

    The deg-1 arcsin step and the /(2*pi) are folded into downstream
    scale bookkeeping by the Bootstrapper."""

    def __init__(self, K: int = 25, eps: float = 2.0 ** -7,
                 degree: int = 59, double_angles: int = 2,
                 arcsin_deg: int = 1):
        """``arcsin_deg``: 1 folds the linear arcsin term into downstream
        scaling; 3 adds the homomorphic cubic correction y + y^3/6 (+2
        levels), cutting the residual from O(y^3) to O(y^5) — needed when
        |m| >> 1 widens the physical EvalMod interval."""
        if arcsin_deg not in (1, 3):
            raise ValueError(f"arcsin_deg must be 1 or 3, not {arcsin_deg}")
        self.K, self.eps = K, eps
        self.degree, self.double_angles = degree, double_angles
        self.arcsin_deg = arcsin_deg
        self.coef, self.x_max = fit_cos_multi_interval(
            K, eps, degree, double_angles)

    @property
    def levels(self) -> int:
        """Composite levels consumed (input prescale + ladder + coeff
        mult + double angles + optional cubic arcsin)."""
        deg = self.degree
        ladder = (deg.bit_length() - 1) + 1
        return 1 + ladder + 1 + self.double_angles + \
            (2 if self.arcsin_deg >= 3 else 0)

    def centre_error(self) -> np.ndarray:
        """The fit's error at the integer centres t = I, |I| <= K, through
        the double angles (float64): what EvalMod adds to a coefficient
        whose message is 0, before the optional cubic arcsin."""
        da = 1 << self.double_angles
        x = (np.arange(-self.K, self.K + 1) - 0.25) / (da * self.x_max)
        c = np.polynomial.chebyshev.chebval(x, self.coef)
        for _ in range(self.double_angles):
            c = 2 * c * c - 1
        return c

    def __call__(self, ev: Evaluator, t: Ciphertext,
                 pre_scale: float = 1.0,
                 work_scale: float | None = None) -> Ciphertext:
        """t (slots hold m*Delta/q0 + I, possibly pre-divided by
        ``pre_scale``): returns ct whose slots are sin(2*pi*t) at the
        working scale.  ``pre_scale`` multiplies the input first (used to
        fold the 1/2 of the real/imag split in for free).

        ``work_scale`` is the scale the Chebyshev ladder lands at.  It
        MUST match the pair product of the levels the ladder actually
        consumes: on a mixed chain (26-bit data pairs + 29-bit boot
        pairs, flagship_config) every rescale inside the bootstrap region
        divides by a ~2^58 boot pair, so landing at ctx.scale (the 2^52
        DATA pair product) shrinks the true scale by the ratio at every
        squaring until the message sinks below the rescale rounding floor
        while the tracked metadata stays "exact" (the JAX package records
        it as an error of 1.7e35 at N=2^16).  Defaults to the pair product
        at the input's level."""
        da = 1 << self.double_angles
        if work_scale is None:
            work_scale = ev.level_pair_scale(t.n_q)
        # x = (t - 0.25)/(da * x_max): one const mult + const add.  The
        # multiply also drops the ciphertext from its reinterpreted scale
        # (~q0) to the working scale, keeping the ladder's squares
        # scale-stable.
        a = pre_scale / (da * self.x_max)
        x = ev.rescale_pair(ev.mul_const_to(t, a, work_scale))
        x = ev.add_const(x, -0.25 / (da * self.x_max))
        c = cheb_eval_bsgs(ev, x, self.coef)
        del x
        for _ in range(self.double_angles):
            c = ev.add_const(ev.mul_int(ev.square_rescale(c), 2), -1.0)
        if self.arcsin_deg >= 3:
            # arcsin(y) ~= y + y^3/6: evaluate y^2 and y/6 in parallel
            # (both one level), multiply, add — 2 levels total.  c6's
            # landing scale is chosen so y2*c6 rescales EXACTLY to c.scale.
            y2 = ev.square_rescale(c)
            pair2 = ev.level_pair_scale(y2.n_q)
            c6 = ev.rescale_pair(ev.mul_const_to(
                c, 1.0 / 6.0, c.scale * pair2 / y2.scale))
            y3 = ev.mul_relin_rescale(y2, c6)
            c = ev.add(*ev.align(c, y3))
        return c
