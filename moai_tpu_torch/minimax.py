"""Minimax approximation toolbox: multi-interval Remez exchange + sign
composition.

A copy of ``moai_tpu/minimax.py`` (numpy only): the port imports nothing
of the JAX package; tests/test_torch_minimax.py holds every function equal
to the original.

TPU-native counterpart of the reference's NTL-based minimax stack
(reference: include/source/bootstrapping/common/Remez.{h,cpp} — the
exchange solver over the interval union [i-2^-loge, i+2^-loge];
common/MinicompFunc.* / PolyUpdate.* / RemezApp.* — the "minicomp"
optimal sign-composition machinery used by the piecewise GELU,
gelu.hpp:109-147).  Differences:

- The exchange runs as a *discrete* Remez on a dense Chebyshev-distributed
  grid in numpy float64 (the reference uses 1000-bit NTL RR;
  RemezParam.h:13).  Float64 equioscillation to ~1e-14 is far below the
  CKKS noise floor (~2^-40 of the message), so extended precision buys
  nothing at these degrees; for very high degrees the basis is Chebyshev
  so the solve stays well-conditioned.
- Sign composition uses the standard widen/sharpen two-phase composite
  (the same family minicomp searches over), with per-stage degrees given
  by the caller instead of a subset-sum search.
"""

from __future__ import annotations

import numpy as np


def _cheb_grid(intervals, n_per: int) -> np.ndarray:
    pts = []
    for lo, hi in intervals:
        k = np.arange(n_per)
        x = np.cos(np.pi * (k + 0.5) / n_per)
        pts.append((lo + hi) / 2 + (hi - lo) / 2 * x)
    return np.unique(np.concatenate(pts))


def remez_fit(f, intervals, degree: int, parity: str | None = None,
              n_grid_per: int = 2048, max_iters: int = 60,
              tol: float = 1e-13):
    """Discrete multi-interval Remez exchange.

    f: vectorized target; intervals: list of (lo, hi); parity: None /
    'odd' / 'even' restricts the Chebyshev basis.  Returns (coeffs over
    full Chebyshev basis T_0..T_degree with zeros at excluded parities,
    max_err).  Domain must lie inside [-1, 1] for conditioning.
    """
    # parity symmetry: fit on the non-negative part of the domain only
    # (error of a parity-restricted fit to a same-parity target is
    # symmetric, and keeping both sides makes the exchange system
    # singular — the reference's Remez solves the full union in RR).
    if parity in ("odd", "even"):
        pos = [(max(lo, 0.0), hi) for lo, hi in intervals if hi > 0]
        neg = [(-hi, -max(lo, 0.0)) for lo, hi in intervals if hi > 0]
        assert pos, "parity fit needs a positive-side domain"
        if all(any(abs(a - c) < 1e-15 and abs(b - d) < 1e-15
                   for c, d in neg) for a, b in
               [(lo, hi) for lo, hi in intervals if lo < 0]):
            intervals = pos
    xs = _cheb_grid(intervals, n_grid_per)
    fx = f(xs)
    ks = np.arange(degree + 1)
    if parity == "odd":
        ks = ks[ks % 2 == 1]
    elif parity == "even":
        ks = ks[ks % 2 == 0]
    m = len(ks)
    V = np.cos(np.outer(np.arccos(np.clip(xs, -1, 1)), ks))

    def compress_alternating(idx, sgn, mag):
        picked = []
        for i in idx:
            if sgn[i] == 0:
                continue
            if picked and sgn[i] == sgn[picked[-1]]:
                if mag[i] > mag[picked[-1]]:
                    picked[-1] = i
            else:
                picked.append(i)
        return picked

    # initial reference: m+1 points spread over the grid
    ref = np.unique(np.linspace(0, len(xs) - 1, m + 1).astype(int))
    best = None
    for _ in range(max_iters):
        A = np.empty((len(ref), m + 1))
        A[:, :m] = V[ref]
        A[:, m] = (-1.0) ** np.arange(len(ref))
        sol, *_ = np.linalg.lstsq(A, fx[ref], rcond=None)
        c, E = sol[:m], sol[m]
        err = V @ c - fx
        mag = np.abs(err)
        cur = float(mag.max())
        if best is None or cur < best[1]:
            best = (c.copy(), cur)
        sgn = np.sign(err)
        loc = np.unique([0] + list(
            np.where((mag[1:-1] >= mag[:-2]) &
                     (mag[1:-1] >= mag[2:]))[0] + 1) + [len(xs) - 1])
        picked = compress_alternating(loc, sgn, mag)
        while len(picked) > m + 1:
            a = np.array([mag[i] for i in picked])
            # drop the global-smallest extremum, then restore alternation
            j = int(np.argmin(a))
            picked.pop(j)
            picked = compress_alternating(picked, sgn, mag)
        if len(picked) < m + 1:
            break
        new_ref = np.array(picked)
        if cur - abs(E) < tol * max(1.0, cur) or np.array_equal(new_ref,
                                                                ref):
            break
        ref = new_ref
    c, max_err = best
    coeffs = np.zeros(degree + 1)
    coeffs[ks] = c
    return coeffs, max_err


def fit_sign_composite(tau: float, degrees: list[int],
                       margin: float = 0.0):
    """Composite odd minimax approximation of sgn(x) on [-1,-tau]∪[tau,1]
    (reference: the minicomp composition trees, PolyUpdate.h:29, used for
    the GELU's sign at gelu.hpp:109-147).

    Returns (list of Chebyshev coeff arrays to apply in order, final max
    deviation of the output from ±1 on the domain).  Stage i approximates
    sgn on ±[lo_i, 1] with an odd degree-degrees[i] poly; the image
    [1-e, 1+e] is renormalized into the next stage's domain.
    """
    polys = []
    lo = tau
    for deg in degrees:
        coef, err = remez_fit(np.sign, [(-1.0, -lo), (lo, 1.0)], deg,
                              parity="odd")
        hi_dev = err + margin
        scale = 1.0 / (1.0 + hi_dev)
        coef = coef * scale                     # image -> [lo', 1]
        polys.append(coef)
        lo = (1.0 - hi_dev) / (1.0 + hi_dev)
    return polys, 1.0 - lo


def choose_sign_composite(tau: float, target_dev: float,
                          max_stages: int = 5,
                          degree_menu=(3, 5, 7, 9, 13, 15, 21, 27, 31),
                          beam: int = 8):
    """Search the composition space for the cheapest odd-polynomial
    composite approximating sgn(x) on ±[tau, 1] to within ``target_dev``
    (the reference's minicomp Choosemax/PolyUpdate machinery,
    common/PolyUpdate.{h,cpp} — there a tree search over compositions;
    here a beam search with a memoized per-stage Remez oracle, which
    reaches the same (levels, mults)-optimal frontier for the degree menu
    the homomorphic evaluator actually supports).

    Cost model per stage of odd degree d evaluated Chebyshev-BSGS:
    levels = ceil(log2(d+1)) composite levels, mults ~ 2*sqrt(d).
    Objective: lexicographic (total levels, total mults).

    Returns (degrees, polys, achieved_dev) with ``polys`` as in
    :func:`fit_sign_composite`.
    """
    from math import ceil, log2, sqrt

    err_memo: dict[tuple[float, int], float] = {}

    def stage_err(lo: float, deg: int) -> float:
        key = (round(lo, 6), deg)
        if key not in err_memo:
            _, e = remez_fit(np.sign, [(-1.0, -lo), (lo, 1.0)], deg,
                             parity="odd")
            err_memo[key] = e
        return err_memo[key]

    def costs(deg: int):
        return ceil(log2(deg + 1)), 2.0 * sqrt(deg)

    # beam states: (levels, mults, lo, degrees)
    states = [(0, 0.0, tau, ())]
    best = None
    for _ in range(max_stages):
        nxt = []
        for lv, mu, lo, seq in states:
            for d in degree_menu:
                e = stage_err(lo, d)
                if e >= 1.0:
                    continue
                lo2 = (1.0 - e) / (1.0 + e)
                dl, dm = costs(d)
                st = (lv + dl, mu + dm, lo2, seq + (d,))
                if 1.0 - lo2 <= target_dev:
                    if best is None or (st[0], st[1]) < (best[0], best[1]):
                        best = st
                else:
                    nxt.append(st)
        if best is not None:
            # prune states already costlier than the found solution
            nxt = [s for s in nxt if (s[0], s[1]) < (best[0], best[1])]
        # beam: keep the highest-precision state per cost bucket
        nxt.sort(key=lambda s: (s[0], s[1], -s[2]))
        seen = set()
        pruned = []
        for s in nxt:
            if len(pruned) >= beam:
                break
            k = round(-np.log10(max(1e-300, 1.0 - s[2])), 1)
            if k in seen:
                continue
            seen.add(k)
            pruned.append(s)
        states = pruned
        if not states:
            break
    if best is None:
        raise ValueError(
            f"no composition of <= {max_stages} stages from {degree_menu} "
            f"reaches deviation {target_dev} from tau={tau}")
    degrees = list(best[3])
    polys, dev = fit_sign_composite(tau, degrees)
    return degrees, polys, dev


def eval_cheb_np(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    return np.polynomial.chebyshev.chebval(x, coeffs)


def fit_cos_remez(K: int, eps: float, degree: int, double_angles: int):
    """EvalMod cosine target via true Remez exchange (drop-in for
    boot.evalmod.fit_cos_multi_interval's Lawson fit; reference:
    RemezCos.h:13-17 — cos(2*pi*(t-0.25)/2^da) over the ±K interval
    union).  Returns (cheb_coeffs, x_max, max_err)."""
    da = 1 << double_angles
    x_max = (K + 0.5) / da
    ivs = []
    for i in range(-K, K + 1):
        lo = ((i - eps) - 0.25) / da / x_max
        hi = ((i + eps) - 0.25) / da / x_max
        ivs.append((lo, hi))
    f = lambda x: np.cos(2 * np.pi * x_max * x)
    coef, err = remez_fit(f, ivs, degree, n_grid_per=256)
    # the Lawson-iterated weighted-LS fit (evalmod) handles the 2K+1
    # near-point intervals better than the discrete exchange; keep the
    # better of the two on a common validation grid
    from .boot.evalmod import fit_cos_multi_interval
    coef2, _ = fit_cos_multi_interval(K, eps, degree, double_angles)
    xs = _cheb_grid(ivs, 64)
    err2 = float(np.abs(np.polynomial.chebyshev.chebval(xs, coef2)
                        - f(xs)).max())
    if err2 < err:
        return coef2, x_max, err2
    return coef, x_max, err
