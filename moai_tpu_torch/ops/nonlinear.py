"""Polynomial nonlinearities: exp, inverse, rsqrt, GELU, softmax, LayerNorm.

Port of ``moai_tpu/ops/nonlinear.py``: every function is a composition of
Evaluator primitives over batched ciphertexts, and every polynomial term is
driven to a common target scale with ``Evaluator.mul_const_to``.  The
approximation coefficients (rsqrt init, GELU, sign composites) are fit on
the host in numpy, as in the JAX package.  ``layernorm``'s ``col_chunk``
bounds what one column chunk holds; the JAX version's ``mod_arith.seq``
chunk sequencing has no counterpart in eager PyTorch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import mod_arith as ma
from ..boot.evalmod import _sum_terms, cheb_eval_bsgs
from ..ciphertext import Ciphertext, Plaintext
from ..encoder import Encoder
from ..encrypt import rounded_to_ntt
from ..evaluator import Evaluator, _sum_leading
from ..minimax import fit_sign_composite, remez_fit
from ..utils import debug


def exp_taylor_primes(r: int) -> int:
    """Primes consumed by :func:`exp_taylor` (1 const-mult + r squarings =
    r+1 composite levels)."""
    return 2 * (r + 1)


def exp_taylor(ev: Evaluator, x: Ciphertext, r: int = 7) -> Ciphertext:
    """exp(x) ~= (1 + x/2^r)^(2^r): 1 const-mult + r squarings.  Accurate
    for x <= 0 (softmax uses x - max)."""
    y = ev.rescale_pair(ev.mul_const_to(x, 1.0 / (1 << r), x.scale))
    y = ev.add_const(y, 1.0)
    for _ in range(r):
        y = ev.square_rescale(y)
    return y


def inverse_goldschmidt(ev: Evaluator, x: Ciphertext, iters: int = 16,
                        reland_every: int = 0) -> Ciphertext:
    """1/x for x in (0, 2): y = 1-x; 1/x = prod_{i=0..iters} (1 + y^(2^i)).
    iters+1 composite levels.  ``reland_every=k`` re-lands y and the
    running product at the input scale every k squarings (one extra level
    each), which bounds the composite-pair scale drift of long chains."""
    tgt = x.scale
    y = ev.add_const(ev.negate(x), 1.0)
    res = ev.add_const(y, 1.0)
    for i in range(iters):
        y = ev.square_rescale(y)
        if reland_every and (i + 1) % reland_every == 0 and i + 1 < iters:
            y = ev.match_scale(y, tgt)
            res = ev.match_scale(res, tgt)
        res = ev.mul_relin_rescale(res, ev.add_const(y, 1.0))
    return res


def fit_rsqrt_line(lo: float, hi: float) -> tuple[float, float]:
    """Host: near-minimax linear init a*x+b for 1/sqrt(x) on [lo, hi]."""
    xs = np.linspace(lo, hi, 4097)
    f = 1.0 / np.sqrt(xs)
    a, b = np.polyfit(xs, f, 1)
    # equioscillate: shift intercept to center the max error
    err = f - (a * xs + b)
    b += (err.max() + err.min()) / 2
    return float(a), float(b)


def fit_rsqrt_cheb(lo: float, hi: float, degree: int = 7,
                   lawson_iters: int = 60) -> np.ndarray:
    """Host: relative-minimax (Lawson-weighted) Chebyshev fit of 1/sqrt(u)
    on [lo, hi], coefficients in t = (2u - hi - lo)/(hi - lo).  Relative
    weighting keeps the init within (0, sqrt(3))x the true value over wide
    domains, where the linear init diverges under Newton (hi/lo > ~20)."""
    k = np.arange(8192)
    t = np.cos(np.pi * (k + 0.5) / len(k))
    u = (t + 1) / 2 * (hi - lo) + lo
    f = 1.0 / np.sqrt(u)
    V = np.polynomial.chebyshev.chebvander(t, degree)
    w = np.ones_like(u)
    c = None
    for _ in range(lawson_iters):
        sw = np.sqrt(w)
        c, *_ = np.linalg.lstsq(V * sw[:, None], f * sw, rcond=None)
        err = np.abs(V @ c - f) / f
        w = w * (1e-12 + err)
        w /= w.sum()
    return c


def _newton_rsqrt(ev: Evaluator, xh: Ciphertext, y: Ciphertext,
                  iters: int) -> Ciphertext:
    """Newton steps y <- y (1.5 + xh y^2) for 1/sqrt(x), xh = -x/2."""
    for _ in range(iters):
        y2 = ev.square_rescale(y)
        t = ev.add_const(ev.mul_relin_rescale(xh, y2), 1.5)
        y = ev.mul_relin_rescale(y, t)
    return y


def invert_sqrt_cheb(ev: Evaluator, x: Ciphertext,
                     domain: tuple[float, float], degree: int = 7,
                     newton_iters: int = 2) -> Ciphertext:
    """1/sqrt(x) on [lo, hi] via a degree-``degree`` relative-minimax
    Chebyshev init + Newton.  Levels: 1 (affine) + cheb depth +
    3*newton."""
    lo, hi = domain
    coeffs = fit_rsqrt_cheb(lo, hi, degree)
    s = x.scale
    t = ev.add_const(ev.rescale_pair(ev.mul_const_to(x, 2.0 / (hi - lo), s)),
                     -(hi + lo) / (hi - lo))
    y = cheb_eval_bsgs(ev, t, coeffs)
    if newton_iters:
        xh = ev.rescale_pair(ev.mul_const_to(x, -0.5, s))   # -x/2
        xh, y = ev.align(xh, y)
        y = _newton_rsqrt(ev, xh, y, newton_iters)
    return y


def invert_sqrt(ev: Evaluator, x: Ciphertext, domain: tuple[float, float],
                newton_iters: int = 4, gold_iters: int = 2) -> Ciphertext:
    """1/sqrt(x) on [lo, hi]: linear init + Newton y(1.5 - 0.5 x y^2) +
    Goldschmidt coupled refinement.

    Levels: 1 (init) + 1 (xh) + 3*newton + 1 (g) + 1 (h) + 2*gold.
    """
    a, b = fit_rsqrt_line(*domain)
    s = x.scale
    y = ev.add_const(ev.rescale_pair(ev.mul_const_to(x, a, s)), b)
    xh = ev.rescale_pair(ev.mul_const_to(x, -0.5, s))      # -x/2, reused
    y = _newton_rsqrt(ev, xh, y, newton_iters)
    if gold_iters:
        g = ev.mul_relin_rescale(x, y)                      # ~ sqrt(x)
        h = ev.rescale_pair(ev.mul_const_to(y, 0.5, s))     # ~ 1/(2 sqrt x)
        for _ in range(gold_iters):
            # g <- g*(1+r), h <- h*(1+r): pure products (adds of
            # differently-rescaled ciphertexts would meet composite-pair
            # scale drift)
            r1 = ev.add_const(ev.negate(ev.mul_relin_rescale(g, h)), 1.5)
            g = ev.mul_relin_rescale(g, r1)
            h = ev.mul_relin_rescale(h, r1)
        y = ev.mul_int(h, 2)
    return y


def _power(ev: Evaluator, pows: dict, k: int) -> Ciphertext:
    if k in pows:
        return pows[k]
    h = 1 << (k.bit_length() - 1)
    if h == k:
        out = ev.square_rescale(_power(ev, pows, k // 2))
    else:
        out = ev.mul_relin_rescale(_power(ev, pows, h),
                                   _power(ev, pows, k - h))
    pows[k] = out
    return out


def poly_eval(ev: Evaluator, x: Ciphertext, coeffs: np.ndarray) -> Ciphertext:
    """sum_k coeffs[k] * x^k with x in ~[-1, 1]: binary-power ladder, every
    term landed at one exact common scale, then summed level-aligned."""
    coeffs = np.asarray(coeffs, np.float64)
    pows: dict[int, Ciphertext] = {1: x}
    terms = [ev.rescale_pair(ev.mul_const_to(_power(ev, pows, k), coeffs[k],
                                             x.scale))
             for k in range(1, len(coeffs)) if coeffs[k] != 0.0]
    return ev.add_const(_sum_terms(ev, terms), float(coeffs[0]))


def fit_gelu_cheb(domain: float = 13.0, degree: int = 24,
                  lawson_iters: int = 30) -> np.ndarray:
    """Host: Lawson-iterated (near-minimax) Chebyshev fit of GELU on
    [-domain, domain]; coefficients in u = x/domain."""
    from scipy.special import erf
    k = np.arange(8192)
    xs = np.cos(np.pi * (k + 0.5) / len(k))
    g = 0.5 * (xs * domain) * (1.0 + erf(xs * domain / np.sqrt(2.0)))
    V = np.polynomial.chebyshev.chebvander(xs, degree)
    w = np.ones_like(xs)
    c = None
    for _ in range(lawson_iters):
        sw = np.sqrt(w)
        c, *_ = np.linalg.lstsq(V * sw[:, None], g * sw, rcond=None)
        err = np.abs(V @ c - g)
        w = w * (1e-12 + err)
        w /= w.sum()
    return c


def fit_gelu_coeffs(domain: float = 13.0, degree: int = 24) -> np.ndarray:
    """Host: the GELU fit as monomial coefficients in u = x/domain.  Prefer
    ``fit_gelu_cheb`` for the encrypted path: monomial coefficients of a
    degree-d Chebyshev fit grow ~2^d and amplify CKKS noise as much."""
    return np.polynomial.chebyshev.cheb2poly(fit_gelu_cheb(domain, degree))


def gelu(ev: Evaluator, x: Ciphertext, domain: float = 13.0,
         degree: int = 24) -> Ciphertext:
    """GELU(x) on [-domain, domain]: 1 (prescale) + ceil(log2 deg) + 1
    composite levels, a Chebyshev-basis BSGS evaluation."""
    u = ev.rescale_pair(ev.mul_const_to(x, 1.0 / domain, x.scale))
    return cheb_eval_bsgs(ev, u, fit_gelu_cheb(domain, degree))


def sign_composite(ev: Evaluator, x: Ciphertext, polys) -> Ciphertext:
    """sgn(x) for |x| in [tau, 1] via composed odd minimax polynomials
    (from ``minimax.fit_sign_composite``)."""
    for p in polys:
        x = cheb_eval_bsgs(ev, x, p)
    return x


def gelu_sign(ev: Evaluator, x: Ciphertext, breakpoint: float = 3.5,
              input_bound: float = 60.0, degrees=(9, 9, 9, 9),
              mid_degree: int = 12) -> Ciphertext:
    """Piecewise GELU via two homomorphic sign evaluations at +-breakpoint:

        gelu(x) ~= A(x)(sgn(x+b) - sgn(x-b))/2 + x(1 + sgn(x-b))/2

    with A a minimax fit of GELU on [-b, b]."""
    from scipy.special import erf
    polys, _ = fit_sign_composite(
        min(0.5 / input_bound, breakpoint / input_bound / 4), list(degrees))
    g = lambda u: 0.5 * (u * breakpoint) * (                # noqa: E731
        1.0 + erf(u * breakpoint / np.sqrt(2.0)))
    mid, _ = remez_fit(g, [(-1.0, 1.0)], mid_degree)
    b = breakpoint
    u = ev.rescale_pair(ev.mul_const_to(x, 1.0 / input_bound, x.scale))
    s0 = sign_composite(ev, ev.add_const(u, b / input_bound), polys)
    s1 = sign_composite(ev, ev.add_const(u, -b / input_bound), polys)
    # A evaluated in v = x/b
    v = ev.rescale_pair(ev.mul_const_to(x, 1.0 / b, x.scale))
    A = cheb_eval_bsgs(ev, v, mid)
    half_diff = ev.rescale_pair(ev.mul_const_to(
        ev.sub(*ev.align(s0, s1)), 0.5, ev.level_pair_scale(
            min(s0.n_q, s1.n_q))))
    half_hi = ev.add_const(ev.rescale_pair(ev.mul_const_to(
        s1, 0.5, ev.level_pair_scale(s1.n_q))), 0.5)
    t1 = ev.mul_relin_rescale(*ev.align(A, half_diff))
    t2 = ev.mul_relin_rescale(*ev.align(x, half_hi))
    t2 = ev.match_scale(t2, t1.scale)
    return ev.add(*ev.align(t1, t2))


def layernorm(ev: Evaluator, x: Ciphertext, gamma: np.ndarray,
              beta: np.ndarray, var_domain: tuple[float, float],
              newton_iters: int = 4, gold_iters: int = 2,
              col_chunk: int | None = None,
              rsqrt: str = "newton") -> Ciphertext:
    """Per-slot (= per token) LayerNorm over the leading column axis C:
        y_j = gamma_j * (x_j - mu)/sigma + beta_j.

    With d_j = C*x_j - sum(x) (no level: integer doubling + free column
    sum), S = sum_j d_j^2:  (x_j - mu)/sigma = sqrt(C) * d_j / sqrt(S).
    ``var_domain`` is the expected range of S, folded into the rsqrt init
    (``rsqrt="cheb"``: the Chebyshev init, for hi/lo past ~20).  One rsqrt
    is shared by all C columns.  ``col_chunk`` columns are processed at a
    time; the sums are exact modular sums, so the result does not depend
    on it.
    """
    C = x.data.shape[0]
    q = ev.dev["q"][:x.n_q].reshape(-1, 1)
    cc = col_chunk or C
    u = _sum_leading(x.data, q)                            # pass 1: sum x

    def d_cols(lo: int, hi: int, n_q: int) -> Ciphertext:
        """Columns [lo, hi) of C*x_j - u at n_q primes (no level)."""
        qn = q[:n_q]
        nx = ev.mul_int(x.with_data(x.data[lo:hi, :, :n_q]), C)
        return x.with_data(ma.sub_mod(nx.data, u[:, :n_q], qn))

    # pass 2: S = sum_j (C x_j - u)^2.  The 3-poly squares are summed over
    # the column axis before relinearizing, so the variance costs one key
    # switch
    S3 = None
    for lo in range(0, C, cc):
        s = _sum_leading(ev.square(d_cols(lo, min(lo + cc, C), x.n_q)).data,
                         q)
        S3 = s if S3 is None else ma.add_mod(S3, s, q)
    S = ev.rescale_pair(ev.relinearize(
        Ciphertext(S3, x.scale * x.scale, True)))
    lo_d, hi_d = var_domain
    c = 1.0 / hi_d                                         # S*c in (lo/hi, 1]
    Sn = ev.rescale_pair(ev.mul_const_to(S, c, S.scale))
    rs = invert_sqrt_cheb(ev, Sn, (lo_d / hi_d, 1.0),
                          newton_iters=newton_iters) if rsqrt == "cheb" \
        else invert_sqrt(ev, Sn, (lo_d / hi_d, 1.0), newton_iters,
                         gold_iters)
    # pass 3: y_j = d_j * rs * (gamma_j * sqrt(C) * sqrt(c)) + beta_j, with
    # d_j formed at rs's level (limbwise, so the same residues as forming
    # it at x's level and dropping primes)
    gscale = np.asarray(gamma, np.float64) * np.sqrt(C) * np.sqrt(c)
    beta = np.asarray(beta, np.float64)
    n = min(x.n_q, rs.n_q)
    rs = ev.mod_drop_to(rs, n)
    outs = []
    for lo in range(0, C, cc):
        hi = min(lo + cc, C)
        dn = d_cols(lo, hi, n)
        prod = ev.mul_relin_rescale(dn, rs.with_data(
            rs.data[None].expand(dn.data.shape)))
        o = ev.rescale_pair(ev.mul_const_vec(prod, gscale[lo:hi],
                                             prod.scale))
        outs.append(ev.add_const_vec(o, beta[lo:hi]))
    return outs[0] if len(outs) == 1 else \
        outs[0].with_data(torch.cat([o.data for o in outs]))


def diag_valid_masks(input_lens, num_x: int, num_row: int, slots: int
                     ) -> np.ndarray:
    """[num_row, slots] 0/1: slot num_x*k+j of diagonal d is valid iff
    row k < len_j and (k+d) mod num_row < len_j."""
    lens = np.asarray(input_lens)
    masks = np.zeros((num_row, slots))
    for d in range(num_row):
        k = np.arange(num_row)
        col = (k + d) % num_row
        for j in range(len(lens)):
            ok = (k < lens[j]) & (col < lens[j])
            masks[d, num_x * k[ok] + j] = 1.0
    return masks


# softmax_diag's plaintexts by where they came from: "encoded" on the host,
# "reused" from a SoftmaxPts memo's coefficients (two a call)
softmax_pts_calls = {"encoded": 0, "reused": 0}


def reset_softmax_pts_calls() -> None:
    for k in softmax_pts_calls:
        softmax_pts_calls[k] = 0


class SoftmaxPts:
    """softmax_diag's two slot-vector plaintexts for one set of masks:
    -max*masks at the input's scale and masks/sum_scale at the exp output's
    pair scale.  The rounded host coefficients of both are kept for the
    last (max_val, in_scale, n_q, exp_r, sum_scale) asked for; every call
    makes fresh device Plaintexts from them (``rounded_to_ntt``), so the
    card holds them only while a pass uses them, as ``CPMM._bias``."""

    def __init__(self, ev: Evaluator, encoder: Encoder, masks: np.ndarray):
        self.ev, self.encoder, self.masks = ev, encoder, masks
        self._key = None
        self._rounded = None          # ((coefficients, scale, n_q), ...)

    @debug.spanned("softmax.pts")
    def __call__(self, max_val: float, in_scale: float, n_q: int,
                 exp_r: int = 7, sum_scale: float | None = None
                 ) -> tuple[Plaintext, Plaintext]:
        if sum_scale is None:
            sum_scale = float(self.masks.shape[0])
        key = (max_val, in_scale, n_q, exp_r, sum_scale)
        if key != self._key:
            n_e = n_q - exp_taylor_primes(exp_r)      # level of exp output
            pair = self.ev.level_pair_scale(n_e)
            enc = self.encoder.encode_coeffs
            self._rounded = (
                (enc(-max_val * self.masks, in_scale), in_scale, n_q),
                (enc(self.masks / sum_scale, pair), pair, n_e))
            self._key = key
            softmax_pts_calls["encoded"] += 2
        else:
            softmax_pts_calls["reused"] += 2
        return tuple(Plaintext(rounded_to_ntt(self.ev.ctx, self.encoder, c,
                                              n), scale)
                     for c, scale, n in self._rounded)


@debug.spanned("softmax")
def softmax_diag(ev: Evaluator, encoder: Encoder, x: Ciphertext,
                 masks: np.ndarray, max_val: float,
                 refresh: Callable[[Ciphertext], Ciphertext],
                 sum_scale: float | None = None, inv_iters: int = 16,
                 eps: float = 1e-5, out_n_q: int | None = None,
                 exp_r: int = 7, pts=None) -> Ciphertext:
    """Softmax over num_row diagonal-packed score ciphertexts (leading axis):
    x - max_val (masked) -> exp -> mask/sum_scale -> column sum + eps ->
    refresh -> Goldschmidt inverse -> exp * inv.

    ``sum_scale`` normalizes the exp-sum into (0, 2) for the inverse;
    defaults to num_row."""
    e, s = softmax_exp_sum(ev, encoder, x, masks, max_val,
                           sum_scale=sum_scale, eps=eps, exp_r=exp_r,
                           pts=pts)
    s = refresh(s)
    return softmax_finish(ev, e, s, inv_iters=inv_iters, out_n_q=out_n_q)


def softmax_exp_sum(ev: Evaluator, encoder: Encoder, x: Ciphertext,
                    masks: np.ndarray, max_val: float,
                    sum_scale: float | None = None, eps: float = 1e-5,
                    exp_r: int = 7, pts=None
                    ) -> tuple[Ciphertext, Ciphertext]:
    """Softmax phase 1: (x - max) -> exp -> mask/sum_scale -> column sum
    + eps.  Returns (e, s); ``s`` is the single sum ciphertext.  ``ev`` may
    be a ShardedEvaluator (``parallel.sharding.softmax_diag_sharded``).
    ``pts``: the two plaintexts, or a ``SoftmaxPts`` of ``masks`` that
    makes them (None: encoded here)."""
    R = masks.shape[0]
    if sum_scale is None:
        sum_scale = float(R)
    if pts is None:
        pts = SoftmaxPts(ev, encoder, masks)
    if isinstance(pts, SoftmaxPts):
        if pts.masks is not masks:
            raise ValueError("the SoftmaxPts memo holds other masks")
        pts = pts(max_val, x.scale, x.n_q, exp_r=exp_r, sum_scale=sum_scale)
    neg_max, mask_pt = pts
    x1 = ev.add_plain(x, neg_max)
    e = exp_taylor(ev, x1, r=exp_r)
    if mask_pt.n_q != e.n_q:
        raise ValueError(f"mask plaintext at n_q={mask_pt.n_q}, exp output "
                         f"at {e.n_q}")
    e = ev.rescale_pair(ev.multiply_plain(e, mask_pt))
    s = ev.add_const(ev.sum_leading(e), eps / sum_scale)
    return e, s


def softmax_finish(ev: Evaluator, e: Ciphertext, s: Ciphertext,
                   inv_iters: int = 16, out_n_q: int | None = None
                   ) -> Ciphertext:
    """Softmax phase 2: Goldschmidt inverse of the sum, then exp * inv
    (over an Evaluator or a ShardedEvaluator, as phase 1)."""
    inv = inverse_goldschmidt(ev, s, inv_iters)
    en, invn = ev.align(e, inv)
    out = ev.mul_relin_rescale(en, ev.expand_like(invn, en))
    if out_n_q is not None and out.n_q > out_n_q:
        out = ev.mod_drop_to(out, out_n_q)
    return out
