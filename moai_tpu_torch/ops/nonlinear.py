"""Polynomial nonlinearities of the attention head: exp, inverse, softmax.

Port of the softmax part of ``moai_tpu/ops/nonlinear.py``: every function
is a composition of Evaluator primitives over batched ciphertexts, and
every polynomial term is driven to a common target scale with
``Evaluator.mul_const_to``.  LayerNorm and GELU are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..ciphertext import Ciphertext, Plaintext
from ..encoder import Encoder
from ..encrypt import encode_ntt
from ..evaluator import Evaluator


def encode_plain(ev: Evaluator, encoder: Encoder, vals, scale: float,
                 n_q: int) -> Plaintext:
    """Host-encode slot values -> NTT+Montgomery Plaintext at (scale, n_q)."""
    return Plaintext(encode_ntt(ev.ctx, encoder, vals, scale, n_q), scale)


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


def _sum_leading(data, q):
    """Modular sum over the leading axis (canonical residues)."""
    return data.sum(0).remainder_(q)


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


def softmax_pts(ev: Evaluator, encoder: Encoder, masks: np.ndarray,
                max_val: float, in_scale: float, n_q: int, exp_r: int = 7,
                sum_scale: float | None = None):
    """Encode softmax_diag's two slot-vector plaintexts: -max*masks and
    masks/sum_scale."""
    if sum_scale is None:
        sum_scale = float(masks.shape[0])
    neg_max = encode_plain(ev, encoder, -max_val * masks, in_scale, n_q)
    n_e = n_q - exp_taylor_primes(exp_r)      # level of exp output
    pair = ev.level_pair_scale(n_e)
    mask_pt = encode_plain(ev, encoder, masks / sum_scale, pair, n_e)
    return neg_max, mask_pt


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
    + eps.  Returns (e, s); ``s`` is the single sum ciphertext."""
    R = masks.shape[0]
    if sum_scale is None:
        sum_scale = float(R)
    if pts is None:
        pts = softmax_pts(ev, encoder, masks, max_val, x.scale, x.n_q,
                          exp_r=exp_r, sum_scale=sum_scale)
    neg_max, mask_pt = pts
    x1 = ev.add_plain(x, neg_max)
    e = exp_taylor(ev, x1, r=exp_r)
    if mask_pt.n_q != e.n_q:
        raise ValueError(f"mask plaintext at n_q={mask_pt.n_q}, exp output "
                         f"at {e.n_q}")
    e = ev.rescale_pair(ev.multiply_plain(e, mask_pt))
    s = Ciphertext(_sum_leading(e.data, ev.dev["q"][:e.n_q].reshape(-1, 1)),
                   e.scale, True)
    s = ev.add_const(s, eps / sum_scale)
    return e, s


def softmax_finish(ev: Evaluator, e: Ciphertext, s: Ciphertext,
                   inv_iters: int = 16, out_n_q: int | None = None
                   ) -> Ciphertext:
    """Softmax phase 2: Goldschmidt inverse of the sum, then exp * inv."""
    inv = inverse_goldschmidt(ev, s, inv_iters)
    en, invn = ev.align(e, inv)
    out = ev.mul_relin_rescale(
        en, invn.with_data(invn.data[None].expand(en.data.shape)))
    if out_n_q is not None and out.n_q > out_n_q:
        out = ev.mod_drop_to(out, out_n_q)
    return out
