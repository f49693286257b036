"""Modular arithmetic for RNS limbs, on int32 torch tensors.

Port of ``moai_tpu/mod_arith.py``.  Residues hold exactly the values the
JAX package holds in uint32: Montgomery form ``x*R mod q`` with R = 2**32
and primes q < 2**30, so every residue fits the non-negative range of an
int32 lane, on the card and on the CPU alike.  Every function returns the
canonical residue in [0, q) as int32, so any exact method agrees bit for
bit with the JAX package; where that code relies on uint32 wrap-around
(``sub_mod``, ``shoup_mul``, ``mont_redc``) this one computes the same
value with ``%`` or a shift.

The plain versions widen their operands to int64 for every product and
every sum of more than one term (a product of two residues is < 2**60)
and narrow the canonical result back to int32; wider integers exist only
inside such a computation.  They also take int64 operands in the ranges
their docstrings state, and still return int32.

``mont_mul`` takes ``rinv = R**-1 mod q`` where the JAX version takes
``-q**-1 mod R``: on 64-bit intermediates the Montgomery product is simply
``a*b*R**-1 mod q``.  The 16-bit-halves multiply (``mul_full_u32``) and the
XLA scheduling barrier (``seq``) have no counterpart here.

Per-limb constants are int32 tensors of shape ``[n_limbs, 1]`` (they are
residues too), broadcast against ``[..., n_limbs, N]`` data.

Each operation dispatches on its data's device, as ``ntt.ntt`` does: a
CUDA tensor launches a hand-written kernel of ``limb_cuda``
(csrc/limb.cu), which takes int32 tensors only, or raises; a CPU tensor
takes the plain version (``*_plain``), which is the torch code of the JAX
package's ops and what the kernels are held ``torch.equal`` to on the
card.  Beside the elementwise family are the scheme's three loops over
limbs, each with its plain version and its kernel: the fast base
conversion (``base_conv``), the key-switch MAC (``ks_mac``) and the
bootstrap's diagonal MAC (``diag_mac``).
"""

from __future__ import annotations

import torch

from . import limb_cuda

R_BITS = 32


# ---------------------------------------------------------------------------
# host-side Montgomery constants
# ---------------------------------------------------------------------------

def mont_constants(q: int) -> dict:
    """Montgomery constants for one odd prime q < 2**30 (the JAX package's
    keys plus ``rinv``)."""
    if not (q % 2 == 1 and q < (1 << 30)):
        raise ValueError(f"modulus must be an odd prime below 2**30, got {q}")
    r = 1 << R_BITS
    qinv = pow(q, -1, r)
    return {
        "q": q,
        "qneg_inv": (r - qinv) % r,       # -q^{-1} mod 2^32
        "r2": (r * r) % q,                # R^2 mod q (to-Montgomery factor)
        "r1": r % q,                      # R mod q   (Montgomery form of 1)
        "rinv": pow(r % q, -1, q),        # R^{-1} mod q
    }


def host_to_mont(x: int, q: int) -> int:
    """Montgomery form of integer x (host, exact)."""
    return (x % q) * (1 << R_BITS) % q


def host_from_mont(x: int, q: int) -> int:
    return x * pow(1 << R_BITS, -1, q) % q


def host_shoup(w: int, q: int) -> int:
    """Shoup companion floor(w * 2^32 / q) of a multiplier w < q."""
    return (w << R_BITS) // q


# ---------------------------------------------------------------------------
# device-side primitives (int32 residues; shapes broadcast).  The plain
# versions compute in int64 and return int32; their domains are stated
# for non-negative operands, and the int32 residues' whole range [0, 2^31)
# lies inside each of them.
# ---------------------------------------------------------------------------

def _on_card(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in xs)


def _wide(x):
    """A tensor operand as int64 (a Python int as it is)."""
    return x.to(torch.int64) if isinstance(x, torch.Tensor) else x


def _narrow(x: torch.Tensor) -> torch.Tensor:
    """A canonical int64 result (below q < 2^30) as the int32 residue."""
    return x.to(torch.int32)


def _mont_mul64(a, b, q, rinv):
    t = _wide(a) * _wide(b)
    t.remainder_(_wide(q))
    t.mul_(_wide(rinv))
    return t.remainder_(_wide(q))


def add_mod_plain(a, b, q):
    """(a + b) mod q, canonical.  Exact for any |a|, |b| < 2^62."""
    return _narrow((_wide(a) + _wide(b)).remainder_(_wide(q)))


def sub_mod_plain(a, b, q):
    """(a - b) mod q, canonical (floored).  Exact for any |a|, |b| < 2^62."""
    return _narrow((_wide(a) - _wide(b)).remainder_(_wide(q)))


def neg_mod_plain(a, q):
    return _narrow((-_wide(a)).remainder_(_wide(q)))


def mont_mul_plain(a, b, q, rinv):
    """Montgomery product: mm(xR, yR) = xyR mod q, in [0, q).  Exact while
    the int64 product a * b stays below 2^63: any a, b in [0, 2^32) with
    one of them below 2^31, so every pair of int32 residues."""
    return _narrow(_mont_mul64(a, b, q, rinv))


def from_mont_plain(x, q, rinv):
    """Montgomery form -> true residue in [0, q).  Exact for |x| < 2^33."""
    return _narrow((_wide(x) * _wide(rinv)).remainder_(_wide(q)))


def sub_mont_mul_plain(a, b, c, q, rinv):
    """mont_mul(sub_mod(a, b), c): the tail of rescale and of the mod-down."""
    return mont_mul_plain(sub_mod_plain(a, b, q), c, q, rinv)


def add_mod(a, b, q):
    if _on_card(a, b):
        return limb_cuda.limb_ew("add", a, b, None, q)
    return add_mod_plain(a, b, q)


def sub_mod(a, b, q):
    if _on_card(a, b):
        return limb_cuda.limb_ew("sub", a, b, None, q)
    return sub_mod_plain(a, b, q)


def neg_mod(a, q):
    if _on_card(a):
        return limb_cuda.limb_ew("neg", a, None, None, q)
    return neg_mod_plain(a, q)


def mont_mul(a, b, q, rinv):
    """Montgomery product a*b*R^-1 mod q.  The kernel derives -q^-1 mod R
    from q once per row, so ``rinv`` is read only by the plain version."""
    if _on_card(a, b):
        return limb_cuda.limb_ew("mul", a, b, None, q)
    return mont_mul_plain(a, b, q, rinv)


def sub_mont_mul(a, b, c, q, rinv):
    """mont_mul(sub_mod(a, b, q), c, q, rinv), in one kernel on the card."""
    if _on_card(a, b, c):
        return limb_cuda.limb_ew("sub_mul", a, b, c, q)
    return sub_mont_mul_plain(a, b, c, q, rinv)


def shoup_mul(x, w, w_shoup, q):
    """x * w mod q for a precomputed multiplier w < q with Shoup companion
    w_shoup = floor(w * 2^32 / q).  h = floor(x*w_shoup / 2^32) puts q*h
    within (xw - 2q, xw], so r = x*w - h*q lies in [0, 2q): one conditional
    subtract.  The multiplier is a true value, so Montgomery x stays
    Montgomery.  Plain torch only: the plain NTT's butterfly, on its int64
    lanes (x * w_shoup needs 62 bits); returns int64."""
    h = (x * w_shoup) >> R_BITS
    r = x * w
    r.sub_(h * q)
    return torch.where(r >= q, r - q, r)


def to_mont(x, q, rinv, r2):
    """True residues (any value in [0, 2**31), even >= q) -> Montgomery
    form; the plain version also takes int64 values below 2**32."""
    return mont_mul(x, r2, q, rinv)


def from_mont(x, q, rinv):
    """Montgomery form -> true residue in [0, q)."""
    if _on_card(x):
        return limb_cuda.limb_ew("from_mont", x, None, None, q)
    return from_mont_plain(x, q, rinv)


# ---------------------------------------------------------------------------
# the scheme's loops over limbs
# ---------------------------------------------------------------------------

def base_conv_plain(x, src_q, src_rinv, hatinv, hat, tq, trinv, k=None,
                    kq=None):
    """Fast base conversion in torch ops (the JAX package's
    ``_ks_decompose`` loop): x [..., S, N] canonical, cut into D digits of
    A limbs (hat [D, A, T]; the last digit zero-padded), each input turned
    into lam = from_mont(mont_mul(x, hatinv)) modulo src_q (hatinv None: x
    holds lam), then out[..., d, t, :] = sum_a mont_mul(lam_a, hat[d, a, t])
    mod tq[t] -> [..., D, T, N].  With k [..., N] and kq [T],
    mont_mul(k, kq) is subtracted (ModRaise's multiple of q0).  src_q,
    src_rinv and hatinv hold at least D*A entries, tq and trinv T.  Exact
    for x and k in [0, 2^32) (k also negative), every sum in int64."""
    D, A, T = hat.shape
    pad = D * A - x.shape[-2]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))],
                      dim=-2)
    lam = x.reshape(x.shape[:-2] + (D, A, x.shape[-1]))
    if hatinv is not None:
        qs = src_q.reshape(-1)[:D * A].reshape(D, A, 1)
        rs = src_rinv.reshape(-1)[:D * A].reshape(D, A, 1)
        lam = from_mont_plain(_mont_mul64(
            lam, hatinv.reshape(-1)[:D * A].reshape(D, A, 1), qs, rs), qs, rs)
    tq, trinv = tq.reshape(-1, 1), trinv.reshape(-1, 1)
    y = None
    for a in range(A):
        term = _mont_mul64(lam[..., :, a, None, :], hat[:, a, :, None],
                           tq, trinv)
        y = term if y is None else y.add_(term)
    y.remainder_(_wide(tq))
    if k is not None:
        y.sub_(_mont_mul64(k[..., None, None, :], kq.reshape(-1, 1), tq,
                           trinv)).remainder_(_wide(tq))
    return _narrow(y)


def base_conv(x, src_q, src_rinv, hatinv, hat, tq, trinv, k=None, kq=None):
    """``base_conv_plain`` on the CPU, the ``base_conv`` kernel on the card."""
    if x.is_cuda:
        return limb_cuda.base_conv(x.contiguous(), src_q, hatinv, hat, tq,
                                   k=None if k is None else k.contiguous(),
                                   kq=kq)
    return base_conv_plain(x, src_q, src_rinv, hatinv, hat, tq, trinv, k, kq)


def _key_rows(key_data, D: int, n_q: int, q_limbs: int):
    """key [..., dnum, 2, q_limbs+K, N] -> the rows of its first D digits
    for the targets Q_l + P: [..., D, 2, n_q+K, N]."""
    kd = key_data[..., :D, :, :, :]
    return torch.cat([kd[..., :n_q, :], kd[..., q_limbs:, :]], dim=-2)


def ks_mac_plain(y, keys, q_limbs: int, tq, trinv, perm=None):
    """The key-switch MAC in torch ops: y [..., D, T, N] against the key rows
    of ``keys`` (one key [dnum, 2, q_limbs+K, N]; with perm [R, N], a list
    of R keys, and y gathered per rotation, y[..., perm[r]]), each digit's
    products summed in int64 and reduced -> (acc0, acc1), [..., T, N]
    (with perm [R, ..., T, N]).  Leading batch axes broadcast."""
    D, T = y.shape[-3], y.shape[-2]
    n_q = T - ((keys if perm is None else keys[0]).shape[-2] - q_limbs)
    tq, trinv = tq.reshape(-1, 1), trinv.reshape(-1, 1)
    if perm is None:
        kr = _key_rows(keys, D, n_q, q_limbs)
    else:
        kr = _key_rows(torch.stack(list(keys)), D, n_q, q_limbs)
        if y.dim() > 3:                                 # broadcast batch
            kr = kr.reshape((kr.shape[0],) + (1,) * (y.dim() - 3)
                            + kr.shape[1:])
        # digits of sigma_g(c1) = sigma_g(digits of c1): a gather
        y = y[..., perm].movedim(-2, 0)                 # [R, ..., D, T, N]
    acc0 = acc1 = None
    for d in range(D):
        yd = y[..., d, :, :]
        t0 = _mont_mul64(yd, kr[..., d, 0, :, :], tq, trinv)
        t1 = _mont_mul64(yd, kr[..., d, 1, :, :], tq, trinv)
        acc0 = t0 if acc0 is None else acc0.add_(t0)
        acc1 = t1 if acc1 is None else acc1.add_(t1)
    return (_narrow(acc0.remainder_(_wide(tq))),
            _narrow(acc1.remainder_(_wide(tq))))


def ks_mac(y, keys, q_limbs: int, tq, trinv, perm=None):
    """``ks_mac_plain`` on the CPU, the ``ks_mac`` kernel on the card (which
    reads each key where it lies and y through perm, without copies)."""
    if y.is_cuda:
        return limb_cuda.ks_mac(y.contiguous(), keys, q_limbs, tq, perm)
    return ks_mac_plain(y, keys, q_limbs, tq, trinv, perm)


def diag_mac_plain(cts, pts, q, rinv):
    """One giant step's sum of multiply_plain products in torch ops:
    sum_j mont_mul(cts[j], pts[j]) mod q, cts[j] [..., n_polys, n_q, N]
    and pts [J, n_q, N] (each diagonal broadcast over the polynomials),
    the canonical products summed in int64 and reduced once."""
    part = None
    for ct, pt in zip(cts, pts):
        term = _mont_mul64(ct, pt.unsqueeze(-3), q, rinv)
        part = term if part is None else part.add_(term)
    return _narrow(part.remainder_(_wide(q)))


def diag_mac(cts, pts, q, rinv):
    """``diag_mac_plain`` on the CPU, the ``diag_mac`` kernel on the card."""
    if pts.is_cuda:
        return limb_cuda.diag_mac([c.contiguous() for c in cts],
                                  pts.contiguous(), q)
    return diag_mac_plain(cts, pts, q, rinv)
