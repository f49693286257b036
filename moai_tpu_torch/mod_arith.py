"""Modular arithmetic for RNS limbs, on int64 torch tensors.

Port of ``moai_tpu/mod_arith.py``.  Residues hold exactly the values the
JAX package holds in uint32: Montgomery form ``x*R mod q`` with R = 2**32
and primes q < 2**30, so a product of two residues is < 2**60 and fits an
int64 lane.  Every function returns the canonical residue in [0, q), so
any exact method agrees bit for bit with the JAX package; where that code
relies on uint32 wrap-around (``sub_mod``, ``shoup_mul``, ``mont_redc``)
this one computes the same value with ``%`` or a shift.

``mont_mul`` takes ``rinv = R**-1 mod q`` where the JAX version takes
``-q**-1 mod R``: on 64-bit lanes the Montgomery product is simply
``a*b*R**-1 mod q``.  The 16-bit-halves multiply (``mul_full_u32``) and the
XLA scheduling barrier (``seq``) have no counterpart here.

Per-limb constants are int64 tensors of shape ``[n_limbs, 1]``, broadcast
against ``[..., n_limbs, N]`` data.  The functions that build a fresh
product reduce it in place, so a call allocates one output tensor.

Each operation dispatches on its data's device, as ``ntt.ntt`` does: a
CUDA tensor launches a hand-written kernel of ``limb_cuda``
(csrc/limb.cu) or raises, a CPU tensor takes the plain version
(``*_plain``), which is the torch code of the JAX package's ops and what
the kernels are held ``torch.equal`` to on the card.  Beside the
elementwise family are the scheme's three loops over limbs, each with its
plain version and its kernel: the fast base conversion (``base_conv``),
the key-switch MAC (``ks_mac``) and the bootstrap's diagonal MAC
(``diag_mac``).
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
# device-side primitives (int64 tensors; shapes broadcast).  The plain
# versions take any int64 values; mont_mul_plain and from_mont_plain are
# exact while their int64 products stay below 2^63.
# ---------------------------------------------------------------------------

def _on_card(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in xs)


def add_mod_plain(a, b, q):
    return (a + b).remainder_(q)


def sub_mod_plain(a, b, q):
    return (a - b).remainder_(q)


def neg_mod_plain(a, q):
    return (-a).remainder_(q)


def mont_mul_plain(a, b, q, rinv):
    """Montgomery product: mm(xR, yR) = xyR mod q, in [0, q).  Exact for any
    a, b < 2**32 with one of them < 2**30 (the product stays < 2**62)."""
    t = a * b
    t.remainder_(q)
    t.mul_(rinv)
    return t.remainder_(q)


def from_mont_plain(x, q, rinv):
    """Montgomery form -> true residue in [0, q)."""
    return (x * rinv).remainder_(q)


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
    from q, so ``rinv`` is read only by the plain version."""
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
    Montgomery.  Plain torch only: the plain NTT's butterfly."""
    h = (x * w_shoup) >> R_BITS
    r = x * w
    r.sub_(h * q)
    return torch.where(r >= q, r - q, r)


def to_mont(x, q, rinv, r2):
    """True residues (any value < 2**32, even >= q) -> Montgomery form."""
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
    src_rinv and hatinv hold at least D*A entries, tq and trinv T."""
    D, A, T = hat.shape
    pad = D * A - x.shape[-2]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))],
                      dim=-2)
    lam = x.reshape(x.shape[:-2] + (D, A, x.shape[-1]))
    if hatinv is not None:
        qs = src_q.reshape(-1)[:D * A].reshape(D, A, 1)
        rs = src_rinv.reshape(-1)[:D * A].reshape(D, A, 1)
        lam = from_mont_plain(mont_mul_plain(
            lam, hatinv.reshape(-1)[:D * A].reshape(D, A, 1), qs, rs), qs, rs)
    tq, trinv = tq.reshape(-1, 1), trinv.reshape(-1, 1)
    y = None
    for a in range(A):
        term = mont_mul_plain(lam[..., :, a, None, :], hat[:, a, :, None],
                              tq, trinv)
        y = term if y is None else y.add_(term)
    y.remainder_(tq)
    if k is not None:
        y = sub_mod_plain(y, mont_mul_plain(k[..., None, None, :],
                                            kq.reshape(-1, 1), tq, trinv), tq)
    return y


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
    products summed and reduced -> (acc0, acc1), [..., T, N] (with perm
    [R, ..., T, N]).  Leading batch axes broadcast."""
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
        t0 = mont_mul_plain(yd, kr[..., d, 0, :, :], tq, trinv)
        t1 = mont_mul_plain(yd, kr[..., d, 1, :, :], tq, trinv)
        acc0 = t0 if acc0 is None else acc0.add_(t0)
        acc1 = t1 if acc1 is None else acc1.add_(t1)
    acc0.remainder_(tq)
    acc1.remainder_(tq)
    return acc0, acc1


def ks_mac(y, keys, q_limbs: int, tq, trinv, perm=None):
    """``ks_mac_plain`` on the CPU, the ``ks_mac`` kernel on the card (which
    reads each key where it lies and y through perm, without copies)."""
    if y.is_cuda:
        return limb_cuda.ks_mac(y.contiguous(), keys, q_limbs, tq, perm)
    return ks_mac_plain(y, keys, q_limbs, tq, trinv, perm)


def diag_mac_plain(cts, pts, q, rinv):
    """One giant step's sum of multiply_plain products in torch ops:
    sum_j mont_mul(cts[j], pts[j]) mod q, cts[j] [..., n_polys, n_q, N]
    and pts [J, n_q, N] (each diagonal broadcast over the polynomials)."""
    part = None
    for ct, pt in zip(cts, pts):
        term = mont_mul_plain(ct, pt.unsqueeze(-3), q, rinv)
        part = term if part is None else add_mod_plain(part, term, q)
    return part


def diag_mac(cts, pts, q, rinv):
    """``diag_mac_plain`` on the CPU, the ``diag_mac`` kernel on the card."""
    if pts.is_cuda:
        return limb_cuda.diag_mac([c.contiguous() for c in cts],
                                  pts.contiguous(), q)
    return diag_mac_plain(cts, pts, q, rinv)
