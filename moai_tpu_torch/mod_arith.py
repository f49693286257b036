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
"""

from __future__ import annotations

import torch

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
# device-side primitives (int64 tensors; shapes broadcast)
# ---------------------------------------------------------------------------

def add_mod(a, b, q):
    return (a + b).remainder_(q)


def sub_mod(a, b, q):
    return (a - b).remainder_(q)


def neg_mod(a, q):
    return (-a).remainder_(q)


def mont_mul(a, b, q, rinv):
    """Montgomery product: mm(xR, yR) = xyR mod q, in [0, q).  Exact for any
    a, b < 2**32 with one of them < 2**30 (the product stays < 2**62)."""
    t = a * b
    t.remainder_(q)
    t.mul_(rinv)
    return t.remainder_(q)


def shoup_mul(x, w, w_shoup, q):
    """x * w mod q for a precomputed multiplier w < q with Shoup companion
    w_shoup = floor(w * 2^32 / q).  h = floor(x*w_shoup / 2^32) puts q*h
    within (xw - 2q, xw], so r = x*w - h*q lies in [0, 2q): one conditional
    subtract.  The multiplier is a true value, so Montgomery x stays
    Montgomery."""
    h = (x * w_shoup) >> R_BITS
    r = x * w
    r.sub_(h * q)
    return torch.where(r >= q, r - q, r)


def to_mont(x, q, rinv, r2):
    """True residues (any value < 2**32, even >= q) -> Montgomery form."""
    return mont_mul(x, r2, q, rinv)


def from_mont(x, q, rinv):
    """Montgomery form -> true residue in [0, q)."""
    return (x * rinv).remainder_(q)
